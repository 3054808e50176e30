"""WanDiT: Wan2.1's T2V DiT over the pyramid's packed tokens.

Wan2.1 (``github.com/Wan-Video/Wan2.1``, ``wan/modules/model.py``,
``WanModel`` with ``model_type="t2v"``) at its published widths by default:
Wan2.1-T2V-14B's ``config.json`` (``dim`` 5120, ``ffn_dim`` 13824, 40 heads
of 128, 40 layers, ``in_dim`` = ``out_dim`` = 16, ``freq_dim`` 256,
``text_len`` 512, ``eps`` 1e-6) and ``WanModel``'s defaults (patch (1, 2,
2), ``text_dim`` 4096, qk norms and ``norm3``), 14,288,491,584 parameters.

It takes the pyramid pipeline's forward arguments, as the other two
families do: ``latent_tokens [B, L, 64]`` (2x2 patches of 16 channels in
``(p1, p2, c)`` order, history then the current clip), ``latent_pos [B, L,
3]`` float (t, h, w) positions, ``latent_time [B, L]`` time ids,
``text_emb [B, Lt, 4096]`` T5 states with ``text_mask``, ``pooled``
(ignored: Wan reads no pooled text) and ``timestep [B]`` on the 0..1000
scale. It returns fp32 velocity tokens ``[B, L, 64]`` in the same layout.

* Text: the mask's tokens keep their states, the rest and a tail up to
  ``text_len`` are zeros (Wan trims each prompt's states to its length and
  pads with zeros, which is this for the prefix masks T5 gives), then
  ``text_embedding``, a GELU-tanh MLP to the model width. No text key is
  masked (Wan passes ``context_lens=None``).
* Time: ``e = time_embedding(sinusoid(t))`` and ``e0 =
  time_projection(e)`` ``[B, 6, D]``, in fp32.
* ``patch_embedding`` keeps the checkpoint's Conv3d weight ``[D, 16, 1, 2,
  2]`` and is applied as a linear over the patchified tokens, as the
  MMDiT's ``pos_embed.proj``.
* RoPE on the axes (44, 42, 42) of the 128-wide head, theta 10000, on the
  pipeline's positions (fractional for a lower-resolution history clip).
* Self-attention keeps the pyramid's temporal-causal time ids, which its
  autoregression needs; Wan itself attends both ways within one clip.
* ``head``: ``Linear(LN(x) * (1 + m1) + m0)`` in fp32, ``m = head.modulation
  + e``.

``bounded_softmax`` defaults to False: the qk norms span all heads, so the
bounded form's exactness argument does not hold (``blocks``). The forward
is the DiT shell's (``models.dit_base``): a ``dit.forward`` span with
``rows``, ``tokens``, ``text_tokens``, ``graph`` and the counters
``attn_launches`` (both attentions, 80 per forward at full depth on the
card), ``cross_attn_launches`` (40) and ``qk_launches`` (the fused q/k/v
kernel, one per attention: 80). A serving forward replays CUDA graphs
captured per layout, cut at each of its two attentions per block
(``models.dit_graphs``); every other forward runs eagerly. One device
only: a mesh with an sp or fsdp dim above 1 is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.rope import rope_freqs
from ...parallel.mesh import SP_AXIS, mesh_dim
from ...utils.devices import model_device
from ..dit_base import DIT_COUNTERS, DiTBase
from ..flux.blocks import layer_norm
from ..flux.model import timestep_sinusoidal
from .blocks import CROSS_ATTN_LAUNCHES, WanAttentionBlock, linear_fp32

__all__ = ["WanConfig", "WanDiT"]


@dataclasses.dataclass(frozen=True)
class WanConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 5120
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 40
    num_layers: int = 40
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def rope_axes(self) -> Tuple[int, int, int]:
        """Wan's split of the head dim over (t, h, w)."""
        d = self.head_dim
        return (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))

    @property
    def token_dim(self) -> int:
        return self.patch_size[1] * self.patch_size[2] * self.in_dim


class _Head(nn.Module):
    def __init__(self, dim: int, out: int, eps: float, **kw):
        super().__init__()
        self.eps = eps
        self.head = nn.Linear(dim, out, **kw)
        self.modulation = nn.Parameter(
            torch.randn(1, 2, dim, **kw) / dim ** 0.5)

    def forward(self, x, e):
        shift, scale = (self.modulation.float() + e[:, None]).chunk(2, dim=1)
        return linear_fp32(self.head,
                           layer_norm(x, self.eps) * (1 + scale) + shift)


class WanDiT(DiTBase):
    """Wan2.1 T2V over packed tokens; see the module docstring."""

    model_name = "pyramid_wan"
    span_counters = {**DIT_COUNTERS, **CROSS_ATTN_LAUNCHES}

    def __init__(self, config: WanConfig = WanConfig(), *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 mesh=None, bounded_softmax: bool = False):
        super().__init__(remat=False, bounded_softmax=bounded_softmax,
                         mesh=mesh)
        cfg = self.config = config
        if tuple(cfg.patch_size) != (1, 2, 2):
            raise ValueError(f"the pyramid packs (1, 2, 2) patches; "
                             f"patch_size {cfg.patch_size}")
        if cfg.dim % cfg.num_heads:
            raise ValueError("dim must divide by num_heads")
        kw = dict(dtype=dtype, device=model_device(device, "WanDiT"))
        d = cfg.dim
        self.patch_embedding = nn.Conv3d(cfg.in_dim, d, cfg.patch_size,
                                         stride=cfg.patch_size, **kw)
        self.text_embedding = nn.Sequential(
            nn.Linear(cfg.text_dim, d, **kw), nn.GELU(approximate="tanh"),
            nn.Linear(d, d, **kw))
        self.time_embedding = nn.Sequential(
            nn.Linear(cfg.freq_dim, d, **kw), nn.SiLU(), nn.Linear(d, d, **kw))
        self.time_projection = nn.Sequential(nn.SiLU(),
                                             nn.Linear(d, 6 * d, **kw))
        self.blocks = nn.ModuleList([
            WanAttentionBlock(d, cfg.ffn_dim, cfg.num_heads, cfg.eps, **kw)
            for _ in range(cfg.num_layers)])
        self.head = _Head(d, cfg.token_dim, cfg.eps, **kw)
        # zero-initialised output, as Wan's init_weights: a fresh DiT
        # predicts its bias
        nn.init.zeros_(self.head.head.weight)
        self._share_sites()

    def set_mesh(self, mesh) -> None:
        """One device only: refuses a mesh with an sp or fsdp dim above 1."""
        sp, fsdp = mesh_dim(mesh, SP_AXIS), mesh_dim(mesh, "fsdp")
        if sp > 1 or fsdp > 1:
            raise ValueError(
                f"the Wan DiT runs on one device: it has no sequence "
                f"parallelism or FSDP (mesh sp={sp}, fsdp={fsdp})")
        super().set_mesh(mesh)

    @property
    def latent_channels(self) -> int:
        return self.config.in_dim

    def stage_inputs(self, rows: int, height: int, width: int, device
                     ) -> Tuple[torch.Tensor, ...]:
        """The forward's inputs after ``timestep``: none."""
        return ()

    def _span_attrs(self) -> dict:
        return {"text_tokens": self.config.text_len}

    def _forward(self, latent_tokens, latent_pos, latent_time, text_emb,
                 text_mask, pooled, timestep):
        cfg = self.config
        b, lt = text_emb.shape[:2]
        if lt > cfg.text_len:
            raise ValueError(f"{lt} text tokens; the Wan DiT takes at most "
                             f"text_len={cfg.text_len}")
        dtype = self.patch_embedding.weight.dtype
        ctx = text_emb.to(dtype) * text_mask[..., None].to(dtype)
        ctx = self.text_embedding(F.pad(ctx, (0, 0, 0, cfg.text_len - lt)))

        te = self.time_embedding
        e = linear_fp32(te[2], F.silu(linear_fp32(
            te[0], timestep_sinusoidal(timestep, cfg.freq_dim))))
        e0 = linear_fp32(self.time_projection[1], F.silu(e)).unflatten(
            1, (6, cfg.dim))

        w = self.patch_embedding.weight
        x = F.linear(latent_tokens.to(dtype),
                     w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1),
                     self.patch_embedding.bias).float()
        cos, sin = rope_freqs(latent_pos.float(), cfg.rope_axes)
        # the pipeline's ids arrive broadcast over the CFG rows
        time_ids = latent_time.to(torch.int32).contiguous()
        time_kv = torch.zeros((b, cfg.text_len), dtype=torch.int32,
                              device=time_ids.device)
        bounded = self.bounded_softmax
        for block in self.blocks:
            x = block(x, e0, ctx, cos, sin, time_ids, time_kv, bounded)
        return self.head(x, e)
