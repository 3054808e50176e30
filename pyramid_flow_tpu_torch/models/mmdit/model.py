"""PyramidDiffusionMMDiT: the SD3-style MMDiT over packed tokens.

The counterpart of the JAX package's ``models/mmdit/model.py``, on the same
packed-token interface as :class:`~..flux.model.PyramidFluxTransformer` plus
``pos_offset``:

* spatial position: the SD3 2D sincos table (``pos_embed_max_size``
  squared), centre-cropped to the current clip's grid and bilinearly
  interpolated for lower-resolution clips, which reduces to a bilinear
  gather of the table at the float token positions offset by the crop
  origin ``pos_offset``;
* temporal position: one-axis RoPE over the whole head dim, text at t=0;
* ``num_layers`` joint blocks, the last ``context_pre_only``.

Parameters are keyed like the released checkpoint: ``pos_embed.proj.weight``
keeps the checkpoint's conv2d shape ``[D, C, p, p]`` and is applied as a
linear over the patchified ``(p1, p2, c)`` token features; the table is
``pos_embed.pos_embed`` ``[1, G*G, D]``; the last block is
``transformer_blocks.{num_layers - 1}``.

The table is a persistent buffer, as in the released checkpoint (a diffusers
``PatchEmbed`` buffer under the same key), so strict loads and
``mmdit_state_dict_from_jax`` see it as before. This departs from the JAX
model on purpose: JAX makes the table a parameter, so its AdamW decays the
table and the table's gradient enters the global-norm clip. Here the table
takes no gradient, no update and no part in the clip; every other
parameter's step is JAX's wherever the clip does not bind.

The default config is the release architecture (24 blocks, 24 heads x 64,
16 latent channels, patch 2, T5 dim 4096, pooled CLIP-L+G dim 2048).
Precision, ``remat``, ``mesh`` (sequence parallelism),
``bounded_softmax`` (the softmax form of every attention), the
``dit.forward`` span and the CUDA graphs are the DiT shell's
(``models.dit_base``), as in the flux model; the last block is
``context_pre_only``, so under sp the local text tokens' outputs are junk
that the gather at exit drops. Built on the CUDA device unless ``device=``
says otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.rope import rope_freqs
from ...parallel.sp import gather_seq
from ...utils.devices import model_device
from ..dit_base import DiTBase
from ..flux.blocks import AdaLayerNormContinuous
from ..flux.model import TimestepTextEmbed
from .blocks import JointTransformerBlock

__all__ = ["MMDiTConfig", "PyramidDiffusionMMDiT", "PatchEmbed",
           "sincos_pos_embed_table", "bilinear_gather", "sincos_crop_origin"]


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    joint_attention_dim: int = 4096
    pos_embed_max_size: int = 192
    use_temporal_causal: bool = True

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def token_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_channels


def sincos_pos_embed_table(embed_dim: int, grid_size: int, base_size: int,
                           interpolation_scale: float = 1.0) -> np.ndarray:
    """SD3 2D sincos table ``[grid, grid, D]`` fp32. The first half of the
    channels encodes the W coordinate, the second half H (the formula's
    ``meshgrid(w, h)``)."""
    pos = np.arange(grid_size, dtype=np.float32) / (grid_size / base_size)
    pos = pos / interpolation_scale

    def embed_1d(p):  # [N] -> [N, D/2]
        half = embed_dim // 2
        omega = np.arange(half // 2, dtype=np.float64) / (half / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", p.astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    w_mesh, h_mesh = np.meshgrid(pos, pos)  # both [H, W]; w varies on axis 1
    table = np.concatenate([embed_1d(w_mesh.reshape(-1)),
                            embed_1d(h_mesh.reshape(-1))], axis=1)
    return table.reshape(grid_size, grid_size, embed_dim).astype(np.float32)


def bilinear_gather(table: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
    """Sample ``table`` ``[G, G, D]`` at float coordinates ``y``, ``x``
    ``[B, L]`` -> ``[B, L, D]``; coordinates are clipped to the table."""
    g = table.shape[0]
    y = y.clamp(0.0, g - 1)
    x = x.clamp(0.0, g - 1)
    y0 = torch.floor(y).long().clamp(0, g - 1)
    x0 = torch.floor(x).long().clamp(0, g - 1)
    y1 = (y0 + 1).clamp(max=g - 1)
    x1 = (x0 + 1).clamp(max=g - 1)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    return ((table[y0, x0] * (1 - fx) + table[y0, x1] * fx) * (1 - fy)
            + (table[y1, x0] * (1 - fx) + table[y1, x1] * fx) * fy)


def sincos_crop_origin(grid: int, rows: int, height: int, width: int,
                       device) -> torch.Tensor:
    """``[rows, 2]`` fp32: the (top, left) origin of a stage's patch grid
    (latent size height x width, patch 2) centred in the ``grid`` squared
    sincos table: the pipeline's, the trainer's and the probe's rule."""
    origin = torch.tensor([[(grid - height // 2) // 2,
                            (grid - width // 2) // 2]],
                          dtype=torch.float32, device=device)
    return origin.expand(rows, -1)


class PatchEmbed(nn.Module):
    """Token projection and spatial sincos position.

    ``proj`` holds the checkpoint's conv2d weight ``[D, C, p, p]`` and is
    applied as a linear over already patchified ``(p1, p2, c)`` tokens;
    ``pos_embed`` is the table ``[1, G*G, D]``, a persistent buffer."""

    def __init__(self, cfg: MMDiTConfig, **kw):
        super().__init__()
        d, p, g = cfg.inner_dim, cfg.patch_size, cfg.pos_embed_max_size
        self.grid = g
        self.proj = nn.Conv2d(cfg.in_channels, d, p, stride=p, **kw)
        table = sincos_pos_embed_table(d, g, cfg.sample_size // p)
        self.register_buffer("pos_embed", torch.as_tensor(
            table.reshape(1, g * g, d), **kw))

    def forward(self, tokens, latent_pos, pos_offset):
        w = self.proj.weight
        x = F.linear(tokens, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                     self.proj.bias)
        table = self.pos_embed.reshape(self.grid, self.grid, -1).float()
        y = latent_pos[..., 1].float() + pos_offset[:, 0:1].float()
        xc = latent_pos[..., 2].float() + pos_offset[:, 1:2].float()
        return x + bilinear_gather(table, y, xc).to(x.dtype)


class PyramidDiffusionMMDiT(DiTBase):
    """SD3 MMDiT over packed tokens.

    forward inputs are ``PyramidFluxTransformer``'s (``latent_tokens`` of
    width ``p * p * in_channels``) plus ``pos_offset [B, 2]``, the (top,
    left) crop origin of the sincos table for each row, which
    ``stage_inputs`` computes from the current clip's grid for the pipeline,
    the trainer and the probe. Returns velocity tokens
    ``[B, L, p * p * in_channels]``."""

    model_name = "pyramid_mmdit"

    def __init__(self, config: MMDiTConfig = MMDiTConfig(), *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 remat: bool = False, mesh=None,
                 bounded_softmax: bool = True):
        super().__init__(remat=remat, bounded_softmax=bounded_softmax,
                         mesh=mesh)
        cfg = self.config = config
        if cfg.caption_projection_dim != cfg.inner_dim:
            raise ValueError("the joint blocks need caption_projection_dim "
                             "== num_attention_heads * attention_head_dim")
        kw = dict(dtype=dtype,
                  device=model_device(device, "PyramidDiffusionMMDiT"))
        d = cfg.inner_dim
        self.time_text_embed = TimestepTextEmbed(
            d, cfg.pooled_projection_dim, **kw)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, d, **kw)
        self.pos_embed = PatchEmbed(cfg, **kw)
        blk = dict(num_heads=cfg.num_attention_heads,
                   head_dim=cfg.attention_head_dim,
                   causal=cfg.use_temporal_causal, **kw)
        self.transformer_blocks = nn.ModuleList(
            [JointTransformerBlock(context_pre_only=i == cfg.num_layers - 1,
                                   **blk) for i in range(cfg.num_layers)])
        self.norm_out = AdaLayerNormContinuous(d, **kw)
        self.proj_out = nn.Linear(d, cfg.token_dim, **kw)
        # zero-initialised output, as the JAX model: a fresh DiT predicts 0
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)
        self._share_sites()

    @property
    def latent_channels(self) -> int:
        """The VAE latent width: ``in_channels``."""
        return self.config.in_channels

    def stage_inputs(self, rows: int, height: int, width: int, device
                     ) -> Tuple[torch.Tensor, ...]:
        """The forward's inputs after ``timestep`` for a stage of latent
        size height x width: ``(pos_offset,)``, its crop origin of the
        table."""
        return (sincos_crop_origin(self.config.pos_embed_max_size, rows,
                                   height, width, device),)

    @property
    def gradient_free_parameters(self) -> Tuple[str, ...]:
        """Names of the parameters that get no gradient: the last block's
        text-query projection and norm, whose attention rows the
        ``context_pre_only`` block discards (the released checkpoint keeps
        them all the same)."""
        last = f"transformer_blocks.{self.config.num_layers - 1}.attn"
        return (f"{last}.add_q_proj.weight", f"{last}.add_q_proj.bias",
                f"{last}.norm_add_q.weight")

    def _forward(self, latent_tokens, latent_pos, latent_time, text_emb,
                 text_mask, pooled, timestep, pos_offset):
        b, lt = text_emb.shape[:2]
        temb = self.time_text_embed(timestep, pooled)
        ctx = self.context_embedder(text_emb)
        x = self.pos_embed(latent_tokens, latent_pos, pos_offset)

        # temporal RoPE over the whole head dim, text at t=0
        t_pos = torch.cat([torch.zeros((b, lt, 1), dtype=torch.float32,
                                       device=latent_pos.device),
                           latent_pos[..., :1].float()], dim=1)
        cos, sin = rope_freqs(t_pos, (self.config.attention_head_dim,))
        ctx, x, cos, sin, time_ids, shard = self._joint(
            ctx, x, cos, sin, text_mask, latent_time)
        for block in self.transformer_blocks:
            x, ctx = self._run(block, x, ctx, temb, cos, sin, time_ids,
                               self.bounded_softmax)
        if shard is not None:  # every local token's output, gathered
            h = torch.cat([ctx, x], dim=1)
            return gather_seq(self.proj_out(self.norm_out(h, temb)), shard)
        return self.proj_out(self.norm_out(x, temb))
