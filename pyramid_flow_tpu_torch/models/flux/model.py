"""PyramidFluxTransformer: the miniFLUX DiT over packed tokens.

The model is a sequence-to-sequence transformer over already-patchified
tokens: each batch row is one (sample, stage), and the pipeline builds the
tokens, float RoPE positions and int time ids. Parameters are per-layer
modules keyed like the released torch checkpoint
(``transformer_blocks.{i}.attn.to_q.weight``, ...).

The default config (19 dual + 38 single blocks, 24 heads x 64, 64 input
channels = 2x2 patch x 16 VAE channels, T5 joint dim 4096, CLIP pooled dim
768) is the release architecture.

Training keeps fp32 parameters and computes in bf16 under
``torch.autocast("cuda", torch.bfloat16)``, the counterpart of flax's
``dtype=bf16, param_dtype=fp32``: the norms and RoPE compute in fp32 and cast
back to their input's dtype, so q, k and v reach the attention kernels in
bf16. ``remat`` checkpoints every block (recomputed in the backward), as the
JAX model's ``remat`` field does. The model is built on the CUDA device
unless ``device=`` says otherwise, and raises without a visible one.

``mesh`` (a (dp, fsdp, sp) ``DeviceMesh``, ``parallel.mesh.make_mesh``)
turns on sequence parallelism when its sp dim is above 1, as the JAX
model's ``mesh`` field does: the forward takes the whole batch rows on every
sp rank, shards the joint sequence (text, then the pyramid tokens, padded to
a multiple of ``sp * 128``) over the sp ranks after the embedders, runs
every block on this rank's ``L / sp`` tokens (everything between the
attentions is per token or per row; the attentions are Ulysses'), and
gathers the output tokens at exit. Every sp rank returns the whole output.

``bounded_softmax`` is the softmax form of every attention: the bounded
forward (True, JAX's default for the DiTs) or the classic online softmax
(False), the counterpart of running the JAX package under
``PF_BOUNDED_SOFTMAX=0``. The bounded form shifts each row by an a-priori
bound from |q| and |k|, exact while ``bound - true max`` stays well under
~120 log2 units (``training.telemetry``); the classic form is exact at any
qk-norm gain. It is one attribute that every forward reads, so setting it
after a load or after ``set_mesh`` switches every attention, under sequence
parallelism too; it is saved in no state dict, config or train state.

The forward, ``set_mesh``, ``capture_qk``, ``remat`` and the attention
sites are the DiT shell's (``models.dit_base``): each forward is a
``dit.forward`` span (``utils.profiling.span``) with its rows, tokens,
flash-forward launches, fused q/k/v launches (``qk_launches``: one per
attention in a serving forward, ``ops.qk_norm_rope``), fused residual-norm
launches (``norm_launches``: three per stream of a dual block, two per
single block and one for ``norm_out``, 191 at the release depth,
``ops.residual_norm``) and ``graph``, how it ran. A serving forward (autograd off, on the card) replays CUDA graphs
captured for its layout, cut at every attention (``models.dit_graphs``);
every other forward runs eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.rope import rope_freqs
from ...parallel.sp import gather_seq
from ...utils.devices import model_device
from ..dit_base import DiTBase
from .blocks import (
    AdaLayerNormContinuous,
    FluxSingleTransformerBlock,
    FluxTransformerBlock,
)

__all__ = ["FluxConfig", "PyramidFluxTransformer", "TimestepTextEmbed",
           "timestep_sinusoidal"]


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    axes_dims_rope: Tuple[int, int, int] = (16, 24, 24)
    patch_size: int = 2
    use_temporal_causal: bool = True
    # the guidance-distilled variant: the conditioning embedding also embeds
    # the guidance scale (the reference's
    # ``CombinedTimestepGuidanceTextProjEmbeddings``); no released
    # Pyramid-Flow config sets it
    guidance_embeds: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@functools.lru_cache(maxsize=None)
def _sinusoid_freqs(half: int, device: torch.device) -> torch.Tensor:
    """The sinusoid's [half] frequencies on ``device``, computed once in
    numpy (a forward then uploads nothing and can be captured)."""
    exponent = -np.log(10000.0) * np.arange(half, dtype=np.float32) / half
    return torch.as_tensor(np.exp(exponent), device=device)


def timestep_sinusoidal(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """[cos, sin] sinusoidal embedding of [B] timesteps, fp32
    (flip_sin_to_cos=True, downscale_freq_shift=0)."""
    freqs = _sinusoid_freqs(dim // 2, t.device)
    arg = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


class _MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, dim: int, **kw):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, **kw)
        self.linear_2 = nn.Linear(dim, dim, **kw)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class TimestepTextEmbed(nn.Module):
    """Timestep MLP plus pooled-text MLP, summed; with ``guidance_embeds``
    a third MLP embeds the [B] guidance scale through the same sinusoid."""

    def __init__(self, embedding_dim: int, pooled_dim: int,
                 guidance_embeds: bool = False, **kw):
        super().__init__()
        self.timestep_embedder = _MLPEmbedder(256, embedding_dim, **kw)
        self.guidance_embedder = (_MLPEmbedder(256, embedding_dim, **kw)
                                  if guidance_embeds else None)
        self.text_embedder = _MLPEmbedder(pooled_dim, embedding_dim, **kw)

    def forward(self, timestep, pooled, guidance=None):
        t_emb = self.timestep_embedder(
            timestep_sinusoidal(timestep).to(pooled.dtype))
        if self.guidance_embedder is not None:
            if guidance is None:
                raise ValueError("a guidance_embeds DiT needs guidance=")
            t_emb = t_emb + self.guidance_embedder(
                timestep_sinusoidal(guidance).to(pooled.dtype))
        return t_emb + self.text_embedder(pooled)


class PyramidFluxTransformer(DiTBase):
    """miniFLUX over packed tokens.

    forward inputs:
      latent_tokens: [B, L, in_channels] (cond history first, current last).
      latent_pos:    [B, L, 3] float (t, h, w) RoPE positions.
      latent_time:   [B, L] int temporal ids (frame index; INVALID for pad).
      text_emb:      [B, Lt, joint_attention_dim].
      text_mask:     [B, Lt] bool.
      pooled:        [B, pooled_projection_dim].
      timestep:      [B] float (0..1000 scale).
      guidance:      [B] float guidance scale; required by, and only read
                     by, a ``guidance_embeds`` config.

    Returns velocity tokens [B, L, in_channels].

    ``model_name``, ``latent_channels`` and ``stage_inputs`` tell the
    pipeline and the trainer the family's latent normalisation, latent width
    and extra forward inputs (none).
    """

    model_name = "pyramid_flux"

    def __init__(self, config: FluxConfig = FluxConfig(), *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 remat: bool = False, mesh=None,
                 bounded_softmax: bool = True):
        super().__init__(remat=remat, bounded_softmax=bounded_softmax,
                         mesh=mesh)
        cfg = self.config = config
        kw = dict(dtype=dtype,
                  device=model_device(device, "PyramidFluxTransformer"))
        d = cfg.inner_dim
        self.time_text_embed = TimestepTextEmbed(
            d, cfg.pooled_projection_dim, cfg.guidance_embeds, **kw)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, d, **kw)
        self.x_embedder = nn.Linear(cfg.in_channels, d, **kw)
        blk = dict(num_heads=cfg.num_attention_heads,
                   head_dim=cfg.attention_head_dim,
                   causal=cfg.use_temporal_causal, **kw)
        self.transformer_blocks = nn.ModuleList(
            [FluxTransformerBlock(**blk) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleTransformerBlock(**blk)
             for _ in range(cfg.num_single_layers)])
        self.norm_out = AdaLayerNormContinuous(d, **kw)
        self.proj_out = nn.Linear(d, cfg.in_channels, **kw)
        # zero-initialised output, as the JAX model: a fresh DiT predicts 0
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)
        self._share_sites()

    @property
    def latent_channels(self) -> int:
        """The VAE latent width: the token width over the patch."""
        return self.config.in_channels // self.config.patch_size ** 2

    def stage_inputs(self, rows: int, height: int, width: int, device
                     ) -> Tuple[torch.Tensor, ...]:
        """The forward's inputs after ``timestep`` for a stage of latent
        size height x width: none."""
        return ()

    def forward(self, latent_tokens, latent_pos, latent_time, text_emb,
                text_mask, pooled, timestep, guidance=None):
        return super().forward(latent_tokens, latent_pos, latent_time,
                               text_emb, text_mask, pooled, timestep, guidance)

    def _forward(self, latent_tokens, latent_pos, latent_time, text_emb,
                 text_mask, pooled, timestep, guidance=None):
        b, lt = text_emb.shape[:2]
        temb = self.time_text_embed(timestep, pooled, guidance)
        ctx = self.context_embedder(text_emb)
        x = self.x_embedder(latent_tokens)

        # RoPE over [text; latent]: text at position 0 on every axis
        text_pos = torch.zeros((b, lt, 3), dtype=torch.float32,
                               device=latent_pos.device)
        cos, sin = rope_freqs(
            torch.cat([text_pos, latent_pos.float()], dim=1),
            self.config.axes_dims_rope)
        ctx, x, cos, sin, time_ids, shard = self._joint(
            ctx, x, cos, sin, text_mask, latent_time)
        bounded = self.bounded_softmax
        for block in self.transformer_blocks:
            x, ctx = self._run(block, x, ctx, temb, cos, sin, time_ids,
                               bounded)
        h = torch.cat([ctx, x], dim=1)  # text first
        for block in self.single_transformer_blocks:
            h = self._run(block, h, temb, cos, sin, time_ids, bounded)
        if shard is not None:  # every local token's output, gathered
            return gather_seq(self.proj_out(self.norm_out(h, temb)), shard)
        return self.proj_out(self.norm_out(h[:, lt:], temb))

