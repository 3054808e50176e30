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

Each forward is a ``dit.forward`` span (``utils.profiling.span``) with its
rows, tokens, flash-forward launches, fused q/k/v launches (``qk_launches``:
one per attention in a serving forward, ``ops.qk_norm_rope``) and
``graph``, how it ran; the MMDiT's forward is one too. A serving forward
(autograd off, on the card) replays CUDA graphs captured for its layout,
cut at every attention (``models.dit_graphs``); every other forward runs
eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.flash_attention import FORWARD_LAUNCHES, INVALID_TIME
from ...ops.qk_norm_rope import QK_LAUNCHES, composition
from ...ops.rope import rope_freqs
from ...parallel.mesh import SP_AXIS, mesh_dim
from ...parallel.sp import SeqShard, gather_seq
from ...utils.devices import model_device
from ...utils.profiling import span
from ..dit_graphs import ForwardGraphs
from . import blocks
from .blocks import (
    AdaLayerNormContinuous,
    FluxSingleTransformerBlock,
    FluxTransformerBlock,
)

__all__ = ["FluxConfig", "PyramidFluxTransformer", "TimestepTextEmbed",
           "timestep_sinusoidal", "set_dit_mesh", "DIT_COUNTERS"]

# a ``dit.forward`` span's counters: flash-forward and fused q/k/v launches
DIT_COUNTERS = {**FORWARD_LAUNCHES, **QK_LAUNCHES}


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


class PyramidFluxTransformer(nn.Module):
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
        super().__init__()
        cfg = self.config = config
        self.remat = remat
        self.bounded_softmax = bounded_softmax
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
        self.set_mesh(mesh)
        self.graphs = ForwardGraphs(blocks)

    def set_mesh(self, mesh) -> None:
        """Run on ``mesh`` (None: one device); with an sp dim above 1 every
        attention is Ulysses' over the mesh's sp group."""
        set_dit_mesh(self, self.attention_modules, mesh)

    @property
    def attention_modules(self) -> List[nn.Module]:
        """Every block's attention, dual blocks first."""
        return [blk.attn for blk in (*self.transformer_blocks,
                                     *self.single_transformer_blocks)]

    @property
    def num_attention_calls(self) -> int:
        """Attentions in one forward: one per block."""
        return self.config.num_layers + self.config.num_single_layers

    @property
    def latent_channels(self) -> int:
        """The VAE latent width: the token width over the patch."""
        return self.config.in_channels // self.config.patch_size ** 2

    def stage_inputs(self, rows: int, height: int, width: int, device
                     ) -> Tuple[torch.Tensor, ...]:
        """The forward's inputs after ``timestep`` for a stage of latent
        size height x width: none."""
        return ()

    @contextlib.contextmanager
    def capture_qk(self) -> Iterator[List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Within the block, every attention appends batch row 0's post-RoPE
        ``(q, k)`` ``[1, H, L, D]`` to the yielded list, dual blocks first.
        Capture without autograd: under ``remat`` a block's recompute in the
        backward would append again. The attentions run the composed q/k
        chain (``ops.qk_norm_rope.composition``), whatever the DiT's dtype
        (the telemetry probe also reads a training DiT's fp32 masters)."""
        attns = self.attention_modules
        captured: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for attn in attns:
            attn.capture = captured
        try:
            with composition():
                yield captured
        finally:
            for attn in attns:
                attn.capture = None

    def _run(self, block, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, latent_tokens, latent_pos, latent_time, text_emb,
                text_mask, pooled, timestep, guidance=None):
        with span("dit.forward", counters=DIT_COUNTERS,
                  rows=latent_tokens.shape[0],
                  tokens=latent_tokens.shape[1]) as record:
            return self.graphs(self, self._forward, (
                latent_tokens, latent_pos, latent_time, text_emb, text_mask,
                pooled, timestep, guidance), record)

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
        # attention time ids: text t=0, masked-out text INVALID
        text_time = torch.where(text_mask, 0, INVALID_TIME).to(torch.int32)
        time_ids = torch.cat([text_time, latent_time.to(torch.int32)], dim=1)

        shard = SeqShard.of(self.sp_group, lt, x.shape[1])
        if shard is not None:
            ctx, x = shard.split(ctx, x)
            cos, sin = shard.local(cos, 1), shard.local(sin)
            time_ids = shard.pad(time_ids, INVALID_TIME)
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


def set_dit_mesh(dit: nn.Module, attns, mesh) -> None:
    """Give ``dit`` and each of ``attns`` the sp group of ``mesh`` (None
    below sp 2)."""
    dit.sp_group = (mesh.get_group(SP_AXIS)
                    if mesh_dim(mesh, SP_AXIS) > 1 else None)
    for attn in attns:
        attn.sp_group = dit.sp_group
