"""miniFLUX transformer blocks.

Each batch row is one (sample, stage) of packed tokens, so modulation is a
per-row broadcast and every attention is one :func:`flash_attention` call
with time-id masking. Module names follow the released torch checkpoint
(``attn.to_q``, ``attn.to_out.0``, ``ff.net.0.proj``, ...), so its state dict
loads as it is.

Each attention module is an attention site (``models.attention_site``): it
keeps its projections and norms and says how its q, k and v are made
(``Slot`` s of :func:`~pyramid_flow_tpu_torch.ops.qk_norm_rope.qkv_heads`,
one launch of the fused kernel on the card), and the site runs the rest:
``capture_qk``'s telemetry, :func:`_attention` or the graph seam in its
place, and the join of the heads. Under sequence parallelism the site holds
this rank's shard of the joint sequence, and :func:`_attention` is Ulysses'
:func:`~pyramid_flow_tpu_torch.parallel.sp.sp_flash_attention` over the
DiT's sp group.

Every block and attention module takes ``bounded`` as its last forward
argument, the softmax form of its attention: the bounded forward (True, the
default) or the classic online softmax. The DiT passes its
``bounded_softmax`` on every forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.qk_norm_rope import Slot
from ...parallel.sp import sp_flash_attention
from ..attention_site import AttentionSite

__all__ = [
    "RMSNorm",
    "AdaLayerNormZero",
    "AdaLayerNormZeroSingle",
    "AdaLayerNormContinuous",
    "FeedForward",
    "JointAttention",
    "SingleAttention",
    "FluxTransformerBlock",
    "FluxSingleTransformerBlock",
]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters, fp32 math, cast back."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


class RMSNorm(nn.Module):
    """Per-head-dim RMS norm with fp32 math."""

    def __init__(self, dim: int, eps: float = 1e-6, **kw):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **kw))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


class AdaLayerNormZero(nn.Module):
    """silu(temb) -> 6 modulation vectors, chunked (shift, scale, gate,
    shift_mlp, scale_mlp, gate_mlp); returns LN(x)*(1+scale)+shift and the
    rest, each [B, 1, D]."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim, **kw)

    def forward(self, x, temb):
        emb = self.linear(F.silu(temb))[:, None]
        shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, -1)
        return (layer_norm(x) * (1 + scale) + shift, gate, shift_mlp,
                scale_mlp, gate_mlp)


class AdaLayerNormZeroSingle(nn.Module):
    """Three-way modulation (shift, scale, gate) for single-stream blocks."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.linear = nn.Linear(dim, 3 * dim, **kw)

    def forward(self, x, temb):
        shift, scale, gate = self.linear(F.silu(temb))[:, None].chunk(3, -1)
        return layer_norm(x) * (1 + scale) + shift, gate


class AdaLayerNormContinuous(nn.Module):
    """Final-layer AdaLN. Its chunks are (scale, shift), the opposite order
    of AdaLayerNormZero."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim, **kw)

    def forward(self, x, temb):
        scale, shift = self.linear(F.silu(temb))[:, None].chunk(2, -1)
        return layer_norm(x) * (1 + scale) + shift


class _GeluProj(nn.Module):
    def __init__(self, dim: int, inner: int, **kw):
        super().__init__()
        self.proj = nn.Linear(dim, inner, **kw)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """gelu-tanh MLP, mult 4; ``net.1`` is the checkpoint's parameterless
    dropout slot."""

    def __init__(self, dim: int, mult: int = 4, **kw):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList(
            [_GeluProj(dim, inner, **kw), nn.Identity(),
             nn.Linear(inner, dim, **kw)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


def _attention(q, k, v, time_ids, causal, head_dim, sp_group=None,
               bounded=True):
    """q, k are RMS-normalised, which keeps the bounded-softmax form exact
    while the qk-norm gains stay in its envelope; ``bounded=False`` takes
    the classic online softmax, exact at any gain. With an sp group of more
    than one rank, q, k, v are this rank's shard of the sequence and the
    attention is Ulysses' (JAX's ``_dispatch_attention``)."""
    return sp_flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              time_ids, sp_group, causal=causal,
                              sm_scale=head_dim ** -0.5, bounded=bounded)


class JointAttention(AttentionSite):
    """Dual-stream attention: separate image/text projections, one softmax
    over [text; image], separate output projections."""

    attention = (__name__, "_attention")

    def __init__(self, num_heads: int, head_dim: int, causal: bool = True,
                 **kw):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim, self.causal = num_heads, head_dim, causal
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_add_out"):
            setattr(self, name, nn.Linear(d, d, **kw))
        self.to_out = nn.ModuleList([nn.Linear(d, d, **kw)])
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSNorm(head_dim, **kw))

    def forward(self, x, ctx, rope_cos, rope_sin, time_ids, bounded=True):
        # text first, matching the RoPE and time-id layout
        o = self.attend((
            Slot((self.add_q_proj(ctx), self.to_q(x)),
                 (self.norm_added_q, self.norm_q), rope=True),
            Slot((self.add_k_proj(ctx), self.to_k(x)),
                 (self.norm_added_k, self.norm_k), rope=True),
            Slot((self.add_v_proj(ctx), self.to_v(x)))),
            time_ids, self.causal, self.head_dim, self.state.sp_group,
            bounded, cos=rope_cos, sin=rope_sin)
        lt = ctx.shape[1]
        return self.to_out[0](o[:, lt:]), self.to_add_out(o[:, :lt])


class SingleAttention(AttentionSite):
    """Single-stream attention without an output projection."""

    attention = (__name__, "_attention")

    def __init__(self, num_heads: int, head_dim: int, causal: bool = True,
                 **kw):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim, self.causal = num_heads, head_dim, causal
        self.to_q = nn.Linear(d, d, **kw)
        self.to_k = nn.Linear(d, d, **kw)
        self.to_v = nn.Linear(d, d, **kw)
        self.norm_q = RMSNorm(head_dim, **kw)
        self.norm_k = RMSNorm(head_dim, **kw)

    def forward(self, x, rope_cos, rope_sin, time_ids, bounded=True):
        return self.attend((
            Slot((self.to_q(x),), (self.norm_q,), rope=True),
            Slot((self.to_k(x),), (self.norm_k,), rope=True),
            Slot((self.to_v(x),))),
            time_ids, self.causal, self.head_dim, self.state.sp_group,
            bounded, cos=rope_cos, sin=rope_sin)


class FluxTransformerBlock(nn.Module):
    """Dual-stream MMDiT block."""

    def __init__(self, num_heads: int, head_dim: int, causal: bool = True,
                 **kw):
        super().__init__()
        d = num_heads * head_dim
        self.norm1 = AdaLayerNormZero(d, **kw)
        self.norm1_context = AdaLayerNormZero(d, **kw)
        self.attn = JointAttention(num_heads, head_dim, causal, **kw)
        self.ff = FeedForward(d, **kw)
        self.ff_context = FeedForward(d, **kw)

    def forward(self, x, ctx, temb, rope_cos, rope_sin, time_ids,
                bounded=True):
        nx, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        nc, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
            ctx, temb)
        x_attn, ctx_attn = self.attn(nx, nc, rope_cos, rope_sin, time_ids,
                                     bounded)

        x = x + gate * x_attn
        h = layer_norm(x) * (1 + scale_mlp) + shift_mlp
        x = x + gate_mlp * self.ff(h)

        ctx = ctx + c_gate * ctx_attn
        hc = layer_norm(ctx) * (1 + c_scale_mlp) + c_shift_mlp
        ctx = ctx + c_gate_mlp * self.ff_context(hc)
        return x, ctx


class FluxSingleTransformerBlock(nn.Module):
    """Single-stream block: attention and MLP in parallel, one fused output
    projection."""

    def __init__(self, num_heads: int, head_dim: int, mlp_ratio: float = 4.0,
                 causal: bool = True, **kw):
        super().__init__()
        d = num_heads * head_dim
        mlp_dim = int(d * mlp_ratio)
        self.norm = AdaLayerNormZeroSingle(d, **kw)
        self.proj_mlp = nn.Linear(d, mlp_dim, **kw)
        self.attn = SingleAttention(num_heads, head_dim, causal, **kw)
        self.proj_out = nn.Linear(d + mlp_dim, d, **kw)

    def forward(self, x, temb, rope_cos, rope_sin, time_ids, bounded=True):
        nx, gate = self.norm(x, temb)
        mlp = F.gelu(self.proj_mlp(nx), approximate="tanh")
        attn = self.attn(nx, rope_cos, rope_sin, time_ids, bounded)
        return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))
