"""Wan2.1 attention blocks over the pyramid's packed latent tokens.

The counterpart of Wan2.1's ``WanAttentionBlock`` (``wan/modules/model.py``,
T2V cross-attention): the sequence holds the latent tokens only, and text
enters through a cross-attention in every block. Per block, with the
model's ``e0 [B, 6, D]`` plus the block's own ``modulation``:

* ``x += self_attn(LN(x) * (1 + e1) + e0) * e2``;
* ``x += cross_attn(LN_affine(x), ctx)`` (``norm3``);
* ``x += ffn(LN(x) * (1 + e4) + e3) * e5``, a GELU-tanh MLP.

q and k are RMS-normalised over all heads' features at once (the full model
width), then split into heads; self-attention rotates them by RoPE and
masks by the pyramid's temporal-causal time ids, cross-attention sees every
text key. The residual stream and the modulation stay fp32, the products
run in the weights' dtype: the casts Wan's bf16 autocast makes, made here
explicitly, because a serving forward runs outside autocast to be graphed
(``models.dit_graphs``).

Two attention sites per block (``models.attention_site``), each calling a
module-level function of this module by name: :func:`_attention` (the flux
blocks', self-attention) and :func:`_cross_attention`. A full-width RMS
norm bounds one head's ``|q|`` only by ``sqrt(D) * max g``, so the bounded
softmax's exactness argument (per-head norms) does not hold here: the DiT
passes ``bounded=False`` unless told otherwise.

Module names follow Wan's checkpoint (``self_attn.q``, ``norm_q``,
``cross_attn.o``, ``norm3``, ``ffn.0``, ``ffn.2``, ``modulation``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import flash_attention, flash_fwd_cuda
from ...ops.qk_norm_rope import Slot
from ...utils.profiling import span
from ..attention_site import AttentionSite
from ..flux.blocks import (  # noqa: F401 (_attention: the site's, by name)
    RMSNorm, _attention, layer_norm)

__all__ = ["WanSelfAttention", "WanCrossAttention", "WanAttentionBlock",
           "CROSS_ATTN_LAUNCHES", "linear_fp32"]


def _cross_attention(q, k, v, time_q, time_kv, head_dim, bounded=False):
    """Latent queries ``[B, H, Lq, D]`` against text keys and values ``[B,
    H, Lk, D]``, non-causal: every key whose time id is valid is visible to
    every query. A ``wan.cross_attn`` span; its flash-forward launches are
    counted in ``_cross_attention_launches``."""
    with span("wan.cross_attn"):
        launched = flash_fwd_cuda.launches
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            time_q, time_kv, causal=False,
                            sm_scale=head_dim ** -0.5, bounded=bounded)
        _cross_attention_launches[0] += flash_fwd_cuda.launches - launched
        return o


_cross_attention_launches = [0]
# a span counter (``utils.profiling.span``): cross-attention's flash launches
CROSS_ATTN_LAUNCHES = {
    "cross_attn_launches": lambda: _cross_attention_launches[0]}


def linear_fp32(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in fp32 whatever its dtype: Wan's conditioning
    path and head run under ``autocast(dtype=float32)``."""
    bias = None if layer.bias is None else layer.bias.float()
    return F.linear(x.float(), layer.weight.float(), bias)


def _modulate(x, shift, scale):
    return layer_norm(x) * (1 + scale) + shift


class WanSelfAttention(AttentionSite):
    """Self-attention over the latent tokens: full-width qk RMS norms,
    3-axis RoPE, time-id masking."""

    attention = (__name__, "_attention")

    def __init__(self, dim: int, num_heads: int, eps: float = 1e-6, **kw):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        for name in ("q", "k", "v", "o"):
            setattr(self, name, nn.Linear(dim, dim, **kw))
        self.norm_q = RMSNorm(dim, eps, **kw)
        self.norm_k = RMSNorm(dim, eps, **kw)

    def forward(self, x, rope_cos, rope_sin, time_ids, bounded=False):
        return self.o(self.attend((
            Slot((self.q(x),), (self.norm_q,), rope=True),
            Slot((self.k(x),), (self.norm_k,), rope=True),
            Slot((self.v(x),))),
            time_ids, True, self.head_dim, None, bounded, cos=rope_cos,
            sin=rope_sin))


class WanCrossAttention(AttentionSite):
    """Latent queries against the embedded text: full-width qk RMS norms, no
    RoPE, no mask."""

    attention = (__name__, "_cross_attention")

    def __init__(self, dim: int, num_heads: int, eps: float = 1e-6, **kw):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        for name in ("q", "k", "v", "o"):
            setattr(self, name, nn.Linear(dim, dim, **kw))
        self.norm_q = RMSNorm(dim, eps, **kw)
        self.norm_k = RMSNorm(dim, eps, **kw)

    def forward(self, x, ctx, time_q, time_kv, bounded=False):
        return self.o(self.attend((
            Slot((self.q(x),), (self.norm_q,)),
            Slot((self.k(ctx),), (self.norm_k,)),
            Slot((self.v(ctx),))),
            time_q, time_kv, self.head_dim, bounded))


class WanAttentionBlock(nn.Module):
    """One Wan2.1 T2V block. ``x`` is the fp32 residual stream ``[B, L, D]``
    and ``e0`` the model's fp32 ``[B, 6, D]`` time modulation."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 eps: float = 1e-6, **kw):
        super().__init__()
        self.eps = eps
        self.self_attn = WanSelfAttention(dim, num_heads, eps, **kw)
        self.norm3 = nn.LayerNorm(dim, eps=eps, **kw)
        self.cross_attn = WanCrossAttention(dim, num_heads, eps, **kw)
        self.ffn = nn.Sequential(nn.Linear(dim, ffn_dim, **kw),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(ffn_dim, dim, **kw))
        self.modulation = nn.Parameter(
            torch.randn(1, 6, dim, **kw) / dim ** 0.5)

    def forward(self, x, e0, ctx, rope_cos, rope_sin, time_ids, time_kv,
                bounded=False):
        dtype = self.modulation.dtype
        e = (self.modulation.float() + e0).chunk(6, dim=1)
        y = self.self_attn(_modulate(x, e[0], e[1]).to(dtype), rope_cos,
                           rope_sin, time_ids, bounded)
        x = x + y.float() * e[2]
        n3 = F.layer_norm(x, x.shape[-1:], self.norm3.weight.float(),
                          self.norm3.bias.float(), self.eps)
        x = x + self.cross_attn(n3.to(dtype), ctx, time_ids, time_kv,
                                bounded).float()
        y = self.ffn(_modulate(x, e[3], e[4]).to(dtype))
        return x + y.float() * e[5]
