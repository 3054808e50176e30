"""SD3 joint transformer block (MMDiT).

The counterpart of the JAX package's ``models/mmdit/blocks.py``, built from
the miniFLUX primitives. Differences from the flux dual block: the text
stream's qk-norms are ``norm_add_q``/``norm_add_k``, and the last block is
``context_pre_only``: its context goes through ``AdaLayerNormContinuous``,
has no ``to_add_out`` and no ``ff_context``, and comes back unchanged.
Module names follow the released checkpoint. ``bounded``, the last forward
argument, is the softmax form, as in the flux blocks.
"""

from __future__ import annotations

from torch import nn

from ...ops.qk_norm_rope import Slot, qkv_heads
from ..flux.blocks import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    FeedForward,
    RMSNorm,
    _attention,
    _capture,
    _unheads,
    layer_norm,
)

__all__ = ["MMDiTJointAttention", "JointTransformerBlock"]


class MMDiTJointAttention(nn.Module):
    """Joint text+image attention: separate projections, one softmax over
    [text; image]; no context output when ``context_pre_only``. ``capture``
    and ``seam`` work as in the flux blocks."""

    def __init__(self, num_heads: int, head_dim: int, causal: bool = True,
                 context_pre_only: bool = False, **kw):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim, self.causal = num_heads, head_dim, causal
        self.context_pre_only = context_pre_only
        names = ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                 "add_v_proj"]
        if not context_pre_only:
            names.append("to_add_out")
        for name in names:
            setattr(self, name, nn.Linear(d, d, **kw))
        self.to_out = nn.ModuleList([nn.Linear(d, d, **kw)])
        for name in ("norm_q", "norm_k", "norm_add_q", "norm_add_k"):
            setattr(self, name, RMSNorm(head_dim, **kw))
        self.capture = None
        self.seam = None
        self.sp_group = None

    def forward(self, x, ctx, rope_cos, rope_sin, time_ids, bounded=True):
        q, k, v = qkv_heads((
            Slot((self.add_q_proj(ctx), self.to_q(x)),
                 (self.norm_add_q, self.norm_q), rope=True),
            Slot((self.add_k_proj(ctx), self.to_k(x)),
                 (self.norm_add_k, self.norm_k), rope=True),
            Slot((self.add_v_proj(ctx), self.to_v(x)))),
            self.num_heads, rope_cos, rope_sin)
        lt = ctx.shape[1]
        if self.capture is not None:
            _capture(self, q, k)
        attend = _attention if self.seam is None else self.seam
        o = _unheads(attend(q, k, v, time_ids, self.causal, self.head_dim,
                            self.sp_group, bounded))
        x_o = self.to_out[0](o[:, lt:])
        if self.context_pre_only:
            return x_o, None
        return x_o, self.to_add_out(o[:, :lt])


class JointTransformerBlock(nn.Module):
    """One MMDiT block; ``context_pre_only`` for the last."""

    def __init__(self, num_heads: int, head_dim: int, causal: bool = True,
                 context_pre_only: bool = False, **kw):
        super().__init__()
        d = num_heads * head_dim
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(d, **kw)
        self.norm1_context = (AdaLayerNormContinuous(d, **kw)
                              if context_pre_only else
                              AdaLayerNormZero(d, **kw))
        self.attn = MMDiTJointAttention(num_heads, head_dim, causal,
                                        context_pre_only, **kw)
        self.ff = FeedForward(d, **kw)
        if not context_pre_only:
            self.ff_context = FeedForward(d, **kw)

    def forward(self, x, ctx, temb, rope_cos, rope_sin, time_ids,
                bounded=True):
        nx, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        if self.context_pre_only:
            nc = self.norm1_context(ctx, temb)
        else:
            nc, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
                self.norm1_context(ctx, temb)
        x_attn, ctx_attn = self.attn(nx, nc, rope_cos, rope_sin, time_ids,
                                     bounded)

        x = x + gate * x_attn
        h = layer_norm(x) * (1 + scale_mlp) + shift_mlp
        x = x + gate_mlp * self.ff(h)
        if self.context_pre_only:
            return x, ctx

        ctx = ctx + c_gate * ctx_attn
        hc = layer_norm(ctx) * (1 + c_scale_mlp) + c_shift_mlp
        ctx = ctx + c_gate_mlp * self.ff_context(hc)
        return x, ctx
