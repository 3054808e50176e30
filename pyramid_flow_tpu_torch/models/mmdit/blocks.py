"""SD3 joint transformer block (MMDiT).

The counterpart of the JAX package's ``models/mmdit/blocks.py``, built from
the miniFLUX primitives. Differences from the flux dual block: the text
stream's qk-norms are ``norm_add_q``/``norm_add_k``, and the last block is
``context_pre_only``: its context goes through ``AdaLayerNormContinuous``,
has no ``to_add_out`` and no ``ff_context``, and comes back unchanged.
Module names follow the released checkpoint. ``bounded``, the last forward
argument, is the softmax form, as in the flux blocks. The attention is an
attention site (``models.attention_site``) calling this module's
``_attention``, the flux blocks' function under this module's name; the
norms and residuals go through ``ops.residual_norm``, as the flux blocks'.
"""

from __future__ import annotations

from torch import nn

from ...ops.qk_norm_rope import Slot
from ...ops.residual_norm import Norm, residual_norm
from ..attention_site import AttentionSite
from ..flux.blocks import (  # noqa: F401 (_attention: the site's, by name)
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    FeedForward,
    RMSNorm,
    _attention,
)

__all__ = ["MMDiTJointAttention", "JointTransformerBlock"]


class MMDiTJointAttention(AttentionSite):
    """Joint text+image attention: separate projections, one softmax over
    [text; image]; no context output when ``context_pre_only``."""

    attention = (__name__, "_attention")

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

    def forward(self, x, ctx, rope_cos, rope_sin, time_ids, bounded=True):
        o = self.attend((
            Slot((self.add_q_proj(ctx), self.to_q(x)),
                 (self.norm_add_q, self.norm_q), rope=True),
            Slot((self.add_k_proj(ctx), self.to_k(x)),
                 (self.norm_add_k, self.norm_k), rope=True),
            Slot((self.add_v_proj(ctx), self.to_v(x)))),
            time_ids, self.causal, self.head_dim, self.state.sp_group,
            bounded, cos=rope_cos, sin=rope_sin)
        lt = ctx.shape[1]
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

        x, h = residual_norm(x, x_attn, gate, Norm(shift_mlp, scale_mlp))
        x, _ = residual_norm(x, self.ff(h), gate_mlp)
        if self.context_pre_only:
            return x, ctx

        ctx, hc = residual_norm(ctx, ctx_attn, c_gate,
                                Norm(c_shift_mlp, c_scale_mlp))
        ctx, _ = residual_norm(ctx, self.ff_context(hc), c_gate_mlp)
        return x, ctx
