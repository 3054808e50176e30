"""T5 v1.1 encoder: the FLUX/SD3 sequence text encoder.

The port of the JAX package's ``models/text/t5.py``, keyed like HF
``T5EncoderModel`` (``shared.weight``,
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight``, the relative
bias table on block 0 only, ``layer.{0,1}.layer_norm.weight``,
``layer.1.DenseReluDense.{wi_0,wi_1,wo}.weight`` and
``encoder.final_layer_norm.weight``), so a released T5-XXL state dict
loads with ``load_state_dict(strict=True)``. T5-XXL: d_model 4096, 24
layers, 64 heads x 64, d_ff 10240, gated-gelu.

* RMS layer norm (no mean, no bias), eps 1e-6, computed in fp32 and cast
  back to its input's dtype;
* relative position bias (32 buckets, max distance 128) from block 0's
  table, shared by every block;
* no 1/sqrt(d) score scale (folded into T5's init); scores, bias and
  softmax in fp32, masked keys set to -1e9;
* gated-gelu feed-forward: ``wo(gelu_tanh(wi_0(x)) * wi_1(x))``.

Built on the CUDA device unless ``device=`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.devices import model_device

__all__ = ["T5Config", "T5Encoder", "T5LayerNorm", "T5Attention", "T5Block",
           "relative_position_bucket"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def relative_position_bucket(relative_position: np.ndarray,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """HF T5's bidirectional bucketing, on the host in float64 as the JAX
    package computes it."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int32) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False, **kw):
        super().__init__()
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, **kw)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, **kw)

    def forward(self, x, mask, position_bias):
        b, l, _ = x.shape

        def heads(t):
            return t.view(b, l, self.num_heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        # no sqrt(d) scaling (T5 convention); fp32 scores
        scores = q.float() @ k.float().transpose(-1, -2) + position_bias
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
        probs = scores.softmax(dim=-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, l, -1)
        return self.o(out)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool, **kw):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, **kw)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **kw)

    def forward(self, x, mask, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), mask,
                                      position_bias)


class _GatedGelu(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **kw)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh")
                       * self.wi_1(h))


class _FeedForwardLayer(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.DenseReluDense = _GatedGelu(cfg, **kw)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **kw)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False, **kw):
        super().__init__()
        self.layer = nn.ModuleList([
            _SelfAttentionLayer(cfg, has_relative_bias, **kw),
            _FeedForwardLayer(cfg, **kw)])

    def forward(self, x, mask, position_bias):
        return self.layer[1](self.layer[0](x, mask, position_bias))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0, **kw)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon, **kw)


class T5Encoder(nn.Module):
    """input_ids [B, L], attention_mask [B, L] -> hidden [B, L, d_model]."""

    def __init__(self, config: T5Config = T5Config(), *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.config = cfg = config
        kw = dict(dtype=dtype, device=model_device(device, "T5Encoder"))
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder = _Stack(cfg, **kw)

    def position_bias(self, length: int) -> torch.Tensor:
        """[1, H, L, L] fp32 bias from block 0's bucket table."""
        cfg = self.config
        rel = np.arange(length)[None, :] - np.arange(length)[:, None]
        buckets = relative_position_bucket(
            rel, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention \
            .relative_attention_bias.weight
        bias = table[torch.as_tensor(buckets, device=table.device)]
        return bias.permute(2, 0, 1)[None].float()

    def forward(self, input_ids, attention_mask):
        x = self.shared(input_ids)
        bias = self.position_bias(input_ids.shape[1])
        mask = attention_mask.bool()
        for block in self.encoder.block:
            x = block(x, mask, bias)
        return self.encoder.final_layer_norm(x)
