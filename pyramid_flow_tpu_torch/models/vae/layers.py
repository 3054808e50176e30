"""Core causal-VAE primitives.

Inside the VAE, activations are torch's ``[B, C, T, H, W]`` held in
``torch.channels_last_3d``: physically ``[B, T, H, W, C]``, the JAX package's
channels-last layout, which the conv kernel reads without a transpose. Every
layer keeps that layout (the conv weights are channels-last too); the model's
public ``encode``/``decode`` take and return ``[B, T, H, W, C]``.

* :class:`CausalConv3d`: a temporally-causal 3D conv (``k_t - 1`` frames in
  front, symmetric zero padding in space). A conv that
  :func:`~pyramid_flow_tpu_torch.ops.causal_conv3d.supports_kernel` admits
  at the dtype it computes in (bf16 weights, or fp32 master weights under
  CUDA bf16 autocast) runs through
  :func:`~pyramid_flow_tpu_torch.ops.causal_conv3d.causal_conv3d` (the CUDA
  kernel on the card, with ``x`` and the weight cast to bf16 and the
  weight's gradient flowing back through that cast), which reads the front
  frames from their own tensor; the others (the 3-, 16- and 32-channel
  ends, the 1x1x1 convs, the strided downsamplers) run ``F.conv3d`` on the
  frames concatenated. For
  windowed coding the conv reads the previous window's last two input frames
  from an explicit ``state`` dict and writes its own there.
* :func:`causal_group_norm`: GroupNorm with statistics per (batch, frame),
  which is what makes windowed and monolithic coding agree.
* :class:`SpatialAttention`: the mid-block's per-frame single-head attention
  over the H*W pixels, fp32 softmax, queries chunked above
  ``ATTN_CHUNK_TOKENS``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.causal_conv3d import (causal_conv3d, compute_dtype,
                                  supports_kernel)

__all__ = ["CausalConv3d", "causal_group_norm", "GroupNorm",
           "SpatialAttention", "ATTN_CHUNK_TOKENS", "channels_last"]


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, W, C]`` -> the VAE's ``[B, C, T, H, W]`` channels-last
    view (a copy only if ``x`` is not contiguous)."""
    return x.contiguous().permute(0, 4, 1, 2, 3)


def _carry(front: Optional[torch.Tensor], x: torch.Tensor, kt: int
           ) -> torch.Tensor:
    """The last two frames of ``front ++ x`` (``[B, T, H, W, C]``; ``front``
    None means ``kt - 1`` zero frames), copied so that the next window does
    not hold the whole of ``x``."""
    if x.shape[1] >= 2:
        return x[:, -2:].clone()
    if front is None:
        front = x.new_zeros((x.shape[0], kt - 1) + x.shape[2:])
    return torch.cat([front[:, -1:].to(x.dtype), x], dim=1)


class CausalConv3d(nn.Module):
    """Temporally-causal 3D convolution on channels-last [B, C, T, H, W].

    With ``state`` (a dict shared by all convs of one model, keyed by
    ``cache_key``) the conv streams: on the first window (``is_init``) it
    pads with zero frames, on a later one it puts the cached frames in front
    (both for stride 1, the last one for temporal stride 2), and it stores
    the last two frames of its padded input for the next window. Without
    ``state`` it pads with zero frames. k_t = 1 convs carry nothing.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1), **kw):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.cache_key = None  # set by the owning model
        _, kh, kw_ = self.kernel_size
        self.conv = nn.Conv3d(in_channels, out_channels, self.kernel_size,
                              stride=self.stride,
                              padding=(0, kh // 2, kw_ // 2), **kw)

    def admits(self, dtype: torch.dtype) -> bool:
        """Whether this conv runs through ``causal_conv3d`` when it
        computes in ``dtype``."""
        w = self.conv.weight
        return supports_kernel(w.shape[1], w.shape[0], self.kernel_size,
                               self.stride, dtype)

    @property
    def uses_kernel(self) -> bool:
        """Whether this conv runs through ``causal_conv3d`` now: admitted at
        the dtype it computes in under the current autocast state."""
        return self.admits(compute_dtype(self.conv.weight))

    def forward(self, x, state: Optional[dict] = None, is_init: bool = True):
        kt, st = self.kernel_size[0], self.stride[0]
        xc = x.permute(0, 2, 3, 4, 1)  # [B, T, H, W, C]
        front = None  # frames in front of x; None = zeros
        if kt > 1 and state is not None:
            if not is_init:
                cached = state[self.cache_key]
                front = cached[:, -1:] if st == 2 else cached
            state[self.cache_key] = _carry(front, xc, kt)
        if self.uses_kernel:
            # the kernel computes in bf16; .to keeps the weight's
            # channels-last layout, the bias stays as it is (added in fp32)
            bf16 = torch.bfloat16
            y = causal_conv3d(xc.to(bf16).contiguous(),
                              self.conv.weight.to(bf16), self.conv.bias,
                              None if front is None else front.to(bf16))
            return y.permute(0, 4, 1, 2, 3)
        if kt > 1:
            if front is None:
                front = xc.new_zeros((xc.shape[0], kt - 1) + xc.shape[2:])
            xc = torch.cat([front.to(xc.dtype), xc], dim=1)
        y = self.conv(xc.permute(0, 4, 1, 2, 3))
        return y.contiguous(memory_format=torch.channels_last_3d)


def causal_group_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, num_groups: int,
                      eps: float = 1e-6) -> torch.Tensor:
    """Per-frame GroupNorm over [B, C, T, H, W] in fp32: statistics per
    (batch, group, frame) over (C/G, H, W)."""
    b, c, t, h, w = x.shape
    xf = x.float().reshape(b, num_groups, c // num_groups, t, h, w)
    var, mean = torch.var_mean(xf, dim=(2, 4, 5), unbiased=False,
                               keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, t, h, w)
    out = xf * weight.float()[:, None, None, None] \
        + bias.float()[:, None, None, None]
    return out.to(x.dtype)


class GroupNorm(nn.Module):
    """Parameterised per-frame group norm."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 **kw):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))

    def forward(self, x):
        return causal_group_norm(x, self.weight, self.bias, self.num_groups,
                                 self.eps)


# Above this many tokens (H*W pixels of a frame) SpatialAttention chunks its
# queries instead of holding the whole [hw, hw] fp32 score matrix.
ATTN_CHUNK_TOKENS = 4096


class SpatialAttention(nn.Module):
    """Per-frame single-head spatial self-attention with residual."""

    def __init__(self, channels: int, num_groups: int = 32, **kw):
        super().__init__()
        self.group_norm = GroupNorm(channels, num_groups, **kw)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **kw)])

    def forward(self, x):
        b, c, t, h, w = x.shape
        hw = h * w
        y = self.group_norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, hw, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        kf = k.float()
        scale = c ** -0.5

        def attend(qi):
            a = torch.softmax(torch.matmul(qi.float(), kf.transpose(1, 2))
                              * scale, dim=-1)
            return torch.matmul(a.to(y.dtype), v)

        if hw > ATTN_CHUNK_TOKENS:
            ck = next(d for d in range(min(2048, hw), 0, -1) if hw % d == 0)
            y = torch.cat([attend(qi) for qi in q.split(ck, dim=1)], dim=1)
        else:
            y = attend(q)
        y = self.to_out[0](y)
        return x + y.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
