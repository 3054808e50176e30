"""Causal VAE blocks on channels-last [B, C, T, H, W]: resnets, the
encoder's strided downsamplers and down blocks, the decoder's spatial and
temporal depth-to-space upsamplers and up blocks, and the mid block.

Every block's forward takes ``(x, state=None, is_init=True)`` and passes them
to its causal convs (see :class:`~.layers.CausalConv3d`), and returns
channels-last activations: the depth-to-space shuffles are written on the
physical ``[B, T, H, W, C]`` order, one copy each.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.cp import current_cp_axis, next_first_frame
from .layers import CausalConv3d, GroupNorm, SpatialAttention

__all__ = ["ResnetBlock3D", "Downsample2x", "TemporalDownsample2x",
           "DownEncoderBlock", "Upsample2x", "TemporalUpsample2x",
           "UpDecoderBlock", "MidBlock"]


class ResnetBlock3D(nn.Module):
    """GroupNorm -> SiLU -> CausalConv, twice, with an (optionally
    projected) skip."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 num_groups: int = 32, eps: float = 1e-6, **kw):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels, num_groups, eps, **kw)
        self.conv1 = CausalConv3d(in_channels, out_channels, (3, 3, 3), **kw)
        self.norm2 = GroupNorm(out_channels, num_groups, eps, **kw)
        self.conv2 = CausalConv3d(out_channels, out_channels, (3, 3, 3), **kw)
        self.conv_shortcut = (
            CausalConv3d(in_channels, out_channels, (1, 1, 1), **kw)
            if in_channels != out_channels else None)

    def forward(self, x, state=None, is_init=True):
        h = self.conv1(F.silu(self.norm1(x)), state, is_init)
        h = self.conv2(F.silu(self.norm2(h)), state, is_init)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, state, is_init)
        return x + h


class Downsample2x(nn.Module):
    """Spatial 2x down: a causal 3x3x3 conv with stride (1, 2, 2)."""

    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.conv = CausalConv3d(in_channels, out_channels, (3, 3, 3),
                                 stride=(1, 2, 2), **kw)

    def forward(self, x, state=None, is_init=True):
        return self.conv(x, state, is_init)


class TemporalDownsample2x(nn.Module):
    """Temporal 2x down: a causal 3x3x3 conv with stride (2, 1, 1); a later
    window puts only the last carried frame in front."""

    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.conv = CausalConv3d(in_channels, out_channels, (3, 3, 3),
                                 stride=(2, 1, 1), **kw)

    def forward(self, x, state=None, is_init=True):
        return self.conv(x, state, is_init)


class DownEncoderBlock(nn.Module):
    """N resnets, then optional spatial and temporal downsamplers."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, add_spatial_downsample: bool = True,
                 add_temporal_downsample: bool = False, num_groups: int = 32,
                 **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels,
                          out_channels, num_groups, **kw)
            for i in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [Downsample2x(out_channels, out_channels, **kw)]
            if add_spatial_downsample else [])
        self.temporal_downsamplers = nn.ModuleList(
            [TemporalDownsample2x(out_channels, out_channels, **kw)]
            if add_temporal_downsample else [])

    def forward(self, x, state=None, is_init=True):
        for layer in (*self.resnets, *self.downsamplers,
                      *self.temporal_downsamplers):
            x = layer(x, state, is_init)
        return x


class Upsample2x(nn.Module):
    """Spatial 2x up: conv to 4*C, then depth-to-space with the channel
    order ``(c p1 p2)``."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = CausalConv3d(channels, channels * 4, (3, 3, 3), **kw)

    def forward(self, x, state=None, is_init=True):
        y = self.conv(x, state, is_init).permute(0, 2, 3, 4, 1)
        b, t, h, w, c4 = y.shape
        c = c4 // 4
        y = y.reshape(b, t, h, w, c, 2, 2).permute(0, 1, 2, 5, 3, 6, 4)
        return y.reshape(b, t, h * 2, w * 2, c).permute(0, 4, 1, 2, 3)


class TemporalUpsample2x(nn.Module):
    """Temporal 2x up: conv to 2*C, then depth-to-space in time with the
    channel order ``(c p)``; the first window drops its duplicated leading
    frame. Under an active cp context that drop is global: each rank drops
    its first frame and appends the next rank's (the last rank appends a
    zero frame, junk at the clip's tail that ``cp_vae_decode`` trims)."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = CausalConv3d(channels, channels * 2, (3, 3, 3), **kw)

    def forward(self, x, state=None, is_init=True):
        y = self.conv(x, state, is_init).permute(0, 2, 3, 4, 1)
        b, t, h, w, c2 = y.shape
        c = c2 // 2
        y = y.reshape(b, t, h, w, c, 2).permute(0, 1, 5, 2, 3, 4)
        y = y.reshape(b, t * 2, h, w, c)
        cp_group = current_cp_axis()
        if is_init and cp_group is not None:
            y = torch.cat([y[:, 1:], next_first_frame(y, cp_group)], dim=1)
        elif is_init:
            y = y[:, 1:].contiguous()
        return y.permute(0, 4, 1, 2, 3)


class UpDecoderBlock(nn.Module):
    """N resnets, then optional spatial and temporal upsamplers."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 3, add_spatial_upsample: bool = True,
                 add_temporal_upsample: bool = False, num_groups: int = 32,
                 **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels,
                          out_channels, num_groups, **kw)
            for i in range(num_layers)])
        self.upsamplers = nn.ModuleList(
            [Upsample2x(out_channels, **kw)] if add_spatial_upsample else [])
        self.temporal_upsamplers = nn.ModuleList(
            [TemporalUpsample2x(out_channels, **kw)]
            if add_temporal_upsample else [])

    def forward(self, x, state=None, is_init=True):
        for layer in (*self.resnets, *self.upsamplers,
                      *self.temporal_upsamplers):
            x = layer(x, state, is_init)
        return x


class MidBlock(nn.Module):
    """resnet -> [spatial attention -> resnet] x num_layers."""

    def __init__(self, channels: int, num_layers: int = 1,
                 add_attention: bool = True, num_groups: int = 32, **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(channels, channels, num_groups, **kw)
            for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            SpatialAttention(channels, num_groups, **kw)
            for _ in range(num_layers)] if add_attention else [])

    def forward(self, x, state=None, is_init=True):
        x = self.resnets[0](x, state, is_init)
        for i, resnet in enumerate(self.resnets[1:]):
            if self.attentions:
                x = self.attentions[i](x)
            x = resnet(x, state, is_init)
        return x
