"""Causal VAE blocks on channels-last [B, C, T, H, W]: resnets, the
encoder's strided downsamplers and down blocks, the decoder's spatial and
temporal depth-to-space upsamplers and up blocks, and the mid block.

Every block's forward takes ``(x, state=None, is_init=True)`` and passes them
to its causal convs (see :class:`~.layers.CausalConv3d`), and returns
channels-last activations: the depth-to-space shuffles are written on the
physical ``[B, T, H, W, C]`` order, one copy each.

The reference's non-causal 2D twins (:class:`ResnetBlock2D`,
:class:`DownEncoderBlock2D`, :class:`UpDecoderBlock2D`, :class:`MidBlock2D`)
work frame by frame with symmetric padding and keep no state; their convs
are library convs (``F.conv2d``/``F.conv3d``), as they are XLA convs in the
JAX package: the conv kernel takes only causal stride-1 3x3x3 convs. A
config selects blocks by the type strings of :data:`DOWN_BLOCKS`,
:data:`UP_BLOCKS` and :data:`MID_BLOCKS`.
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
           "UpDecoderBlock", "MidBlock", "ResnetBlock2D",
           "DownEncoderBlock2D", "UpDecoderBlock2D", "MidBlock2D",
           "DOWN_BLOCKS", "UP_BLOCKS", "MID_BLOCKS"]


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


# ----------------------------------------------------------- the 2D twins
def _per_frame(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 2D conv on every frame of channels-last [B, C, T, H, W]."""
    b, c, t, h, w = x.shape
    y = conv(x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w))
    y = y.reshape(b, t, *y.shape[1:]).permute(0, 2, 1, 3, 4)
    return y.contiguous(memory_format=torch.channels_last_3d)


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last_3d)


class ResnetBlock2D(nn.Module):
    """Per-frame non-causal resnet, the twin of :class:`ResnetBlock3D`:
    GroupNorm -> SiLU -> 3x3 conv (SAME), twice, with a 1x1-projected skip
    where the width changes. Keeps no state."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 num_groups: int = 32, eps: float = 1e-6, **kw):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels, num_groups, eps, **kw)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.norm2 = GroupNorm(out_channels, num_groups, eps, **kw)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               **kw)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x, state=None, is_init=True):
        h = _per_frame(self.conv1, F.silu(self.norm1(x)))
        h = _per_frame(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = _per_frame(self.conv_shortcut, x)
        return x + h


class _Conv3dHolder(nn.Module):
    """``.conv``: a plain Conv3d (the key layout of the causal samplers)."""

    def __init__(self, channels: int, stride, padding, **kw):
        super().__init__()
        self.conv = nn.Conv3d(channels, channels, 3, stride=stride,
                              padding=padding, **kw)


class DownEncoderBlock2D(nn.Module):
    """Per-frame 2D encoder block: N :class:`ResnetBlock2D`, then optional
    spatial (3x3, stride 2, padding 0 before and 1 after in H and W) and
    non-causal temporal (3x3x3, stride (2, 1, 1), padding (0, 1) in time
    and 1 in space) downsamplers."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, add_spatial_downsample: bool = True,
                 add_temporal_downsample: bool = False, num_groups: int = 32,
                 **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, num_groups, **kw)
            for i in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, stride=2, **kw)]
            if add_spatial_downsample else [])
        self.temporal_downsamplers = nn.ModuleList(
            [_Conv3dHolder(out_channels, (2, 1, 1), (0, 1, 1), **kw)]
            if add_temporal_downsample else [])

    def forward(self, x, state=None, is_init=True):
        for resnet in self.resnets:
            x = resnet(x)
        for down in self.downsamplers:
            x = _per_frame(down, F.pad(x, (0, 1, 0, 1)))
        for down in self.temporal_downsamplers:
            x = _cl(down.conv(F.pad(x, (0, 0, 0, 0, 0, 1))))
        return x


class UpDecoderBlock2D(nn.Module):
    """Per-frame 2D decoder block: N :class:`ResnetBlock2D`, then optional
    spatial (nearest 2x, then a 3x3 SAME conv) and temporal (each frame
    twice, then a 3x3x3 SAME conv) upsamplers."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 3, add_spatial_upsample: bool = True,
                 add_temporal_upsample: bool = False, num_groups: int = 32,
                 **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, num_groups, **kw)
            for i in range(num_layers)])
        self.upsamplers = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1, **kw)]
            if add_spatial_upsample else [])
        self.temporal_upsamplers = nn.ModuleList(
            [_Conv3dHolder(out_channels, 1, 1, **kw)]
            if add_temporal_upsample else [])

    def forward(self, x, state=None, is_init=True):
        for resnet in self.resnets:
            x = resnet(x)
        for up in self.upsamplers:
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            x = _per_frame(up, x)
        for up in self.temporal_upsamplers:
            x = _cl(up.conv(x.repeat_interleave(2, dim=2)))
        return x


class MidBlock2D(nn.Module):
    """Per-frame 2D mid block: resnet -> [spatial attention -> resnet] x
    num_layers, all :class:`ResnetBlock2D`."""

    def __init__(self, channels: int, num_layers: int = 1,
                 add_attention: bool = True, num_groups: int = 32, **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, num_groups, **kw)
            for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            SpatialAttention(channels, num_groups, **kw)
            for _ in range(num_layers)] if add_attention else [])

    def forward(self, x, state=None, is_init=True):
        x = self.resnets[0](x)
        for i, resnet in enumerate(self.resnets[1:]):
            if self.attentions:
                x = self.attentions[i](x)
            x = resnet(x)
        return x


# the block-type strings of the VAE's config; the causal 3D names are the
# released checkpoint's
DOWN_BLOCKS = {"DownEncoderBlockCausal3D": DownEncoderBlock,
               "DownEncoderBlock2D": DownEncoderBlock2D}
UP_BLOCKS = {"UpDecoderBlockCausal3D": UpDecoderBlock,
             "UpDecoderBlock2D": UpDecoderBlock2D}
MID_BLOCKS = {"CausalUNetMidBlock2D": MidBlock, "UNetMidBlock2D": MidBlock2D}
