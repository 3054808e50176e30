"""Causal video VAE (8x8x8 compression), decoder half.

* :class:`CausalVideoVAE` holds ``post_quant_conv`` and the :class:`Decoder`,
  keyed like the released torch checkpoint (``decoder.conv_in.conv.weight``,
  ``decoder.up_blocks.0.upsamplers.0.conv.conv.weight``, ...).
* :func:`chunk_decode` decodes a latent video window by window. The causal
  convs' carry (the last two input frames of every temporal conv) is an
  explicit ``state`` dict threaded from one window to the next, so windowed
  decoding equals monolithic decoding under any split.

The default geometry is the released checkpoint's: 16 latent channels,
(128, 256, 512, 512) channels, 3 up blocks that upsample in space and time.
The encoder, spatial tiling and posterior helpers are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import MidBlock, UpDecoderBlock
from .layers import CausalConv3d, GroupNorm

__all__ = ["VAEConfig", "Decoder", "CausalVideoVAE", "chunk_decode"]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decoder_layers_per_block: Tuple[int, ...] = (3, 3, 3, 3)
    num_groups: int = 32
    downsample_scale: int = 8  # 8x spatial, 8x temporal (+1 frame)


class Decoder(nn.Module):
    """conv_in -> mid block -> up blocks -> norm/silu/conv_out, on
    [B, C, T, H, W]. Up blocks 0..2 upsample in space and time."""

    def __init__(self, config: VAEConfig, **kw):
        super().__init__()
        cfg = config
        rev = list(reversed(cfg.block_out_channels))
        up = (True, True, True, False)
        self.conv_in = CausalConv3d(cfg.latent_channels, rev[0], (3, 3, 3),
                                    **kw)
        self.mid_block = MidBlock(rev[0], num_groups=cfg.num_groups, **kw)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock(rev[max(i - 1, 0)], ch,
                           num_layers=cfg.decoder_layers_per_block[i],
                           add_spatial_upsample=up[i],
                           add_temporal_upsample=up[i],
                           num_groups=cfg.num_groups, **kw)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1], cfg.num_groups, **kw)
        self.conv_out = CausalConv3d(rev[-1], cfg.in_channels, (3, 3, 3),
                                     **kw)

    def forward(self, z, state=None, is_init=True):
        z = self.conv_in(z, state, is_init)
        z = self.mid_block(z, state, is_init)
        for block in self.up_blocks:
            z = block(z, state, is_init)
        return self.conv_out(F.silu(self.conv_norm_out(z)), state, is_init)


class CausalVideoVAE(nn.Module):
    """The VAE's decode path: ``post_quant_conv`` -> :class:`Decoder`."""

    def __init__(self, config: VAEConfig = VAEConfig(), *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=device)
        zc = config.latent_channels
        self.decoder = Decoder(config, **kw)
        self.post_quant_conv = CausalConv3d(zc, zc, (1, 1, 1), **kw)
        for name, module in self.named_modules():
            if isinstance(module, CausalConv3d):
                module.cache_key = name

    def decode(self, z: torch.Tensor, state: Optional[dict] = None,
               is_init: bool = True) -> torch.Tensor:
        """z [B, T, h, w, Zc] -> pixels [B, T', 8h, 8w, 3], with
        T' = 1 + 8 (T - 1) on the first window and 8 T on later ones.

        ``state``: None for a monolithic decode, else the dict this window
        reads the previous window's carry from and writes its own to."""
        dtype = self.post_quant_conv.conv.weight.dtype
        x = z.to(dtype).permute(0, 4, 1, 2, 3)
        x = self.post_quant_conv(x, state, is_init)
        x = self.decoder(x, state, is_init)
        return x.permute(0, 2, 3, 4, 1)


def _window_starts(num_frames: int, window: int) -> List[Tuple[int, int]]:
    """Window boundaries: the first window is the single first frame, the
    rest ``window`` frames each."""
    starts = [(0, min(1, num_frames))]
    fid = starts[0][1]
    while fid < num_frames:
        starts.append((fid, min(fid + window, num_frames)))
        fid += window
    return starts


@torch.no_grad()
def chunk_decode(model: CausalVideoVAE, z: torch.Tensor,
                 window_size: int = 2) -> torch.Tensor:
    """Window-by-window decode of z [B, T, h, w, Zc] with the causal carry
    threaded between windows; any split gives the same frames."""
    state: dict = {}
    outs = []
    for idx, (s, e) in enumerate(_window_starts(z.shape[1], window_size)):
        outs.append(model.decode(z[:, s:e], state, is_init=(idx == 0)))
    return torch.cat(outs, dim=1)
