"""Causal video VAE (8x8x8 compression): encoder, decoder, posterior,
windowed and tiled coding.

* :class:`CausalVideoVAE` holds the :class:`Encoder`, ``quant_conv``,
  ``post_quant_conv`` and the :class:`Decoder`, keyed like the released torch
  checkpoint (``encoder.down_blocks.0.downsamplers.0.conv.conv.weight``,
  ``decoder.up_blocks.0.upsamplers.0.conv.conv.weight``, ...). Its conv
  weights and activations are channels-last (see :mod:`.layers`).
* :func:`chunk_encode` and :func:`chunk_decode` code a video window by window.
  The causal convs' carry (the last two input frames of every temporal conv)
  is an explicit ``state`` dict threaded from one window to the next, so
  windowed coding equals monolithic coding under any split.
* ``CausalVideoVAE.decode_features`` is ``decode`` up to the decoder's
  ``conv_out``, which the GAN trainer applies itself.
* :func:`tiled_encode` and :func:`tiled_decode` code overlapping spatial
  tiles and crossfade their seams; :func:`reconstruct` is encode -> posterior
  -> decode.
* :func:`gaussian_sample`, :func:`gaussian_mode` and :func:`gaussian_kl` are
  the diagonal-Gaussian posterior over the encoder's moments.

The default geometry is the released checkpoint's: 16 latent channels,
(128, 256, 512, 512) channels, 2 resnets per encoder block and 3 per decoder
block, and blocks 0-2 that downsample (encoder) and upsample (decoder) in
space and time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.devices import model_device
from .blocks import DownEncoderBlock, MidBlock, UpDecoderBlock
from .layers import CausalConv3d, GroupNorm, channels_last

__all__ = ["VAEConfig", "Encoder", "Decoder", "CausalVideoVAE",
           "chunk_encode", "chunk_decode", "tiled_encode", "tiled_decode",
           "reconstruct", "gaussian_sample", "gaussian_mode", "gaussian_kl",
           "kernel_conv_count"]

# the release VAE's blocks 0-2 resample in space and time, block 3 does not
_RESAMPLE = (True, True, True, False)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    encoder_layers_per_block: Tuple[int, ...] = (2, 2, 2, 2)
    decoder_layers_per_block: Tuple[int, ...] = (3, 3, 3, 3)
    num_groups: int = 32
    downsample_scale: int = 8  # 8x spatial, 8x temporal (+1 frame)


class Encoder(nn.Module):
    """conv_in -> down blocks -> mid block -> norm/silu/conv_out (2 * Zc
    moments), on [B, C, T, H, W]. Down blocks 0..2 downsample in space and
    time."""

    def __init__(self, config: VAEConfig, **kw):
        super().__init__()
        cfg = config
        ch = cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, ch[0], (3, 3, 3), **kw)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock(ch[max(i - 1, 0)], c,
                             num_layers=cfg.encoder_layers_per_block[i],
                             add_spatial_downsample=_RESAMPLE[i],
                             add_temporal_downsample=_RESAMPLE[i],
                             num_groups=cfg.num_groups, **kw)
            for i, c in enumerate(ch)])
        self.mid_block = MidBlock(ch[-1], num_groups=cfg.num_groups, **kw)
        self.conv_norm_out = GroupNorm(ch[-1], cfg.num_groups, **kw)
        self.conv_out = CausalConv3d(ch[-1], 2 * cfg.latent_channels,
                                     (3, 3, 3), **kw)

    def forward(self, x, state=None, is_init=True):
        x = self.conv_in(x, state, is_init)
        for block in self.down_blocks:
            x = block(x, state, is_init)
        x = self.mid_block(x, state, is_init)
        return self.conv_out(F.silu(self.conv_norm_out(x)), state, is_init)


class Decoder(nn.Module):
    """conv_in -> mid block -> up blocks -> norm/silu/conv_out, on
    [B, C, T, H, W]. Up blocks 0..2 upsample in space and time."""

    def __init__(self, config: VAEConfig, **kw):
        super().__init__()
        cfg = config
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv3d(cfg.latent_channels, rev[0], (3, 3, 3),
                                    **kw)
        self.mid_block = MidBlock(rev[0], num_groups=cfg.num_groups, **kw)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock(rev[max(i - 1, 0)], ch,
                           num_layers=cfg.decoder_layers_per_block[i],
                           add_spatial_upsample=_RESAMPLE[i],
                           add_temporal_upsample=_RESAMPLE[i],
                           num_groups=cfg.num_groups, **kw)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1], cfg.num_groups, **kw)
        self.conv_out = CausalConv3d(rev[-1], cfg.in_channels, (3, 3, 3),
                                     **kw)

    def forward(self, z, state=None, is_init=True, skip_conv_out=False):
        """``skip_conv_out``: return the features ``conv_out`` would take
        (after the norm and SiLU), for the GAN trainer's adaptive weight."""
        z = self.conv_in(z, state, is_init)
        z = self.mid_block(z, state, is_init)
        for block in self.up_blocks:
            z = block(z, state, is_init)
        z = F.silu(self.conv_norm_out(z))
        if skip_conv_out:
            return z
        return self.conv_out(z, state, is_init)


class CausalVideoVAE(nn.Module):
    """The VAE: ``encode`` (:class:`Encoder` -> ``quant_conv``) and
    ``decode`` (``post_quant_conv`` -> :class:`Decoder`). Built on the CUDA
    device unless ``device=`` says otherwise; raises without a visible
    one."""

    def __init__(self, config: VAEConfig = VAEConfig(), *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=model_device(device, "CausalVideoVAE"))
        zc = config.latent_channels
        self.encoder = Encoder(config, **kw)
        self.decoder = Decoder(config, **kw)
        self.quant_conv = CausalConv3d(2 * zc, 2 * zc, (1, 1, 1), **kw)
        self.post_quant_conv = CausalConv3d(zc, zc, (1, 1, 1), **kw)
        for name, module in self.named_modules():
            if isinstance(module, CausalConv3d):
                module.cache_key = name
        # channels-last conv weights: the kernel reads [Co, 3, 3, 3, C]
        self.to(memory_format=torch.channels_last_3d)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.conv.weight.dtype

    def encode(self, x: torch.Tensor, state: Optional[dict] = None,
               is_init: bool = True) -> torch.Tensor:
        """pixels [B, T, H, W, 3] -> moments [B, T', H/8, W/8, 2 Zc], with
        T' = 1 + (T - 1) / 8 on the first window and T / 8 on later ones.

        ``state``: None for a monolithic encode, else the dict this window
        reads the previous window's carry from and writes its own to."""
        h = self.encoder(channels_last(x.to(self.dtype)), state, is_init)
        return self.quant_conv(h, state, is_init).permute(0, 2, 3, 4, 1)

    def decode(self, z: torch.Tensor, state: Optional[dict] = None,
               is_init: bool = True) -> torch.Tensor:
        """z [B, T, h, w, Zc] -> pixels [B, T', 8h, 8w, 3], with
        T' = 1 + 8 (T - 1) on the first window and 8 T on later ones.

        ``state``: None for a monolithic decode, else the dict this window
        reads the previous window's carry from and writes its own to."""
        x = self.post_quant_conv(channels_last(z.to(self.dtype)), state,
                                 is_init)
        return self.decoder(x, state, is_init).permute(0, 2, 3, 4, 1)

    def decode_features(self, z: torch.Tensor, is_init: bool = True
                        ) -> torch.Tensor:
        """``decode`` without the decoder's ``conv_out``: z [B, T, h, w, Zc]
        -> the features it would take, ``[B, C, T', 8h, 8w]`` channels-last
        (the layout ``decoder.conv_out`` takes). The GAN trainer applies
        ``conv_out`` itself, to differentiate the losses with respect to its
        weight alone."""
        x = self.post_quant_conv(channels_last(z.to(self.dtype)), None,
                                 is_init)
        return self.decoder(x, None, is_init, skip_conv_out=True)


def kernel_conv_count(module: nn.Module,
                      dtype: Optional[torch.dtype] = None) -> int:
    """How many of ``module``'s causal convs run through the conv kernel:
    each launches it once per window. ``dtype`` is the dtype they compute
    in; None reads it as the forward does (``CausalConv3d.uses_kernel``:
    the weights' dtype, or CUDA autocast's while it is on)."""
    convs = [m for m in module.modules() if isinstance(m, CausalConv3d)]
    if dtype is None:
        return sum(m.uses_kernel for m in convs)
    return sum(m.admits(dtype) for m in convs)


# ----------------------------------------------------------- posterior math
def _split_moments(moments):
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def gaussian_sample(moments: torch.Tensor,
                    noise: Union[torch.Tensor, torch.Generator]
                    ) -> torch.Tensor:
    """``mean + std * noise``; ``noise`` is the standard-normal draw of the
    mean's shape, or a ``torch.Generator`` to draw it from."""
    mean, logvar = _split_moments(moments)
    if isinstance(noise, torch.Generator):
        noise = torch.randn(mean.shape, generator=noise, device=noise.device,
                            dtype=torch.float32)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)


def gaussian_mode(moments: torch.Tensor) -> torch.Tensor:
    return _split_moments(moments)[0]


def gaussian_kl(moments: torch.Tensor) -> torch.Tensor:
    """KL to the standard normal, summed over (T, H, W, C) per batch row, in
    fp32."""
    mean, logvar = (m.float() for m in _split_moments(moments))
    return 0.5 * (mean.square() + logvar.exp() - 1.0 - logvar).sum(
        dim=(1, 2, 3, 4))


# -------------------------------------------------------- streaming windows
def _window_starts(num_frames: int, window: int,
                   init_window: Optional[int] = None
                   ) -> List[Tuple[int, int]]:
    """Window boundaries: the first window is ``init_window`` frames
    (default ``window + 1``, the encoder's split), the rest ``window`` frames
    each. Decoding passes ``init_window=1``."""
    init = window + 1 if init_window is None else init_window
    starts = [(0, min(init, num_frames))]
    fid = starts[0][1]
    while fid < num_frames:
        starts.append((fid, min(fid + window, num_frames)))
        fid += window
    return starts


@torch.no_grad()
def chunk_encode(model: CausalVideoVAE, x: torch.Tensor,
                 window_size: int = 16) -> torch.Tensor:
    """Window-by-window encode of pixels x [B, T, H, W, 3] with
    ``(T - 1) % 8 == 0``: a first window of ``window_size + 1`` frames, then
    ``window_size``, with the causal carry threaded between windows. Returns
    moments [B, 1 + (T - 1) / 8, H/8, W/8, 2 Zc]."""
    state: dict = {}
    outs = []
    for idx, (s, e) in enumerate(_window_starts(x.shape[1], window_size)):
        outs.append(model.encode(x[:, s:e], state, is_init=(idx == 0)))
    return torch.cat(outs, dim=1)


@torch.no_grad()
def chunk_decode(model: CausalVideoVAE, z: torch.Tensor,
                 window_size: int = 2) -> torch.Tensor:
    """Window-by-window decode of z [B, T, h, w, Zc] (a first window of one
    frame, then ``window_size``) with the causal carry threaded between
    windows; any split gives the same frames."""
    state: dict = {}
    outs = []
    for idx, (s, e) in enumerate(_window_starts(z.shape[1], window_size, 1)):
        outs.append(model.decode(z[:, s:e], state, is_init=(idx == 0)))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------------ tiling
def _blend_axis(prev: torch.Tensor, cur: torch.Tensor, extent: int,
                axis: int) -> torch.Tensor:
    """Linear crossfade of ``cur``'s leading ``extent`` slices with
    ``prev``'s trailing ones along ``axis``: weight ``i / extent`` on
    ``cur``."""
    extent = min(prev.shape[axis], cur.shape[axis], extent)
    if extent == 0:
        return cur
    shape = [1] * cur.ndim
    shape[axis] = extent
    w = (torch.arange(extent, dtype=torch.float32, device=cur.device)
         / extent).to(cur.dtype).reshape(shape)
    prev_tail = prev.narrow(axis, prev.shape[axis] - extent, extent)
    blended = prev_tail * (1 - w) + cur.narrow(axis, 0, extent) * w
    rest = cur.narrow(axis, extent, cur.shape[axis] - extent)
    return torch.cat([blended, rest], dim=axis)


def _tiled_apply(x: torch.Tensor, tile_in: int, tile_out: int,
                 overlap_factor: float,
                 fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Apply ``fn`` to overlapping spatial tiles of x [B, T, H, W, C]
    (``tile_in`` square, ``fn`` mapping it to ``tile_out``), crossfade each
    tile's seams with its upper and left neighbours, crop and stitch."""
    overlap_in = int(tile_in * (1 - overlap_factor))
    blend = int(tile_out * overlap_factor)
    row_limit = tile_out - blend
    rows = [[fn(x[:, :, i:i + tile_in, j:j + tile_in])
             for j in range(0, x.shape[3], overlap_in)]
            for i in range(0, x.shape[2], overlap_in)]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_axis(rows[i - 1][j], tile, blend, axis=2)
            if j > 0:
                tile = _blend_axis(row[j - 1], tile, blend, axis=3)
            out_row.append(tile[:, :, :row_limit, :row_limit])
        out_rows.append(torch.cat(out_row, dim=3))
    return torch.cat(out_rows, dim=2)


@torch.no_grad()
def tiled_encode(model: CausalVideoVAE, x: torch.Tensor,
                 tile_sample_min_size: int = 256,
                 temporal_chunk: bool = False, window_size: int = 16,
                 overlap_factor: float = 0.25) -> torch.Tensor:
    """Spatially tiled encode of pixels [B, T, H, W, 3]: square tiles of
    ``tile_sample_min_size`` pixels overlapping by ``overlap_factor``, each
    encoded whole or (``temporal_chunk``) window by window."""
    tile_latent = tile_sample_min_size // model.config.downsample_scale

    def enc(tile):
        if temporal_chunk:
            return chunk_encode(model, tile, window_size)
        return model.encode(tile)

    return _tiled_apply(x, tile_sample_min_size, tile_latent, overlap_factor,
                        enc)


@torch.no_grad()
def tiled_decode(model: CausalVideoVAE, z: torch.Tensor,
                 tile_sample_min_size: int = 256,
                 temporal_chunk: bool = False, window_size: int = 2,
                 overlap_factor: float = 0.25) -> torch.Tensor:
    """Spatially tiled decode of z [B, T, h, w, Zc]: latent tiles of
    ``tile_sample_min_size / 8`` overlapping by ``overlap_factor``, each
    decoded whole or (``temporal_chunk``) window by window."""
    tile_latent = tile_sample_min_size // model.config.downsample_scale

    def dec(tile):
        if temporal_chunk:
            return chunk_decode(model, tile, window_size)
        return model.decode(tile)

    return _tiled_apply(z, tile_latent, tile_sample_min_size, overlap_factor,
                        dec)


@torch.no_grad()
def reconstruct(model: CausalVideoVAE, x: torch.Tensor, *,
                noise: Union[None, torch.Tensor, torch.Generator] = None,
                window_size: int = 16, tiled: bool = False,
                tile_sample_min_size: int = 256) -> torch.Tensor:
    """Encode -> posterior (its mode, or a sample with ``noise``) -> decode
    of pixels [B, T, H, W, 3] in [-1, 1]; the decode window is the encode
    window over the temporal downsampling (8)."""
    dec_window = max(window_size // 8, 1)
    if tiled:
        moments = tiled_encode(model, x, tile_sample_min_size,
                               temporal_chunk=True, window_size=window_size)
    else:
        moments = chunk_encode(model, x, window_size)
    z = gaussian_mode(moments) if noise is None else gaussian_sample(
        moments, noise)
    if tiled:
        return tiled_decode(model, z, tile_sample_min_size,
                            temporal_chunk=True, window_size=dec_window)
    return chunk_decode(model, z, dec_window)
