"""Spatial resampling over the trailing (H, W) dims.

* :func:`avg_pool_2x`: the exact 2x bilinear downsample, which is a 2x2 mean;
* :func:`nearest_up_2x`: nearest 2x upsample, each pixel to a 2x2 block;
* :func:`interp_linear_1d_grid`: ``arange(in_size)`` linearly resampled to
  ``out_size`` points (align_corners=False), the RoPE positions of low-res
  stages (numpy);
* :func:`resize_bilinear`: a general bilinear resize (align_corners=False,
  ``F.interpolate``'s ``bilinear`` without antialiasing), through
  :func:`avg_pool_2x` for an exact 2x reduction;
* :func:`downsample_pyramid`: ``[lowest, ..., x]`` by repeated 2x
  reduction of [B, T, H, W, C].
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["avg_pool_2x", "nearest_up_2x", "interp_linear_1d_grid",
           "resize_bilinear", "downsample_pyramid"]


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] with H, W even -> [..., H/2, W/2] 2x2 means."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def nearest_up_2x(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., 2H, 2W], each pixel repeated over a 2x2 block."""
    *lead, h, w = x.shape
    x = x[..., :, None, :, None].expand(*lead, h, 2, w, 2)
    return x.reshape(*lead, h * 2, w * 2)


def _linear_weights(in_size: int, out_size: int):
    """Source indices and weights for 1-D linear resize, align_corners=False."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


def interp_linear_1d_grid(in_size: int, out_size: int) -> np.ndarray:
    """``arange(in_size)`` linearly resampled to ``out_size`` points."""
    if in_size == out_size:
        return np.arange(in_size, dtype=np.float32)
    lo, hi, frac = _linear_weights(in_size, out_size)
    grid = np.arange(in_size, dtype=np.float32)
    return (grid[lo] * (1 - frac) + grid[hi] * frac).astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of the trailing (H, W) to (out_h, out_w),
    align_corners=False, in ``x``'s dtype; an exact 2x reduction is the
    2x2 mean (:func:`avg_pool_2x`)."""
    *_, h, w = x.shape
    if out_h == h and out_w == w:
        return x
    if out_h * 2 == h and out_w * 2 == w:
        return avg_pool_2x(x)
    lo_h, hi_h, fh = (torch.as_tensor(a, device=x.device)
                      for a in _linear_weights(h, out_h))
    lo_w, hi_w, fw = (torch.as_tensor(a, device=x.device)
                      for a in _linear_weights(w, out_w))
    fh, fw = fh.to(x.dtype)[:, None], fw.to(x.dtype)[None, :]
    row = x[..., lo_h, :] * (1 - fh) + x[..., hi_h, :] * fh
    return row[..., lo_w] * (1 - fw) + row[..., hi_w] * fw


def downsample_pyramid(x: torch.Tensor, num_levels: int,
                       noise_scale: bool = False) -> list:
    """``[lowest, ..., x]``: ``num_levels`` 2x reductions of x [B, T, H, W,
    C] (channels last), low resolution first; ``noise_scale`` multiplies
    each level by 2 (the variance of downsampled white noise)."""
    out = [x]
    cur = x
    for _ in range(num_levels):
        cur = avg_pool_2x(cur.movedim(-1, -3)).movedim(-3, -1)
        if noise_scale:
            cur = cur * 2
        out.append(cur)
    return list(reversed(out))
