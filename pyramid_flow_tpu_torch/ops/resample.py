"""Spatial resampling over the trailing (H, W) dims.

* :func:`avg_pool_2x`: the exact 2x bilinear downsample, which is a 2x2 mean;
* :func:`nearest_up_2x`: nearest 2x upsample, each pixel to a 2x2 block;
* :func:`interp_linear_1d_grid`: ``arange(in_size)`` linearly resampled to
  ``out_size`` points (align_corners=False), the RoPE positions of low-res
  stages (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["avg_pool_2x", "nearest_up_2x", "interp_linear_1d_grid"]


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
