"""Latent normalisation constants and the clean-latent pyramid.

The inference half of the JAX package's ``pipeline/noising.py``; the
training-noise construction is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.resample import avg_pool_2x

__all__ = ["LATENT_NORMS", "VIDEO_NORM", "latent_pyramid"]

# (shift, scale) of frame 0 per model, and of the later frames
LATENT_NORMS = {
    "pyramid_flux": (-0.04, 1 / 1.8726),
    "pyramid_mmdit": (0.1490, 1 / 1.8415),
}
VIDEO_NORM = (-0.2343, 1 / 3.0986)


def down2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 1/2 downsample over H, W of [B, T, H, W, C]."""
    return avg_pool_2x(x.movedim(-1, -3)).movedim(-3, -1)


def latent_pyramid(x: torch.Tensor, num_stages: int):
    """[lowest .. full] clean-latent pyramid, no scaling."""
    out = [x]
    cur = x
    for _ in range(num_stages - 1):
        cur = down2(cur)
        out.append(cur)
    return list(reversed(out))
