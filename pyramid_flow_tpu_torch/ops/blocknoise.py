"""Correlated 2x2-block noise for pyramid stage transitions.

Each 2x2 spatial block is drawn from MVN(0, (1+g)I - g*11^T), so that after
the nearest-2x upsample-and-renoise the per-pixel variance is corrected while
the block mean stays consistent. The block vector is ``L @ z`` with ``L`` the
Cholesky factor and ``z`` standard normal; ``z`` is an argument so that a
caller can replay a given draw.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["block_noise_from_normal"]


def _chol(gamma: float) -> np.ndarray:
    cov = (1 + gamma) * np.eye(4) - gamma * np.ones((4, 4))
    return np.linalg.cholesky(cov).astype(np.float32)


def block_noise_from_normal(z: torch.Tensor, gamma: float = 1.0 / 3
                            ) -> torch.Tensor:
    """z [B, T, H/2, W/2, C, 4] standard normal (fp32) -> [B, T, H, W, C]
    noise, laid out as (p, q) within each 2x2 block."""
    b, t, h2, w2, c, _ = z.shape
    chol = torch.as_tensor(_chol(gamma), device=z.device)
    v = torch.einsum("...i,ji->...j", z.float(), chol)
    v = v.reshape(b, t, h2, w2, c, 2, 2).permute(0, 1, 2, 5, 3, 6, 4)
    return v.reshape(b, t, h2 * 2, w2 * 2, c)
