"""Multi-axis rotary embeddings (FLUX convention) for packed sequences.

Per-axis interleaved-pair rotations with axis dims ``[16, 24, 24]`` over
(t, h, w) positions; positions may be fractional (low-res stages interpolate
the full-res grid). Text tokens sit at position 0 on every axis, an identity
rotation. The rotation is carried as ``(cos, sin)`` of shape [B, L, D/2].

Each axis's frequencies are computed once per device in numpy and kept
there, so a forward uploads nothing from the host and can be captured in a
CUDA graph.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["rope_freqs", "apply_rope"]


@functools.lru_cache(maxsize=None)
def _omega(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The [dim // 2] fp32 frequencies of one axis on ``device``."""
    scale = np.arange(0, dim, 2, dtype=np.float64) / dim
    return torch.as_tensor((1.0 / (theta ** scale)).astype(np.float32),
                           device=device)


def rope_freqs(positions: torch.Tensor,
               axes_dim: Sequence[int] = (16, 24, 24),
               theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, L, n_axes] float -> (cos, sin) [B, L, sum(axes_dim)//2]
    fp32, axis-major (t pairs, then h pairs, then w pairs)."""
    outs_cos, outs_sin = [], []
    for i, dim in enumerate(axes_dim):
        omega = _omega(dim, float(theta), positions.device)
        ang = positions[..., i].float()[..., None] * omega
        outs_cos.append(torch.cos(ang))
        outs_sin.append(torch.sin(ang))
    return torch.cat(outs_cos, dim=-1), torch.cat(outs_sin, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate interleaved pairs of the head dim in fp32, cast back.

    x: [B, H, L, D]; cos/sin: [B, L, D/2].
    out_even = cos*x_even - sin*x_odd; out_odd = sin*x_even + cos*x_odd."""
    xf = x.float()
    x_even, x_odd = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    out = torch.stack([c * x_even - s * x_odd, s * x_even + c * x_odd], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
