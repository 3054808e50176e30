"""Where the port's models are built.

The DiTs and the VAE build on the CUDA device unless the caller names
another. Without a visible CUDA device they raise instead of building on the
CPU, where a full-size model would run silently at a fraction of the speed.
"""

from __future__ import annotations

import torch

__all__ = ["model_device"]


def model_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be visible.

    ``what`` names the model in the error."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} is built on {dev} unless device= says otherwise, and no "
            f"CUDA device is visible; pass device='cpu' to build it on the "
            f"CPU")
    return dev
