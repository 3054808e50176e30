"""The one switch from the fused kernels back to the chains they replace.

Both fused kernels of the DiT blocks, the q/k/v pass
(``ops.qk_norm_rope.qkv_heads``) and the residual norm
(``ops.residual_norm.residual_norm``), launch on CUDA tensors and have no
backward. A caller that needs the differentiable chains on the card, or
computes in fp32, runs inside :func:`composition`: the train step (its
forwards and backward, a remat block's recompute included),
``capture_qk``'s telemetry, and reference forwards.
"""

from __future__ import annotations

import contextlib

__all__ = ["composition", "composing"]

# open composition() blocks; a module global and not a thread's, because
# the autograd engine runs a CUDA backward, and so a remat block's
# recompute, on a thread of its own
_COMPOSING = [0]


@contextlib.contextmanager
def composition():
    """Within the block, ``qkv_heads`` and ``residual_norm`` run their
    compositions on every device."""
    _COMPOSING[0] += 1
    try:
        yield
    finally:
        _COMPOSING[0] -= 1


def composing() -> bool:
    """Whether a :func:`composition` block is open."""
    return _COMPOSING[0] > 0
