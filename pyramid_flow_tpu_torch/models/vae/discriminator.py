"""PatchGAN discriminators, 2D (per frame) and 3D (per clip).

The counterparts of the JAX package's ``models/vae/discriminator.py``: 4-wide
convs with padding 1, stride 2 for the first ``n_layers`` (the 3D one
strides (2, 2, 2) first, then (1, 2, 2)), then stride 1; each conv after the
first followed by an instance norm without affine parameters (the
population variance, eps 1e-5, over the spatial axes per sample and
channel), all but the last by a leaky ReLU of slope 0.2; one logit channel
per patch; RGB in. Weights are drawn N(0, 0.02), biases zero, as JAX
initialises them; the parameters are fp32.

Keyed by JAX's layer names (``conv_0`` ... ``conv_{n_layers}``,
``conv_out``), so ``discriminator_state_dict_from_jax`` carries JAX's
weights over. Inputs and outputs are channels-last, as in JAX:
``[N, H, W, C]`` -> ``[N, H', W', 1]`` (2D) and ``[N, T, H, W, C]`` ->
``[N, T', H', W', 1]`` (3D). Under autocast the convs compute in its dtype;
the norm's statistics are fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.devices import model_device

__all__ = ["PatchDiscriminator2D", "PatchDiscriminator3D"]


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / sqrt(var + 1e-5)`` over the spatial axes of a
    ``[N, C, ...]`` tensor, per sample and channel, in fp32 (the population
    variance, as JAX's ``var``); the result in ``x``'s dtype."""
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=axes, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


class _PatchDiscriminator(nn.Module):
    """The layers of both discriminators; ``conv_cls`` is the subclass's
    conv (2D or 3D), ``strides`` one per ``conv_{n}``."""

    conv_cls: type

    def __init__(self, ndf: int, n_layers: int, strides: Sequence, device):
        super().__init__()
        kw = dict(kernel_size=4, padding=1,
                  device=model_device(device, type(self).__name__))
        widths = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        cin = 3
        for n, (width, stride) in enumerate(zip(widths, strides)):
            setattr(self, f"conv_{n}", self.conv_cls(cin, width,
                                                     stride=stride, **kw))
            cin = width
        self.conv_out = self.conv_cls(cin, 1, stride=1, **kw)
        self.n_layers = n_layers
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, self.conv_cls):
                    m.weight.normal_(0.0, 0.02)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = x.dim()
        h = x.permute(0, nd - 1, *range(1, nd - 1))  # channels-last view
        h = F.leaky_relu(self.conv_0(h), 0.2)
        for n in range(1, self.n_layers + 1):
            h = F.leaky_relu(_instance_norm(getattr(self, f"conv_{n}")(h)),
                             0.2)
        h = self.conv_out(h)
        return h.permute(0, *range(2, nd), 1)


class PatchDiscriminator2D(_PatchDiscriminator):
    """``[N, H, W, C]`` -> ``[N, H', W', 1]`` patch logits, per frame.
    Built on the CUDA device unless ``device=`` says otherwise."""

    conv_cls = nn.Conv2d

    def __init__(self, ndf: int = 64, n_layers: int = 4, *, device="cuda"):
        super().__init__(ndf, n_layers, [2] * n_layers + [1], device)
        self.to(memory_format=torch.channels_last)


class PatchDiscriminator3D(_PatchDiscriminator):
    """``[N, T, H, W, C]`` -> ``[N, T', H', W', 1]`` patch logits over the
    clip; stride (2, 2, 2) first, then (1, 2, 2). Built on the CUDA device
    unless ``device=`` says otherwise."""

    conv_cls = nn.Conv3d

    def __init__(self, ndf: int = 64, n_layers: int = 3, *, device="cuda"):
        strides: Tuple = ((2, 2, 2),) + ((1, 2, 2),) * (n_layers - 1) + (1,)
        super().__init__(ndf, n_layers, strides, device)
        self.to(memory_format=torch.channels_last_3d)
