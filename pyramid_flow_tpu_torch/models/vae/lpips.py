"""LPIPS perceptual distance (VGG16 in five slices).

The counterpart of the JAX package's ``models/vae/lpips.py``: the inputs
shifted and scaled, VGG16's ``features`` cut after relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3 (a 2x2 max-pool opens each slice after the
first), each slice's features unit-normalised over the channels (``+1e-10``
on the norm), the squared difference of the two inputs' features weighted
per channel by a learned 1x1 head, averaged over space and summed over the
slices.

Keyed like the reference's ``vgg_lpips.pth``, so that file loads with
``load_state_dict(strict=True)``: ``net.slice{1..5}.{idx}.weight|bias`` at
VGG16's ``features`` numbering (a slice's max-pool and ReLUs hold the other
indices) and ``lin{k}.model.1.weight`` ``[1, C, 1, 1]`` (index 0 is the
reference's dropout, which its frozen LPIPS runs in eval mode: here the
identity). Without that file the VGG weights are PyTorch's default init and
the heads non-negative, as the released heads are.

Inputs are ``[N, H, W, 3]`` in [-1, 1], the JAX package's channels-last
layout (the trainer folds video time into N). The parameters are frozen;
gradients flow to the inputs. Under autocast the VGG convs compute in its
dtype; the normalisation, the heads and the sums run in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.devices import model_device

__all__ = ["LPIPS", "SLICES"]

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# output channels of each VGG16 conv, per slice
SLICES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
          (512, 512, 512))


class LPIPS(nn.Module):
    """``(x, y)`` ``[N, H, W, 3]`` -> per-sample LPIPS ``[N, 1, 1, 1]``.
    fp32 parameters, built on the CUDA device unless ``device=`` says
    otherwise."""

    def __init__(self, *, device="cuda"):
        super().__init__()
        kw = dict(device=model_device(device, "LPIPS"))
        self.net = nn.Module()
        idx, cin = 0, 3
        for s, channels in enumerate(SLICES):
            layers = nn.Sequential()
            if s > 0:
                layers.add_module(str(idx), nn.MaxPool2d(2, 2))
                idx += 1
            for c in channels:
                layers.add_module(str(idx), nn.Conv2d(cin, c, 3, padding=1,
                                                      **kw))
                layers.add_module(str(idx + 1), nn.ReLU())
                idx, cin = idx + 2, c
            setattr(self.net, f"slice{s + 1}", layers)
        for k, channels in enumerate(SLICES):
            head = nn.Sequential(nn.Identity(), nn.Conv2d(
                channels[-1], 1, 1, bias=False, **kw))
            with torch.no_grad():
                head[1].weight.abs_()
            setattr(self, f"lin{k}", nn.Module())
            getattr(self, f"lin{k}").model = head
        self.register_buffer("shift", torch.tensor(SHIFT, **kw),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE, **kw),
                             persistent=False)
        self.requires_grad_(False)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        # both inputs through the VGG at once: [2N, 3, H, W] channels-last
        h = (torch.cat([x, y]) - self.shift) / self.scale
        h = h.permute(0, 3, 1, 2)
        total = None
        for k in range(len(SLICES)):
            h = getattr(self.net, f"slice{k + 1}")(h)
            with torch.autocast(h.device.type, enabled=False):
                f = h.float()
                f = f / (f.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
                diff = (f[:n] - f[n:]).square()
                w = getattr(self, f"lin{k}").model[1].weight.float()
                d = F.conv2d(diff, w).mean(dim=(2, 3), keepdim=True)
            total = d if total is None else total + d
        return total
