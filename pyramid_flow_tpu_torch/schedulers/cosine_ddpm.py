"""Cosine DDPM scheduler (a slot of the scheduler registry; the pyramid
pipeline does not use it).

The reference's ``scheduling_cosine_ddpm.py``, as the JAX package writes it:
a continuous-time cosine alpha-bar with scaler warping, forward noising and
the ancestral DDPM step. Timesteps are t in [0, 1] (1 = pure noise). The
step draws its noise from an explicit ``torch.Generator``, or takes it
given (to replay another program's draws).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch

from .flow_matching import PyramidFlowMatchEulerDiscreteScheduler

__all__ = ["DDPMCosineScheduler", "SCHEDULER_REGISTRY", "get_scheduler"]


@dataclasses.dataclass(frozen=True)
class DDPMCosineScheduler:
    """Continuous cosine schedule with ``scaler`` warping of t and offset
    ``s``."""

    scaler: float = 1.0
    s: float = 0.008

    @property
    def _init_alpha_cumprod(self) -> float:
        return math.cos(self.s / (1 + self.s) * math.pi * 0.5) ** 2

    def alpha_cumprod(self, t) -> torch.Tensor:
        """alpha-bar(t), fp32, clipped to [1e-4, 0.9999]."""
        t = torch.as_tensor(t, dtype=torch.float32)
        if self.scaler > 1:
            t = 1 - (1 - t) ** self.scaler
        elif self.scaler < 1:
            t = t ** self.scaler
        ac = torch.cos((t + self.s) / (1 + self.s) * math.pi * 0.5) ** 2
        return torch.clamp(ac / self._init_alpha_cumprod, 1e-4, 0.9999)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """``num_inference_steps + 1`` times from 1 down to 0."""
        return np.linspace(1.0, 0.0, num_inference_steps + 1,
                           dtype=np.float32)

    def _per_row(self, t, like: torch.Tensor) -> torch.Tensor:
        return self.alpha_cumprod(t).to(like.device).reshape(
            (-1,) + (1,) * (like.dim() - 1))

    def add_noise(self, x: torch.Tensor, noise: torch.Tensor, t
                  ) -> torch.Tensor:
        """``sqrt(ac) x + sqrt(1 - ac) noise`` with one t per batch row."""
        ac = self._per_row(t, x)
        return torch.sqrt(ac) * x + torch.sqrt(1 - ac) * noise

    def step(self, model_output: torch.Tensor, t, t_prev,
             sample: torch.Tensor,
             noise: Union[torch.Tensor, torch.Generator, None] = None,
             ) -> torch.Tensor:
        """The ancestral step from t to t_prev for an epsilon prediction;
        no noise is added where t_prev is 0. ``noise`` is the standard
        normal draw of ``sample``'s shape, or a ``torch.Generator`` to draw
        it from."""
        if noise is None:
            raise ValueError("pass noise: a tensor or a torch.Generator")
        ac = self._per_row(t, sample)
        ac_prev = self._per_row(t_prev, sample)
        alpha = ac / ac_prev
        mu = torch.rsqrt(alpha) * (
            sample - (1 - alpha) * model_output * torch.rsqrt(1 - ac))
        std = torch.sqrt((1 - alpha) * (1 - ac_prev) / (1 - ac))
        if isinstance(noise, torch.Generator):
            noise = torch.randn(sample.shape, generator=noise,
                                device=noise.device, dtype=sample.dtype)
        not_last = (torch.as_tensor(t_prev, device=sample.device).reshape(
            (-1,) + (1,) * (sample.dim() - 1)) != 0).to(sample.dtype)
        return mu + std * noise.to(sample.device, sample.dtype) * not_last


SCHEDULER_REGISTRY = {
    "pyramid_flow_match": PyramidFlowMatchEulerDiscreteScheduler,
    "ddpm_cosine": DDPMCosineScheduler,
}


def get_scheduler(name: str, **kwargs):
    """The registered scheduler ``name`` built with ``kwargs``."""
    if name not in SCHEDULER_REGISTRY:
        raise KeyError(
            f"unknown scheduler {name!r}; have {sorted(SCHEDULER_REGISTRY)}")
    return SCHEDULER_REGISTRY[name](**kwargs)
