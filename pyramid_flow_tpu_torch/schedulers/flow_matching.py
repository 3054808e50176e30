"""Pyramidal flow-matching Euler scheduler: the tables and their lookups.

The table math is numpy and is the same as in the JAX package's
``schedulers/flow_matching.py`` (copied, since that module imports jax):

* a global shifted-sigma schedule ``sigma' = shift*sigma / (1 + (shift-1)*sigma)``
  over ``num_train_timesteps`` points;
* the unit interval split into ``stages`` windows by ``stage_range``, with
  the start sigma of each stage > 0 corrected for the upsample-and-renoise
  transition;
* per-stage timestep tables linspaced inside each window, and per-stage
  sigma ("ratio") tables ``linspace(1, 0, N+1)[:-1]``.

Inference reads linspaces of those tables; training maps uniform draws to
table entries. The Euler step itself is one line in the pipeline's denoise
loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["PyramidFlowMatchEulerDiscreteScheduler"]


def _shifted_sigmas(num_train_timesteps: int, shift: float) -> np.ndarray:
    """Global sigma table, descending from ~1 to 1/N, with SD3-style shift."""
    timesteps = np.linspace(
        1, num_train_timesteps, num_train_timesteps, dtype=np.float32
    )[::-1].copy()
    sigmas = timesteps / num_train_timesteps
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return sigmas.astype(np.float32)


@dataclass(frozen=True)
class PyramidFlowMatchEulerDiscreteScheduler:
    """Static scheduler tables; all methods are pure."""

    num_train_timesteps: int = 1000
    shift: float = 1.0
    stages: int = 3
    stage_range: Tuple[float, ...] = (0.0, 1.0 / 3, 2.0 / 3, 1.0)
    gamma: float = 1.0 / 3

    sigmas: np.ndarray = field(init=False, repr=False)
    timesteps: np.ndarray = field(init=False, repr=False)
    start_sigmas: Tuple[float, ...] = field(init=False)
    end_sigmas: Tuple[float, ...] = field(init=False)
    ori_start_sigmas: Tuple[float, ...] = field(init=False)
    timestep_ratios: Tuple[Tuple[float, float], ...] = field(init=False)
    timesteps_per_stage: Tuple[np.ndarray, ...] = field(init=False, repr=False)
    sigmas_per_stage: Tuple[np.ndarray, ...] = field(init=False, repr=False)

    def __post_init__(self):
        n = self.num_train_timesteps
        sigmas = _shifted_sigmas(n, self.shift)
        timesteps = sigmas * n

        start_sigmas: List[float] = []
        end_sigmas: List[float] = []
        ori_start_sigmas: List[float] = []
        stage_distance: List[float] = []
        for i_s in range(self.stages):
            start_idx = max(int(self.stage_range[i_s] * n), 0)
            end_idx = min(int(self.stage_range[i_s + 1] * n), n)
            start_sigma = float(sigmas[start_idx])
            end_sigma = float(sigmas[end_idx]) if end_idx < n else 0.0
            ori_start_sigmas.append(start_sigma)
            if i_s != 0:
                ori = 1 - start_sigma
                corrected = (
                    1.0 / (math.sqrt(1 + 1 / self.gamma) * (1 - ori) + ori)
                ) * ori
                start_sigma = 1 - corrected
            stage_distance.append(start_sigma - end_sigma)
            start_sigmas.append(start_sigma)
            end_sigmas.append(end_sigma)

        tot = sum(stage_distance)
        ratios: List[Tuple[float, float]] = []
        for i_s in range(self.stages):
            start_ratio = 0.0 if i_s == 0 else sum(stage_distance[:i_s]) / tot
            end_ratio = (1.0 if i_s == self.stages - 1
                         else sum(stage_distance[: i_s + 1]) / tot)
            ratios.append((start_ratio, end_ratio))

        ts_per_stage: List[np.ndarray] = []
        sig_per_stage: List[np.ndarray] = []
        for r0, r1 in ratios:
            t_max = float(timesteps[int(r0 * n)])
            t_min = float(timesteps[min(int(r1 * n), n - 1)])
            ts = np.linspace(t_max, t_min, n + 1)[:-1]
            ts_per_stage.append(ts.astype(np.float32))
            sig_per_stage.append(
                np.linspace(1.0, 0.0, n + 1)[:-1].astype(np.float32))

        object.__setattr__(self, "sigmas", sigmas)
        object.__setattr__(self, "timesteps", timesteps.astype(np.float32))
        object.__setattr__(self, "start_sigmas", tuple(start_sigmas))
        object.__setattr__(self, "end_sigmas", tuple(end_sigmas))
        object.__setattr__(self, "ori_start_sigmas", tuple(ori_start_sigmas))
        object.__setattr__(self, "timestep_ratios", tuple(ratios))
        object.__setattr__(self, "timesteps_per_stage", tuple(ts_per_stage))
        object.__setattr__(self, "sigmas_per_stage", tuple(sig_per_stage))

    def inference_tables(self, num_inference_steps: int, stage_index: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """``(timesteps[n], sigmas[n+1])`` for a stage's denoise loop:
        timesteps linspaced between the stage table's first and last entries,
        sigmas linspaced over ``n`` points with a terminal 0 appended."""
        stage_ts = self.timesteps_per_stage[stage_index]
        timesteps = np.linspace(float(stage_ts[0]), float(stage_ts[-1]),
                                num_inference_steps).astype(np.float32)
        stage_sig = self.sigmas_per_stage[stage_index]
        sigmas = np.linspace(float(stage_sig[0]), float(stage_sig[-1]),
                             num_inference_steps).astype(np.float32)
        sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=np.float32)])
        return timesteps, sigmas

    def sample_stage_timesteps(self, u: torch.Tensor, stage_index: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform draws ``u in [0, 1)`` -> ``(timesteps, ratios)`` of a stage
        for training: ``idx = clamp(int(u * N), 0, N - 1)`` into the stage's
        tables, on ``u``'s device."""
        n = self.num_train_timesteps
        idx = (u * n).to(torch.int32).clamp(0, n - 1).long()
        ts = torch.as_tensor(self.timesteps_per_stage[stage_index],
                             device=u.device)[idx]
        ratios = torch.as_tensor(self.sigmas_per_stage[stage_index],
                                 device=u.device)[idx]
        return ts, ratios

    def transition_coefficients(self, stage_index: int) -> Tuple[float, float]:
        """``(alpha, beta)`` for the stage transition
        ``x <- alpha * up(x) + beta * block_noise``."""
        if stage_index <= 0:
            raise ValueError("stage 0 has no transition")
        ori_sigma = 1 - self.ori_start_sigmas[stage_index]
        gamma = self.gamma
        alpha = 1 / (math.sqrt(1 + (1 / gamma)) * (1 - ori_sigma) + ori_sigma)
        beta = alpha * (1 - ori_sigma) / math.sqrt(gamma)
        return alpha, beta
