"""The pyramid's arithmetic, written out plainly for the reference.

A frozen copy of what the pipeline and the trainer compute around the DiT:
the flow-matching tables (timesteps and sigmas per stage, training's table
lookup, the stage-transition coefficients), the 2x2 patch packing, the RoPE
positions and time ids of packed clips, the served layout's padding budget,
the 2x2-mean pyramid and nearest 2x upsample, and the correlated 2x2 block
noise. It imports nothing of the program, so a fault in the program's copy
shows as a difference.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

INVALID_TIME = 2 ** 30
TEXT_BLOCK = 128  # text tokens the budget rounds against


class Tables:
    """Release pyramid: 3 stages over [0, 1/3, 2/3, 1], shift 1, gamma
    1/3, 1000 training timesteps."""

    def __init__(self, stages: int = 3, n: int = 1000, gamma: float = 1 / 3,
                 shift: float = 1.0):
        self.stages, self.n, self.gamma = stages, n, gamma
        stage_range = [i / stages for i in range(stages + 1)]
        t = np.linspace(1, n, n, dtype=np.float32)[::-1].copy()
        sigmas = t / n
        sigmas = (shift * sigmas / (1 + (shift - 1) * sigmas)).astype(
            np.float32)
        timesteps = sigmas * n
        self.ori_start, self.start, self.end, dist = [], [], [], []
        for s in range(stages):
            a = max(int(stage_range[s] * n), 0)
            b = min(int(stage_range[s + 1] * n), n)
            start = float(sigmas[a])
            end = float(sigmas[b]) if b < n else 0.0
            self.ori_start.append(start)
            if s:
                ori = 1 - start
                start = 1 - ori / (math.sqrt(1 + 1 / gamma) * (1 - ori) + ori)
            self.start.append(start)
            self.end.append(end)
            dist.append(start - end)
        tot = sum(dist)
        # per stage: n timesteps linspaced in its window, and n sigmas
        # ("ratios") from 1 down; inference linspaces between their ends
        self.stage_ts = []
        for s in range(stages):
            r0 = 0.0 if s == 0 else sum(dist[:s]) / tot
            r1 = 1.0 if s == stages - 1 else sum(dist[:s + 1]) / tot
            t_max = float(timesteps[int(r0 * n)])
            t_min = float(timesteps[min(int(r1 * n), n - 1)])
            self.stage_ts.append(
                np.linspace(t_max, t_min, n + 1)[:-1].astype(np.float32))
        self.stage_sig = np.linspace(1.0, 0.0, n + 1)[:-1].astype(np.float32)
        self.ts_first = [float(t[0]) for t in self.stage_ts]
        self.ts_last = [float(t[-1]) for t in self.stage_ts]
        self.sig_last = float(self.stage_sig[-1])

    def steps(self, num: int, stage: int) -> Tuple[np.ndarray, np.ndarray]:
        """(timesteps [num], sigmas [num + 1]) of one stage's Euler loop."""
        ts = np.linspace(self.ts_first[stage], self.ts_last[stage],
                         num).astype(np.float32)
        sig = np.linspace(1.0, self.sig_last, num).astype(np.float32)
        return ts, np.concatenate([sig, np.zeros(1, np.float32)])

    def sample(self, u: torch.Tensor, stage: int):
        """Uniform draws -> (timesteps, ratios) of a stage for training:
        entry ``clamp(int(u * n), 0, n - 1)`` of its tables."""
        idx = (u * self.n).to(torch.int32).clamp(0, self.n - 1).long()
        ts = torch.as_tensor(self.stage_ts[stage], device=u.device)[idx]
        return ts, torch.as_tensor(self.stage_sig, device=u.device)[idx]

    def transition(self, stage: int) -> Tuple[float, float]:
        """(alpha, beta) of x <- alpha * up2(x) + beta * block_noise."""
        ori = 1 - self.ori_start[stage]
        alpha = 1 / (math.sqrt(1 + 1 / self.gamma) * (1 - ori) + ori)
        return alpha, alpha * (1 - ori) / math.sqrt(self.gamma)


def patchify(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T * H/2 * W/2, 4C] in (p1, p2, c) order."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t * (h // 2) * (w // 2), 4 * c)


def unpatchify(tok: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    b, c = tok.shape[0], tok.shape[-1] // 4
    x = tok.reshape(b, t, h // 2, w // 2, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, h, w, c)


def down2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean over H, W of [B, T, H, W, C]."""
    b, t, h, w, c = x.shape
    return x.reshape(b, t, h // 2, 2, w // 2, 2, c).mean(dim=(3, 5))


def up2(x: torch.Tensor) -> torch.Tensor:
    """Each pixel of [B, T, H, W, C] to a 2x2 block."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def pyramid(x: torch.Tensor, stages: int) -> List[torch.Tensor]:
    """[lowest, ..., x] by repeated 2x2 means."""
    out = [x]
    for _ in range(stages - 1):
        out.append(down2(out[-1]))
    return out[::-1]


def block_noise(z: torch.Tensor, gamma: float) -> torch.Tensor:
    """z [B, T, H/2, W/2, C, 4] standard normal -> [B, T, H, W, C], each
    2x2 block drawn from N(0, (1 + g) I - g 11^T) through its Cholesky
    factor, laid out (p, q) in the block."""
    cov = (1 + gamma) * np.eye(4) - gamma * np.ones((4, 4))
    chol = torch.as_tensor(np.linalg.cholesky(cov).astype(np.float32),
                           device=z.device)
    b, t, h2, w2, c, _ = z.shape
    v = z.float() @ chol.T
    v = v.reshape(b, t, h2, w2, c, 2, 2).permute(0, 1, 2, 5, 3, 6, 4)
    return v.reshape(b, t, 2 * h2, 2 * w2, c)


def _grid(n_in: int, n_out: int) -> np.ndarray:
    """arange(n_in) resampled linearly to n_out points (half-pixel
    centres)."""
    if n_in == n_out:
        return np.arange(n_in, dtype=np.float32)
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0,
                  n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (src - lo).astype(np.float32)
    g = np.arange(n_in, dtype=np.float32)
    return (g[lo] * (1 - f) + g[hi] * f).astype(np.float32)


def cond_plan(unit: int, stage: int) -> List[Tuple[int, int, int]]:
    """[(stage s, first frame, end frame)] of the history clips of (unit,
    stage), oldest first, one frame per unit: the newest unit at the current
    stage, each older one a stage lower, all older than stage 0 in one
    lowest-stage clip; frame 0 is unit 0's."""
    plan, j, s = [], unit - 1, stage
    while j >= 0:
        if s == 0:
            plan.append((0, 0, 1 + j))
            break
        plan.append((s, j, j + 1))
        j, s = j - 1, s - 1
    return plan[::-1]


def clip_meta(dims: Sequence[Tuple[int, int, int]]):
    """(positions [L, 3], time ids [L]) of clips ``[(frames, h, w), ...]``
    at latent sizes, the last the current clip: time counts frames from the
    oldest; lower-resolution clips take the current clip's patch grid
    resampled to their own."""
    gh, gw = dims[-1][1] // 2, dims[-1][2] // 2
    pos, times, start = [], [], 0
    for (t, h, w) in dims:
        hp, wp = h // 2, w // 2
        p = np.zeros((t, hp, wp, 3), np.float32)
        p[..., 0] = np.arange(start, start + t, dtype=np.float32)[:, None,
                                                                   None]
        p[..., 1] = _grid(gh, hp)[None, :, None]
        p[..., 2] = _grid(gw, wp)[None, None, :]
        pos.append(p.reshape(-1, 3))
        times.append(np.repeat(np.arange(start, start + t, dtype=np.int64),
                               hp * wp))
        start += t
    return np.concatenate(pos), np.concatenate(times)


class Layout:
    """One (unit, stage) of a request at latent size h_lat x w_lat: its
    history clips, current clip, padding and token metadata."""

    def __init__(self, unit: int, stage: int, h_lat: int, w_lat: int,
                 stages: int = 3):
        self.unit, self.stage, self.stages = unit, stage, stages
        self.h = h_lat >> (stages - 1 - stage)
        self.w = w_lat >> (stages - 1 - stage)
        self.plan = cond_plan(unit, stage)
        dims = [(hi - lo, h_lat >> (stages - 1 - s), w_lat >> (stages - 1 - s))
                for s, lo, hi in self.plan]
        self.history = sum(t * (h // 2) * (w // 2) for t, h, w in dims)
        self.current = (self.h // 2) * (self.w // 2)
        # pad so that text + history + current lands on a multiple of 512
        # (of 128 up to 512)
        total = TEXT_BLOCK + self.history + self.current
        self.budget = self.history + (-total) % (512 if total > 512 else 128)
        self.length = self.budget + self.current
        pos, times = clip_meta(dims + [(1, self.h, self.w)])
        pad = self.budget - self.history
        self.positions = np.concatenate(
            [pos[:self.history], np.zeros((pad, 3), np.float32),
             pos[self.history:]])
        self.time_ids = np.concatenate(
            [times[:self.history], np.full(pad, INVALID_TIME, np.int64),
             times[self.history:]])

    def history_tokens(self, finals: Sequence[torch.Tensor],
                       dtype: torch.dtype) -> torch.Tensor:
        """[B, budget, 4C]: the clips of ``finals`` (each unit's final
        latent [B, 1, h_lat, w_lat, C]) that this layout conditions on,
        patchified in ``dtype`` and zero-padded to the budget."""
        hist = torch.cat(list(finals), dim=1)
        levels = pyramid(hist, self.stages)
        toks = [patchify(levels[s][:, lo:hi].to(dtype))
                for s, lo, hi in self.plan]
        b, c = hist.shape[0], hist.shape[-1]
        toks.append(hist.new_zeros((b, self.budget - self.history, 4 * c),
                                   dtype=dtype))
        return torch.cat(toks, dim=1)


def initial_latent(noise: torch.Tensor, stages: int) -> torch.Tensor:
    """The full-size initial draw [B, T, H, W, C] taken to the lowest stage:
    2x2 means with the x2 noise scale, once per stage below the top."""
    x = noise.float()
    for _ in range(stages - 1):
        x = down2(x) * 2
    return x
