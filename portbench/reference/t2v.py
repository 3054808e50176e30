"""The plain reference of a text-to-video request, and the comparison.

A request runs, per temporal unit (one latent frame), a cascade of pyramid
stages, each a loop of classifier-free-guided Euler steps through the DiT
on ``[negative, positive]`` rows. The served program's state at each step
is the current clip it feeds its DiT; the comparison follows that state step
by step and holds every transition between steps to this module's own
arithmetic:

* ``dit``: the program's DiT output against the plain float32 forward of
  the same packed layout, on a sample of forwards drawn from the seed with
  the longest layout in it;
* ``euler``: each step's change of the current clip against ``dt`` times the
  guided velocity the program's DiT returned;
* ``start``: each unit's first input against the run's initial draw taken
  to the lowest stage;
* ``transition``: each later stage's first input against the 2x upsample
  and block renoise of the stage before, with the run's block draws;
* ``history``: each later unit's packed history against the pyramid of the
  units before it, as this module packs it.

Each number is the relative L2 distance ``|a - b| / |b|``, the worst over
what it covers. :func:`plain_request` is the same request run by the
reference itself, at a chosen precision: the control.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

from . import dit as ref_dit
from .pyramid import (Layout, Tables, block_noise, initial_latent, patchify,
                      unpatchify, up2)

CHECKS = ("dit", "euler", "start", "transition", "history")


@dataclass
class Request:
    """What one request fed its DiT and got back, one entry per forward in
    order: ``(unit, stage, step)``, the current clip's tokens (row 1; both
    rows carry the same), the output's current-clip tokens of both rows, and
    at each stage's first step the packed history tokens."""
    forwards: List[dict] = field(default_factory=list)


@dataclass
class Noise:
    """The run's draws for one request: the initial latent draw and each
    (unit, stage)'s block-noise normals."""
    initial: torch.Tensor
    blocks: Dict[Tuple[int, int], torch.Tensor]


@dataclass
class Traffic:
    """A request's settings, read from the workload file."""
    temp: int
    height: int
    width: int
    steps: Sequence[int]
    video_steps: Sequence[int]
    guidance: float
    video_guidance: float

    @property
    def h_lat(self) -> int:
        return self.height // 8

    @property
    def w_lat(self) -> int:
        return self.width // 8

    def guidance_of(self, unit: int) -> float:
        return self.guidance if unit == 0 else self.video_guidance

    def steps_of(self, unit: int) -> Sequence[int]:
        return self.steps if unit == 0 else self.video_steps


def forward_schedule(tr: Traffic, stages: int = 3
                     ) -> List[Tuple[int, int, int]]:
    """(unit, stage, step) of every DiT forward of a request, in order."""
    return [(u, s, i) for u in range(tr.temp) for s in range(stages)
            for i in range(tr.steps_of(u)[s])]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _units(req: Request, tr: Traffic, stages: int):
    """{unit: {stage: [forward, ...]}} of the units whose every forward is
    in ``req``."""
    out: Dict[int, Dict[int, List[dict]]] = {}
    for f in req.forwards:
        out.setdefault(f["unit"], {}).setdefault(f["stage"], []).append(f)
    return {u: st for u, st in out.items()
            if all(len(st.get(s, [])) == tr.steps_of(u)[s]
                   for s in range(stages))}


def judge(family: str, cfg: dict, W, req: Request, noise: Noise, text,
          tr: Traffic, seed: int, n_dit: int, dtype: torch.dtype,
          P: ref_dit.Precision = ref_dit.Precision(), stages: int = 3
          ) -> Dict[str, float]:
    """The five numbers of the module docstring for one request. ``text``
    is ``(emb [2, Lt, J], mask [2, Lt], pooled [2, P])`` as the rows were
    fed; ``dtype`` is the precision the configuration serves tokens in."""
    tab = Tables(stages)
    units = _units(req, tr, stages)
    if not units:
        return {k: float("nan") for k in CHECKS}
    worst = {k: 0.0 for k in CHECKS}
    finals: Dict[int, torch.Tensor] = {}
    start = initial_latent(noise.initial, stages)

    def note(k, v):  # the worst reading; a NaN stays
        if worst[k] == worst[k] and not v <= worst[k]:
            worst[k] = v

    for u in sorted(units):
        prev = None
        for s in range(stages):
            fw = units[u][s]
            lay = Layout(u, s, tr.h_lat, tr.w_lat, stages)
            _, sig = tab.steps(len(fw), s)
            g = tr.guidance_of(u)
            xs = [unpatchify(f["cur"].float()[None], 1, lay.h, lay.w)
                  for f in fw]
            for i, f in enumerate(fw):
                v = f["v"].float()
                vg = v[0] + g * (v[1] - v[0])
                dt = float(torch.tensor(sig[i + 1]) - torch.tensor(sig[i]))
                step = dt * unpatchify(vg[None], 1, lay.h, lay.w)
                if i + 1 < len(fw):
                    note("euler", rel(xs[i + 1] - xs[i], step))
                else:
                    x_end = xs[i] + step
            if s == 0:
                want = start[:, u:u + 1]
                note("start", rel(xs[0], want.to(dtype).float()))
            else:
                a, b = tab.transition(s)
                want = a * up2(prev) + b * block_noise(noise.blocks[(u, s)],
                                                      tab.gamma)
                note("transition", rel(xs[0], want.to(dtype).float()))
            if u > 0:
                hist = lay.history_tokens([finals[j] for j in range(u)],
                                          dtype)[0]
                note("history", rel(fw[0]["cond"].float(), hist.float()))
            prev = x_end
        finals[u] = prev

    # the DiT on a sample drawn from the seed, with the longest layout in it
    flat = [(u, s, i) for u in sorted(units) for s in range(stages)
            for i in range(len(units[u][s]))]
    longest = max(flat, key=lambda k: (Layout(k[0], k[1], tr.h_lat, tr.w_lat,
                                              stages).length, k))
    pick = random.Random(seed).sample(flat, min(n_dit - 1, len(flat)))
    emb, mask, pooled = text
    for (u, s, i) in sorted(set(pick) | {longest}):
        fw = units[u][s]
        lay = Layout(u, s, tr.h_lat, tr.w_lat, stages)
        ts, _ = tab.steps(len(fw), s)
        cur = fw[i]["cur"].float()
        tokens = torch.cat([fw[0]["cond"].float(), cur])[None].expand(2, -1,
                                                                     -1)
        dev = cur.device
        pos = torch.as_tensor(lay.positions, device=dev)[None].expand(2, -1,
                                                                       -1)
        times = torch.as_tensor(lay.time_ids, device=dev)[None].expand(2, -1)
        t = torch.full((2,), float(ts[i]), device=dev)
        out = ref_dit.forward(family, cfg, W, tokens, pos, times, emb, mask,
                              pooled, t, lay.h, lay.w, P)[:, -cur.shape[0]:]
        note("dit", rel(fw[i]["v"].float(), out))
    return worst


def plain_request(family: str, cfg: dict, W, noise: Noise, text,
                  tr: Traffic, units: int, token_dtype: torch.dtype,
                  P: ref_dit.Precision, stages: int = 3) -> Request:
    """The first ``units`` units of the request, run by the reference in
    the program's place: tokens cast to ``token_dtype`` where the program
    casts them to its serving dtype, products at ``P``, the DiT's output
    rounded as ``P`` rounds. Records what :func:`judge` reads."""
    tab = Tables(stages)
    emb, mask, pooled = text
    low = initial_latent(noise.initial, stages)
    req, finals = Request(), []
    for u in range(units):
        x = low[:, u:u + 1]
        for s in range(stages):
            lay = Layout(u, s, tr.h_lat, tr.w_lat, stages)
            if s:
                a, b = tab.transition(s)
                x = a * up2(x) + b * block_noise(noise.blocks[(u, s)],
                                                 tab.gamma)
            cond = lay.history_tokens(finals, token_dtype)[0] if u else (
                x.new_zeros((lay.budget, x.shape[-1] * 4)))
            cond = cond.float()
            ts, sig = tab.steps(tr.steps_of(u)[s], s)
            dev = x.device
            pos = torch.as_tensor(lay.positions, device=dev)[None].expand(
                2, -1, -1)
            times = torch.as_tensor(lay.time_ids, device=dev)[None].expand(
                2, -1)
            g = tr.guidance_of(u)
            for i in range(len(ts)):
                cur = patchify(x.to(token_dtype)).float()[0]
                tokens = torch.cat([cond, cur])[None].expand(2, -1, -1)
                t = torch.full((2,), float(ts[i]), device=dev)
                v = P.round(ref_dit.forward(
                    family, cfg, W, tokens, pos, times, emb, mask, pooled, t,
                    lay.h, lay.w, P)[:, -cur.shape[0]:])
                req.forwards.append(dict(unit=u, stage=s, step=i, cur=cur,
                                         v=v, **({"cond": cond} if i == 0
                                                 else {})))
                vg = v[0] + g * (v[1] - v[0])
                dt = float(torch.tensor(sig[i + 1]) - torch.tensor(sig[i]))
                x = x + dt * unpatchify(vg[None], 1, lay.h, lay.w)
        finals.append(x)
    return req


def make_noise(tr: Traffic, gen: torch.Generator, stages: int = 3,
               channels: int = 16) -> Noise:
    """All draws of one request, made up front from ``gen``: the initial
    latent and every (unit, stage > 0)'s block normals."""
    dev = gen.device
    initial = torch.randn((1, tr.temp, tr.h_lat, tr.w_lat, channels),
                          generator=gen, device=dev)
    blocks = {}
    for u in range(tr.temp):
        for s in range(1, stages):
            h = tr.h_lat >> (stages - 1 - s)
            w = tr.w_lat >> (stages - 1 - s)
            blocks[(u, s)] = torch.randn((1, 1, h // 2, w // 2, channels, 4),
                                         generator=gen, device=dev)
    return Noise(initial, blocks)
