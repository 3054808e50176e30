"""The plain reference of the DiT's training step, and the comparison.

One step, as the training recipe defines it (autoregressive temporal
pyramid, ``scripts/train_pyramid_flow.sh``):

* a 10% CFG text drop per row (text and pooled replaced by the null
  features, zeros here);
* the batch split into stage rows by the sample ratios; per stage, the
  clean-latent and noise pyramids, a uniform timestep per row, the noisy
  current unit and its velocity target, the history units corrupted with a
  per-row sigma, packed oldest first;
* one DiT forward per stage, the mean squared error of the current unit per
  row, the mean over the batch;
* the anomaly gate (a loss that is not finite or not below 2 changes
  nothing), the global-norm clip, and AdamW (betas 0.9 and 0.95, eps 1e-8,
  weight decay on matrices only) at the schedule's rate for the count of
  applied updates.

Draws come from one generator per step, seeded as the program seeds its
step's draws from the run's seed and the step, and are taken in the
recipe's order. The forward is :mod:`dit`'s, each block recomputed in the
backward.

The comparison (:func:`judge`) takes each step's loss, the first step's
gradient as the optimizer received it, and the parameters' change over the
steps, the last two by leaf: the gap between the program's norm and the
reference's over the larger of the reference's norm of that leaf and of the
median leaf.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from . import dit as ref_dit
from .pyramid import Tables, clip_meta, down2, patchify, pyramid, up2


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A step's draws: a generator seeded by ``hash((seed, step))``."""
    return torch.Generator(device).manual_seed(
        hash((int(seed), int(step))) % 2 ** 63)


class Draws:
    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.gen.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.gen.device)


def stage_rows(batch: int, ratios: Sequence[int]):
    per = batch // sum(ratios)
    out, start = [], 0
    for r in ratios:
        out.append((start, per * r))
        start += per * r
    return out


def ar_stage(d: Draws, tab: Tables, clean: List[torch.Tensor], stage: int,
             units: int, corrupt: float):
    """(clips oldest first, timesteps, target) of one stage's rows, one
    frame per unit; ``clean`` is their clean-latent pyramid."""
    full = clean[-1]
    units = min(units, full.shape[1])
    noise = [d.normal(full.shape)]
    for _ in range(tab.stages - 1):
        noise.append(down2(noise[-1]) * 2)
    noise = noise[::-1]
    s0, e0 = tab.start[stage], tab.end[stage]
    start = noise[stage] if stage == 0 else (
        s0 * noise[stage] + (1 - s0) * up2(clean[stage - 1]))
    end = clean[stage] if stage == tab.stages - 1 else (
        e0 * noise[stage] + (1 - e0) * clean[stage])
    ts, ratio = tab.sample(d.uniform((full.shape[0],)), stage)
    r = ratio[:, None, None, None, None]
    noisy = (r * start + (1 - r) * end)[:, :units][:, -1:]
    target = (start - end)[:, :units][:, -1:]
    sigma = (d.uniform((full.shape[0],)) * corrupt)[:, None, None, None,
                                                       None]

    def corrupted(x):
        return sigma * d.normal(x.shape) + (1 - sigma) * x

    if units == 1:
        return [noisy], ts, target
    clips = [noisy, corrupted(clean[stage][:, :units][:, -2:-1])]
    unit, s = 2, stage
    while unit < units:
        s = max(s - 1, 0)
        if s == 0:
            break
        unit += 1
        clips.append(corrupted(clean[s][:, :units][:, -unit:-(unit - 1)]))
    if s == 0 and unit < units:
        clips.append(corrupted(clean[0][:, :units][:, :-unit]))
    return clips[::-1], ts, target


def step_loss(family: str, cfg: dict, W, batch: dict, units: Sequence[int],
              gen: torch.Generator, p: dict, P: ref_dit.Precision,
              fault: str = ""):
    """The step's loss, a 0-dim tensor on the graph of ``W``. ``fault``
    plants one of the faults the comparison must catch: ``"half_batch"``
    (the loss over the first half of the rows alone) or
    ``"altered_token"`` (one output token of every forward moved by 1)."""
    tab = Tables()
    d = Draws(gen)
    lat = batch["latents"]
    b = lat.shape[0]
    drop = d.uniform((b,)) <= p["cfg_rate"]
    text = torch.where(drop[:, None, None], batch["null_text_emb"],
                       batch["text_emb"])
    pooled = torch.where(drop[:, None], batch["null_pooled"],
                         batch["pooled"])
    mask = batch["text_mask"]
    levels = pyramid(lat, tab.stages)
    losses = []
    for stage, (r0, n) in enumerate(stage_rows(b, p["sample_ratios"])):
        clean = [lv[r0:r0 + n] for lv in levels]
        clips, ts, target = ar_stage(d, tab, clean, stage, units[stage],
                                     p["corrupt_ratio"])
        dims = [tuple(c.shape[1:4]) for c in clips]
        pos, times = clip_meta(dims)
        x = torch.cat([patchify(c) for c in clips], 1)
        cur = dims[-1][0] * (dims[-1][1] // 2) * (dims[-1][2] // 2)
        dev = x.device
        out = ref_dit.forward(
            family, cfg, W, x,
            torch.as_tensor(pos, device=dev)[None].expand(n, -1, -1),
            torch.as_tensor(times, device=dev)[None].expand(n, -1),
            text[r0:r0 + n], mask[r0:r0 + n], pooled[r0:r0 + n], ts,
            dims[-1][1], dims[-1][2], P, remat=True)[:, -cur:]
        if fault == "altered_token":
            out = torch.cat([out[:, :-1], out[:, -1:] + 1.0], 1)
        err = (out - patchify(target)) ** 2
        losses.append(err.reshape(n, -1).mean(1))
    rows = torch.cat(losses)
    if fault == "half_batch":
        return rows[:b // 2].mean()
    return rows.sum() / b


def lr_at(count: int, p: dict) -> float:
    """The recipe's cosine schedule with linear warm-up from 0."""
    total = p["epochs"] * p["steps_per_epoch"]
    step, warm, base = min(count, total - 1), p["warmup_steps"], p["lr"]
    if step < warm:
        return step / max(warm, 1) * base
    prog = (step - warm) / max(total - warm, 1)
    return 1e-6 + 0.5 * (base - 1e-6) * (1 + math.cos(math.pi * prog))


def train_steps(family: str, cfg: dict, W: Dict[str, torch.Tensor],
                batches: Sequence[dict], units: Sequence[Sequence[int]],
                draw_seed: int, p: dict,
                P: ref_dit.Precision = ref_dit.Precision(), fault: str = ""
                ) -> dict:
    """Run the steps on float32 leaves ``W`` (updated in place). Returns
    each step's loss, the first step's gradient as the optimizer received it
    (zero where the gate held the update back) and the first step's raw
    gradient, by leaf. ``fault``: :func:`step_loss`'s."""
    names = sorted(W)
    leaves = [W[k].requires_grad_(True) for k in names]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    count, out = 0, {"loss": []}
    for k, batch in enumerate(batches):
        gen = step_generator(draw_seed, k, leaves[0].device)
        loss = step_loss(family, cfg, W, batch, units[k], gen, p, P, fault)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = float(loss.detach())
        out["loss"].append(loss)
        if k == 0:
            out["raw_grad"] = _norms(names, grads)
            out["grad"] = dict.fromkeys(names, 0.0)
        if not (math.isfinite(loss) and loss < p["anomaly_loss"]):
            continue
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads])))
        if norm >= p["clip"]:
            grads = [g * (p["clip"] / norm) for g in grads]
        if k == 0:
            out["grad"] = _norms(names, grads)
        lr, count = lr_at(count, p), count + 1
        b1, b2 = p["betas"]
        with torch.no_grad():
            for x, g, mi, vi in zip(leaves, grads, m, v):
                if x.ndim > 1:
                    x.mul_(1 - lr * p["weight_decay"])
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi.sqrt() / math.sqrt(1 - b2 ** count)).add_(1e-8)
                x.addcdiv_(mi, denom, value=-lr / (1 - b1 ** count))
    for x in leaves:
        x.requires_grad_(False)
    return out


def _norms(names, tensors) -> Dict[str, float]:
    """Each tensor's L2 norm, read back at once."""
    vals = torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    return dict(zip(names, vals.tolist()))


def stage_units(step: int, max_units: int, max_temporal: int = 31,
                sync_group: int = 8) -> List[int]:
    """Units per stage (lowest resolution first) of a one-rank run's step,
    as the recipe rotates the AR positions a sync group covers."""
    turns = max(1, max_temporal // sync_group)
    high = max(1 + (step % turns) * sync_group, 1)
    mid = max(1 + max_temporal - high, 1)
    return [min(x, max_units) for x in (mid, mid, high)]


def ar_dims(stage: int, units: int, frames: int, h_lat: int, w_lat: int,
            stages: int = 3) -> List[tuple]:
    """(frames, h, w) of the clips :func:`ar_stage` packs, oldest first."""
    units = min(units, frames)

    def size(s):
        return (h_lat >> (stages - 1 - s), w_lat >> (stages - 1 - s))

    dims = [(1, *size(stage))]
    if units == 1:
        return dims
    dims.append((1, *size(stage)))
    unit, s = 2, stage
    while unit < units:
        s = max(s - 1, 0)
        if s == 0:
            break
        unit += 1
        dims.append((1, *size(s)))
    if s == 0 and unit < units:
        dims.append((units - unit, *size(0)))
    return dims[::-1]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names=None) -> float:
    """The worst leaf's gap of norms, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    names = sorted(ref) if names is None else names
    vals = sorted(ref[k] for k in names)
    median = vals[len(vals) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in names)


def judge(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss``: the worst step's relative gap of losses; ``grad``: the
    first step's gradient as the optimizer received it; ``change``: the
    parameters' change over the steps, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (a leaf with none
    moves under AdamW by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    raw = ref["raw_grad"]
    median = sorted(raw.values())[len(raw) // 2]
    moving = [k for k in sorted(raw) if raw[k] >= 1e-3 * median]
    return {"loss": loss, "grad": leaf_gaps(prog["grad"], ref["grad"]),
            "change": leaf_gaps(prog["change"], ref["change"], moving)}
