"""The DiT training step.

The counterpart of the JAX package's ``training/trainer.py``:

* a 10% CFG text drop per row (text, mask and pooled replaced by the null
  features);
* the latent pyramid and per-stage noising on the device;
* one DiT forward per stage sub-batch, each with its own token count (stage 0
  rows hold 16x fewer tokens than stage 2 rows), with the DiT's
  ``stage_inputs`` (the MMDiT's crop origin of its sincos table);
* loss = mean over rows of the per-row MSE of the trainable tail;
* ``accum_steps`` micro-batches with averaged losses and gradients, each
  with its own noise draw;
* clip, anomaly gate, AdamW and EMA in :meth:`TrainState.apply_gradients`;
* raw-pixel batches (``"video"``): the frozen VAE encodes them, its
  posterior is sampled from the step's own draw, and the latents are
  normalised, before all of the above;
* spans (``utils.profiling.span``, recorded only inside
  ``profiling.recording()``) around the step, the encode, each backward,
  the optimizer and each ``.item()`` read, under the step's trace id.

On a (dp, fsdp, sp) mesh (``parallel.mesh``) each rank takes its slice of
the global batch: the dp x fsdp ranks hold different rows, the ranks of one
sp group the same rows and different token shards (the DiT's own sequence
parallelism). Every rank draws the global batch's noise and keeps its rows,
so a row is noised as JAX's global program noises it; a stage of which a
rank holds no row runs one zero-weighted row, so every rank runs the same
forwards (FSDP2's collectives pair up). Each rank's loss is the mean over
its rows of the per-row MSE; FSDP2 averages the gradients over every rank,
which makes them the gradient of the global mean (an sp rank's gradient is
``sp`` times its tokens' share, through the gather at the DiT's exit).

Accumulation splits the global batch as JAX's step does: micro-batch ``i``
is global rows ``[i B / a, (i + 1) B / a)``, after the CFG drop drawn on the
whole batch, with the ``i``-th split of the noise draw. A rank takes its
rows of each micro-batch, which may be none: it then runs the micro-batch's
stage forwards on zero-weighted rows, so the collectives still pair up.
"""

from __future__ import annotations

import contextlib
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.vae.model import chunk_encode, gaussian_sample
from ..ops.composition import composition
from ..parallel.mesh import data_rank
from ..pipeline.noising import (
    GeneratorDraws,
    StageBatch,
    add_ar_noise_stage,
    add_pyramid_noise_stage,
    dit_model_name,
    latent_pyramid,
    normalize_latent,
)
from ..pipeline.packing import pack_clips, patchify
from ..utils.profiling import ALLOCATOR, span
from .train_state import TrainState, global_norm

__all__ = ["dit_loss_fn", "make_train_step", "stage_row_split", "global_norm",
           "top_grad_offenders", "encode_video"]

# frames per window of the raw-pixel encode (after a first window of 9)
VIDEO_ENCODE_WINDOW = 8


def stage_row_split(batch_size: int, sample_ratios: Sequence[int]
                    ) -> List[Tuple[int, int]]:
    """Contiguous row blocks per stage, sized by ``sample_ratios``: a list of
    (start, count)."""
    total = sum(sample_ratios)
    if batch_size % total:
        raise ValueError(f"batch size {batch_size} does not divide by the "
                         f"sample ratios {tuple(sample_ratios)}")
    per = batch_size // total
    spans, start = [], 0
    for r in sample_ratios:
        spans.append((start, per * r))
        start += per * r
    return spans


def global_rows(local: torch.Tensor, rows: Tuple[int, int]) -> torch.Tensor:
    """This rank's ``[b, ...]`` rows placed at ``rows = (first, total)`` of
    a zero ``[total, ...]`` batch."""
    first, total = rows
    out = local.new_zeros((total,) + tuple(local.shape[1:]))
    out[first:first + local.shape[0]] = local
    return out


def dit_loss_fn(dit, draws, latents: torch.Tensor, text_emb: torch.Tensor,
                text_mask: torch.Tensor, pooled: torch.Tensor, scheduler,
                sample_ratios: Sequence[int] = (1, 2, 1),
                use_temporal_pyramid: bool = True,
                num_units_per_stage: Optional[Sequence[int]] = None,
                frame_per_unit: int = 1, corrupt_ratio: float = 1.0 / 3,
                rows: Optional[Tuple[int, int]] = None):
    """Noising, one DiT forward per stage and the per-row MSE. ``latents``
    ``[B, T, H, W, C]`` are clean and normalised. Returns (loss, metrics).

    ``rows = (first, total)``: the batch is rows ``[first, first + B)`` of a
    global batch of ``total`` (a rank's slice on a mesh). The stages split
    the global batch and every draw is the global batch's, so each row is
    noised as in the global program; the loss is the mean over this rank's
    rows. A stage without a row of this rank runs its first row with weight
    0, against the first row of the text features (so ``B`` may be 0: the
    loss is then 0, on the graph of those forwards)."""
    num_stages = scheduler.stages
    b_local = latents.shape[0]
    first, total = rows if rows is not None else (0, b_local)
    if total != b_local:
        latents = global_rows(latents, (first, total))
    pyramid = latent_pyramid(latents, num_stages)
    spans = stage_row_split(total, sample_ratios)
    device = latents.device

    losses = []
    for stage, (start, count) in enumerate(spans):
        draws, sub = draws.split(2)
        stage_latents = [lvl[start:start + count] for lvl in pyramid]
        if use_temporal_pyramid:
            nu = num_units_per_stage[stage] if num_units_per_stage else 1
            sb: StageBatch = add_ar_noise_stage(
                sub, scheduler, stage_latents, stage, num_stages, nu,
                frame_per_unit, corrupt_ratio)
        else:
            sb = add_pyramid_noise_stage(sub, scheduler, stage_latents, stage,
                                         num_stages)
        tokens, positions, time_ids, trainable = pack_clips(sb.clips)
        targets = sb.targets
        timesteps = sb.timesteps
        # this rank's rows of the stage (global indices), or a stand-in
        lo, hi = max(start, first), min(start + count, first + b_local)
        weight = 1.0
        if total != b_local:
            if lo >= hi:
                lo, hi, weight = start, start + 1, 0.0
            sel = slice(lo - start, hi - start)
            tokens, targets, timesteps = (tokens[sel], targets[sel],
                                          timesteps[sel])
        local = slice(lo - first, hi - first) if weight else slice(0, 1)
        b = tokens.shape[0]
        pos = torch.as_tensor(positions, device=device)[None].expand(b, -1, -1)
        times = torch.as_tensor(time_ids, device=device)[None].expand(b, -1)
        extra = dit.stage_inputs(b, *stage_latents[stage].shape[2:4], device)
        pred = dit(tokens.to(text_emb.dtype), pos, times,
                   text_emb[local], text_mask[local], pooled[local],
                   timesteps, *extra)
        pred = pred[:, -trainable:]
        err = (pred.float() - patchify(targets).float()) ** 2
        losses.append(err.reshape(b, -1).mean(dim=1) * weight)

    loss = torch.cat(losses).sum() / max(b_local, 1)
    return loss, {"train/loss": loss}


def encode_video(vae, video: torch.Tensor, draws,
                 model_name: str = "pyramid_flux",
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Raw pixels [B, T, H, W, 3] in [-1, 1] -> normalised latents: the
    VAE's moments, a posterior sample with ``draws.normal`` as its draw, and
    ``model_name``'s latent normalisation. The encode runs one row and one
    window of ``VIDEO_ENCODE_WINDOW`` frames at a time, which equals
    encoding the whole batch and keeps the activations to one window's.
    ``rows = (first, total)``: ``video`` is rows ``[first, first + B)`` of a
    global batch of ``total``, whose draw this takes its rows of."""
    moments = torch.cat([chunk_encode(vae, row[None], VIDEO_ENCODE_WINDOW)
                         for row in video])
    b = moments.shape[0]
    first, total = rows if rows is not None else (0, b)
    mean_shape = (total,) + moments.shape[1:-1] + (moments.shape[-1] // 2,)
    noise = draws.normal(mean_shape)[first:first + b]
    z = gaussian_sample(moments, noise)
    return normalize_latent(z.float(), model_name)


def make_train_step(dit, scheduler, sample_ratios: Sequence[int] = (1, 2, 1),
                    use_temporal_pyramid: bool = True,
                    frame_per_unit: int = 1, corrupt_ratio: float = 1.0 / 3,
                    cfg_rate: float = 0.1, accum_steps: int = 1,
                    compute_dtype: Optional[torch.dtype] = None, vae=None,
                    model_name: Optional[str] = None, mesh=None):
    """Build the train step.

    ``step(state, batch, draws, num_units_per_stage) -> (state, metrics)``
    updates ``state`` in place. ``batch``: latents, text_emb, text_mask,
    pooled, null_text_emb, null_pooled (and optionally null_text_mask) on the
    DiT's device; or, with ``vae`` (a frozen ``CausalVideoVAE``), ``video``
    [B, T, H, W, 3] raw pixels in [-1, 1] in place of the latents
    (:func:`encode_video`, normalised for the DiT's family,
    ``dit.model_name``; a ``model_name`` given as well must name it, or
    this raises). ``draws`` is the run's draw source (a ``torch.Generator``
    is wrapped in :class:`GeneratorDraws`); each step folds in its
    ``state.step``. ``compute_dtype=torch.bfloat16`` runs the loss under
    autocast with the parameters kept fp32. ``accum_steps > 1`` splits the
    global batch into that many micro-batches and averages their losses and
    gradients; the global batch size must divide by
    ``accum_steps * sum(sample_ratios)``.
    Metrics: ``train/loss`` and the pre-clip ``train/grad_norm`` as floats,
    and ``train/applied`` (whether the anomaly gate let the update through).

    ``mesh``: the (dp, fsdp, sp) mesh the DiT was built on and sharded over
    (``parallel.mesh.param_sharding``); ``batch`` is then this rank's slice
    of the global batch (the same rows on the ranks of one sp group), and
    the metrics are the global batch's on every rank.
    """

    model_name = dit_model_name(dit, model_name)
    data_index, data_ranks = data_rank(mesh)

    def autocast(device):
        if compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=compute_dtype)

    def loss_fn(draws_mb, latents, text_emb, text_mask, pooled, units,
                rows=None):
        with autocast(latents.device):
            loss, _ = dit_loss_fn(
                dit, draws_mb, latents, text_emb, text_mask, pooled,
                scheduler, sample_ratios, use_temporal_pyramid, units,
                frame_per_unit, corrupt_ratio, rows)
        return loss

    def step(state: TrainState, batch: Mapping[str, torch.Tensor], draws,
             num_units_per_stage: Tuple[int, ...]):
        # the attentions' q/k chain composed, since the fused kernel has no
        # backward: forwards, backward and a remat block's recompute
        with span("train.step", trace_id=state.step,
                  counters=ALLOCATOR) as step_span, composition():
            return traced_step(step_span, state, batch, draws,
                               num_units_per_stage)

    def traced_step(step_span, state, batch, draws, num_units_per_stage):
        if isinstance(draws, torch.Generator):
            draws = GeneratorDraws(draws)
        draws_drop, draws_noise, draws_vae = draws.fold_in(state.step).split(3)
        x = batch["video"] if "video" in batch else batch["latents"]
        b = x.shape[0]
        rows = (data_index * b, data_ranks * b)  # this rank's global rows
        if "video" in batch:
            if vae is None:
                raise ValueError("a raw-pixel batch ('video') needs "
                                 "make_train_step(vae=...)")
            with span("train.encode", frames=x.shape[1]):
                latents = encode_video(vae, x, draws_vae, model_name, rows)
        else:
            latents = x
        b_, t_, h_, w_ = latents.shape[:4]  # the batch's 2x2 patches
        step_span.set(tokens=b_ * t_ * (h_ // 2) * (w_ // 2))
        # CFG text drop
        drop = draws_drop.uniform((rows[1],))[rows[0]:rows[0] + b]
        drop = drop.to(latents.device) <= cfg_rate
        text_emb = torch.where(drop[:, None, None], batch["null_text_emb"],
                               batch["text_emb"])
        text_mask = torch.where(
            drop[:, None], batch.get("null_text_mask", batch["text_mask"]),
            batch["text_mask"])
        pooled = torch.where(drop[:, None], batch["null_pooled"],
                             batch["pooled"])

        params = list(dit.parameters())
        for p in params:
            p.grad = None
        first, total = rows
        micro = total // accum_steps
        loss = torch.zeros((), device=latents.device)
        splits = (draws_noise.split(accum_steps) if accum_steps > 1
                  else [draws_noise])
        for i, draws_mb in enumerate(splits):
            # this rank's rows of global micro-batch i, [i m, (i + 1) m)
            lo = max(first, i * micro)
            hi = max(min(first + b, (i + 1) * micro), lo)
            sel = slice(lo - first, hi - first)
            text = [t[sel] if hi > lo else t[:1]
                    for t in (text_emb, text_mask, pooled)]
            mb_loss = loss_fn(draws_mb, latents[sel], *text,
                              num_units_per_stage,
                              (lo - i * micro if hi > lo else 0, micro))
            # the micro-batch's share of this rank's mean: the average over
            # micro-batches, and the global one once FSDP2 averages ranks
            mb_loss = mb_loss * ((hi - lo) / b)
            with span("train.backward", micro_batch=i):
                mb_loss.backward()  # sums into .grad
            loss = loss + mb_loss.detach()
        if mesh is not None:  # the global mean on every rank
            dist.all_reduce(loss)
            loss = loss / mesh.size()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        with span("train.sync", read="grad_norm"):
            gnorm = global_norm(grads).item()
        with span("train.sync", read="loss"):
            loss = loss.item()
        with span("train.optimizer") as opt_span:  # clip, AdamW, EMA
            applied = state.apply_gradients(grads, loss)
            opt_span.set(applied=applied)
        for p in params:
            p.grad = None
        return state, {"train/loss": loss, "train/grad_norm": gnorm,
                       "train/applied": applied}

    return step


def top_grad_offenders(grads: Mapping[str, torch.Tensor], k: int = 5
                       ) -> List[Tuple[str, float]]:
    """The ``k`` largest per-parameter gradient norms, largest first: a
    debugging aid on materialised gradients."""
    norms = [(name, torch.linalg.vector_norm(g.float()).item())
             for name, g in grads.items()]
    return sorted(norms, key=lambda kv: -kv[1])[:k]
