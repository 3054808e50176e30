"""Training telemetry: the bounded-softmax exactness envelope.

The DiT's attention uses the bounded forward by default: its softmax shift is
an a-priori bound from |q| and |k| instead of the running row max, exact only
while ``bound - true_max_score`` stays well under ~120 log2 units. The
qk-norm keeps released weights in the low tens, but a fine-tune that grows the
qk-norm gains can drift out of the envelope and would then denormalise
attention silently. :func:`make_bound_overshoot_probe` runs one DiT forward
that captures every attention's q and k and returns the largest overshoot,
on either softmax route; the train CLI logs it and, on the bounded route,
warns past :data:`OVERSHOOT_WARN_LOG2` that the run should restart with
``--classic_softmax`` (the DiT's ``bounded_softmax=False``), whose classic
online softmax is exact at any gain.
"""

from __future__ import annotations

import torch

from ..models.mmdit.model import sincos_crop_origin
from ..ops.flash_attention import INVALID_TIME, bounded_softmax_overshoot
from ..pipeline.noising import add_pyramid_noise_stage, latent_pyramid
from ..pipeline.packing import pack_clips

__all__ = ["OVERSHOOT_WARN_LOG2", "make_bound_overshoot_probe",
           "mmdit_pos_offset_fn"]

# exactness dies near ~120 log2 units; in-envelope models measure in the
# low tens
OVERSHOOT_WARN_LOG2 = 100.0


def make_bound_overshoot_probe(dit, scheduler, pos_offset_fn=None):
    """Build ``probe(latents, text_emb, text_mask, pooled, draws) -> float``.

    Batch row 0 goes through one noised DiT forward at the last stage (the
    longest sequence the trainer makes; overshoot only shrinks with more
    visible keys) with q/k capture, and the probe returns the max
    :func:`bounded_softmax_overshoot` over every attention.
    ``pos_offset_fn(stage_batch, rows)``, when given, returns the DiT's
    ``pos_offset`` (the MMDiT's: :func:`mmdit_pos_offset_fn`), as the JAX
    probe takes it; otherwise the DiT's ``stage_inputs`` give it."""
    num_stages = scheduler.stages
    probe_stage = num_stages - 1

    @torch.no_grad()
    def probe(latents, text_emb, text_mask, pooled, draws) -> float:
        pyramid = latent_pyramid(latents[:1], num_stages)
        sb = add_pyramid_noise_stage(draws, scheduler, pyramid, probe_stage,
                                     num_stages)
        tokens, positions, time_ids, _ = pack_clips(sb.clips)
        dev = latents.device
        pos = torch.as_tensor(positions, device=dev)[None]
        times = torch.as_tensor(time_ids, device=dev)[None]
        if pos_offset_fn is None:
            extra = dit.stage_inputs(1, *sb.clips[0].shape[2:4], dev)
        else:
            extra = (pos_offset_fn(sb, 1),)
        with dit.capture_qk() as captured:
            dit(tokens.to(text_emb.dtype), pos, times, text_emb[:1],
                text_mask[:1], pooled[:1], sb.timesteps, *extra)
        # model-level attention time ids: [text (0 / INVALID); latent], and
        # under sequence parallelism the INVALID tail the DiT pads to
        text_time = torch.where(text_mask[:1], 0, INVALID_TIME)
        tq = torch.cat([text_time, times], dim=1).to(torch.int32)
        tq = torch.nn.functional.pad(tq, (0, captured[0][0].shape[2]
                                          - tq.shape[1]), value=INVALID_TIME)
        return max(bounded_softmax_overshoot(q, k, tq).item()
                   for q, k in captured)

    return probe


def mmdit_pos_offset_fn(pos_embed_max_size: int):
    """``pos_offset_fn`` for the MMDiT: the crop origin of its sincos table
    for the probe stage's grid (the trainer's and the pipeline's rule)."""
    def fn(sb, rows):
        h, w = sb.clips[0].shape[2:4]
        return sincos_crop_origin(pos_embed_max_size, rows, h, w,
                                  sb.clips[0].device)
    return fn
