"""Where a 768p forward's time goes on one CUDA card.

    python -m pyramid_flow_tpu_torch.tools.profile_768p [--height 768]
        [--width 1280] [--unit 15] [--trace DIR] [--skip-vae] [--sweep]

The counterpart of the JAX package's ``tools/profile_768p.py``, at the
worst-case shapes of a 5 s 768x1280 request (the last AR unit, whose
conditioning history is longest):

1. one bf16 forward of the release-width miniFLUX (random weights from a
   seed) per stage at that unit's packed layout (CFG batch 2, 128 text
   tokens, the history padded to the pipeline's budget between the history
   and the current clip), the median of ``ITERS`` calls after two (CUDA
   events, ``exp_flash_h2.median_ms``, as K1's time below);
2. the bounded flash forward (K1) alone at each stage's ``[2, 24, L + 128,
   64]``, and the share of the forward that its 57 calls would take; the
   classic forward (K2, the DiT's ``bounded_softmax=False`` route) beside
   it on the same inputs, as the JAX tool times its default (classic)
   attention;
3. ``--trace DIR``: a ``torch.profiler`` trace of three stage-2 forwards
   (``utils.profiling.trace``), for TensorBoard;
4. unless ``--skip-vae``: the 17-frame latent decoded through
   ``PyramidFlowPipeline.decode_latent(save_memory=True)`` (the plan the
   card's memory selects), the first call and a second one, with the peak
   memory;
5. ``--sweep``: K1 and the heads-per-block forward (K6) at each ``hs`` whose
   block fits the card, and ``scaled_dot_product_attention`` with the
   time-id mask, at the stage-2 length (the JAX tool sweeps its kernel's
   block sizes here; K1's tile is fixed).

Results print as one JSON object per line. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

from ..ops.flash_attention import (HN_HEADS_PER_BLOCK, INVALID_TIME,
                                   flash_attention, flash_fwd_hn_resources)
from ..utils.profiling import annotate, trace
from .exp_flash_h2 import median_ms, flash_h2

__all__ = ["stage_inputs", "profile_forwards", "profile_decode", "sweep",
           "main"]

TEXT_LEN = 128
LATENT_CHANNELS = 16
SEED = 0
ITERS = 5    # timed calls per forward and kernel, after two
FRAMES = 17  # latent frames of the decode: 5 s of 768p video


def _emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def stage_inputs(dit, height: int, width: int, unit: int, stage: int,
                 gen: torch.Generator):
    """The DiT's inputs at one (unit, stage) of a ``height`` x ``width``
    request, CFG batch 2: random bf16 tokens, the pipeline's packed
    positions and time ids (the history padded to its budget between the
    history and the current clip), random text (all 128 tokens valid) and
    pooled features, timestep 500. Returns (inputs, latent time ids [L])."""
    from ..pipeline.pyramid_pipeline import PyramidFlowPipeline

    dev = gen.device
    meta = PyramidFlowPipeline(None, latent_channels=LATENT_CHANNELS,
                               device=dev)
    h_lat, w_lat = height // 8, width // 8
    budget = meta._cond_token_budget(unit, h_lat, w_lat)[stage]
    positions, time_ids, _ = meta._stage_metadata(1, 1, h_lat, w_lat, unit,
                                                  stage, budget)
    cfg, L, dtype = dit.config, positions.shape[0], torch.bfloat16
    width_tok = cfg.patch_size ** 2 * dit.latent_channels

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    lat_time = torch.as_tensor(time_ids, device=dev)
    inputs = (randn(2, L, width_tok),
              torch.as_tensor(positions, device=dev)[None].expand(2, -1, -1),
              lat_time[None].expand(2, -1),
              randn(2, TEXT_LEN, cfg.joint_attention_dim),
              torch.ones((2, TEXT_LEN), dtype=torch.bool, device=dev),
              randn(2, cfg.pooled_projection_dim),
              torch.full((2,), 500.0, device=dev))
    return inputs, lat_time


def attention_inputs(lat_time: torch.Tensor, heads: int, head_dim: int,
                     gen: torch.Generator):
    """K1's inputs at a forward's attention: q ``[2, heads, L + 128,
    head_dim]`` bf16 from ``gen`` (q = k = v, as the JAX tool times it) and
    the time ids (text at 0, then the latent's)."""
    dev = lat_time.device
    t = torch.cat([torch.zeros(TEXT_LEN, dtype=torch.int32, device=dev),
                   lat_time.to(torch.int32)])[None].expand(2, -1).contiguous()
    q = torch.randn((2, heads, t.shape[1], head_dim), generator=gen,
                    device=dev).bfloat16()
    return q, t


@torch.no_grad()
def profile_forwards(dit, height: int, width: int, unit: int, iters: int,
                     gen: torch.Generator, trace_dir=None) -> list:
    """Per stage: the DiT forward's, K1's and K2's milliseconds at the unit's
    layout, and each kernel's share of the forward (its time x the DiT's
    attention calls over the forward's). ``trace_dir``: a profiler trace of
    three stage-2 forwards there."""
    cfg = dit.config
    rows = []
    for stage in range(3):
        inputs, lat_time = stage_inputs(dit, height, width, unit, stage, gen)
        fwd_ms = median_ms(lambda: dit(*inputs), iters)
        q, t = attention_inputs(lat_time, cfg.num_attention_heads,
                                cfg.attention_head_dim, gen)
        k1_ms, k2_ms = (median_ms(lambda: flash_attention(
            q, q, q, t, causal=True, bounded=bounded), iters)
            for bounded in (True, False))
        calls = dit.num_attention_calls
        rows.append(_emit(dict(
            stage=stage, L=int(lat_time.shape[0]), L_attention=t.shape[1],
            dit_forward_ms=fwd_ms, k1_ms=k1_ms, k1_calls=calls,
            k1_share=k1_ms * calls / fwd_ms, k2_ms=k2_ms,
            k2_share=k2_ms * calls / fwd_ms)))
        del q, t
    if trace_dir is not None:
        with trace(trace_dir):
            for _ in range(3):
                with annotate("dit_forward_stage2"):
                    dit(*inputs)
            torch.cuda.synchronize()
        rows.append(_emit(dict(trace=str(trace_dir))))
    return rows


@torch.no_grad()
def profile_decode(vae, height: int, width: int, frames: int,
                   gen: torch.Generator, dit=None) -> dict:
    """``decode_latent(save_memory=True)`` of a random ``frames``-frame
    latent through a pipeline holding ``vae`` and ``dit`` (resident, as in
    the JAX tool; None decodes as after a released DiT), on the plan this
    card's memory selects: the first call's seconds, a second call's, and
    the peak memory of the second."""
    from ..pipeline.pyramid_pipeline import (PyramidFlowPipeline,
                                             decode_settings,
                                             device_memory_gb)

    dev = gen.device
    pipe = PyramidFlowPipeline(dit, vae, latent_channels=LATENT_CHANNELS,
                               device=dev)
    z = torch.randn((1, frames, height // 8, width // 8, LATENT_CHANNELS),
                    generator=gen, device=dev)
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = pipe.decode_latent(z, save_memory=True)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    plan = decode_settings(True, device_memory_gb(dev),
                           dit_resident=dit is not None)
    return _emit(dict(decode_frames=int(out.shape[1]),
                      frame=list(out.shape[2:4]), plan=repr(plan),
                      first_s=secs[0], steady_s=secs[1],
                      peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9))


def sdpa_mask(t: torch.Tensor) -> torch.Tensor:
    """[B, 1, L, L] causal time-id mask for
    ``scaled_dot_product_attention``."""
    tq, tk = t[:, None, :, None], t[:, None, None, :]
    return (tk != INVALID_TIME) & (tk <= tq)


@torch.no_grad()
def sweep(dit, height: int, width: int, unit: int, iters: int,
          gen: torch.Generator) -> list:
    """At the stage-2 attention length: K1, K6 at each ``hs`` whose block
    fits the card (the others reported), and SDPA with the time-id mask,
    each timed over ``iters`` launches (median, ``exp_flash_h2``'s
    timer)."""
    cfg = dit.config
    _, lat_time = stage_inputs(dit, height, width, unit, 2, gen)
    q, t = attention_inputs(lat_time, cfg.num_attention_heads,
                            cfg.attention_head_dim, gen)
    L = t.shape[1]
    base = median_ms(lambda: flash_attention(q, q, q, t, causal=True,
                                            bounded=True), iters)
    rows = [_emit(dict(sweep="flash_fwd", L=L, ms=base))]
    for hs in HN_HEADS_PER_BLOCK:
        r = dict(sweep="flash_fwd_hn", hs=hs, L=L)
        if flash_fwd_hn_resources(hs, True)["fits"]:
            r["ms"] = median_ms(lambda: flash_h2(q, q, q, t, hs=hs), iters)
            r["speedup_vs_flash_fwd"] = base / r["ms"]
        else:
            r["result"] = "does not fit"
        rows.append(_emit(r))
    mask = sdpa_mask(t)
    rows.append(_emit(dict(sweep="sdpa", L=L, ms=median_ms(
        lambda: F.scaled_dot_product_attention(q, q, q, attn_mask=mask),
        iters))))
    return rows


def build_models(dev, seed: int = 0, dit: bool = True, vae: bool = True):
    """(DiT, VAE): the release miniFLUX and the release VAE, both bf16, each
    left out (None) when its flag is off, with N(0, 0.02) weights (1 +
    N(0, 0.02) norm weights) drawn in that order from a generator seeded
    with ``seed``."""
    from ..models.flux.model import FluxConfig, PyramidFluxTransformer
    from ..models.vae.model import CausalVideoVAE, VAEConfig

    gen = torch.Generator(dev).manual_seed(seed)
    models = (
        PyramidFluxTransformer(FluxConfig(), dtype=torch.bfloat16, device=dev)
        if dit else None,
        CausalVideoVAE(VAEConfig(), dtype=torch.bfloat16, device=dev)
        if vae else None)
    with torch.no_grad():
        for m in models:
            for name, p in (m.named_parameters() if m is not None else ()):
                p.normal_(0.0, 0.02, generator=gen)
                if p.dim() == 1 and "norm" in name and name.endswith(
                        "weight"):
                    p.add_(1.0)
    return tuple(m.eval() if m is not None else None for m in models)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--unit", type=int, default=15)
    ap.add_argument("--trace", default=None,
                    help="directory for a profiler trace of three stage-2 "
                         "forwards")
    ap.add_argument("--skip-vae", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="K1, K6 at each hs and SDPA at the stage-2 length")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_768p: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(dev)}), flush=True)
    dit, vae = build_models(dev, SEED, vae=not args.skip_vae)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    profile_forwards(dit, args.height, args.width, args.unit, ITERS, gen,
                     args.trace)
    if args.sweep:
        sweep(dit, args.height, args.width, args.unit, ITERS, gen)
    if vae is not None:
        profile_decode(vae, args.height, args.width, FRAMES, gen, dit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
