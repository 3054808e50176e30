"""Experiment: which VAE-decode tiling plan decodes 768p fastest on one CUDA
card, and in how much memory.

    python -m pyramid_flow_tpu_torch.tools.exp_vae_tiling [--iters 2]
        [--no-ballast] [--temp 17]

The counterpart of the JAX package's ``tools/exp_vae_tiling.py``: its ten
plans, by name, decode a random 17-frame latent of the 768p request
(96 x 160, bf16, x 2) with the release VAE (bf16, random weights from a
seed): the reference-style walk of 384-pixel tiles overlapping by 1/8
(ragged edge tiles), uniform planned tiles (``plan_axis``), full-height
column strips of several widths in windows of 1 and 2, and the untiled
decode in windows of 1 and 2. Unless ``--no-ballast``, a buffer of the
release miniFLUX's bf16 bytes stays allocated throughout, as the DiT would
be resident beside the decode (the JAX tool's 5.8 GB is a TPU figure; this
one is computed from the built model). Each plan runs ``--iters`` times (the
JAX tool's extra first run compiles; PyTorch compiles nothing, and a first
decode on an H100 took within 5% of a second, PERF.md); it reports the least
seconds, the first run's, the peak memory (``max_memory_allocated``,
ballast included) and the largest difference of a subsample of its last
frame from the first plan's, then each plan's speed against the first.
Results print as one JSON object per line. Without a CUDA device it exits
1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models.vae.model import chunk_decode, tiled_decode, tiled_decode_planned
from .profile_768p import build_models

__all__ = ["VARIANTS", "dit_bytes", "run", "main"]

LATENT = (96, 160)  # the 768x1280 request's latent
# the JAX tool's plans by name, each a decode of (vae, z)
VARIANTS = {
    "current_384px_ov8": lambda vae, z: tiled_decode(
        vae, z, tile_sample_min_size=384, temporal_chunk=True,
        window_size=2, overlap_factor=0.125),
    "planned_48x48": lambda vae, z: tiled_decode_planned(vae, z, 48, 48),
    "strip_h96_w46": lambda vae, z: tiled_decode_planned(vae, z, 96, 46),
    "strip_h96_w58": lambda vae, z: tiled_decode_planned(vae, z, 96, 58),
    "strip_h96_w83": lambda vae, z: tiled_decode_planned(vae, z, 96, 83),
    "untiled_w2": lambda vae, z: chunk_decode(vae, z, window_size=2),
    "untiled_w1": lambda vae, z: chunk_decode(vae, z, window_size=1),
    "strip_w83_w1": lambda vae, z: tiled_decode_planned(
        vae, z, 96, 83, window_size=1),
    "strip_w58_w1": lambda vae, z: tiled_decode_planned(
        vae, z, 96, 58, window_size=1),
    "strip_w46_w2": lambda vae, z: tiled_decode_planned(
        vae, z, 96, 46, window_size=2),
}


def dit_bytes() -> int:
    """The bf16 bytes of the release miniFLUX, counted from a model built
    on PyTorch's meta device (no memory)."""
    from ..models.flux.model import FluxConfig, PyramidFluxTransformer

    dit = PyramidFluxTransformer(FluxConfig(), dtype=torch.bfloat16,
                                 device="meta")
    return sum(p.numel() * p.element_size() for p in dit.parameters())


def _sync_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.no_grad()
def run(vae, z: torch.Tensor, iters: int) -> dict:
    """Each plan of ``VARIANTS``, in the JAX tool's order: its
    ``{"seconds", "first_s", "peak_gb", "max_diff"}`` (None for a plan that
    ran out of memory), printed as it goes, then each plan's speed against
    the first."""
    dev = z.device
    results, ref = {}, None
    for name, fn in VARIANTS.items():
        out = None
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for _ in range(iters):
                del out
                out, s = _sync_s(lambda: fn(vae, z))
                times.append(s)
        except torch.cuda.OutOfMemoryError as e:
            results[name] = None
            print(json.dumps(dict(plan=name, result="out of memory",
                                  error=str(e)[:200])), flush=True)
            torch.cuda.empty_cache()
            continue
        if tuple(out.shape[2:4]) != (8 * z.shape[2], 8 * z.shape[3]):
            raise AssertionError(f"{name}: frames {tuple(out.shape)}")
        sample = out[:, -1, ::7, ::11].float()
        if ref is None:
            ref = sample
        r = dict(plan=name, seconds=min(times), first_s=times[0],
                 peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                 max_diff=(sample - ref).abs().max().item())
        print(json.dumps(r), flush=True)
        results[name] = r
        del out
        torch.cuda.empty_cache()
    base = next(iter(results.values()), None)
    for name, r in results.items():
        if r is not None and base is not None:
            print(json.dumps(dict(plan=name, seconds=r["seconds"],
                                  speedup_vs_first=base["seconds"]
                                  / r["seconds"])), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2,
                    help="timed decodes per plan (>= 1)")
    ap.add_argument("--no-ballast", action="store_true")
    ap.add_argument("--temp", type=int, default=17,
                    help="latent frames")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    if not torch.cuda.is_available():
        print("exp_vae_tiling: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(dev)}), flush=True)
    _, vae = build_models(dev, dit=False)
    ballast = None
    if not args.no_ballast:
        ballast = torch.empty(dit_bytes(), dtype=torch.uint8, device=dev)
        print(json.dumps({"ballast_gb": ballast.numel() / 1e9}), flush=True)
    gen = torch.Generator(dev).manual_seed(1)
    z = torch.randn((1, args.temp) + LATENT + (16,), generator=gen,
                    device=dev).bfloat16() * 2.0
    run(vae, z, args.iters)
    del ballast
    return 0


if __name__ == "__main__":
    sys.exit(main())
