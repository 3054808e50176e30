#!/usr/bin/env python3
"""The device time of one fixed unit of a t2v cell's request, by kernel
kind, so that a parent commit and a change can be compared on the same
work on one card.

    python3 profile_unit.py --cell flux-t2v-384p-5s --seed 2239012345 \
        --unit 12 [--root DIR]

Builds the cell as the benchmark's run does (``portbench``'s cell, from
``--root``'s program and benchmark; default: this checkout), runs one
request unprofiled up to the end of unit ``--unit`` (its wall time between
the unit's two progress callbacks, ``unprofiled_wall_s``), then a second
request with that unit under ``torch.profiler``. A unit is the same work
whatever the checkout: the same seed gives the same request, and the first
request has captured the graphs of every layout the unit runs. Prints one
JSON line: every CUDA kernel's time summed by kind (``by_kind``: the fused
kernels K7 and K8, the flash forwards, GEMMs and the elementwise glue;
``device_s`` their sum), the union of the kernels' intervals
(``busy_s``), launches by kind and the 25 longest kernels by name. Unpack
the parent with ``git archive`` into a gitignored directory and run
parent, change in one call. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

# kind: substrings of a kernel's name, the first kind that matches counts
KINDS = (("K8 residual_norm", ("residual_norm",)),
         ("K7 qk_norm_rope", ("qk_norm_rope",)),
         ("flash", ("flash_fwd",)),
         ("GEMM", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
         ("LayerNorm", ("layer_norm",)),
         ("GELU", ("gelu", "Gelu")),
         ("concatenation", ("CatArrayBatchedCopy",)),
         ("copies and casts", ("copy_kernel", "direct_copy")),
         ("fp32 multiplies", ("MulFunctor<float>",)),
         ("bf16 multiplies", ("MulFunctor<c10::BFloat16>",)),
         ("fp32 adds", ("add<float>", "AddFunctor<float>")),
         ("bf16 adds", ("add<c10::BFloat16>", "AddFunctor<c10::BFloat16>")))


class _Stop(Exception):
    """Ends a request after the unit."""


def union_seconds(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals in us, in s."""
    busy, end = 0.0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            busy, end = busy + t - s, t
        elif t > end:
            busy, end = busy + t - end, t
    return busy / 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--unit", type=int, required=True)
    p.add_argument("--root", type=Path,
                   default=Path(__file__).resolve().parent)
    args = p.parse_args(argv)
    root = args.root.resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_unit.py needs a CUDA device", file=sys.stderr)
        return 1
    from portbench.harness.cell import Bench
    from portbench.reference import t2v as ref_t2v

    bench = Bench(root)
    spec = bench.spec(args.cell, args.seed, 30.0, False, "cuda:0")
    gen = bench.generator(spec.generator)
    base = getattr(gen, "base", gen)
    t0 = time.perf_counter()
    cell = gen.Cell(spec)
    setup = time.perf_counter() - t0
    tr, unit = cell.tr, args.unit

    def request(on_unit):
        noise = ref_t2v.make_noise(tr, cell.noise_gen)
        try:
            cell.pipe.generate(
                None, *cell.pos, *cell.neg, height=tr.height,
                width=tr.width, temp=tr.temp,
                num_inference_steps=list(tr.steps),
                video_num_inference_steps=list(tr.video_steps),
                guidance_scale=tr.guidance,
                video_guidance_scale=tr.video_guidance,
                output_type="latent", progress_callback=on_unit,
                noise=base.ReplayNoise(noise))
        except _Stop:
            pass

    marks, state = {}, {}

    def timed(info):
        torch.cuda.synchronize()
        marks[info["unit"]] = time.perf_counter()
        if info["unit"] > unit:
            raise _Stop

    def profiled(info):
        if info["unit"] == unit:
            torch.cuda.synchronize()
            state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
            state["prof"].__enter__()
        elif info["unit"] == unit + 1:
            torch.cuda.synchronize()
            state["prof"].__exit__(None, None, None)
            raise _Stop

    request(timed)
    request(profiled)
    by_kind, by_name = defaultdict(float), defaultdict(float)
    counts, intervals = defaultdict(int), []
    for e in state["prof"].events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        kind = next((k for k, pats in KINDS
                     if any(p in e.name for p in pats)), "other")
        by_kind[kind] += (t - s) / 1e6
        by_name[e.name[:160]] += (t - s) / 1e6
        counts[kind] += 1
    print(json.dumps(dict(
        root=str(root), cell=args.cell, seed=args.seed, unit=unit,
        setup_s=setup, unprofiled_wall_s=marks[unit + 1] - marks[unit],
        device_s=sum(by_kind.values()), busy_s=union_seconds(intervals),
        by_kind={k: round(v, 4) for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])},
        launches={k: counts[k] for k in sorted(counts)},
        top=[(n, round(v, 4)) for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:25]],
        card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
