#!/usr/bin/env python3
"""Where one text-to-video request's, or one training step's, time goes on
a CUDA card.

    python3 profile_port.py [--temp 4]
    python3 profile_port.py --train

Serving: builds what ``chip_smoke.py`` serves with (the release-architecture
miniFLUX and the default VAE, bf16, random weights from a seed), serves a
warm-up request (temp 1), then one request at 384x640 with ``--temp``
frames' worth of latents, steps [20,20,20]/[10,10,10], twice: once plain,
for its wall time and DiT/decode split, and once under ``torch.profiler``
for the device kernels.

Training (``--train``): the release DiT with fp32 parameters, remat and
bf16 autocast, ``create_train_state`` and the train step at the JAX CLI's
default shape, as ``chip_smoke.py`` trains it; a warm-up step, three plain
steps, then one step under the profiler.

It prints, one JSON object per line:

* ``request`` or ``train step``: the plain runs (as ``chip_smoke.py`` prints
  them);
* ``profiled``: the profiled run's wall time, the device's busy time (the
  union of all kernel intervals), and the idle share ``1 - busy / wall``
  both against the profiled wall time and against the plain one (the
  profiler slows the host, not the kernels);
* ``category``: device time by kind of kernel (flash attention forward and
  backward, GEMM, convolution, the optimizer, the rest), with launch counts;
* ``kernel``: the longest-running kernels by device time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.vae.model import CausalVideoVAE, VAEConfig
from pyramid_flow_tpu_torch.pipeline.noising import (
    GeneratorDraws, sample_stage_length)
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.lr_schedules import cosine_schedule
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import make_train_step

CATEGORIES = (  # first match wins; names are lower-cased
    ("flash attention", ("flash_fwd_kernel",)),
    ("flash attention backward", ("flash_bwd_",)),
    ("causal conv kernel", ("causal_conv3d_kernel",)),
    ("convolution (cuDNN)", ("conv", "fprop", "cudnn", "winograd")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma")),
    ("optimizer (fused AdamW)", ("adam",)),
)
OTHER = "other (elementwise, norms, copies, reductions)"


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return OTHER


def busy_seconds(intervals) -> float:
    """Length of the union of [start, end) microsecond intervals, in s."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def profile_serving(dev, gen, temp):
    """(profiler, profiled wall s, plain wall s, what) of one request."""
    dit = PyramidFluxTransformer(FluxConfig(), dtype=torch.bfloat16,
                                 device=dev)
    smoke.randomize_(dit, gen)
    vae = CausalVideoVAE(VAEConfig(), dtype=torch.bfloat16, device=dev)
    smoke.randomize_(vae, gen)
    pipe = PyramidFlowPipeline(dit, vae, dtype=torch.bfloat16, device=dev)

    smoke.serve(pipe, dev, gen, "warm-up", 1)
    plain = smoke.serve(pipe, dev, gen, "plain", temp)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smoke.serve(pipe, dev, gen, "profiled", temp)
        wall = time.perf_counter() - t0
    return prof, wall, plain["wall_s"], dict(temp=temp)


def profile_training(dev, gen, steps):
    """(profiler, profiled wall s, median plain step s, what) of one train
    step; the units rotate with the step as in the trainer."""
    dit = PyramidFluxTransformer(FluxConfig(), dtype=torch.float32,
                                 device=dev, remat=True)
    smoke.randomize_(dit, gen)
    smoke.zero_output_(dit)
    state = create_train_state(dit, TrainConfig(
        learning_rate=5e-5, weight_decay=1e-4, max_grad_norm=1.0,
        lr_schedule=cosine_schedule(5e-5, 1e-6, 1000, 10, 1000)))
    step_fn = make_train_step(dit, PyramidFlowMatchEulerDiscreteScheduler(),
                              compute_dtype=torch.bfloat16)
    batch = smoke.training_batch(dit.config, dev, gen, smoke.TRAIN_BATCH)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(smoke.SEED))

    def one_step(label):
        nonlocal state
        units = tuple(sample_stage_length(0, state.step, 3, 31, 1, 8,
                                          max_units=smoke.TRAIN_FRAMES))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, draws, units)
        torch.cuda.synchronize()
        r = dict(run=label, units=units, seconds=time.perf_counter() - t0,
                 loss=m["train/loss"], applied=m["train/applied"])
        smoke.log("train step " + json.dumps(r))
        return r["seconds"]

    torch.cuda.reset_peak_memory_stats(dev)
    one_step("warm-up")
    plain = statistics.median(one_step("plain") for _ in range(steps))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = one_step("profiled")
    return prof, wall, plain, dict(
        train_steps=steps,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--temp", type=int, default=4)
    parser.add_argument("--train", action="store_true",
                        help="profile a training step instead of a request")
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smoke.log(smoke.card_line())
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    if args.train:
        prof, wall, plain_wall, what = profile_training(dev, gen, 3)
    else:
        prof, wall, plain_wall, what = profile_serving(dev, gen, args.temp)

    # device kernels; ranges the profiler annotates on the device timeline
    # (an optimizer's step, say) are not kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in kernels)
    smoke.log("profiled " + json.dumps(dict(
        **what, wall_s=wall, plain_wall_s=plain_wall,
        device_busy_s=busy, kernel_launches=len(kernels),
        idle_share_profiled=1 - busy / wall,
        idle_share_vs_plain_wall=1 - busy / plain_wall)))

    by_cat = defaultdict(lambda: [0.0, 0])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dt = (e.time_range.end - e.time_range.start) / 1e6
        for table, key in ((by_cat, category(e.name)), (by_name, e.name)):
            table[key][0] += dt
            table[key][1] += 1
    kernel_total = sum(s for s, _ in by_cat.values())
    for cat, (secs, count) in sorted(by_cat.items(), key=lambda x: -x[1][0]):
        smoke.log("category " + json.dumps(dict(
            category=cat, device_s=secs, launches=count,
            share=secs / kernel_total)))
    top = sorted(by_name.items(), key=lambda x: -x[1][0])[:args.top]
    for name, (secs, count) in top:
        smoke.log("kernel " + json.dumps(dict(
            name=name[:100], category=category(name), device_s=secs,
            launches=count, share=secs / kernel_total)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
