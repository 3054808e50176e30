#!/usr/bin/env python3
"""Run the PyTorch port's text-to-video and DiT-training paths once on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: its name and power limit as nvidia-smi reports them;
2. build: the CUDA flash-attention forward and backward libraries from
   ``pyramid_flow_tpu_torch/csrc``, one nvcc each, started together; ptxas's
   register and spill lines;
3. kernel vs plain: the forward kernel against the plain PyTorch version on the
   DiT's packed attention layouts (384x640 unit 0 stage 0, 384x640 unit 15
   stage 2, 768x1280 unit 15 stage 2) at B=2, H=24, D=64 in bf16, bounded
   and classic softmax, causal and not; valid rows must agree within
   max|do| <= 1e-2 and max|dlse| <= 2e-3 of the fp32 plain version; both
   are timed with CUDA events;
4. full-width DiT: the release-architecture miniFLUX (19 dual + 38 single
   blocks, 24 x 64 heads) in bf16 with random weights, one forward at the
   384x640 unit 15 stage 2 layout through the kernel and through the plain
   version; relative L2 <= 2e-2 on the valid tokens;
5. serve: two text-to-video requests through ``PyramidFlowPipeline.generate``
   with that DiT and the default VAE, 384x640, temp 1 and temp 4, steps
   [20,20,20]/[10,10,10], guidance 7/5, uint8 frames out. The latents must be
   finite, the frames not constant, and the kernel's launch counter must
   grow by exactly 57 per DiT forward;
6. backward kernels vs plain: dK/dV and dQ against the plain fp32 backward
   on the layouts of phase 3 (B=2, H=24, D=64, causal and not) and on the
   384x640 unit 15 stage 2 layout at H=12, D=128; o and lse from the forward
   kernel, the upstream gradient random on valid rows and zero on padded
   ones; max|err| <= 2e-2 * max|ref| for each of dq, dk, dv; both timed;
7. full-width DiT gradient: the release DiT with fp32 parameters, bf16
   autocast and remat, one training-loss backward of a batch row at the
   384x640 unit-16 stage-2 training layout (L = 3068), through the kernels
   and through the plain version; relative L2 of the concatenated parameter
   gradient <= 5e-2, every parameter with a nonzero gradient, and exactly
   2 forward launches (forward and recompute) and one of each backward
   kernel per attention;
8. train: the serving models freed, ``create_train_state`` on that DiT (its
   output projection zeroed, as the JAX model initialises it) and three
   ``make_train_step`` steps at the JAX CLI's default shape (batch 4, 16
   latent frames of 48x80, units from ``sample_stage_length``, the CLI's lr
   schedule); finite losses and grad norms, at least one update applied that
   moves the parameters, exact kernel launch counts; step seconds and the
   peak memory printed.

Before the last line it prints one JSON object with each kernel's launches on
the main paths (serve and train, each counted from 0), its largest error
against the plain version, and its time and the plain version's at the
384x640 unit 15 stage 2 layout. The last line is ``{"ok": true, "device":
{...}}``. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

from pyramid_flow_tpu_torch.models.flux import blocks as flux_blocks
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.vae.model import CausalVideoVAE, VAEConfig
from pyramid_flow_tpu_torch.ops import flash_attention as fa
from pyramid_flow_tpu_torch.pipeline.noising import (
    GeneratorDraws, add_ar_noise_stage, latent_pyramid, sample_stage_length)
from pyramid_flow_tpu_torch.pipeline.packing import pack_clips, patchify
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.lr_schedules import cosine_schedule
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import make_train_step

SEED = 0
B, H, D = 2, 24, 64
TEXT_LEN, TEXT_VALID = 128, 100   # the prompt's last 28 tokens are masked
O_ATOL, LSE_ATOL, DIT_REL_L2 = 1e-2, 2e-3, 2e-2
GRAD_REL, DIT_GRAD_REL_L2 = 2e-2, 5e-2
BWD_D128 = ("384x640 u15 s2", 12, 128)  # (layout, heads, head dim)
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS = 4, 16, 3
LAYOUTS = (  # (name, height, width, unit, stage)
    ("384x640 u0 s0", 384, 640, 0, 0),
    ("384x640 u15 s2", 384, 640, 15, 2),
    ("768x1280 u15 s2", 768, 1280, 15, 2),
)
TIMED_LAYOUT = "384x640 u15 s2"
REQUESTS = (("a", 1), ("b", 4))  # (name, temp) at 384x640
STEPS, VIDEO_STEPS = [20, 20, 20], [10, 10, 10]


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def text_time(dev) -> torch.Tensor:
    t = torch.zeros(TEXT_LEN, dtype=torch.int32, device=dev)
    t[TEXT_VALID:] = fa.INVALID_TIME
    return t


def layout_time_ids(meta_pipe, height, width, unit, stage, dev):
    """[B, L] attention time ids of the DiT at one (unit, stage): the
    prompt, then the pipeline's own packed latent layout."""
    h_lat, w_lat = height // 8, width // 8
    budget = meta_pipe._cond_token_budget(unit, h_lat, w_lat)[stage]
    positions, time_ids, _ = meta_pipe._stage_metadata(
        B, 1, h_lat, w_lat, unit, stage, budget)
    t = torch.cat([text_time(dev), torch.as_tensor(time_ids, device=dev)])
    return positions, t[None].expand(B, -1).contiguous()


def rms_normal(shape, gen, dev):
    """bf16 rows of RMS 1, as the DiT's qk-norm makes them."""
    x = torch.randn(shape, generator=gen, device=dev)
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()


def plain_attention(q, k, v, t, causal, head_chunk=2):
    """The plain version, a few heads at a time so that the fp32 score
    matrix of the 12k-token layout fits."""
    outs = [fa.attention_reference(q[:, i:i + head_chunk],
                                   k[:, i:i + head_chunk],
                                   v[:, i:i + head_chunk], t, causal=causal,
                                   return_lse=True)
            for i in range(0, q.shape[1], head_chunk)]
    return (torch.cat([o for o, _ in outs], 1),
            torch.cat([lse for _, lse in outs], 1))


def kernel_vs_plain(meta_pipe, dev, gen):
    results = []
    for name, height, width, unit, stage in LAYOUTS:
        _, t = layout_time_ids(meta_pipe, height, width, unit, stage, dev)
        L = t.shape[1]
        q = rms_normal((B, H, L, D), gen, dev)
        k = rms_normal((B, H, L, D), gen, dev)
        v = torch.randn((B, H, L, D), generator=gen, device=dev).bfloat16()
        valid = t[0] != fa.INVALID_TIME
        reps = 20 if L <= 4096 else 5
        for causal in (True, False):
            o_ref, lse_ref = plain_attention(q, k, v, t, causal)
            plain_ms = cuda_ms(lambda: plain_attention(q, k, v, t, causal),
                               reps=3, warmup=1)
            for bounded in (True, False):
                def run():
                    return fa.flash_fwd_cuda(q, k, v, t, t, causal=causal,
                                             sm_scale=D ** -0.5,
                                             bounded=bounded)
                o, lse = run()
                torch.cuda.synchronize()
                do = (o.float() - o_ref.float())[:, :, valid].abs().max().item()
                dl = (lse - lse_ref)[:, :, valid].abs().max().item()
                ms = cuda_ms(run, reps)
                r = dict(layout=name, L=L, causal=causal, bounded=bounded,
                         max_abs_err_o=do, max_abs_err_lse=dl, ms=ms,
                         plain_ms=plain_ms)
                log("kernel vs plain " + json.dumps(r))
                if not (do <= O_ATOL and dl <= LSE_ATOL):
                    raise AssertionError(f"kernel disagrees with plain: {r}")
                results.append(r)
        del q, k, v, o_ref, lse_ref
        torch.cuda.empty_cache()
    return results


def plain_backward(q, k, v, t, o, lse, do, causal, head_chunk=2):
    """The plain backward in fp32, a few heads at a time."""
    outs = [fa.attention_backward_reference(
        q[:, i:i + head_chunk], k[:, i:i + head_chunk],
        v[:, i:i + head_chunk], t, t, o[:, i:i + head_chunk],
        lse[:, i:i + head_chunk], do[:, i:i + head_chunk], causal=causal)
        for i in range(0, q.shape[1], head_chunk)]
    return tuple(torch.cat([g[j] for g in outs], 1) for j in range(3))


def bwd_kernel_runs(q, k, v, t, o, lse, do, delta, causal):
    """One launch of each backward kernel, for timing: the library's entry
    points called directly (the wrapper launches both)."""
    lib = fa.bwd_kernel_library()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    b, h, l, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            t.data_ptr(), t.data_ptr(), lse.data_ptr(), delta.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def dkv():
        if lib.pf_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), b, h, l,
                                l, d, d ** -0.5, int(causal), stream):
            raise RuntimeError("flash_bwd_dkv launch failed")

    def dq_():
        if lib.pf_flash_bwd_dq(*ptrs, dq.data_ptr(), b, h, l, l, d, d ** -0.5,
                               int(causal), stream):
            raise RuntimeError("flash_bwd_dq launch failed")

    return dkv, dq_


def bwd_vs_plain(meta_pipe, dev, gen):
    """The backward kernels against the plain backward; upstream gradient
    zero on padded query rows (the backward's contract)."""
    cases = [(name, H, D) for name, *_ in LAYOUTS] + [BWD_D128]
    results = []
    for name, heads, d in cases:
        _, height, width, unit, stage = next(x for x in LAYOUTS
                                             if x[0] == name)
        _, t = layout_time_ids(meta_pipe, height, width, unit, stage, dev)
        L = t.shape[1]
        q = rms_normal((B, heads, L, d), gen, dev)
        k = rms_normal((B, heads, L, d), gen, dev)
        v = torch.randn((B, heads, L, d), generator=gen, device=dev).bfloat16()
        valid = (t != fa.INVALID_TIME)[:, None, :, None]
        reps = 20 if L <= 4096 else 5
        for causal in (True, False):
            o, lse = fa.flash_fwd_cuda(q, k, v, t, t, causal=causal,
                                       sm_scale=d ** -0.5, bounded=True)
            do = (torch.randn(o.shape, generator=gen, device=dev)
                  * valid).bfloat16()
            delta = (o.float() * do.float()).sum(-1)
            got = fa.flash_bwd_cuda(q, k, v, t, t, o, lse, do, delta,
                                    causal=causal, sm_scale=d ** -0.5)
            torch.cuda.synchronize()
            ref = plain_backward(q, k, v, t, o, lse, do, causal)
            r = dict(layout=name, L=L, heads=heads, d=d, causal=causal)
            for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - b.float()).abs().max().item()
                scale = b.float().abs().max().item()
                if not (torch.isfinite(a).all() and err <= GRAD_REL * scale):
                    raise AssertionError(
                        f"backward kernel disagrees on {gname}: {err} vs "
                        f"max|ref| {scale} at {r}")
                r[f"max_abs_err_{gname}"], r[f"max_abs_{gname}"] = err, scale
            dkv, dq_ = bwd_kernel_runs(q, k, v, t, o, lse, do, delta, causal)
            r["ms_dkv"] = cuda_ms(dkv, reps)
            r["ms_dq"] = cuda_ms(dq_, reps)
            r["plain_ms"] = cuda_ms(
                lambda: plain_backward(q, k, v, t, o, lse, do, causal),
                reps=3, warmup=1)
            log("backward kernels vs plain " + json.dumps(r))
            results.append(r)
            del o, lse, do, delta, got, ref
        del q, k, v
        torch.cuda.empty_cache()
    return results


@torch.no_grad()
def randomize_(module: torch.nn.Module, gen: torch.Generator, std=0.02):
    """N(0, std) for every weight and bias, 1 + N(0, std) for norm weights:
    no layer is zero, and q/k keep the RMS the qk-norm gives them."""
    for name, p in module.named_parameters():
        p.normal_(0.0, std, generator=gen)
        if p.dim() == 1 and "norm" in name and name.endswith("weight"):
            p.add_(1.0)


def dit_inputs(meta_pipe, dev, gen, cfg, dtype):
    positions, t = layout_time_ids(meta_pipe, 384, 640, 15, 2, dev)
    lat_time = t[:, TEXT_LEN:]
    lat_len = lat_time.shape[1]
    tokens = torch.randn((B, lat_len, cfg.in_channels), generator=gen,
                         device=dev).to(dtype)
    pos = torch.as_tensor(positions, device=dev)[None].expand(B, -1, -1)
    text = torch.randn((B, TEXT_LEN, cfg.joint_attention_dim), generator=gen,
                       device=dev).to(dtype)
    mask = text_time(dev)[None].expand(B, -1) == 0
    pooled = torch.randn((B, cfg.pooled_projection_dim), generator=gen,
                         device=dev).to(dtype)
    ts = torch.full((B,), 900.0, device=dev)
    return (tokens, pos, lat_time, text, mask, pooled, ts), lat_time[0]


@torch.no_grad()
def dit_check(dit, meta_pipe, dev, gen):
    inputs, lat_time = dit_inputs(meta_pipe, dev, gen, dit.config,
                                  next(dit.parameters()).dtype)
    before = fa.flash_fwd_cuda.launches
    out_k = dit(*inputs)
    torch.cuda.synchronize()
    launched = fa.flash_fwd_cuda.launches - before
    if launched != dit.num_attention_calls:
        raise AssertionError(f"{launched} kernel launches in one forward, "
                             f"expected {dit.num_attention_calls}")

    def plain(q, k, v, time_ids, *, causal, sm_scale, bounded):
        return fa.attention_reference(q, k, v, time_ids, causal=causal,
                                      sm_scale=sm_scale)

    with mock.patch.object(flux_blocks, "flash_attention", plain):
        out_p = dit(*inputs)
    torch.cuda.synchronize()
    valid = lat_time != fa.INVALID_TIME
    a, b = out_k[:, valid].float(), out_p[:, valid].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite DiT output")
    rel = ((a - b).norm() / b.norm()).item()
    log(f"full-width DiT forward, L={inputs[2].shape[1] + TEXT_LEN}: "
        f"kernel vs plain relative L2 {rel:.3e} (limit {DIT_REL_L2}), "
        f"|out| rms {b.square().mean().sqrt().item():.3e}")
    if not rel <= DIT_REL_L2:
        raise AssertionError(f"DiT kernel vs plain relative L2 {rel}")
    return rel


def training_batch(dit_cfg, dev, gen, batch):
    """The JAX CLI's default training shape at 384x640: latents [B, 16, 48,
    80, 16] N(0, 1), T5 features [B, 128, 4096] with 100 valid tokens,
    pooled [B, 768], null features of zeros."""
    lat = torch.randn((batch, TRAIN_FRAMES, 48, 80, 16), generator=gen,
                      device=dev)
    text = torch.randn((batch, TEXT_LEN, dit_cfg.joint_attention_dim),
                       generator=gen, device=dev)
    mask = (text_time(dev) == 0)[None].expand(batch, -1).contiguous()
    pooled = torch.randn((batch, dit_cfg.pooled_projection_dim),
                         generator=gen, device=dev)
    return {"latents": lat, "text_emb": text, "text_mask": mask,
            "pooled": pooled, "null_text_emb": torch.zeros_like(text),
            "null_pooled": torch.zeros_like(pooled)}


def launch_counts():
    return (fa.flash_fwd_cuda.launches, fa.flash_bwd_cuda.dkv_launches,
            fa.flash_bwd_cuda.dq_launches)


def reset_launch_counts():
    fa.flash_fwd_cuda.launches = 0
    fa.flash_bwd_cuda.dkv_launches = 0
    fa.flash_bwd_cuda.dq_launches = 0


def dit_grad_check(dit, dev, gen):
    """One training-loss backward of a batch row at the stage-2 training
    layout through the kernels and through the plain version."""
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    batch = training_batch(dit.config, dev, gen, 1)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    sb = add_ar_noise_stage(draws, sched, latent_pyramid(batch["latents"], 3),
                            2, 3, TRAIN_FRAMES)
    tokens, positions, time_ids, trainable = pack_clips(sb.clips)
    pos = torch.as_tensor(positions, device=dev)[None]
    times = torch.as_tensor(time_ids, device=dev)[None]
    target = patchify(sb.targets)
    L = TEXT_LEN + tokens.shape[1]

    def backward():
        dit.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            pred = dit(tokens, pos, times, batch["text_emb"],
                       batch["text_mask"], batch["pooled"], sb.timesteps)
            loss = (pred[:, -trainable:].float() - target.float()).square(
                ).mean()
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in dit.named_parameters()}
        dit.zero_grad(set_to_none=True)
        return loss.item(), grads

    reset_launch_counts()
    t0 = time.perf_counter()
    loss_k, gk = backward()
    kernel_s = time.perf_counter() - t0
    launched = launch_counts()
    n = dit.num_attention_calls
    if launched != (2 * n, n, n):
        raise AssertionError(f"launches (fwd, dkv, dq) {launched} in one "
                             f"remat forward+backward, expected "
                             f"{(2 * n, n, n)}")
    missing = [name for name, g in gk.items()
               if g is None or not bool((g != 0).any())]
    if missing:
        raise AssertionError(f"{len(missing)} parameters got no gradient "
                             f"through the kernels, e.g. {missing[:5]}")

    def plain(q, k, v, time_ids, *, causal, sm_scale, bounded):
        return fa.attention_reference(q, k, v, time_ids, causal=causal,
                                      sm_scale=sm_scale)

    with mock.patch.object(flux_blocks, "flash_attention", plain):
        t0 = time.perf_counter()
        loss_p, gp = backward()
        plain_s = time.perf_counter() - t0
    diff2 = ref2 = 0.0
    worst = ("", 0.0)
    for name, g in gk.items():
        d2 = (g - gp[name]).float().square().sum().item()
        r2 = gp[name].float().square().sum().item()
        diff2, ref2 = diff2 + d2, ref2 + r2
        if r2 > 0 and math.sqrt(d2 / r2) > worst[1]:
            worst = (name, math.sqrt(d2 / r2))
    rel = math.sqrt(diff2 / ref2)
    r = dict(L=L, loss_kernel=loss_k, loss_plain=loss_p, rel_l2=rel,
             worst_leaf=worst[0], worst_leaf_rel_l2=worst[1],
             launches_fwd=launched[0], launches_dkv=launched[1],
             launches_dq=launched[2], kernel_s=kernel_s, plain_s=plain_s)
    log("full-width DiT gradient, kernel vs plain " + json.dumps(r))
    if not (math.isfinite(rel) and rel <= DIT_GRAD_REL_L2):
        raise AssertionError(f"DiT gradient relative L2 {rel} > "
                             f"{DIT_GRAD_REL_L2}")
    return r


@torch.no_grad()
def zero_output_(dit):
    """A fresh DiT's zero output projection (``randomize_`` drew it): the
    loss starts at E[target^2], below the anomaly gate."""
    dit.proj_out.weight.zero_()
    dit.proj_out.bias.zero_()


def train(dit, dev, gen):
    """Three train steps of the release DiT at the CLI's default shape."""
    zero_output_(dit)
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(dit, TrainConfig(
        learning_rate=5e-5, weight_decay=1e-4, max_grad_norm=1.0,
        lr_schedule=cosine_schedule(5e-5, 1e-6, 1000, 10, 1000)))
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    step_fn = make_train_step(dit, sched, (1, 2, 1), True, 1, 1 / 3,
                              cfg_rate=0.1, compute_dtype=torch.bfloat16)
    batch = training_batch(dit.config, dev, gen, TRAIN_BATCH)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    steps = []
    reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        units = tuple(sample_stage_length(0, state.step, 3, 31, 1, 8,
                                          max_units=TRAIN_FRAMES))
        before = dit.proj_out.weight.detach().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, draws, units)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        moved = not torch.equal(before, dit.proj_out.weight)
        r = dict(step=state.step, units=units, loss=m["train/loss"],
                 grad_norm=m["train/grad_norm"], applied=m["train/applied"],
                 moved=moved, lr_count=state.opt_count, seconds=seconds)
        log("train step " + json.dumps(r))
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"non-finite train step {r}")
        steps.append(r)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    attentions = dit.num_attention_calls * 3 * TRAIN_STEPS  # 3 stage forwards
    if launched != (2 * attentions, attentions, attentions):
        raise AssertionError(f"train launches (fwd, dkv, dq) {launched}, "
                             f"expected {(2 * attentions, attentions, attentions)}")
    if not any(r["applied"] and r["moved"] for r in steps):
        raise AssertionError("no train step passed the anomaly gate and "
                             "moved the parameters")
    log(f"train: peak memory {peak:.3f} GB, launches (fwd, dkv, dq) "
        f"{launched}")
    return steps, launched, peak


def serve(pipe, dev, gen, name, temp):
    cfg = pipe.dit.config
    emb = torch.randn((1, TEXT_LEN, cfg.joint_attention_dim), generator=gen,
                      device=dev).to(pipe.dtype)
    mask = (text_time(dev) == 0)[None]
    pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen,
                         device=dev).to(pipe.dtype)
    seen = []
    decode = pipe.decode_latent

    def spy(latents, plan):
        seen.append(latents)
        return decode(latents, plan)

    forwards = sum(STEPS) + (temp - 1) * sum(VIDEO_STEPS)
    before = fa.flash_fwd_cuda.launches
    torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(pipe, "decode_latent", spy):
        t0 = time.perf_counter()
        frames = pipe.generate(
            torch.Generator(dev).manual_seed(SEED + temp), emb, mask, pooled,
            emb * 0, mask, pooled * 0, height=384, width=640, temp=temp,
            num_inference_steps=STEPS, video_num_inference_steps=VIDEO_STEPS,
            guidance_scale=7.0, video_guidance_scale=5.0,
            output_type="pixels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = fa.flash_fwd_cuda.launches - before
    expect = (1, 1 + 8 * (temp - 1), 384, 640, 3)
    if tuple(frames.shape) != expect or frames.dtype != torch.uint8:
        raise AssertionError(f"frames {tuple(frames.shape)} {frames.dtype}, "
                             f"expected {expect} uint8")
    if not torch.isfinite(seen[0]).all():
        raise AssertionError("non-finite latents")
    if frames.min() == frames.max():
        raise AssertionError("constant frames")
    if launched != pipe.dit.num_attention_calls * forwards:
        raise AssertionError(f"{launched} kernel launches for {forwards} DiT "
                             "forwards")
    r = dict(request=name, temp=temp, frames=expect[1], dit_forwards=forwards,
             kernel_launches=launched, wall_s=wall,
             dit_s=pipe.last_dit_seconds, decode_s=pipe.last_decode_seconds,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             latent_rms=seen[0].square().mean().sqrt().item(),
             frame_std=frames.float().std().item())
    log("request " + json.dumps(r))
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        libs = {"flash_fwd": pool.submit(fa.kernel_library),
                "flash_bwd": pool.submit(fa.bwd_kernel_library)}
        libs = {name: f.result() for name, f in libs.items()}
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        log(f"build {name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log("  " + line.strip())

    gen = torch.Generator(dev).manual_seed(SEED)
    meta_pipe = PyramidFlowPipeline(None, device=dev)
    checks = kernel_vs_plain(meta_pipe, dev, gen)
    bwd_checks = bwd_vs_plain(meta_pipe, dev, gen)

    t0 = time.perf_counter()
    dit = PyramidFluxTransformer(FluxConfig(), dtype=torch.bfloat16,
                                 device=dev)
    randomize_(dit, gen)
    vae = CausalVideoVAE(VAEConfig(), dtype=torch.bfloat16, device=dev)
    randomize_(vae, gen)
    torch.cuda.synchronize()
    log(f"models: DiT {sum(p.numel() for p in dit.parameters()) / 1e9:.3f} B "
        f"params, VAE {sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M "
        f"params, built in {time.perf_counter() - t0:.1f} s")
    dit_check(dit, meta_pipe, dev, gen)

    pipe = PyramidFlowPipeline(dit, vae, dtype=torch.bfloat16, device=dev)
    reset_launch_counts()  # count the serving path's launches only
    requests = [serve(pipe, dev, gen, name, temp) for name, temp in REQUESTS]
    serve_launches = launch_counts()
    forwards = sum(r["dit_forwards"] for r in requests)
    if serve_launches != (dit.num_attention_calls * forwards, 0, 0):
        raise AssertionError(f"{serve_launches} launches on the serving path")

    # training: free the serving models first
    del pipe, dit, vae
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tdit = PyramidFluxTransformer(FluxConfig(), dtype=torch.float32,
                                  device=dev, remat=True)
    randomize_(tdit, gen)
    torch.cuda.synchronize()
    log(f"training DiT: fp32 parameters, remat, built in "
        f"{time.perf_counter() - t0:.1f} s")
    dit_grad_check(tdit, dev, gen)
    _, train_launches, _ = train(tdit, dev, gen)

    timed = next(r for r in checks if r["layout"] == TIMED_LAYOUT
                 and r["causal"] and r["bounded"])
    btimed = next(r for r in bwd_checks if r["layout"] == TIMED_LAYOUT
                  and r["d"] == D and r["causal"])
    log(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:207",
        "launches": serve_launches[0] + train_launches[0],
        "max_abs_err": max(r["max_abs_err_o"] for r in checks),
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
    }, {
        "name": "flash_bwd_dkv",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:447",
        "launches": train_launches[1],
        "max_abs_err": max(max(r["max_abs_err_dk"], r["max_abs_err_dv"])
                           for r in bwd_checks),
        "ms": btimed["ms_dkv"],
        "plain_ms": btimed["plain_ms"],
    }, {
        "name": "flash_bwd_dq",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:514",
        "launches": train_launches[2],
        "max_abs_err": max(r["max_abs_err_dq"] for r in bwd_checks),
        "ms": btimed["ms_dq"],
        "plain_ms": btimed["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
