#!/usr/bin/env python3
"""Run the PyTorch port's text-to-video main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: its name and power limit as nvidia-smi reports them;
2. build: the CUDA flash-attention kernel from ``pyramid_flow_tpu_torch/csrc``;
3. kernel vs plain: the kernel against the plain PyTorch version on the
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
   grow by exactly 57 per DiT forward.

Before the last line it prints one JSON object with the kernel's launches on
the main path, its largest error against the plain version, and its time and
the plain version's at the main path's longest 384x640 layout. The last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

from pyramid_flow_tpu_torch.models.flux import blocks as flux_blocks
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.vae.model import CausalVideoVAE, VAEConfig
from pyramid_flow_tpu_torch.ops import flash_attention as fa
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)

SEED = 0
B, H, D = 2, 24, 64
TEXT_LEN, TEXT_VALID = 128, 100   # the prompt's last 28 tokens are masked
O_ATOL, LSE_ATOL, DIT_REL_L2 = 1e-2, 2e-3, 2e-2
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
    lib = fa.kernel_library()
    log(f"build flash_fwd: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s)")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    gen = torch.Generator(dev).manual_seed(SEED)
    meta_pipe = PyramidFlowPipeline(None, device=dev)
    checks = kernel_vs_plain(meta_pipe, dev, gen)

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
    fa.flash_fwd_cuda.launches = 0  # count the main path's launches only
    requests = [serve(pipe, dev, gen, name, temp) for name, temp in REQUESTS]
    launches = fa.flash_fwd_cuda.launches
    forwards = sum(r["dit_forwards"] for r in requests)
    if launches == 0 or launches != dit.num_attention_calls * forwards:
        raise AssertionError(f"{launches} launches on the main path")

    timed = next(r for r in checks if r["layout"] == TIMED_LAYOUT
                 and r["causal"] and r["bounded"])
    log(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:207",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err_o"] for r in checks),
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
