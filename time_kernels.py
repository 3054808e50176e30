#!/usr/bin/env python3
"""Time the forward kernels (K1, K2, K6 at hs=2), the backward (K3 and K4,
and the delta kernel where the checkout has one) and the conv kernel (K5) of
one checkout as its paths call them, so that a parent commit and a change
can be compared on one card in one call.

    python3 time_kernels.py [--root DIR] [--reps 20]

``pyramid_flow_tpu_torch`` is imported from ``--root`` (default: this
checkout), every input and timer from this checkout's ``chip_smoke.py``, so
both sides run the same timing code on the same inputs: unpack the parent
with ``git archive`` into a gitignored directory and run parent, change,
change, parent. Each wrapper is called back to back between two CUDA events
(``ms``) at ``chip_smoke.py``'s timed shapes, the 384x640 unit 15 stage 2
attention layout (B=2, H=24, D=64, L=3072, causal) and ``TIMED_CONV``;
beside it, the kernel's own device time from a profiler trace of the same
calls (``kernel_ms``; for the forwards also every kernel a call launches,
``by_kernel``, and their sum, ``device_ms``), and SDPA with the time-id mask
and cuDNN's ``F.conv3d`` on the same inputs. The backward is timed as the
training path calls it: ``torch.autograd.grad`` through ``flash_attention``
less its forward (``chip_smoke.bwd_path_ms``), beside SDPA's backward timed
the same way, and every kernel a forward plus backward launches
(``by_kernel``). K6 is also timed at every hs whose block fits
(``flash_fwd_hn_by_hs``), and K1 and K6 at the short 384x640 unit 0 stage 0
layout (``stage0``). Prints the card's name and power limit, then
one JSON object. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONV_REPS = 10


def load_smoke(root: Path):
    """This checkout's ``chip_smoke`` module, bound to the package under
    ``root``."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def time_attention(smoke, dev, gen, reps: int) -> dict:
    torch, fa = smoke.torch, smoke.fa
    meta_pipe = smoke.PyramidFlowPipeline(None, device=dev)
    _, t = smoke.layout_time_ids(meta_pipe, smoke.HEIGHT, smoke.WIDTH, 15, 2,
                                 dev)
    b, h, d, L = smoke.B, smoke.H, smoke.D, t.shape[1]
    q = smoke.rms_normal((b, h, L, d), gen, dev)
    k = smoke.rms_normal((b, h, L, d), gen, dev)
    v = torch.randn((b, h, L, d), generator=gen, device=dev).bfloat16()
    mask = smoke.sdpa_mask(t, True)
    out = dict(L=L, sdpa_ms=smoke.cuda_ms(
        lambda: smoke.F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        reps))
    calls = (
        ("flash_fwd", "flash_fwd_kernel", lambda: fa.flash_fwd_cuda(
            q, k, v, t, t, causal=True, sm_scale=d ** -0.5, bounded=True)),
        ("flash_fwd_classic", "flash_fwd_kernel", lambda: fa.flash_fwd_cuda(
            q, k, v, t, t, causal=True, sm_scale=d ** -0.5, bounded=False)),
        ("flash_fwd_hn", "flash_fwd_hn_kernel", lambda: fa.flash_fwd_hn_cuda(
            q, k, v, t, t, causal=True, sm_scale=d ** -0.5,
            hs=smoke.HN_TIMED_HS)))
    for name, kernel, fn in calls:
        by_kernel = smoke.device_ms_by_kernel(fn, reps)
        out[name] = dict(
            ms=smoke.cuda_ms(fn, reps),
            kernel_ms=sum(ms for kname, ms in by_kernel.items()
                          if kernel in kname),
            device_ms=sum(by_kernel.values()),
            by_kernel={kname[:80]: ms for kname, ms in by_kernel.items()})
    # K6 at every hs whose block fits the card
    out["flash_fwd_hn_by_hs"] = {}
    for hs in fa.HN_HEADS_PER_BLOCK:
        if not fa.flash_fwd_hn_resources(hs, True)["fits"]:
            continue

        def fn(hs=hs):
            return fa.flash_fwd_hn_cuda(q, k, v, t, t, causal=True,
                                        sm_scale=d ** -0.5, hs=hs)
        out["flash_fwd_hn_by_hs"][hs] = dict(
            ms=smoke.cuda_ms(fn, reps),
            kernel_ms=smoke.kernel_device_ms(fn, reps,
                                             "flash_fwd_hn_kernel"))

    # the backward: upstream gradient zero on padded rows, its contract
    valid = (t != fa.INVALID_TIME)[:, None, :, None]
    do = (torch.randn(q.shape, generator=gen, device=dev) * valid).bfloat16()
    timed, by_kernel = smoke.bwd_path_ms(q, k, v, t, do, True, reps)
    out["flash_bwd"] = dict(
        timed, by_kernel={kname[:80]: ms for kname, ms in by_kernel.items()})
    out["sdpa_bwd_ms"] = smoke.sdpa_backward_ms(q, k, v, t, do, True,
                                                reps)["library_ms"]
    out["stage0"] = time_stage0(smoke, meta_pipe, dev, gen, reps)
    return out


def time_stage0(smoke, meta_pipe, dev, gen, reps: int) -> dict:
    """K1 and K6 (hs=2) at the short 384x640 unit 0 stage 0 layout, causal,
    where a grid of 64-row q-tiles has fewer blocks than the card has SMs
    for K6's blocks of two heads."""
    torch, fa = smoke.torch, smoke.fa
    _, t = smoke.layout_time_ids(meta_pipe, smoke.HEIGHT, smoke.WIDTH, 0, 0,
                                 dev)
    b, h, d, L = smoke.B, smoke.H, smoke.D, t.shape[1]
    q, k = (smoke.rms_normal((b, h, L, d), gen, dev) for _ in range(2))
    v = torch.randn((b, h, L, d), generator=gen, device=dev).bfloat16()
    calls = (
        ("flash_fwd", "flash_fwd_kernel", lambda: fa.flash_fwd_cuda(
            q, k, v, t, t, causal=True, sm_scale=d ** -0.5, bounded=True)),
        ("flash_fwd_hn", "flash_fwd_hn_kernel", lambda: fa.flash_fwd_hn_cuda(
            q, k, v, t, t, causal=True, sm_scale=d ** -0.5,
            hs=smoke.HN_TIMED_HS)))
    out = dict(L=L)
    for name, kernel, fn in calls:
        out[name] = dict(ms=smoke.cuda_ms(fn, reps),
                         kernel_ms=smoke.kernel_device_ms(fn, reps, kernel))
    return out


def time_conv(smoke, dev, gen) -> dict:
    torch, cc = smoke.torch, smoke.cc
    b, t, h, w, c, co, _ = smoke.TIMED_CONV
    weight = (torch.randn((co, c, 3, 3, 3), generator=gen, device=dev)
              / math.sqrt(27 * c)).bfloat16()
    weight = weight.contiguous(memory_format=torch.channels_last_3d)
    bias = (0.1 * torch.randn((co,), generator=gen, device=dev)).bfloat16()
    x = torch.randn((b, t, h, w, c), generator=gen, device=dev).bfloat16()
    front = torch.randn((b, 2, h, w, c), generator=gen, device=dev).bfloat16()

    def fn():
        return cc.causal_conv3d_cuda(x, weight, bias, front)
    xl = torch.cat([front, x], 1).permute(0, 4, 1, 2, 3)
    return dict(ms=smoke.cuda_ms(fn, CONV_REPS),
                kernel_ms=smoke.kernel_device_ms(fn, CONV_REPS,
                                                 "causal_conv3d_kernel"),
                cudnn_ms=smoke.cuda_ms(lambda: smoke.F.conv3d(
                    xl, weight, bias, padding=(0, 1, 1)), CONV_REPS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose pyramid_flow_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20,
                    help="wrapper calls per attention timing")
    args = ap.parse_args(argv)
    smoke = load_smoke(args.root.resolve())
    torch = smoke.torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smoke.log(smoke.card_line())
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    out = dict(package=str(Path(smoke.fa.__file__).resolve().parents[2]),
               attention=time_attention(smoke, dev, gen, args.reps))
    torch.cuda.empty_cache()
    out["causal_conv3d"] = time_conv(smoke, dev, gen)
    smoke.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
