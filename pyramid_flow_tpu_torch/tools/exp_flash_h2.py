"""Experiment: the bounded flash forward with ``hs`` heads per block.

    python -m pyramid_flow_tpu_torch.tools.exp_flash_h2 [--iters 8] [--full]

The counterpart of the JAX package's ``tools/exp_flash_h2.py``, on the CUDA
card: the heads-per-block forward (``csrc/flash_fwd_hn.cu``) is checked
against the plain attention at a mixed layout (text, four frames, INVALID
padding) and on rows with no visible key, then timed at the 768p final-unit
stage-2 layout (B=2, H=24, D=64, L=11008) at every ``hs`` it is built for,
beside the one-head-per-block forward (``flash_fwd_cuda``). An ``hs`` whose
block does not fit the card is reported as such and not launched. The
question is the JAX tool's: whether grouping heads in one block makes the
forward faster. With ``--full`` both forwards are then timed once more at
that layout with every time id equal, so that every tile is FULL (no mask
to apply, none to skip): the ceiling that shows what the masking costs.
Results print as one JSON object per line. Without a CUDA device it exits
1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ..ops.flash_attention import (
    HN_HEADS_PER_BLOCK,
    INVALID_TIME,
    attention_reference,
    flash_fwd_cuda,
    flash_fwd_hn_cuda,
    flash_fwd_hn_resources,
)

__all__ = ["flash_h2", "reference_lse", "layout_768p_stage2", "median_ms",
           "main"]

# the JAX tool's correctness thresholds (max |err| on valid rows)
O_TOL, LSE_TOL = 0.035, 0.02
WARMUP = 2
FULL_HS = 2  # the heads per block ``--full`` times (the JAX tool's)


def flash_h2(q, k, v, time_q, time_kv=None, *, causal=True, sm_scale=None,
             return_lse=False, hs=2):
    """The bounded forward with ``hs`` heads per block for CUDA tensors, its
    plain version for CPU tensors. q, k, v ``[B, H, L, D]``, time ids
    ``[B, L]``. Returns o, or ``(o, lse)`` with ``return_lse``."""
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        o, lse = attention_reference(q, k, v, time_q, time_kv, causal=causal,
                                     sm_scale=sm_scale, return_lse=True)
    else:
        o, lse = flash_fwd_hn_cuda(q, k, v, time_q, time_kv, causal=causal,
                                   sm_scale=sm_scale, hs=hs)
    return (o, lse) if return_lse else o


def reference_lse(q, k, time_q, time_kv=None, *, causal=True, sm_scale=None):
    """Natural-log row logsumexp ``[B, H, Lq]`` fp32 with the attention's
    mask; rows with no visible key get the kernel's 3e38."""
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = (time_kv != INVALID_TIME)[:, None, None, :]
    if causal:
        mask = mask & (time_kv[:, None, None, :] <= time_q[:, None, :, None])
    mask = mask.expand(s.shape)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(mask.any(-1), lse, torch.full_like(lse, 3e38))


def layout_768p_stage2(device="cuda", seed=0):
    """The 768p final-unit stage-2 layout: text (128 tokens, t=0), 7000
    history tokens over frames 1-15, INVALID padding to a multiple of 512,
    and the current clip's 3840 tokens at t=16. Returns (q [2, 24, L, 64]
    bf16, N(0, 0.3^2) from a seeded generator; time ids [2, L] int32; L)."""
    b, nh, d = 2, 24, 64
    h_lat, w_lat = 96, 160
    cur = (h_lat // 2) * (w_lat // 2)
    cond = 7000
    budget = -(-(128 + cond) // 512) * 512
    pad = budget - 128 - cond
    L = budget + cur
    hist = np.repeat(np.arange(1, 16, dtype=np.int32), -(-cond // 15))[:cond]
    t = np.concatenate([np.zeros(128, np.int32), hist,
                        np.full(pad, INVALID_TIME, np.int32),
                        np.full(cur, 16, np.int32)])
    gen = torch.Generator(device).manual_seed(seed)
    q = (torch.randn((b, nh, L, d), generator=gen, device=device) * 0.3
         ).bfloat16()
    tq = torch.as_tensor(t, dtype=torch.int32, device=device)[None].repeat(
        b, 1)
    return q, tq, L


def median_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches after
    ``WARMUP`` (CUDA events)."""
    for _ in range(WARMUP):
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


def check(dev) -> list:
    """The JAX tool's checks at its default hs=2: the mixed layout (b=2,
    nh=4, L=640) causal and not against the plain attention, and rows with
    no visible key. Raises on a mismatch; returns the errors."""
    hs = 2
    b, nh, L, d = 2, 4, 640, 64
    gens = [torch.Generator(dev).manual_seed(s) for s in (1, 2, 3)]
    q, k = ((torch.randn((b, nh, L, d), generator=g, device=dev) * 0.3
             ).bfloat16() for g in gens[:2])
    v = torch.randn((b, nh, L, d), generator=gens[2], device=dev).bfloat16()
    t = np.concatenate([np.zeros(64, np.int32), np.repeat(np.arange(1, 5), 96),
                        np.full(L - 64 - 384, INVALID_TIME, np.int32)])
    tq = torch.as_tensor(t, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    valid = torch.as_tensor(t != INVALID_TIME, device=dev)
    out = []
    for causal in (True, False):
        got, got_lse = flash_h2(q, k, v, tq, causal=causal, return_lse=True,
                                hs=hs)
        want = attention_reference(q, k, v, tq, causal=causal)
        want_lse = reference_lse(q, k, tq, causal=causal)
        err = (got.float() - want.float())[:, :, valid].abs().max().item()
        lse_err = (got_lse - want_lse)[:, :, valid].abs().max().item()
        r = dict(check="mixed layout", hs=hs, causal=causal, max_abs_err=err,
                 max_abs_lse_err=lse_err)
        print(json.dumps(r), flush=True)
        if not (err < O_TOL and lse_err < LSE_TOL):
            raise AssertionError(f"heads-per-block forward mismatch: {r}")
        out.append(r)
    # every key invisible: o == 0 and lse == 3e38
    tq_v = torch.ones((b, L), dtype=torch.int32, device=dev)
    tk_inv = torch.full((b, L), INVALID_TIME, dtype=torch.int32, device=dev)
    o_e, lse_e = flash_h2(q, k, v, tq_v, tk_inv, causal=False,
                          return_lse=True, hs=hs)
    r = dict(check="empty rows", hs=hs, lse_sentinel=bool(
        (lse_e == 3e38).all()), o_zero=bool((o_e == 0).all()))
    print(json.dumps(r), flush=True)
    if not (r["lse_sentinel"] and r["o_zero"]):
        raise AssertionError(f"empty-row handling: {r}")
    return out + [r]


def sweep(dev, iters: int, full: bool = False) -> list:
    """The one-head-per-block forward and the heads-per-block forward at
    each hs at the 768p stage-2 layout (causal, self-attention on q as the
    JAX tool does), each timed over ``iters`` launches after ``WARMUP``.
    ``full``: the JAX tool's ``--full`` ceiling, every time id equal (every
    key visible to every query, every tile FULL) and only ``FULL_HS``."""
    q, tq, L = layout_768p_stage2(dev)
    tag = {}
    if full:
        tq, tag = torch.ones_like(tq), dict(tiles="full")
    sm_scale = q.shape[-1] ** -0.5
    base = median_ms(lambda: flash_fwd_cuda(q, q, q, tq, tq, causal=True,
                                           sm_scale=sm_scale, bounded=True),
                    iters)
    rows = [dict(kernel="flash_fwd", **tag, L=L, ms=base)]
    print(json.dumps(rows[0]), flush=True)
    for hs in (FULL_HS,) if full else HN_HEADS_PER_BLOCK:
        res = flash_fwd_hn_resources(hs, True)
        r = dict(kernel="flash_fwd_hn", hs=hs, **tag, L=L,
                 registers=res["registers"], threads=res["threads"],
                 max_threads=res["max_threads"],
                 shared_bytes=res["shared_bytes"])
        if res["fits"]:
            r["ms"] = median_ms(lambda: flash_h2(q, q, q, tq, hs=hs), iters)
            r["speedup_vs_flash_fwd"] = base / r["ms"]
        else:
            r["result"] = "does not fit"
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=8,
                    help="timed launches per kernel")
    ap.add_argument("--full", action="store_true",
                    help="also time both forwards with every tile FULL")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_flash_h2: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(dev)}), flush=True)
    check(dev)
    sweep(dev, args.iters)
    if args.full:
        sweep(dev, args.iters, full=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
