"""Experiment: does a stacked-channel 2D conv beat the conv the VAE decode
runs, on one CUDA card?

    python -m pyramid_flow_tpu_torch.tools.exp_conv_stack [--iters 6]

The counterpart of the JAX package's ``tools/exp_conv_stack.py``, at its
decode shapes (``[1, T + 2, H, W, C]`` bf16 with the two front frames in
front, C -> C, 3x3x3): the causal conv as

* ``k5``: the conv kernel the decode runs (``causal_conv3d_cuda``, the
  front frames as its own operand);
* ``cudnn``: ``F.conv3d`` on the front-padded input (channels-last);
* ``tap_summed``: three per-tap ``F.conv2d`` calls over the frames, summed
  (the JAX package's form for narrow convs);
* ``stacked``: one ``F.conv2d`` over the three taps stacked along the
  channels (tap-major), the JAX experiment's hypothesis.

Each is first held to the conv's plain version (``causal_conv3d_reference``
in fp32) within 2e-2 of its largest magnitude, then timed with CUDA events
(the median of ``--iters`` calls after two, ``exp_flash_h2``'s timer),
with its rate. Results print as one JSON object per line, with a verdict per
shape. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..ops.causal_conv3d import causal_conv3d_cuda, causal_conv3d_reference
from .exp_flash_h2 import median_ms

__all__ = ["SHAPES", "VARIANTS", "run", "main"]

# (name, T out, H, W, C): the JAX tool's per-(tile, window) decode shapes of
# the 768p request (384-pixel tiles, windows of 2 latent frames)
SHAPES = (("up3_128ch", 16, 384, 384, 128),
          ("up2_256ch", 8, 192, 192, 256),
          ("up1_512ch", 4, 96, 96, 512),
          ("up0_512ch", 2, 48, 48, 512))
REL_TOL = 2e-2  # max |err| over max |plain|, the JAX tool's limit


def k5(x, w, bias):
    """The conv kernel: x ``[B, T + 2, H, W, C]``, its first two frames the
    front. Returns ``[B, T, H, W, Co]``."""
    return causal_conv3d_cuda(x[:, 2:], w, bias, x[:, :2])


def cudnn(x, w, bias):
    """``F.conv3d`` on the front-padded frames (channels-last)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias, padding=(0, 1, 1))
    return y.permute(0, 2, 3, 4, 1)


def tap_summed(x, w, bias):
    """Three 2D convs, one per temporal tap, over every output frame,
    summed."""
    b, tp, h, wd, c = x.shape
    t = tp - 2
    out = None
    for tap in range(3):
        xt = x[:, tap:tap + t].reshape(b * t, h, wd, c).permute(0, 3, 1, 2)
        o = F.conv2d(xt, w[:, :, tap], bias if tap == 0 else None,
                     padding=1)
        out = o if out is None else out + o
    return out.permute(0, 2, 3, 1).reshape(b, t, h, wd, -1)


def stacked(x, w, bias):
    """One 2D conv over the three taps stacked along the channels:
    ``xs[t, ..., tap * C + c] = x[t + tap, ..., c]``."""
    b, tp, h, wd, c = x.shape
    t = tp - 2
    xs = torch.cat([x[:, 0:t], x[:, 1:t + 1], x[:, 2:t + 2]], dim=-1)
    xs = xs.reshape(b * t, h, wd, 3 * c).permute(0, 3, 1, 2)
    wk = w.permute(0, 2, 1, 3, 4).reshape(w.shape[0], 3 * c, 3, 3)
    o = F.conv2d(xs, wk.contiguous(memory_format=torch.channels_last), bias,
                 padding=1)
    return o.permute(0, 2, 3, 1).reshape(b, t, h, wd, -1)


VARIANTS = {"k5": k5, "cudnn": cudnn, "tap_summed": tap_summed,
            "stacked": stacked}


@torch.no_grad()
def run(dev, iters: int, gen: torch.Generator, shapes=SHAPES) -> list:
    """Every variant at every shape: its error against the plain version
    (raises above ``REL_TOL``), milliseconds and TFLOP/s; then the shape's
    verdict (the fastest, and its speed against ``k5``)."""
    rows = []
    for name, t, h, w, c in shapes:
        x = torch.randn((1, t + 2, h, w, c), generator=gen, device=dev
                        ).bfloat16()
        wt = (torch.randn((c, c, 3, 3, 3), generator=gen, device=dev)
              * 0.05).bfloat16().contiguous(
                  memory_format=torch.channels_last_3d)
        bias = torch.zeros(c, dtype=torch.bfloat16, device=dev)
        ref = causal_conv3d_reference(x[:, 2:].float(), wt.float(),
                                      bias.float(), x[:, :2].float())
        scale = ref.abs().max().item()
        flops = 2 * 27 * c * c * t * h * w
        times = {}
        for vname, fn in VARIANTS.items():
            err = (fn(x, wt, bias).float() - ref).abs().max().item() / scale
            if not err < REL_TOL:
                raise AssertionError(f"{name} {vname}: relative error {err}")
            ms = median_ms(lambda: fn(x, wt, bias), iters)
            times[vname] = ms
            rows.append(dict(shape=name, variant=vname, t=t, h=h, w=w, c=c,
                             ms=ms, tflops=flops / ms / 1e9, rel_err=err))
            print(json.dumps(rows[-1]), flush=True)
        best = min(times, key=times.get)
        rows.append(dict(shape=name, verdict=best,
                         k5_over_best=times["k5"] / times[best]))
        print(json.dumps(rows[-1]), flush=True)
        del x, wt, ref
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_conv_stack: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(dev)}), flush=True)
    # the library convs in bf16 as the decode runs them; no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    run(dev, args.iters, torch.Generator(dev).manual_seed(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
