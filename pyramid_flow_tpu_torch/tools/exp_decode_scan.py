"""Experiment: what each window's dispatch costs in the windowed VAE decode
on one CUDA card.

    python -m pyramid_flow_tpu_torch.tools.exp_decode_scan [--iters 3]
        [--temp 17]

The counterpart of the JAX package's ``tools/exp_decode_scan.py``, which
folds the uniform continuation windows of a tile's decode into one
``lax.scan`` program. The card's form: ``loop_w2`` is ``chunk_decode``
(window 2, every window's kernels launched from the host), ``graph_w2``
decodes the first window the same way and replays one CUDA graph per
continuation window (:class:`GraphDecode`). Both decode a random 17-frame
latent of one 384-pixel tile (48 x 48 latent) with the release VAE (bf16,
random weights from a seed); the frames must be equal bit for bit. Each
reports the least wall seconds (synchronised), the host seconds until the
call returned (the enqueue) and the device milliseconds (CUDA events), in
total and per window. Results print as one JSON object per line. Without a
CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models.vae.model import _window_starts, chunk_decode
from ..ops.causal_conv3d import causal_conv3d_cuda
from .profile_768p import build_models

__all__ = ["GraphDecode", "time_decode", "run", "main"]

TILE = 48  # latent pixels: one 384-pixel tile of the 768p decode


class GraphDecode:
    """``chunk_decode(vae, z, window)`` with the continuation windows
    replayed from one CUDA graph.

    The conv kernel's tensor maps hold its operands' addresses and are
    baked into the captured launches, so every tensor a window reads is a
    static buffer: the window's latent (``static_z``) and every conv's
    carried frames (``static_state``); the graph copies each conv's new
    carry into its static buffer at the end. One eager continuation window
    on a side stream comes first (the kernels' shared-memory opt-in and the
    libraries' lazy set-up must not happen under capture). Built for one
    latent shape ``[B, T, h, w, C]``; a last window shorter than ``window``
    runs eagerly. The conv kernel counts the launches it records under
    capture apart from those it makes (``causal_conv3d_cuda.captured``);
    each replay adds the graph's conv launches (``graph_launches``) to
    ``causal_conv3d_cuda.launches``, since that is when they run."""

    @torch.no_grad()
    def __init__(self, vae, z: torch.Tensor, window: int = 2):
        self.vae, self.window = vae, window
        b, _, h, w, c = z.shape
        self.shape = (b, h, w, c)
        state: dict = {}
        vae.decode(z[:, :1], state, is_init=True)
        self.static_z = z[:, 1:1 + window].clone()
        self.static_state = {k: v.clone() for k, v in state.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm = {k: v.clone() for k, v in state.items()}
            vae.decode(self.static_z, warm, is_init=False)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        captured = causal_conv3d_cuda.captured
        with torch.cuda.graph(self.graph):
            carry = dict(self.static_state)
            self.static_out = vae.decode(self.static_z, carry,
                                         is_init=False)
            for k, buf in self.static_state.items():
                buf.copy_(carry[k])
        self.graph_launches = causal_conv3d_cuda.captured - captured
        self.replays = 0

    @torch.no_grad()
    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        b, _, h, w, c = z.shape
        if (b, h, w, c) != self.shape:
            raise ValueError(f"built for {self.shape}, got {tuple(z.shape)}")
        state: dict = {}
        outs = [self.vae.decode(z[:, :1], state, is_init=True)]
        for k, buf in self.static_state.items():
            buf.copy_(state[k])
        for s, e in _window_starts(z.shape[1], self.window, 1)[1:]:
            if e - s == self.window:
                self.static_z.copy_(z[:, s:e])
                self.graph.replay()
                causal_conv3d_cuda.launches += self.graph_launches
                self.replays += 1
                outs.append(self.static_out.clone())
            else:  # a short last window
                rest = {k: v.clone() for k, v in self.static_state.items()}
                outs.append(self.vae.decode(z[:, s:e], rest, is_init=False))
        return torch.cat(outs, dim=1)


def time_decode(fn, iters: int, windows: int):
    """The least wall seconds (synchronised), the host seconds until ``fn``
    returned and the device milliseconds (CUDA events) over ``iters``
    calls after one, in total and per window; and the last call's
    frames."""
    out = fn()
    best = None
    for _ in range(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
        r = dict(wall_s=time.perf_counter() - t0, host_s=host_s,
                 device_ms=start.elapsed_time(end))
        if best is None or r["wall_s"] < best["wall_s"]:
            best = r
    best.update({f"{k}_per_window": v / windows
                 for k, v in list(best.items())})
    return best, out


@torch.no_grad()
def run(vae, z: torch.Tensor, iters: int, window: int = 2) -> dict:
    """``loop_w2`` against ``graph_w2`` on ``z``: each one's times (printed
    as JSON lines) and whether their frames are equal bit for bit. Where
    the graph cannot be captured, the eager times and the reason."""
    windows = len(_window_starts(z.shape[1], window, 1))
    loop, ref = time_decode(lambda: chunk_decode(vae, z, window), iters,
                            windows)
    loop.update(variant=f"loop_w{window}", windows=windows)
    print(json.dumps(loop), flush=True)
    result = {"loop": loop}
    try:
        graph_decode = GraphDecode(vae, z, window)
    except RuntimeError as e:  # capture refused: report why
        result["graph_error"] = f"{type(e).__name__}: {e}"[:400]
        print(json.dumps(dict(variant=f"graph_w{window}",
                              error=result["graph_error"])), flush=True)
        return result
    graph, out = time_decode(lambda: graph_decode(z), iters, windows)
    graph.update(variant=f"graph_w{window}", windows=windows,
                 replays=graph_decode.replays,
                 graph_conv_launches=graph_decode.graph_launches,
                 bit_equal=bool(torch.equal(out, ref)),
                 shape=list(out.shape))
    print(json.dumps(graph), flush=True)
    result["graph"] = graph
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--temp", type=int, default=17, help="latent frames")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_decode_scan: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(dev)}), flush=True)
    _, vae = build_models(dev, dit=False)
    gen = torch.Generator(dev).manual_seed(1)
    z = torch.randn((1, args.temp, TILE, TILE, 16), generator=gen,
                    device=dev).bfloat16() * 2.0
    result = run(vae, z, args.iters)
    return 0 if result.get("graph", {}).get("bit_equal", True) else 1


if __name__ == "__main__":
    sys.exit(main())
