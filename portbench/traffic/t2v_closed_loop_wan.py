"""Text-to-video serving on the Wan DiT, one client in a closed loop.

``t2v_closed_loop``'s request, window and comparison, with the Wan2.1 DiT
(``pyramid_flow_tpu_torch.models.wan``) in the pipeline: the mix's
parameters are read as there. What differs, each the Wan family's
counterpart of a flux-else-MMDiT branch there:

* set-up imports the Wan family first, so a program without it fails at
  once; the DiT and its weights come from ``reference/wan.py``'s
  ``param_specs``; the text is seeded T5 states (the DiT pads them to its
  ``text_len``) and an empty pooled vector, which Wan does not read;
* the model FLOPs (:func:`matmul_flops`): the text MLP and the
  cross-attentions' k and v per text token (``text_len`` per row), the time
  MLPs and the modulation projection once per row, every other product per
  latent token of the padded layout; attention's visible pairs on top;
* ``--trace 1``: the profiled unit runs inside ``profiling.recording()``, so
  the program's ``wan.cross_attn`` spans are profiler ranges there; the
  self-attention is labelled by wrapping the Wan blocks' ``_attention``, as
  the other families' is; each gets its own device time and bound;
* the comparison: ``reference/wan.py``'s ``judge`` on the weights held in
  bf16 as seeded (each matrix cast to float32 at its use).

The window's graph counts (``dit_graphs.GRAPH_FORWARDS``) and, traced, how
the profiled unit's forwards ran are printed to standard error.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.harness import seeded, trace, yardstick
from portbench.reference import t2v as ref_t2v
from portbench.reference import wan as ref_wan
from portbench.reference.pyramid import Layout
from portbench.traffic import t2v_closed_loop as base

TAG_DIT, TAG_VAE, TAG_TEXT, TAG_NOISE, TAG_SAMPLE = (
    base.TAG_DIT, base.TAG_VAE, base.TAG_TEXT, base.TAG_NOISE,
    base.TAG_SAMPLE)
ATTENTION = base.ATTENTION
CROSS_ATTENTION = "wan.cross_attn"  # the program's span


def matmul_flops(specs, text: int, latent: int) -> float:
    """2 per multiply-add of every matrix product of one row with ``text``
    text tokens (after padding) and ``latent`` latent tokens."""
    total = 0.0
    for name, shape in specs:
        if not name.endswith("weight") or len(shape) < 2:
            continue
        if name.startswith(("time_embedding", "time_projection")):
            tokens = 1
        elif name.startswith("text_embedding") or (
                ".cross_attn." in name and name.endswith(
                    (".k.weight", ".v.weight"))):
            tokens = text
        else:
            tokens = latent
        total += 2.0 * int(np.prod(shape)) * tokens
    return total


def cross_attention_work(time_q: np.ndarray, text: int, heads: int,
                         head_dim: int, rows: int) -> Tuple[float, float]:
    """(flops, bytes) of one cross-attention call: 4 * head_dim per (valid
    query, text key) pair and head; q, k, v and o in bf16 once."""
    valid = int((np.asarray(time_q) != yardstick.INVALID_TIME).sum())
    flops = 4.0 * head_dim * heads * valid * text * rows
    nbytes = (2.0 * (len(time_q) + text) * heads * head_dim
              * yardstick.BF16_BYTES * rows)
    return flops, nbytes


def _build(spec):
    """The program's pipeline with the Wan DiT and the configuration's VAE,
    weights drawn from the seed."""
    from pyramid_flow_tpu_torch.models.vae.model import (CausalVideoVAE,
                                                         VAEConfig)
    from pyramid_flow_tpu_torch.models.wan.model import WanConfig, WanDiT
    from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import \
        PyramidFlowPipeline

    cfg, dev = spec.config, spec.device
    dtype = getattr(torch, cfg["dtype"])
    dit = WanDiT(WanConfig(**base._tuples(cfg["dit"])), dtype=dtype,
                 device=dev)
    seeded.load_into(dit, seeded.seeded_weights(
        ref_wan.param_specs(cfg["dit"]), spec.seed, TAG_DIT, dev, dtype))
    vae = CausalVideoVAE(VAEConfig(**base._tuples(cfg["vae"])), dtype=dtype,
                         device=dev)
    specs = sorted((n, tuple(p.shape)) for n, p in vae.named_parameters())
    seeded.load_into(vae, seeded.seeded_weights(specs, spec.seed, TAG_VAE,
                                                dev, dtype))
    return PyramidFlowPipeline(dit.eval(), vae.eval(), dtype=dtype,
                               device=dev)


def _text(spec, params, dtype):
    """(positive, negative) features: seeded T5 states with ``text_valid``
    valid tokens and an empty pooled vector; the negative prompt's zeros."""
    dev = spec.device
    gen = seeded.generator(spec.seed, TAG_TEXT, dev)
    n = params["text_len"]
    emb = torch.randn((1, n, spec.config["dit"]["text_dim"]), generator=gen,
                      device=dev).to(dtype)
    pooled = torch.zeros((1, 0), dtype=dtype, device=dev)
    mask = (torch.arange(n, device=dev) < params["text_valid"])[None]
    return (emb, mask, pooled), (emb * 0, mask, pooled)


class Cell(base.Cell):
    """One run of the cell: set-up, the window, the comparison."""

    def __init__(self, spec):
        # first: a program without the Wan family fails here, in seconds
        from pyramid_flow_tpu_torch.models import dit_graphs, wan  # noqa
        from pyramid_flow_tpu_torch.models.wan import blocks as wan_blocks
        self.graph_forwards = dit_graphs.GRAPH_FORWARDS
        self.wan_blocks = wan_blocks
        self.spec = spec
        self.params = spec.traffic
        self.tr = base._traffic(self.params)
        self.dtype = getattr(torch, spec.config["dtype"])
        self.pipe = _build(spec)
        self.pos, self.neg = _text(spec, self.params, self.dtype)
        self.noise_gen = seeded.generator(spec.seed, TAG_NOISE, spec.device)
        self.layouts = {(u, s): Layout(u, s, self.tr.h_lat, self.tr.w_lat)
                        for u in range(self.tr.temp) for s in range(3)}
        # warm-up: units 0 and 1 at every stage's layout
        w = self.params["warmup_steps"]
        warm = ref_t2v.Traffic(2, self.tr.height, self.tr.width, [w] * 3,
                               [w] * 3, self.tr.guidance,
                               self.tr.video_guidance)
        self.pipe.generate(
            None, *self.pos, *self.neg, height=warm.height, width=warm.width,
            temp=2, num_inference_steps=warm.steps,
            video_num_inference_steps=warm.video_steps,
            guidance_scale=warm.guidance,
            video_guidance_scale=warm.video_guidance, output_type="latent",
            noise=base.ReplayNoise(ref_t2v.make_noise(warm, self.noise_gen)))
        self._sync()
        self.requests: List[ref_t2v.Request] = []
        self.noises: List[ref_t2v.Noise] = []
        self.finishes: List[tuple] = []  # (request, unit, host time)
        self.failed = 0
        self.summary: Dict[str, object] = {}

    # ------------------------------------------------------------ window
    def window(self) -> Dict[str, float]:
        """``t2v_closed_loop``'s window; traced, the profiled unit runs
        inside ``profiling.recording()`` with the self-attention wrapped."""
        from pyramid_flow_tpu_torch.utils import profiling

        tr = self.tr
        spans = trace.ForwardSpans(self.pipe.dit) if self.spec.trace else None
        prof: Dict[str, object] = {}
        graphs_at_open = dict(self.graph_forwards)
        t0 = time.perf_counter()
        deadline = t0 + self.spec.seconds
        marks = [t0]  # unit boundaries on the host clock
        closed = []  # set once the window has closed

        def close():
            if not closed:
                closed.append(True)
                self.summary["peak_mem_bytes"] = base._peak(self.spec.device)
                self.summary["graph_forwards"] = {
                    k: v - graphs_at_open[k]
                    for k, v in self.graph_forwards.items()}

        def progress(info):
            now = time.perf_counter()
            if "prof" in prof:  # the profiled unit has ended
                trace.stop_profile(prof["prof"])
                prof["wall"] = now - marks[-1]
                raise base.WindowClosed
            if info["phase"] != "denoise":
                close()
                if spans is None:
                    raise base.WindowClosed
                return
            prev = marks[-1]
            marks.append(now)
            if not closed and now <= deadline:
                self.finishes.append((len(self.requests) - 1,
                                      info["unit"] - 1, now))
                return
            close()
            if spans is None:
                raise base.WindowClosed
            if not 2 <= info["unit"] < info["units"]:
                return  # profile a later unit that follows a later unit
            spans.close()
            prof.update(unit=info["unit"], unprofiled=now - prev,
                        rec=profiling.recording(),
                        ctx=trace.wrapped([(self.wan_blocks, "_attention")],
                                          ATTENTION))
            prof["recorder"] = prof["rec"].__enter__()
            prof["ctx"].__enter__()
            marks.append(time.perf_counter())
            prof["prof"] = trace.start_profile()

        try:
            while time.perf_counter() <= deadline + (120 if spans else 0):
                req = ref_t2v.Request()
                noise = ref_t2v.make_noise(tr, self.noise_gen)
                self.requests.append(req)
                self.noises.append(noise)
                handle = self._capture_hook(req, ref_t2v.forward_schedule(tr))
                try:
                    self.pipe.generate(
                        None, *self.pos, *self.neg, height=tr.height,
                        width=tr.width, temp=tr.temp,
                        num_inference_steps=list(tr.steps),
                        video_num_inference_steps=list(tr.video_steps),
                        guidance_scale=tr.guidance,
                        video_guidance_scale=tr.video_guidance,
                        output_type="pixels", progress_callback=progress,
                        noise=base.ReplayNoise(noise))
                except base.WindowClosed:
                    break
                except (RuntimeError, ValueError):
                    self.failed += 1
                finally:
                    handle.remove()
                marks.append(time.perf_counter())
        finally:
            if "ctx" in prof:
                prof["ctx"].__exit__(None, None, None)
                prof["rec"].__exit__(None, None, None)
            if spans is not None:
                spans.close()
        self._sync()
        print("unit ends (s after the window opened): "
              + " ".join(f"{t - t0:.3f}" for _, _, t in self.finishes),
              file=sys.stderr)
        print(f"graph forwards in the window: "
              f"{self.summary.get('graph_forwards')}", file=sys.stderr)
        self.failed += self._non_finite_units()
        units = len(self.finishes)
        stretch = self.finishes[-1][2] - t0 if units else self.spec.seconds
        self.summary.update(stretch_s=stretch, units=units)
        if spans is not None:
            n = sum(sum(self.tr.steps_of(u)) for _, u, _ in self.finishes)
            host = spans.durations[:n]
            work = [self._unit_work(u) for _, u, _ in self.finishes]
            self.summary.update(
                forward_host_s=host,
                host_outside_forward_s=stretch - sum(host),
                model_flops=sum(w[0] + w[1] + w[3] for w in work))
        if "wall" in prof:
            self._profile_summary(prof)
        return {"t2v_latent_frames_per_s": units / stretch}

    def _unit_work(self, u: int):
        """(matmul flops, self-attention flops and bytes, cross-attention
        flops and bytes) of unit ``u``'s forwards, both CFG rows."""
        dcfg = self.spec.config["dit"]
        specs = ref_wan.param_specs(dcfg)
        heads, layers = dcfg["num_heads"], dcfg["num_layers"]
        hd, n_text = dcfg["dim"] // heads, dcfg["text_len"]
        work = np.zeros(5)
        for s in range(3):
            lay = self.layouts[(u, s)]
            n = self.tr.steps_of(u)[s]
            sa = yardstick.attention_work(lay.time_ids, heads, hd, 2)
            ca = cross_attention_work(lay.time_ids, n_text, heads, hd, 2)
            work += n * np.array([
                2 * matmul_flops(specs, n_text, lay.length),
                layers * sa[0], layers * sa[1], layers * ca[0],
                layers * ca[1]])
        return tuple(float(w) for w in work)

    def _profile_summary(self, prof):
        """The profiled unit: busy time, each attention's device time
        against its bound, and the breakdown."""
        read = trace.read_profile(prof["prof"], ATTENTION)
        cross = trace.read_profile(prof["prof"], CROSS_ATTENTION, top=0)
        _, af, ab, cf, cb = self._unit_work(prof["unit"])
        how = [s.attrs.get("graph") for s in prof["recorder"].spans()
               if s.name == "dit.forward"]
        print(f"profiled unit {prof['unit']}: forwards by how they ran "
              f"{ {k: how.count(k) for k in sorted(set(how))} }",
              file=sys.stderr)
        self.summary.update(
            busy_s=read["busy_s"], traced_wall_s=prof["wall"],
            same_work_unprofiled_s=prof["unprofiled"],
            attn_device_s=read["labelled_device_s"],
            attn_bound_s=yardstick.bound_seconds(af, ab),
            cross_attn_device_s=cross["labelled_device_s"],
            cross_attn_bound_s=yardstick.bound_seconds(cf, cb),
            device_ops=read["device_ops"], idle_gaps=read["idle_gaps"])

    # -------------------------------------------------------- comparison
    def check(self) -> Dict[str, float]:
        """Free the program, then hold the first request to the reference,
        whose weights stay in bf16 as seeded."""
        spec = self.spec
        self.pipe = None
        gc.collect()
        if spec.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dcfg = spec.config["dit"]
        W = dict(seeded.seeded_weights(ref_wan.param_specs(dcfg), spec.seed,
                                       TAG_DIT, spec.device, self.dtype))
        text = tuple(torch.cat([n, p]).float() if n.is_floating_point()
                     else torch.cat([n, p])
                     for n, p in zip(self.neg, self.pos))
        with torch.no_grad():
            return ref_wan.judge(
                dcfg, W, self.requests[0], self.noises[0], text, self.tr,
                seeded.sub_seed(spec.seed, TAG_SAMPLE),
                self.params["dit_samples"], self.dtype)
