"""Text-to-video serving, one client in a closed loop.

As the serving app (``tools/serve.py``) handles requests, one at a time:
each request is ``PyramidFlowPipeline.generate`` with the app's defaults
(``output_type="pixels"``, ``save_memory``, the DiT kept resident, a
progress callback after every unit), seeded T5 features and pooled text
for the positive prompt, zeros for the negative one, and noise drawn from
the run's seed. The window opens as the first request starts and closes
at the first unit boundary past ``--seconds``, or when every unit of the
request is done, before its decode: a window holds the denoising of one
request, and a unit that ends after the close is not counted.

The mix's parameters (``traffic/<mix>.json``): ``temp``,
``height``, ``width``, ``steps`` and ``video_steps`` per stage,
``guidance`` and ``video_guidance``, ``text_len`` and ``text_valid``
tokens, ``warmup_steps`` (Euler steps per stage of the two-unit warm-up
request), ``dit_samples`` (forwards the reference recomputes).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import torch

from portbench.harness import seeded, trace, yardstick
from portbench.reference import dit as ref_dit
from portbench.reference import t2v as ref_t2v
from portbench.reference.pyramid import Layout

TAG_DIT, TAG_VAE, TAG_TEXT, TAG_NOISE, TAG_SAMPLE = 1, 2, 3, 4, 5
ATTENTION = "portbench.attention"


class WindowClosed(Exception):
    """Raised from the progress callback to stop a request at a unit
    boundary once the window has closed."""


class ReplayNoise:
    """The pipeline's noise source (``generate(noise=...)``), handing out
    draws the benchmark made."""

    def __init__(self, noise: ref_t2v.Noise):
        self.noise = noise

    def initial(self, shape):
        if tuple(shape) != tuple(self.noise.initial.shape):
            raise ValueError(f"initial draw {tuple(shape)} requested, "
                             f"{tuple(self.noise.initial.shape)} made")
        return self.noise.initial

    def block(self, unit, stage, shape):
        z = self.noise.blocks[(unit, stage)]
        if tuple(shape) != tuple(z.shape):
            raise ValueError(f"block draw {tuple(shape)} requested, "
                             f"{tuple(z.shape)} made")
        return z


def _traffic(params: dict) -> ref_t2v.Traffic:
    return ref_t2v.Traffic(
        temp=params["temp"], height=params["height"], width=params["width"],
        steps=params["steps"], video_steps=params["video_steps"],
        guidance=params["guidance"], video_guidance=params["video_guidance"])


def _build(spec):
    """The program's pipeline with the configuration's DiT and VAE, weights
    drawn from the seed."""
    from pyramid_flow_tpu_torch.models.vae.model import (CausalVideoVAE,
                                                         VAEConfig)
    from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import \
        PyramidFlowPipeline

    cfg, dev = spec.config, spec.device
    dtype = getattr(torch, cfg["dtype"])
    fam, dcfg = cfg["family"], cfg["dit"]
    if fam == "flux":
        from pyramid_flow_tpu_torch.models.flux.model import (
            FluxConfig, PyramidFluxTransformer)
        dit = PyramidFluxTransformer(FluxConfig(**_tuples(dcfg)), dtype=dtype,
                                     device=dev)
    else:
        from pyramid_flow_tpu_torch.models.mmdit.model import (
            MMDiTConfig, PyramidDiffusionMMDiT)
        dit = PyramidDiffusionMMDiT(MMDiTConfig(**_tuples(dcfg)), dtype=dtype,
                                    device=dev)
    seeded.load_into(dit, seeded.seeded_weights(
        ref_dit.param_specs(fam, dcfg), spec.seed, TAG_DIT, dev, dtype))
    vae = CausalVideoVAE(VAEConfig(**_tuples(cfg["vae"])), dtype=dtype,
                         device=dev)
    specs = sorted((n, tuple(p.shape)) for n, p in vae.named_parameters())
    seeded.load_into(vae, seeded.seeded_weights(specs, spec.seed, TAG_VAE,
                                                dev, dtype))
    return PyramidFlowPipeline(dit.eval(), vae.eval(), dtype=dtype,
                               device=dev)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _text(spec, params, dtype):
    """(positive, negative) features: seeded T5 states with ``text_valid``
    valid tokens and seeded pooled text; the negative prompt's zeros."""
    dcfg, dev = spec.config["dit"], spec.device
    gen = seeded.generator(spec.seed, TAG_TEXT, dev)
    n = params["text_len"]
    emb = torch.randn((1, n, dcfg["joint_attention_dim"]), generator=gen,
                      device=dev).to(dtype)
    pooled = torch.randn((1, dcfg["pooled_projection_dim"]), generator=gen,
                         device=dev).to(dtype)
    mask = (torch.arange(n, device=dev) < params["text_valid"])[None]
    return (emb, mask, pooled), (emb * 0, mask, pooled * 0)


class Cell:
    """One run of the cell: set-up, the window, the comparison."""

    def __init__(self, spec):
        self.spec = spec
        self.params = spec.traffic
        self.tr = _traffic(self.params)
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
            noise=ReplayNoise(ref_t2v.make_noise(warm, self.noise_gen)))
        self._sync()
        self.requests: List[ref_t2v.Request] = []
        self.noises: List[ref_t2v.Noise] = []
        self.finishes: List[tuple] = []  # (request, unit, host time)
        self.failed = 0
        self.summary: Dict[str, object] = {}

    def _sync(self):
        if self.spec.device.type == "cuda":
            torch.cuda.synchronize(self.spec.device)

    # ------------------------------------------------------------ window
    def _capture_hook(self, req: ref_t2v.Request, schedule):
        """Record what each DiT forward of ``req`` was fed and returned."""
        it = iter(schedule)

        def hook(module, args, out):
            u, s, i = next(it)
            lay = self.layouts[(u, s)]
            tokens = args[0]
            rec = dict(unit=u, stage=s, step=i,
                       cur=tokens[1, -lay.current:].clone(),
                       v=out[:, -lay.current:].clone())
            if i == 0:
                rec["cond"] = tokens[1, :lay.budget].clone()
            req.forwards.append(rec)

        return self.pipe.dit.register_forward_hook(hook)

    def window(self) -> Dict[str, float]:
        """The closed loop for ``--seconds``; with ``--trace`` host spans
        around every DiT forward, then one more unit under the profiler."""
        tr = self.tr
        spans = trace.ForwardSpans(self.pipe.dit) if self.spec.trace else None
        prof: Dict[str, object] = {}
        t0 = time.perf_counter()
        deadline = t0 + self.spec.seconds
        marks = [t0]  # unit boundaries on the host clock
        closed = []  # set once the window has closed

        def close():
            if not closed:
                closed.append(True)
                self.summary["peak_mem_bytes"] = _peak(self.spec.device)

        def progress(info):
            now = time.perf_counter()
            if "prof" in prof:  # the profiled unit has ended
                trace.stop_profile(prof["prof"])
                prof["wall"] = now - marks[-1]
                raise WindowClosed
            if info["phase"] != "denoise":
                # every unit of the request is done: the window closes before
                # its decode (a traced run decodes, then profiles a unit of
                # the next request)
                close()
                if spans is None:
                    raise WindowClosed
                return
            prev = marks[-1]
            marks.append(now)
            if not closed and now <= deadline:
                self.finishes.append((len(self.requests) - 1,
                                      info["unit"] - 1, now))
                return
            close()
            if spans is None:
                raise WindowClosed
            if not 2 <= info["unit"] < info["units"]:
                return  # profile a later unit that follows a later unit
            spans.close()
            prof.update(unit=info["unit"], unprofiled=now - prev,
                        ctx=trace.wrapped(trace.attention_sites(), ATTENTION))
            prof["ctx"].__enter__()
            marks.append(time.perf_counter())
            prof["prof"] = trace.start_profile()

        try:
            # a traced run goes on to profile the unit after the window
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
                        noise=ReplayNoise(noise))
                except WindowClosed:
                    break
                except (RuntimeError, ValueError):
                    # a unit that raises (out of memory, a kernel's refusal)
                    # fails; the client sends its next request
                    self.failed += 1
                finally:
                    handle.remove()
                marks.append(time.perf_counter())
        finally:
            if "ctx" in prof:
                prof["ctx"].__exit__(None, None, None)
            if spans is not None:
                spans.close()
        self._sync()
        print("unit ends (s after the window opened): "
              + " ".join(f"{t - t0:.3f}" for _, _, t in self.finishes),
              file=sys.stderr)
        self.failed += self._non_finite_units()
        units = len(self.finishes)
        stretch = self.finishes[-1][2] - t0 if units else self.spec.seconds
        self.summary.update(stretch_s=stretch, units=units)
        if spans is not None:
            n = sum(sum(self.tr.steps_of(u)) for _, u, _ in self.finishes)
            host = spans.durations[:n]
            work = [self._unit_work(u) for _, u, _ in self.finishes]
            self.summary.update(
                forward_host_s=host, host_outside_forward_s=stretch - sum(host),
                model_flops=sum(mm + af for mm, af, _ in work))
        if "wall" in prof:
            self._profile_summary(prof)
        return {"t2v_latent_frames_per_s": units / stretch}

    def _non_finite_units(self) -> int:
        """Counted units whose DiT outputs hold a non-finite value."""
        bad = set()
        for r, req in enumerate(self.requests):
            for f in req.forwards:
                if not torch.isfinite(f["v"]).all():
                    bad.add((r, f["unit"]))
        return len(bad & {(r, u) for r, u, _ in self.finishes})

    def _unit_work(self, u: int):
        """(matmul flops, attention flops, attention bytes) of unit ``u``'s
        forwards, both CFG rows."""
        cfg = self.spec.config
        dcfg = cfg["dit"]
        specs = ref_dit.param_specs(cfg["family"], dcfg)
        calls = dcfg["num_layers"] + dcfg.get("num_single_layers", 0)
        n_text = self.params["text_len"]
        mm = af = ab = 0.0
        for s in range(3):
            lay = self.layouts[(u, s)]
            times = _full_times(lay, n_text, self.params["text_valid"])
            f, b = yardstick.attention_work(
                times, dcfg["num_attention_heads"],
                dcfg["attention_head_dim"], 2)
            n = self.tr.steps_of(u)[s]
            mm += n * 2 * yardstick.matmul_flops(specs, n_text, lay.length)
            af += n * calls * f
            ab += n * calls * b
        return mm, af, ab

    def _profile_summary(self, prof):
        """The profiled unit: busy time, attention's device time against its
        bound, and the breakdown."""
        read = trace.read_profile(prof["prof"], ATTENTION)
        _, af, ab = self._unit_work(prof["unit"])
        self.summary.update(
            busy_s=read["busy_s"], traced_wall_s=prof["wall"],
            same_work_unprofiled_s=prof["unprofiled"],
            attn_device_s=read["labelled_device_s"],
            attn_bound_s=yardstick.bound_seconds(af, ab),
            device_ops=read["device_ops"], idle_gaps=read["idle_gaps"])

    @property
    def attempted(self) -> int:
        return len(self.finishes) + self.failed

    # -------------------------------------------------------- comparison
    def check(self) -> Dict[str, float]:
        """Free the program, then hold the first request to the reference."""
        spec = self.spec
        self.pipe = None
        gc.collect()
        if spec.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        cfg = spec.config
        fam, dcfg = cfg["family"], cfg["dit"]
        W = {n: w.float() for n, w in seeded.seeded_weights(
            ref_dit.param_specs(fam, dcfg), spec.seed, TAG_DIT, spec.device,
            self.dtype)}
        text = tuple(torch.cat([n, p]).float() if n.is_floating_point()
                     else torch.cat([n, p])
                     for n, p in zip(self.neg, self.pos))
        with torch.no_grad():
            return ref_t2v.judge(
                fam, dcfg, W, self.requests[0], self.noises[0], text,
                self.tr, seeded.sub_seed(spec.seed, TAG_SAMPLE),
                self.params["dit_samples"], self.dtype)


def _peak(device) -> int:
    """The device memory peak since the window opened."""
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _full_times(lay: Layout, n_text: int, n_valid: int):
    import numpy as np
    text = np.where(np.arange(n_text) < n_valid, 0, yardstick.INVALID_TIME)
    return np.concatenate([text, lay.time_ids])
