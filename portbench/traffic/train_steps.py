"""DiT training, train steps back to back.

As the training CLI (``tools/train_pyramid_flow.py``) builds and drives them
on one card: the DiT with fp32 parameters and ``remat``, the train state of
``create_train_state`` (AdamW, the clip, the anomaly gate, the EMA) under
the CLI's cosine schedule, the step of ``make_train_step`` under bf16
autocast, one draw source for the run, and per step the units of the AR
positions a one-rank run covers. Each step takes a fresh batch of seeded
latents and text features, rows that all differ. Set-up builds that one
state and step and drives them through the first steps; the window then
runs further steps of the same state until ``--seconds``, and a step that
ends after the close is not counted.

The mix's parameters (``traffic/<mix>.json``): ``batch``, ``sample_ratios``,
``frames``, ``height`` and ``width`` (pixels; latents are 1/8), the text
sizes, the CLI's schedule and optimizer settings, ``cfg_rate``,
``corrupt_ratio``, ``setup_steps`` (the steps the reference follows).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import seeded, trace, yardstick
from portbench.reference import dit as ref_dit
from portbench.reference import train as ref_train
from portbench.reference.pyramid import clip_meta

TAG_DIT, TAG_DRAWS, TAG_BATCH = 1, 6, 1000
ATTENTION = "portbench.attention"
BACKWARD = "FlashAttentionFunctionBackward"
BETA1 = 0.9


def _batch(spec, p: dict, step: int) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: seeded N(0, 1) latents, T5 states and pooled
    text (``text_valid`` valid tokens), zero null features."""
    dcfg, dev = spec.config["dit"], spec.device
    gen = seeded.generator(spec.seed, TAG_BATCH + step, dev)
    b, n = p["batch"], p["text_len"]
    channels = dcfg["in_channels"] // (4 if spec.config["family"] == "flux"
                                       else 1)  # flux's width is 2x2 patches
    lat = torch.randn((b, p["frames"], p["height"] // 8, p["width"] // 8,
                       channels), generator=gen, device=dev)
    text = torch.randn((b, n, dcfg["joint_attention_dim"]), generator=gen,
                       device=dev)
    pooled = torch.randn((b, dcfg["pooled_projection_dim"]), generator=gen,
                         device=dev)
    mask = (torch.arange(n, device=dev) < p["text_valid"])[None].expand(
        b, -1).contiguous()
    return {"latents": lat, "text_emb": text, "text_mask": mask,
            "pooled": pooled, "null_text_emb": torch.zeros_like(text),
            "null_pooled": torch.zeros_like(pooled)}


def _ref_params(p: dict) -> dict:
    return dict(cfg_rate=p["cfg_rate"], sample_ratios=p["sample_ratios"],
                corrupt_ratio=p["corrupt_ratio"], lr=p["learning_rate"],
                warmup_steps=p["warmup_steps"], epochs=p["epochs"],
                steps_per_epoch=p["steps_per_epoch"], clip=p["clip_grad"],
                weight_decay=p["weight_decay"], betas=(BETA1, 0.95),
                anomaly_loss=2.0)


class Cell:
    """One run: the train state and step built once, its first steps as
    set-up, the window, the comparison."""

    def __init__(self, spec):
        from pyramid_flow_tpu_torch.pipeline.noising import GeneratorDraws
        from pyramid_flow_tpu_torch.schedulers.flow_matching import \
            PyramidFlowMatchEulerDiscreteScheduler
        from pyramid_flow_tpu_torch.training.lr_schedules import \
            cosine_schedule
        from pyramid_flow_tpu_torch.training.train_state import (
            TrainConfig, create_train_state)
        from pyramid_flow_tpu_torch.training.trainer import make_train_step

        self.spec, p = spec, spec.traffic
        self.p = p
        cfg, dev = spec.config, spec.device
        self.family, self.dcfg = cfg["family"], cfg["dit"]
        self.specs = ref_dit.param_specs(self.family, self.dcfg)
        self.dit = _build_dit(spec)
        seeded.load_into(self.dit, seeded.seeded_weights(
            self.specs, spec.seed, TAG_DIT, dev, torch.float32))
        self.state = create_train_state(self.dit, TrainConfig(
            learning_rate=p["learning_rate"], weight_decay=p["weight_decay"],
            max_grad_norm=p["clip_grad"], lr_schedule=cosine_schedule(
                p["learning_rate"], 1e-6, p["steps_per_epoch"], p["epochs"],
                p["warmup_steps"])))
        self.step_fn = make_train_step(
            self.dit, PyramidFlowMatchEulerDiscreteScheduler(),
            tuple(p["sample_ratios"]), True, 1, p["corrupt_ratio"],
            cfg_rate=p["cfg_rate"], compute_dtype=(
                None if cfg["dtype"] == "float32"
                else getattr(torch, cfg["dtype"])))
        self.draw_seed = seeded.sub_seed(spec.seed, TAG_DRAWS)
        self.draws = GeneratorDraws(
            torch.Generator(dev).manual_seed(self.draw_seed))
        self.h_lat, self.w_lat = p["height"] // 8, p["width"] // 8
        self.finishes: List[tuple] = []  # (step, host time)
        self.failed = 0
        self.summary: Dict[str, object] = {}
        # the first steps, followed by the reference after the window
        self.prog = {"loss": []}
        for k in range(p["setup_steps"]):
            m = self._step(k)
            self.prog["loss"].append(m["train/loss"])
            if k == 0:
                self.prog["grad"] = self._first_gradient()
        self.prog["change"] = self._change()

    def _units(self, k: int) -> List[int]:
        return ref_train.stage_units(k, self.p["frames"])

    def _step(self, k: int) -> dict:
        _, metrics = self.step_fn(self.state, _batch(self.spec, self.p, k),
                                  self.draws, tuple(self._units(k)))
        return metrics

    def _first_gradient(self) -> Dict[str, float]:
        """Each leaf's gradient as AdamW received it, from its first moment
        after one update (``(1 - beta1) g``)."""
        opt = self.state.optimizer
        names, moms = [], []
        for name, prm in self.dit.named_parameters():
            names.append(name)
            st = opt.state.get(prm, {})
            moms.append(st["exp_avg"] if "exp_avg" in st
                        else torch.zeros_like(prm))
        norms = torch.stack([torch.linalg.vector_norm(m) for m in moms])
        return dict(zip(names, (norms / (1 - BETA1)).tolist()))

    def _change(self) -> Dict[str, float]:
        return change_norms(dict(self.dit.named_parameters()), self.specs,
                            self.spec.seed, self.spec.device)

    # ------------------------------------------------------------ window
    def window(self) -> Dict[str, float]:
        """Steps until ``--seconds``; with ``--trace`` host spans around
        every DiT forward, then two more steps under the profiler."""
        spec, p = self.spec, self.p
        spans = trace.ForwardSpans(self.dit) if spec.trace else None
        k = p["setup_steps"]
        t0 = time.perf_counter()
        deadline = t0 + spec.seconds
        walls = {}
        while True:
            t = time.perf_counter()
            try:
                m = self._step(k)
                ok = m["train/loss"] == m["train/loss"]
            except RuntimeError:
                ok = False
            now = time.perf_counter()
            walls[k] = now - t
            if not ok:
                self.failed += 1
            elif now <= deadline:
                self.finishes.append((k, now))
            k += 1
            if now > deadline:
                break
        if spec.device.type == "cuda":
            self.summary["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                spec.device)
        stretch = self.finishes[-1][1] - t0 if self.finishes else spec.seconds
        tokens = sum(self._step_work(s)[3] for s, _ in self.finishes)
        self.summary.update(stretch_s=stretch, steps=len(self.finishes))
        if spans is not None:
            n = 3 * len(self.finishes)  # one DiT forward per stage
            spans.close()
            host = spans.durations[:n]
            work = [self._step_work(s) for s, _ in self.finishes]
            self.summary.update(
                forward_host_s=host,
                model_flops=sum(3 * (mm + af) for mm, af, _, _ in work))
            self._profile(k, walls)
        return {"train_tokens_per_s": tokens / stretch}

    def _step_work(self, k: int):
        """(matmul flops, attention forward flops, attention forward bytes,
        latent tokens) of step ``k``'s forwards."""
        p, d = self.p, self.dcfg
        calls = d["num_layers"] + d.get("num_single_layers", 0)
        mm = af = ab = toks = 0.0
        rows = ref_train.stage_rows(p["batch"], p["sample_ratios"])
        for stage, (_, n) in enumerate(rows):
            dims = ref_train.ar_dims(stage, self._units(k)[stage],
                                     p["frames"], self.h_lat, self.w_lat)
            _, times = clip_meta(dims)
            text = np.where(np.arange(p["text_len"]) < p["text_valid"], 0,
                            yardstick.INVALID_TIME)
            f, b = yardstick.attention_work(
                np.concatenate([text, times]), d["num_attention_heads"],
                d["attention_head_dim"], n)
            mm += n * yardstick.matmul_flops(self.specs, p["text_len"],
                                             len(times))
            af += calls * f
            ab += calls * b
            toks += n * len(times)
        return mm, af, ab, toks

    def _profile(self, k: int, walls: Dict[int, float]):
        """Two more steps under the profiler; the unprofiled wall of the
        same work is the two steps three before them (the units repeat
        every three steps)."""
        torch.cuda.synchronize(self.spec.device)
        with trace.wrapped(trace.attention_sites(), ATTENTION):
            prof = trace.start_profile()
            t = time.perf_counter()
            for j in (k, k + 1):
                self._step(j)
            wall = time.perf_counter() - t
            trace.stop_profile(prof)
        read = trace.read_profile(prof, ATTENTION, also=(BACKWARD,))
        af = ab = 0.0
        for j in (k, k + 1):
            _, f, b, _ = self._step_work(j)
            af, ab = af + 3.5 * f, ab + 3.5 * b
        same = [walls.get(j - 3) for j in (k, k + 1)]
        if None not in same:
            self.summary["same_work_unprofiled_s"] = sum(same)
        self.summary.update(
            busy_s=read["busy_s"], traced_wall_s=wall,
            attn_device_s=read["labelled_device_s"],
            attn_bound_s=yardstick.bound_seconds(af, ab),
            device_ops=read["device_ops"], idle_gaps=read["idle_gaps"])

    @property
    def attempted(self) -> int:
        return len(self.finishes) + self.failed

    # -------------------------------------------------------- comparison
    def check(self) -> Dict[str, float]:
        """Free the program, then run the reference over the first steps
        on the same weights, batches and draws."""
        spec, p = self.spec, self.p
        self.dit = self.state = self.step_fn = self.draws = None
        gc.collect()
        dev = spec.device
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        W = dict(seeded.seeded_weights(self.specs, spec.seed, TAG_DIT, dev,
                                       torch.float32))
        n = p["setup_steps"]
        ref = ref_train.train_steps(
            self.family, self.dcfg, W, [_batch(spec, p, k) for k in range(n)],
            [self._units(k) for k in range(n)], self.draw_seed,
            _ref_params(p))
        ref["change"] = change_norms(W, self.specs, spec.seed, dev)
        return ref_train.judge(self.prog, ref)


def change_norms(params: Dict[str, torch.Tensor], specs, seed: int, device
                 ) -> Dict[str, float]:
    """Each leaf's distance from the weights it was drawn with."""
    names, diffs = [], []
    with torch.no_grad():
        for name, w0 in seeded.seeded_weights(specs, seed, TAG_DIT, device,
                                              torch.float32):
            names.append(name)
            diffs.append(torch.linalg.vector_norm(params[name].detach() - w0))
    return dict(zip(names, torch.stack(diffs).tolist()))


def _build_dit(spec):
    cfg, dev = spec.config, spec.device
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["dit"].items()}
    if cfg["family"] == "flux":
        from pyramid_flow_tpu_torch.models.flux.model import (
            FluxConfig, PyramidFluxTransformer)
        return PyramidFluxTransformer(FluxConfig(**kw), dtype=torch.float32,
                                      device=dev, remat=True)
    from pyramid_flow_tpu_torch.models.mmdit.model import (
        MMDiTConfig, PyramidDiffusionMMDiT)
    return PyramidDiffusionMMDiT(MMDiTConfig(**kw), dtype=torch.float32,
                                 device=dev, remat=True)
