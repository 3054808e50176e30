"""The port's spans (``utils.profiling.span``) on the CPU, for both DiTs.

* recording off: ``span`` hands out one shared null context, and a
  ``generate`` and a train step build no span at all;
* recording on: a temp-3 ``generate`` records one ``pipeline.request``,
  3 ``pipeline.unit``, 9 ``pipeline.stage`` and one ``dit.forward`` per
  Euler step, each inside the right parent and all under the request's
  trace id; a train step records ``train.step`` holding 3 ``dit.forward``
  (one per stage, none from the remat recompute), one ``train.backward``,
  one ``train.optimizer`` holding the clip's ``train.sync``, and the grad
  norm's and the loss's ``train.sync``;
* the outputs with recording on are bit-equal to those with it off;
* under the CPU profiler a span's start lies within 1 ms of the start of
  its ``record_function`` range, on the same clock.

Tiny DiTs (1-2 blocks, 2-4 heads of 8), 64x64 requests; no JAX.
"""

import time

import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.mmdit.model import (
    MMDiTConfig, PyramidDiffusionMMDiT)
from pyramid_flow_tpu_torch.pipeline.noising import GeneratorDraws
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.train_state import create_train_state
from pyramid_flow_tpu_torch.training.trainer import make_train_step
from pyramid_flow_tpu_torch.utils import profiling

FAMILIES = ("flux", "mmdit")
STEPS, VIDEO_STEPS = [2, 2, 2], [1, 1, 1]
UNITS = (3, 3, 2)


def _dit(family, remat=False):
    torch.manual_seed(0)
    if family == "flux":
        return PyramidFluxTransformer(FluxConfig(
            in_channels=16, num_layers=1, num_single_layers=1,
            attention_head_dim=8, num_attention_heads=2,
            joint_attention_dim=32, pooled_projection_dim=24,
            axes_dims_rope=(4, 2, 2)), device="cpu", remat=remat)
    return PyramidDiffusionMMDiT(MMDiTConfig(
        sample_size=32, in_channels=4, num_layers=2, attention_head_dim=8,
        num_attention_heads=4, caption_projection_dim=32,
        pooled_projection_dim=24, joint_attention_dim=32,
        pos_embed_max_size=24), device="cpu", remat=remat)


def _text():
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(rng.standard_normal((1, 8, 32)).astype(np.float32))
    mask = torch.ones((1, 8), dtype=torch.bool)
    mask[:, 6:] = False
    pooled = torch.from_numpy(rng.standard_normal((1, 24)).astype(np.float32))
    return emb, mask, pooled


def _generate(pipe):
    emb, mask, pooled = _text()
    return pipe.generate(
        torch.Generator().manual_seed(3), emb, mask, pooled, emb * 0, mask,
        pooled * 0, height=64, width=64, temp=3,
        num_inference_steps=STEPS, video_num_inference_steps=VIDEO_STEPS,
        output_type="latent", progress_callback=lambda info: None)


def _batch(b=4):
    rng = np.random.default_rng(6)
    mask = np.ones((b, 8), bool)
    mask[:, 6:] = False
    batch = {"latents": 0.5 * rng.standard_normal((b, 4, 8, 8, 4)),
             "text_emb": rng.standard_normal((b, 8, 32)),
             "text_mask": mask, "pooled": rng.standard_normal((b, 24)),
             "null_text_emb": np.zeros((b, 8, 32)),
             "null_pooled": np.zeros((b, 24))}
    return {k: torch.from_numpy(v if v.dtype == bool
                                else v.astype(np.float32))
            for k, v in batch.items()}


def _train_step(family):
    """One step of a fresh tiny train state: (metrics, parameters)."""
    dit = _dit(family, remat=True)
    step = make_train_step(dit, PyramidFlowMatchEulerDiscreteScheduler())
    state = create_train_state(dit)
    _, metrics = step(state, _batch(), GeneratorDraws(
        torch.Generator().manual_seed(5)), UNITS)
    return metrics, {n: p.detach().clone()
                     for n, p in dit.named_parameters()}


def _children(spans, index, name=None):
    return [s for s in spans if s.parent == index
            and (name is None or s.name == name)]


@pytest.mark.parametrize("family", FAMILIES)
def test_nothing_is_built_while_off(family, monkeypatch):
    assert profiling.span("a") is profiling.span("b", x=1)

    def refuse(*args, **kwargs):
        raise AssertionError("a span was built while nothing records")

    monkeypatch.setattr(profiling, "_Span", refuse)
    _generate(PyramidFlowPipeline(_dit(family), latent_channels=4,
                                  dtype=torch.float32))
    _train_step(family)
    with profiling.recording() as rec:
        pass
    assert rec.spans() == []


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_spans(family):
    dit = _dit(family)
    want = _generate(PyramidFlowPipeline(dit, latent_channels=4,
                                         dtype=torch.float32))
    pipe = PyramidFlowPipeline(dit, latent_channels=4, dtype=torch.float32)
    with profiling.recording() as rec:
        got = _generate(pipe)
    assert torch.equal(got, want)
    spans = rec.spans()
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns
               for s in spans)
    assert {s.trace_id for s in spans} == {pipe.requests} == {1}
    (request,) = [i for i, s in enumerate(spans)
                  if s.name == "pipeline.request"]
    assert spans[request].parent is None
    assert spans[request].attrs == {"temp": 3, "units": 3}
    units = [i for i, s in enumerate(spans) if s.parent == request
             and s.name == "pipeline.unit"]
    assert [spans[i].attrs["unit"] for i in units] == [0, 1, 2]
    # the CPU makes no cudaMalloc and runs no flash kernel
    assert all(spans[i].attrs["allocator_calls"] == 0 for i in units)
    forwards = 0
    for u in units:
        stages = [i for i, s in enumerate(spans) if s.parent == u
                  and s.name == "pipeline.stage"]
        assert len(stages) == 3
        assert len(_children(spans, u, "pipeline.sync")) == 1
        for i_s, st in enumerate(stages):
            steps = (STEPS if spans[u].attrs["unit"] == 0
                     else VIDEO_STEPS)[i_s]
            assert spans[st].attrs["stage"] == i_s
            assert spans[st].attrs["steps"] == steps
            fw = _children(spans, st, "dit.forward")
            assert len(fw) == steps
            assert all(f.attrs["rows"] == 2 and f.attrs["attn_launches"] == 0
                       and f.attrs["qk_launches"] == 0
                       and f.attrs["norm_launches"] == 0
                       and f.attrs["tokens"] == spans[st].attrs["tokens"]
                       for f in fw)
            forwards += steps
    assert forwards == sum(STEPS) + 2 * sum(VIDEO_STEPS)
    assert sum(s.name == "dit.forward" for s in spans) == forwards
    assert len(_children(spans, request, "pipeline.sync")) == 1


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_spans(family):
    want, want_params = _train_step(family)
    with profiling.recording() as rec:
        got, got_params = _train_step(family)
    assert got == want
    assert all(torch.equal(got_params[n], want_params[n])
               for n in want_params)
    spans = rec.spans()
    (step,) = [i for i, s in enumerate(spans) if s.name == "train.step"]
    assert spans[step].parent is None and spans[step].trace_id == 0
    assert spans[step].attrs == {"tokens": 4 * 4 * 4 * 4,
                                 "allocator_calls": 0}
    assert {s.trace_id for s in spans} == {0}
    assert len(_children(spans, step, "dit.forward")) == 3
    assert sum(s.name == "dit.forward" for s in spans) == 3
    assert len(_children(spans, step, "train.backward")) == 1
    (opt,) = [i for i, s in enumerate(spans) if s.name == "train.optimizer"]
    assert spans[opt].parent == step and spans[opt].attrs == {"applied": True}
    assert [s.attrs for s in _children(spans, opt)] == [{"read": "clip_norm"}]
    assert [s.attrs["read"] for s in _children(spans, step, "train.sync")
            ] == ["grad_norm", "loss"]


def test_span_start_is_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(3):
                with profiling.span(f"probe.{i}"):
                    torch.ones(64) * 2
                time.sleep(0.002)
        with profiling.span("probe.unprofiled"):
            pass
    kineto = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    spans = rec.spans()
    assert sorted(kineto) == ["probe.0", "probe.1", "probe.2"]
    for s in spans[:3]:
        assert abs(s.start_ns - kineto[s.name]) < 1_000_000
    assert spans[3].name == "probe.unprofiled"
