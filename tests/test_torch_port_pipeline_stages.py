"""Port parity for the pyramid's stage count, timestep shift, stage windows
and block-noise gamma, and for the entry points that pass them on.

The tiny DiT of test_torch_port_pipeline.py (JAX weights redrawn from a
numpy seed, carried to the port by the converters) in pipelines of each
package with the same pyramid: JAX's built from its constructor's settings,
the port's given the scheduler those settings make (the port's pipeline
takes its stage count from its scheduler). The port replays JAX's draws
(``JaxNoise``). fp32 on the CPU, latents out:

* 2 stages, timestep shift 3, stage windows (0, 1/2, 1), gamma 1/4 at
  64x64 temp 2, text-to-video and image-to-video;
* 4 stages (windows (0, 1/4, 1/2, 3/4, 1)) at 128x128 temp 2;
* without a scheduler the pipeline builds the release one (3 stages);
* ``PyramidFlowPipeline.from_pretrained``, ``PyramidFlowRunner.from_pretrained``
  (on test_torch_port_checkpoint.py's tiny release-layout directory) and
  ``from_train_state`` (on a port train state of the tiny DiT) pass the
  scheduler and ``frame_per_unit`` to the pipeline, whose scheduler tables
  then equal those of JAX's ``from_pretrained`` with the same settings.

Tolerance: latents atol 5e-4, as test_torch_port_pipeline.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline as JPipeline)
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.pipeline.runner import PyramidFlowRunner
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as Scheduler)
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from test_torch_port_checkpoint import VARIANT, write_release_dir
from test_torch_port_pipeline import (  # noqa: F401 (the fixture)
    DIT, SEED, JaxNoise, _text, pipelines)

LATENT_ATOL = 5e-4
# JAX's constructor settings
TWO = dict(stages=(1, 2), timestep_shift=3.0, stage_range=(0, 0.5, 1),
           scheduler_gamma=0.25)
FOUR = dict(stages=(1, 2, 4, 8), stage_range=(0, 0.25, 0.5, 0.75, 1))


def _scheduler(settings):
    """The port's scheduler for JAX's constructor ``settings``."""
    return Scheduler(shift=settings.get("timestep_shift", 1.0),
                     stages=len(settings["stages"]),
                     stage_range=settings["stage_range"],
                     gamma=settings.get("scheduler_gamma", 1 / 3))


def _args(wrap):
    emb, mask, pooled = _text()
    return tuple(map(wrap, (emb, mask, pooled, emb * 0, mask, pooled * 0)))


def _generate_both(pipelines, settings, size, image=None):  # noqa: F811
    """JAX's and the port's latents at temp 2, ``size`` square, one step per
    stage (two at stage 0), from the same tiny DiT and draws; ``image``
    (a raw latent frame) makes it image-to-video."""
    jpipe, tpipe = pipelines
    jp = JPipeline(jpipe.dit, jpipe.dit_params, latent_channels=4,
                   dtype=jnp.float32, **settings)
    sched = _scheduler(settings)
    tp = PyramidFlowPipeline(tpipe.dit, scheduler=sched, latent_channels=4,
                             dtype=torch.float32)
    n = len(settings["stages"])
    assert tp.scheduler is sched and tp.num_stages == n
    gen = dict(height=size, width=size, temp=2,
               num_inference_steps=[2] + [1] * (n - 1),
               video_num_inference_steps=[1] * n, output_type="latent")
    key = jax.random.PRNGKey(SEED)
    if image is None:
        ref = jp.generate(key, *_args(jnp.asarray), **gen)
        noise = JaxNoise(SEED)
        out = tp.generate(None, *_args(torch.from_numpy), noise=noise, **gen)
    else:
        ref = jp.generate_i2v(key, jnp.asarray(image), *_args(jnp.asarray),
                              **gen)
        noise = JaxNoise(SEED, first_unit=1)
        out = tp.generate_i2v(None, torch.from_numpy(image),
                              *_args(torch.from_numpy), noise=noise, **gen)
    first = 0 if image is None else 1
    assert [c[1:3] for c in noise.calls[1:]] == [
        (u, s) for u in range(first, 2) for s in range(1, n)]
    return out.numpy(), np.asarray(ref)


def test_two_stages_match_jax(pipelines):  # noqa: F811
    out, ref = _generate_both(pipelines, TWO, 64)
    assert out.shape == ref.shape == (1, 2, 8, 8, 4)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)


def test_two_stages_i2v_match_jax(pipelines):  # noqa: F811
    img = np.random.default_rng(3).standard_normal(
        (1, 1, 8, 8, 4)).astype(np.float32)
    out, ref = _generate_both(pipelines, TWO, 64, image=img)
    assert out.shape == ref.shape == (1, 2, 8, 8, 4)
    assert np.abs(ref[:, 1:]).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)


def test_four_stages_match_jax(pipelines):  # noqa: F811
    out, ref = _generate_both(pipelines, FOUR, 128)
    assert out.shape == ref.shape == (1, 2, 16, 16, 4)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)


def test_default_scheduler_is_the_release_one():
    jpipe = JPipeline(None, None)
    pipe = PyramidFlowPipeline(None, device="cpu")
    s, js = pipe.scheduler, jpipe.scheduler
    assert pipe.num_stages == jpipe.num_stages == 3
    assert pipe.frame_per_unit == jpipe.frame_per_unit == 1
    assert (s.shift, s.stages, s.gamma) == (js.shift, js.stages, js.gamma)
    np.testing.assert_allclose(s.stage_range, js.stage_range, rtol=1e-12)
    for stage in range(3):
        for a, b in zip(s.inference_tables(20, stage),
                        js.inference_tables(20, stage)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)


# every setting away from its default, for the entry points: JAX's, and the
# port's (the scheduler they make)
JAX_SETTINGS = dict(TWO, frame_per_unit=2)
SETTINGS = dict(scheduler=_scheduler(TWO), frame_per_unit=2)


def _assert_settings(pipe, jpipe):
    """``pipe`` carries the port's SETTINGS, and its scheduler's tables are
    those of ``jpipe`` (JAX's, built with JAX_SETTINGS)."""
    assert pipe.num_stages == 2
    assert pipe.frame_per_unit == 2 == jpipe.frame_per_unit
    s = pipe.scheduler
    assert (s.shift, s.stages, s.stage_range, s.gamma) == (
        3.0, 2, (0, 0.5, 1), 0.25)
    assert jpipe.num_stages == 2
    for stage in range(2):
        for a, b in zip(s.inference_tables(4, stage),
                        jpipe.scheduler.inference_tables(4, stage)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)
    np.testing.assert_allclose(s.transition_coefficients(1),
                               jpipe.scheduler.transition_coefficients(1),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def release_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pyramid_flux"))
    write_release_dir(root, "pyramid_flux")
    return root


@pytest.fixture(scope="module")
def jax_pipe(release_root):
    return JPipeline.from_pretrained(release_root, VARIANT, "pyramid_flux",
                                     dtype=jnp.float32, **JAX_SETTINGS)


def test_from_pretrained_passes_the_settings(release_root, jax_pipe):
    pipe = PyramidFlowPipeline.from_pretrained(
        release_root, VARIANT, "pyramid_flux", dtype=torch.float32,
        device="cpu", **SETTINGS)
    _assert_settings(pipe, jax_pipe)


def test_runner_passes_the_settings(release_root, jax_pipe):
    runner = PyramidFlowRunner.from_pretrained(
        release_root, VARIANT, "pyramid_flux", dtype=torch.float32,
        device="cpu", **SETTINGS)
    _assert_settings(runner.pipeline, jax_pipe)
    # a run at these settings: unit 0 and one unit of two frames at 2 stages
    out = runner.generate("a cat", height=64, width=64, temp=3,
                          num_inference_steps=[1, 1],
                          video_num_inference_steps=[1, 1],
                          output_type="latent")
    assert out.shape == (1, 3, 8, 8, 4) and torch.isfinite(out).all()


def test_from_train_state_passes_the_settings(jax_pipe):
    state = create_train_state(
        PyramidFluxTransformer(FluxConfig(**DIT), device="cpu"),
        TrainConfig())
    pipe = PyramidFlowPipeline.from_train_state(
        state.model, state, dtype=torch.float32, latent_channels=4,
        **SETTINGS)
    _assert_settings(pipe, jax_pipe)
