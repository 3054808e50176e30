"""Port parity at more than one latent frame per temporal unit.

The tiny DiT of test_torch_port_pipeline.py (JAX weights redrawn from a
numpy seed, carried to the port by the converters) in a second pipeline of
each package built with ``frame_per_unit=2``; the port replays JAX's draws
(``JaxNoise``). At 64x64, steps [2,2,2] / [1,1,1], fp32 on the CPU:

* text-to-video at temp 5: unit 0 is one frame, units 1 and 2 two frames
  each, 5 latent frames;
* image-to-video at temp 5: the image is unit 0 and unit 1 (two frames)
  is generated, 1 + (5 // 2 - 1) * 2 = 3 latent frames;
* the conditioning plan, each (unit, stage)'s positions, time ids and
  trainable count, and the per-stage token budgets at fpu 2 and 4, equal to
  JAX's.

Tolerance: latents atol 5e-4, as test_torch_port_pipeline.py's (the same DiT
forwards, fed back through the AR history).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline as JPipeline)
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from test_torch_port_pipeline import (  # noqa: F401 (the fixture)
    SEED, JaxNoise, _text, pipelines)

LATENT_ATOL = 5e-4
FPU, TEMP = 2, 5
GEN = dict(height=64, width=64, temp=TEMP, num_inference_steps=[2, 2, 2],
           video_num_inference_steps=[1, 1, 1], output_type="latent")


@pytest.fixture(scope="module")
def fpu_pipelines(pipelines):  # noqa: F811
    jpipe, tpipe = pipelines
    return (JPipeline(jpipe.dit, jpipe.dit_params, latent_channels=4,
                      dtype=jnp.float32, frame_per_unit=FPU),
            PyramidFlowPipeline(tpipe.dit, latent_channels=4,
                                dtype=torch.float32, frame_per_unit=FPU))


def _args(wrap):
    emb, mask, pooled = _text()
    return tuple(map(wrap, (emb, mask, pooled, emb * 0, mask, pooled * 0)))


def test_t2v_two_frames_per_unit_matches_jax(fpu_pipelines):
    jpipe, tpipe = fpu_pipelines
    assert (tpipe.frame_per_unit, tpipe.num_stages) == (FPU, 3)
    ref = np.asarray(jpipe.generate(jax.random.PRNGKey(SEED),
                                    *_args(jnp.asarray), **GEN))
    noise = JaxNoise(SEED)
    out = tpipe.generate(None, *_args(torch.from_numpy), noise=noise, **GEN)
    # 1 + ((5 - 1) // 2) * 2 latent frames
    assert out.shape == ref.shape == (1, 5, 8, 8, 4)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=LATENT_ATOL, rtol=0)
    # unit 0 draws one frame of block noise, units 1 and 2 two each
    assert noise.calls[0] == ("initial", (1, 5, 8, 8, 4))
    assert [c[1:] for c in noise.calls[1:]] == [
        (u, s, (1, 1 if u == 0 else FPU, 1 << s, 1 << s, 4, 4))
        for u in range(3) for s in (1, 2)]


def test_i2v_two_frames_per_unit_matches_jax(fpu_pipelines):
    jpipe, tpipe = fpu_pipelines
    img = np.random.default_rng(3).standard_normal(
        (1, 1, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jpipe.generate_i2v(
        jax.random.PRNGKey(SEED), jnp.asarray(img), *_args(jnp.asarray),
        **GEN))
    noise = JaxNoise(SEED, first_unit=1)
    calls = []
    out = tpipe.generate_i2v(None, torch.from_numpy(img),
                             *_args(torch.from_numpy), noise=noise,
                             progress_callback=calls.append, **GEN)
    # 1 + (5 // 2 - 1) * 2 latent frames: the image, then one unit of two
    assert out.shape == ref.shape == (1, 3, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=LATENT_ATOL, rtol=0)
    np.testing.assert_allclose(out[:, :1].numpy(), (img + 0.04) / 1.8726,
                               rtol=1e-6)
    assert [c[1:] for c in noise.calls[1:]] == [
        (1, s, (1, FPU, 1 << s, 1 << s, 4, 4)) for s in (1, 2)]
    assert [(c["unit"], c["units"]) for c in calls] == [(1, 1)]


@pytest.mark.parametrize("fpu", [2, 4])
def test_stage_metadata_and_budgets_match_jax(fpu):
    jpipe = JPipeline(None, None, frame_per_unit=fpu)
    tpipe = PyramidFlowPipeline(None, frame_per_unit=fpu, device="cpu")
    for h_lat, w_lat in ((8, 8), (48, 80), (96, 160)):
        for unit in (0, 1, 2, 5, 15):
            budgets = tpipe._cond_token_budget(unit, h_lat, w_lat)
            assert budgets == jpipe._cond_token_budget(unit, h_lat, w_lat)
            cur = 1 if unit == 0 else fpu  # the current clip's frames
            for stage in range(3):
                assert (tpipe._cond_clip_plan(unit, stage)
                        == jpipe._cond_clip_plan(unit, stage))
                for a, b in zip(
                        tpipe._stage_metadata(2, cur, h_lat, w_lat, unit,
                                              stage, budgets[stage]),
                        jpipe._stage_metadata(2, cur, h_lat, w_lat, unit,
                                              stage, budgets[stage])):
                    np.testing.assert_array_equal(a, b)
