"""Port parity: scheduler tables and pipeline primitives, JAX vs torch.

Inputs come from a numpy seed and go to both sides as numpy; JAX runs on the
CPU. Tolerance: exact for the numpy tables and integer layouts, atol 1e-6
for fp32 tensor math (both sides do the same fp32 operations, only their
order differs).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.ops import blocknoise as jblocknoise
from pyramid_flow_tpu.ops import resample as jresample
from pyramid_flow_tpu.ops import rope as jrope
from pyramid_flow_tpu.pipeline import noising as jnoising
from pyramid_flow_tpu.pipeline import packing as jpacking
from pyramid_flow_tpu.schedulers import flow_matching as jfm
from pyramid_flow_tpu_torch.ops import blocknoise, resample, rope
from pyramid_flow_tpu_torch.pipeline import noising, packing
from pyramid_flow_tpu_torch.schedulers import flow_matching as fm

ATOL = 1e-6


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("shift,stages", [(1.0, 3), (3.0, 3), (1.0, 2)])
def test_scheduler_tables_equal(shift, stages):
    rng = tuple(np.linspace(0, 1, stages + 1))
    j = jfm.PyramidFlowMatchEulerDiscreteScheduler(
        shift=shift, stages=stages, stage_range=rng)
    t = fm.PyramidFlowMatchEulerDiscreteScheduler(
        shift=shift, stages=stages, stage_range=rng)
    np.testing.assert_array_equal(fm._shifted_sigmas(1000, shift),
                                  jfm._shifted_sigmas(1000, shift))
    for s in range(stages):
        for n in (1, 10, 20):
            for a, b in zip(t.inference_tables(n, s),
                            j.inference_tables(n, s)):
                np.testing.assert_array_equal(a, b)
        if s > 0:
            assert t.transition_coefficients(s) == \
                j.transition_coefficients(s)
    assert t.start_sigmas == j.start_sigmas
    assert t.ori_start_sigmas == j.ori_start_sigmas


def test_rope_matches():
    pos = np.abs(_rand((2, 37, 3))) * 7
    x = _rand((2, 3, 37, 64), 1)
    jc, js = jrope.rope_freqs(jnp.asarray(pos))
    tc, ts = rope.rope_freqs(torch.from_numpy(pos))
    _close(tc, jc)
    _close(ts, js)
    _close(rope.apply_rope(torch.from_numpy(x), tc, ts),
           jrope.apply_rope(jnp.asarray(x), jc, js))


def test_resample_matches():
    x = _rand((2, 3, 8, 12, 5))
    cl = np.moveaxis(x, -1, -3)  # the pipeline's moveaxis use
    _close(resample.avg_pool_2x(torch.from_numpy(cl)),
           jresample.avg_pool_2x(jnp.asarray(cl)))
    _close(resample.nearest_up_2x(torch.from_numpy(cl)),
           jresample.nearest_up_2x(jnp.asarray(cl)))
    for a, b in ((8, 4), (8, 2), (10, 5), (6, 6)):
        np.testing.assert_array_equal(
            resample.interp_linear_1d_grid(a, b),
            jresample.interp_linear_1d_grid(a, b))


def test_block_noise_replays_jax_draw():
    """Given JAX's standard-normal draw z, the port's Cholesky layout gives
    JAX's block noise."""
    shape = (2, 3, 8, 6, 4)
    key = jax.random.PRNGKey(3)
    ref = jblocknoise.sample_block_noise(key, shape)
    z = jax.random.normal(key, (2, 3, 4, 3, 4, 4), jnp.float32)
    _close(blocknoise.block_noise_from_normal(torch.from_numpy(np.array(z))),
           ref)


def test_packing_matches():
    x = _rand((2, 3, 8, 6, 4))
    tok = packing.patchify(torch.from_numpy(x))
    _close(tok, jpacking.patchify(jnp.asarray(x)), atol=0)
    _close(packing.unpatchify(tok, 3, 8, 6), x, atol=0)
    np.testing.assert_array_equal(packing.clip_positions(2, 3, 4, 6, 8, 5),
                                  jpacking.clip_positions(2, 3, 4, 6, 8, 5))
    shapes = [(1, 2, 4, 4, 16), (1, 1, 8, 8, 16), (1, 1, 16, 16, 16)]
    for a, b in zip(packing.clip_metadata(shapes),
                    jpacking.clip_metadata(shapes)):
        np.testing.assert_array_equal(a, b)


def test_noising_inference_half_matches():
    assert noising.LATENT_NORMS == jnoising.LATENT_NORMS
    assert noising.VIDEO_NORM == jnoising.VIDEO_NORM
    x = _rand((2, 3, 16, 8, 4))
    for a, b in zip(noising.latent_pyramid(torch.from_numpy(x), 3),
                    jnoising.latent_pyramid(jnp.asarray(x), 3)):
        _close(a, b)


def test_port_imports_no_jax():
    """Importing the port and every module of its slices, the training CLI
    and the data loaders included, loads no JAX (imports inside functions:
    test_torch_port_imports.py)."""
    mods = [
        "pyramid_flow_tpu_torch",
        "pyramid_flow_tpu_torch.ops.flash_attention",
        "pyramid_flow_tpu_torch.ops.rope",
        "pyramid_flow_tpu_torch.ops.resample",
        "pyramid_flow_tpu_torch.ops.blocknoise",
        "pyramid_flow_tpu_torch.ops.causal_conv3d",
        "pyramid_flow_tpu_torch.schedulers.flow_matching",
        "pyramid_flow_tpu_torch.pipeline.packing",
        "pyramid_flow_tpu_torch.pipeline.noising",
        "pyramid_flow_tpu_torch.pipeline.pyramid_pipeline",
        "pyramid_flow_tpu_torch.pipeline.runner",
        "pyramid_flow_tpu_torch.models.flux.blocks",
        "pyramid_flow_tpu_torch.models.flux.model",
        "pyramid_flow_tpu_torch.models.vae.layers",
        "pyramid_flow_tpu_torch.models.vae.blocks",
        "pyramid_flow_tpu_torch.models.vae.model",
        "pyramid_flow_tpu_torch.utils.converters",
        "pyramid_flow_tpu_torch.utils.cuda_build",
        "pyramid_flow_tpu_torch.utils.metrics",
        "pyramid_flow_tpu_torch.data.bucket",
        "pyramid_flow_tpu_torch.data.datasets",
        "pyramid_flow_tpu_torch.data.loaders",
        "pyramid_flow_tpu_torch.training.lr_schedules",
        "pyramid_flow_tpu_torch.training.train_state",
        "pyramid_flow_tpu_torch.training.trainer",
        "pyramid_flow_tpu_torch.training.telemetry",
        "pyramid_flow_tpu_torch.tools.train_pyramid_flow",
    ]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'pyramid_flow_tpu')"
            " or m.startswith(('jax.', 'flax', 'pyramid_flow_tpu.'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
