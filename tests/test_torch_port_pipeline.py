"""Port parity for the whole slice: ``generate`` JAX vs torch.

A tiny DiT and VAE (the configs of ``tests/test_pipeline.py``) with JAX
weights redrawn from a numpy seed, carried to the port by the converters.
The port replays JAX's noise: a noise source re-derives JAX's key splits for
the initial draw and for every stage transition's block noise. temp = 3 at
64x64, steps [2,2,2] / [1,1,1], fp32 on the CPU.

Tolerances: latents atol 5e-4 (about 30 DiT forwards of fp32 sums in another
order, fed back through the AR history); uint8 frames equal except for at
most 1 level on at most 0.1% of values (a pixel value sitting on a
rounding edge of the float -> uint8 cast).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.flux.model import (
    FluxConfig as JFluxConfig, PyramidFluxTransformer as JDiT)
from pyramid_flow_tpu.models.vae.model import (
    CausalVideoVAE as JVAE, VAEConfig as JVAEConfig, tiled_decode)
from pyramid_flow_tpu.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline as JPipeline)
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.vae.model import CausalVideoVAE, VAEConfig
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    DecodePlan, PyramidFlowPipeline)
from pyramid_flow_tpu_torch.utils.converters import (
    flux_state_dict_from_jax, vae_state_dict_from_jax)

DIT = dict(in_channels=16, num_layers=1, num_single_layers=1,
           attention_head_dim=8, num_attention_heads=4,
           joint_attention_dim=32, pooled_projection_dim=24,
           axes_dims_rope=(4, 2, 2))
VAE = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
           decoder_layers_per_block=(1, 1, 1, 1), num_groups=4)
SEED = 11
GEN = dict(height=64, width=64, temp=3, num_inference_steps=[2, 2, 2],
           video_num_inference_steps=[1, 1, 1])


class JaxNoise:
    """Replays the draws JAX's ``generate(key)`` makes (``key`` a PRNG key or
    an int seed): the initial latents from the first split, and for unit u,
    stage s > 0 the block-noise draw from the (s+1)-th split of the unit's
    key, the unit's key being the (u - first_unit + 1)-th split after the
    initial one (``first_unit`` is 1 for image-to-video, whose loop starts at
    unit 1)."""

    def __init__(self, key, first_unit=0):
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key
        self.first_unit = first_unit
        self.calls = []

    def initial(self, shape):
        _, sub = jax.random.split(self.key)
        self.calls.append(("initial", shape))
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))

    def block(self, unit, stage, shape):
        rng, _ = jax.random.split(self.key)
        for _ in range(unit - self.first_unit + 1):
            rng, unit_key = jax.random.split(rng)
        for _ in range(stage + 1):
            unit_key, sub = jax.random.split(unit_key)
        self.calls.append(("block", unit, stage, shape))
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))


@pytest.fixture(scope="module")
def pipelines():
    dit_j = JDiT(config=JFluxConfig(**DIT), dtype=jnp.float32)
    # shapes only (nothing compiles): every leaf is redrawn below
    dit_params = jax.eval_shape(
        dit_j.init, jax.random.PRNGKey(0), jnp.zeros((2, 16, 16)),
        jnp.zeros((2, 16, 3)), jnp.zeros((2, 16), jnp.int32),
        jnp.zeros((2, 8, 32)), jnp.ones((2, 8), bool), jnp.zeros((2, 24)),
        jnp.zeros((2,)))
    rng = np.random.default_rng(1)
    dit_params = jax.tree.map(
        lambda p: (0.02 * rng.standard_normal(p.shape)).astype(np.float32),
        dit_params)
    vae_j = JVAE(config=JVAEConfig(encoder_layers_per_block=(1, 1, 1, 1),
                                   **VAE))
    vae_params = jax.eval_shape(lambda: vae_j.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 1, 32, 32, 3)),
        rng=jax.random.PRNGKey(3)))
    vae_params = jax.tree_util.tree_map_with_path(
        lambda path, p: (
            rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[:-1]))
            if path[-1].key == "kernel" else
            (path[-1].key == "scale") + 0.1 * rng.standard_normal(p.shape)
        ).astype(np.float32), vae_params)
    jpipe = JPipeline(dit_j, dit_params, vae_j, vae_params, latent_channels=4,
                      dtype=jnp.float32)

    dit_t = PyramidFluxTransformer(FluxConfig(**DIT), device="cpu")
    dit_t.load_state_dict(flux_state_dict_from_jax(
        jax.tree.map(np.asarray, dit_params)), strict=True)
    vae_t = CausalVideoVAE(VAEConfig(encoder_layers_per_block=(1, 1, 1, 1),
                                     **VAE), device="cpu")
    vae_t.load_state_dict(vae_state_dict_from_jax(
        jax.tree.map(np.asarray, vae_params)), strict=True)
    tpipe = PyramidFlowPipeline(dit_t, vae_t, latent_channels=4,
                                dtype=torch.float32)
    return jpipe, tpipe


def _text(b=1):
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((b, 8, 32)).astype(np.float32)
    mask = np.ones((b, 8), bool)
    mask[:, 6:] = False
    pooled = rng.standard_normal((b, 24)).astype(np.float32)
    return emb, mask, pooled


@pytest.fixture(scope="module")
def jax_latents(pipelines):
    jpipe, _ = pipelines
    emb, mask, pooled = map(jnp.asarray, _text())
    return np.asarray(jpipe.generate(
        jax.random.PRNGKey(SEED), emb, mask, pooled, emb * 0, mask,
        pooled * 0, output_type="latent", **GEN))


def _port_generate(tpipe, noise, **kw):
    emb, mask, pooled = map(torch.from_numpy, _text())
    return tpipe.generate(None, emb, mask, pooled, emb * 0, mask, pooled * 0,
                          noise=noise, **{**GEN, **kw})


def test_generate_latents_match_jax(pipelines, jax_latents):
    _, tpipe = pipelines
    noise = JaxNoise(SEED)
    out = _port_generate(tpipe, noise, output_type="latent")
    assert out.shape == jax_latents.shape == (1, 3, 8, 8, 4)
    assert np.abs(jax_latents).max() > 0.1
    np.testing.assert_allclose(out.numpy(), jax_latents, atol=5e-4, rtol=0)
    # one initial draw, then a block-noise draw per (unit, stage > 0)
    assert noise.calls[0] == ("initial", (1, 3, 8, 8, 4))
    assert [c[1:3] for c in noise.calls[1:]] == [
        (u, s) for u in range(3) for s in (1, 2)]


def test_generate_pixels_match_jax(pipelines, jax_latents):
    jpipe, tpipe = pipelines
    ref = np.asarray(jpipe.decode_latent(jnp.asarray(jax_latents)))
    calls = []
    out = _port_generate(tpipe, JaxNoise(SEED), output_type="pixels",
                         progress_callback=calls.append).numpy()
    assert out.shape == ref.shape == (1, 17, 64, 64, 3)
    assert out.dtype == ref.dtype == np.uint8
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert len(np.unique(ref)) > 10
    assert [c["phase"] for c in calls] == ["denoise"] * 3 + ["decode"]


def test_linear_guidance_and_generator_noise(pipelines):
    """Linear guidance changes the result; the default noise comes from the
    explicit generator and repeats with its seed."""
    _, tpipe = pipelines
    emb, mask, pooled = map(torch.from_numpy, _text())

    def run(seed, **kw):
        return tpipe.generate(torch.Generator().manual_seed(seed), emb, mask,
                              pooled, emb * 0, mask, pooled * 0, **GEN, **kw)

    a, b = run(0), run(0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, run(0, use_linear_guidance=True))
    assert not torch.allclose(a, run(1))


def test_release_dit_is_one_shot_and_decode_plan_limit(pipelines):
    """Above the plan's untiled limit the decode tiles, as JAX's
    ``tiled_decode`` with the same tile, overlap and window."""
    jpipe, tpipe = pipelines
    dit = tpipe.dit
    try:
        out = _port_generate(tpipe, JaxNoise(SEED), output_type="pixels",
                             release_dit_before_decode=True, temp=1)
        assert out.shape == (1, 1, 64, 64, 3) and tpipe.dit is None
        with pytest.raises(RuntimeError, match="released"):
            _port_generate(tpipe, JaxNoise(SEED))
    finally:
        tpipe.dit = dit
    lat = np.random.default_rng(9).standard_normal(
        (1, 3, 8, 8, 4)).astype(np.float32)
    plan = DecodePlan(untiled_max_latent=4, tile=32, overlap=0.25)
    with pytest.raises(TypeError):  # save_memory and plan are keyword-only
        tpipe.decode_latent(torch.from_numpy(lat), plan)
    out = tpipe.decode_latent(torch.from_numpy(lat), plan=plan)
    z = jpipe.denormalize_latent(jnp.asarray(lat))
    ref = jnp.clip(tiled_decode(jpipe.vae, jpipe.vae_params, z, 32,
                                temporal_chunk=True, window_size=2,
                                overlap_factor=0.25) * 127.5 + 127.5, 0, 255)
    ref = np.asarray(ref.astype(jnp.uint8))
    assert out.shape == ref.shape == (1, 17, 64, 64, 3)
    diff = np.abs(out.numpy().astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_stage_metadata_and_budgets_match_jax(pipelines):
    jpipe, tpipe = pipelines
    for h_lat, w_lat in ((8, 8), (48, 80), (96, 160)):
        for unit in (0, 1, 2, 5, 15):
            budgets = tpipe._cond_token_budget(unit, h_lat, w_lat)
            assert budgets == jpipe._cond_token_budget(unit, h_lat, w_lat)
            for stage in range(3):
                for a, b in zip(
                        tpipe._stage_metadata(2, 1, h_lat, w_lat, unit,
                                              stage, budgets[stage]),
                        jpipe._stage_metadata(2, 1, h_lat, w_lat, unit,
                                              stage, budgets[stage])):
                    np.testing.assert_array_equal(a, b)
