"""Port parity: the causal VAE encoder, the posterior and tiled coding, JAX vs
torch.

A tiny VAE (latent 4, channels (8, 8, 16, 16), one resnet per block) with
JAX weights redrawn from a numpy seed goes to the port through
``vae_state_dict_from_jax`` and a strict load. fp32 on the CPU.
Tolerances: the port against JAX atol 1e-4 (about 20 conv layers of fp32
sums in another order; the decoder's parity test uses the same); the port's
windowed encode against its own monolithic encode atol 1e-5 (the same convs
on the same frames); the posterior helpers rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.vae import model as jmodel
from pyramid_flow_tpu_torch.models.vae import layers, model
from pyramid_flow_tpu_torch.utils.converters import vae_state_dict_from_jax
from test_torch_port_vae import CFG, _randomize

ATOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    jcfg = jmodel.VAEConfig(encoder_layers_per_block=(1, 1, 1, 1), **CFG)
    jvae = jmodel.CausalVideoVAE(config=jcfg)
    shapes = jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)),
        rng=jax.random.PRNGKey(1)))
    params = jax.tree.map(jnp.asarray, _randomize(shapes, 12))
    tvae = model.CausalVideoVAE(model.VAEConfig(
        encoder_layers_per_block=(1, 1, 1, 1), **CFG), device="cpu")
    tvae.load_state_dict(vae_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return jvae, params, tvae


def _pixels(t, h=32, w=32, seed=4):
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, t, h, w, 3)).astype(np.float32)


def test_encode_matches_jax(vaes):
    jvae, params, tvae = vaes
    x = _pixels(9)
    ref = np.asarray(jvae.apply(params, jnp.asarray(x), method=jvae.encode))
    with torch.no_grad():
        out = tvae.encode(torch.from_numpy(x))
    assert out.shape == ref.shape == (1, 2, 4, 4, 8)
    assert np.abs(ref).max() > 0.1  # the random weights carry signal
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_chunk_encode_matches_jax_and_monolithic(vaes):
    """17 frames: one 17-frame window (JAX's default split at window 16),
    and windows of 9 + 8 frames, which carry every temporal conv's front
    across the split."""
    jvae, params, tvae = vaes
    x = _pixels(17, seed=5)
    ref = np.asarray(jmodel.chunk_encode(jvae, params, jnp.asarray(x),
                                         window_size=16))
    xt = torch.from_numpy(x)
    out = model.chunk_encode(tvae, xt, window_size=16)
    assert out.shape == ref.shape == (1, 3, 4, 4, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    with torch.no_grad():
        mono = tvae.encode(xt)
    np.testing.assert_allclose(model.chunk_encode(tvae, xt, 8).numpy(),
                               mono.numpy(), atol=1e-5, rtol=0)


def test_gaussian_helpers_match_jax():
    rng = np.random.default_rng(8)
    moments = (3 * rng.standard_normal((2, 3, 4, 5, 8))).astype(np.float32)
    moments[..., 4:] *= 10  # log-variances beyond the clip on both sides
    key = jax.random.PRNGKey(3)
    jm = jnp.asarray(moments)
    ref = np.asarray(jmodel.gaussian_sample(jm, key))
    draw = torch.from_numpy(np.array(
        jax.random.normal(key, (2, 3, 4, 5, 4), jnp.float32)))
    tm = torch.from_numpy(moments)
    np.testing.assert_allclose(model.gaussian_sample(tm, draw).numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(model.gaussian_mode(tm).numpy(),
                                  np.asarray(jmodel.gaussian_mode(jm)))
    np.testing.assert_allclose(model.gaussian_kl(tm).numpy(),
                               np.asarray(jmodel.gaussian_kl(jm)), rtol=1e-6)
    # a generator draws the same as the draw it would give
    a = model.gaussian_sample(tm, torch.Generator().manual_seed(1))
    b = model.gaussian_sample(tm, torch.randn(
        (2, 3, 4, 5, 4), generator=torch.Generator().manual_seed(1)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tiled_encode_and_decode_match_jax(vaes):
    """32-pixel tiles (4 latent pixels) overlapping by a quarter over a
    48x64 frame: ragged edge tiles and a blended seam on both axes."""
    jvae, params, tvae = vaes
    x = _pixels(9, 48, 64, seed=6)
    ref = np.asarray(jmodel.tiled_encode(
        jvae, params, jnp.asarray(x), tile_sample_min_size=32,
        temporal_chunk=True, window_size=8))
    out = model.tiled_encode(tvae, torch.from_numpy(x),
                             tile_sample_min_size=32, temporal_chunk=True,
                             window_size=8)
    assert out.shape == ref.shape == (1, 2, 6, 8, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)

    z = np.asarray(jmodel.gaussian_mode(jnp.asarray(ref)))
    ref_px = np.asarray(jmodel.tiled_decode(
        jvae, params, jnp.asarray(z), tile_sample_min_size=32,
        temporal_chunk=True, window_size=1))
    px = model.tiled_decode(tvae, torch.from_numpy(z),
                            tile_sample_min_size=32, temporal_chunk=True,
                            window_size=1)
    assert px.shape == ref_px.shape == (1, 9, 48, 64, 3)
    np.testing.assert_allclose(px.numpy(), ref_px, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tiled", [False, True])
def test_reconstruct_matches_jax(vaes, tiled):
    """At the tiled test's frame size, whose tile programs JAX has
    compiled already."""
    jvae, params, tvae = vaes
    x = _pixels(9, 48, 64, seed=7)
    ref = np.asarray(jmodel.reconstruct(jvae, params, jnp.asarray(x),
                                        window_size=8, tiled=tiled,
                                        tile_sample_min_size=32))
    out = model.reconstruct(tvae, torch.from_numpy(x), window_size=8,
                            tiled=tiled, tile_sample_min_size=32)
    assert out.shape == ref.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_convs_see_channels_last_inputs(vaes):
    """No hidden layout copies: every conv of the encode and the decode
    receives a channels-last activation, so the kernel route's
    ``contiguous()`` never copies."""
    _, _, tvae = vaes
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(
            (m.cache_key, args[0].is_contiguous(
                memory_format=torch.channels_last_3d))))
        for m in tvae.modules() if isinstance(m, layers.CausalConv3d)]
    try:
        moments = model.chunk_encode(tvae, torch.from_numpy(_pixels(17)), 8)
        model.chunk_decode(tvae, model.gaussian_mode(moments), 2)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) > 50
    assert [k for k, ok in seen if not ok] == []
