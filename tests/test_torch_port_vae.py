"""Port parity: the causal VAE decoder, JAX vs torch (the encoder's tests
are in test_torch_port_encoder.py).

JAX weights (redrawn from a numpy seed so that every layer carries signal)
go to the port through ``vae_state_dict_from_jax`` and a strict load. fp32
on the CPU. Tolerances: windowed decode vs JAX's ``chunk_decode`` atol 1e-4
(27 conv layers of fp32 sums in another order); the port's windowed decode
vs its own monolithic decode atol 1e-5 (the same convs on the same frames).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.vae import layers as jlayers
from pyramid_flow_tpu.models.vae import model as jmodel
from pyramid_flow_tpu_torch.models.vae import layers, model
from pyramid_flow_tpu_torch.utils.converters import vae_state_dict_from_jax

CFG = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
           decoder_layers_per_block=(1, 1, 1, 1), num_groups=4)


def _randomize(params, seed):
    """Kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1), biases
    ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, p):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def vaes():
    jvae = jmodel.CausalVideoVAE(config=jmodel.VAEConfig(
        encoder_layers_per_block=(1, 1, 1, 1), **CFG))
    params = jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)),
                       rng=jax.random.PRNGKey(1))
    params = _randomize(params, 2)
    tvae = model.CausalVideoVAE(model.VAEConfig(
        encoder_layers_per_block=(1, 1, 1, 1), **CFG), device="cpu")
    np_params = jax.tree.map(np.asarray, params)
    sd = vae_state_dict_from_jax(np_params)
    res = tvae.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    # every leaf is consumed, the encoder's and quant_conv's included
    n_leaves = sum(np.size(x) for x in jax.tree.leaves(params["params"]))
    assert sum(t.numel() for t in sd.values()) == n_leaves
    return jvae, params, tvae


def _latent(t=3, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (1, t, 8, 8, 4)).astype(np.float32)


def test_chunk_decode_matches_jax(vaes):
    jvae, params, tvae = vaes
    z = _latent()
    ref = np.asarray(jmodel.chunk_decode(jvae, params, jnp.asarray(z),
                                         window_size=2))
    out = model.chunk_decode(tvae, torch.from_numpy(z), window_size=2)
    assert out.shape == (1, 17, 64, 64, 3) == ref.shape
    assert np.abs(ref).max() > 0.1  # the random weights carry signal
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("window", [1, 2])
def test_windowed_decode_equals_monolithic(vaes, window):
    _, _, tvae = vaes
    z = torch.from_numpy(_latent(t=4, seed=6))
    with torch.no_grad():
        mono = tvae.decode(z)
    out = model.chunk_decode(tvae, z, window_size=window)
    assert out.shape == mono.shape == (1, 25, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), mono.numpy(), atol=1e-5, rtol=0)


def test_window_starts_match_jax():
    for n, window in ((7, 2), (1, 2), (9, 4), (8, 3), (17, 16), (33, 8)):
        for init in (None, 1):
            assert (model._window_starts(n, window, init)
                    == jmodel._window_starts(n, window, init))


def test_spatial_attention_query_chunking_matches(monkeypatch):
    """Above ATTN_CHUNK_TOKENS both sides chunk the queries; the result is
    the direct attention's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 2, 8, 12, 16)).astype(np.float32)
    ja = jlayers.SpatialAttention(num_groups=4)
    params = _randomize(ja.init(jax.random.PRNGKey(0), jnp.asarray(x)), 8)
    ref = np.asarray(ja.apply(params, jnp.asarray(x)))
    ta = layers.SpatialAttention(16, num_groups=4)
    ta.load_state_dict(vae_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        direct = ta(xt).permute(0, 2, 3, 4, 1).numpy()
        monkeypatch.setattr(layers, "ATTN_CHUNK_TOKENS", 16)
        chunked = ta(xt).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(direct, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(chunked, direct, atol=1e-6, rtol=0)
