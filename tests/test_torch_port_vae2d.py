"""Port parity: the VAE's per-level resample flags and block-type strings,
with the non-causal 2D twin blocks, JAX vs torch on the CPU.

Two tiny configs: the JAX package's own 2D-twin test config (every block a
2D twin, no temporal downsampling; ``tests/test_vae.py``), and a mixed one
(2D down blocks 0-1 that downsample in time through the twin's non-causal
temporal conv, causal blocks elsewhere, the causal mid block, 2D up blocks).
JAX weights redrawn from a numpy seed go to the port through
``vae_state_dict_from_jax`` and a strict load (every leaf consumed). fp32;
tolerance atol 1e-4 on moments and frames (conv sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.vae import model as jmodel
from pyramid_flow_tpu_torch.models.vae import model
from pyramid_flow_tpu_torch.models.vae.blocks import (
    DownEncoderBlock2D, MidBlock2D, UpDecoderBlock2D)
from pyramid_flow_tpu_torch.utils.converters import vae_state_dict_from_jax

BASE = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
            encoder_layers_per_block=(1, 1, 1, 1),
            decoder_layers_per_block=(1, 1, 1, 1), num_groups=4)
CONFIGS = {
    "all_2d": dict(BASE, down_block_types=("DownEncoderBlock2D",) * 4,
                   up_block_types=("UpDecoderBlock2D",) * 4,
                   mid_block_type="UNetMidBlock2D",
                   temporal_down_sample=(False,) * 4),
    "mixed": dict(BASE, down_block_types=(
        "DownEncoderBlock2D", "DownEncoderBlock2D",
        "DownEncoderBlockCausal3D", "DownEncoderBlockCausal3D"),
        up_block_types=("UpDecoderBlock2D", "UpDecoderBlockCausal3D",
                        "UpDecoderBlock2D", "UpDecoderBlockCausal3D"),
        spatial_down_sample=(True, True, True, False),
        temporal_down_sample=(True, True, False, False)),
}
FRAMES = {"all_2d": 2, "mixed": 5}
TOL = dict(atol=1e-4, rtol=0)


def _randomize(params, seed):
    rng = np.random.default_rng(seed)

    def draw(path, p):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def vaes(request):
    cfg = CONFIGS[request.param]
    jvae = jmodel.CausalVideoVAE(config=jmodel.VAEConfig(**cfg))
    x0 = jnp.zeros((1, FRAMES[request.param], 32, 32, 3))
    # shapes only (no compile): every leaf is redrawn from numpy anyway
    params = _randomize(jax.eval_shape(
        jvae.init, jax.random.PRNGKey(0), x0, rng=jax.random.PRNGKey(1)), 2)
    tvae = model.CausalVideoVAE(model.VAEConfig(**cfg), device="cpu")
    sd = vae_state_dict_from_jax(jax.tree.map(np.asarray, params))
    res = tvae.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    n_leaves = sum(np.size(x) for x in jax.tree.leaves(params["params"]))
    assert sum(t.numel() for t in sd.values()) == n_leaves
    return request.param, jvae, params, tvae


def test_blocks_follow_the_config(vaes):
    name, _, _, tvae = vaes
    cfg = CONFIGS[name]
    kinds = [type(b) is DownEncoderBlock2D for b in tvae.encoder.down_blocks]
    assert kinds == [t == "DownEncoderBlock2D"
                     for t in cfg["down_block_types"]]
    assert [type(b) is UpDecoderBlock2D for b in tvae.decoder.up_blocks] == [
        t == "UpDecoderBlock2D" for t in cfg["up_block_types"]]
    assert (type(tvae.encoder.mid_block) is MidBlock2D) == (
        cfg.get("mid_block_type") == "UNetMidBlock2D")
    temporal = [len(b.temporal_downsamplers) == 1
                for b in tvae.encoder.down_blocks]
    assert temporal == list(cfg["temporal_down_sample"])
    # the 2D twins' per-frame conv weights stay 4-D, the others channels-last
    for p in tvae.parameters():
        if p.dim() == 5:
            assert p.is_contiguous(memory_format=torch.channels_last_3d)


def test_encode_decode_match_jax(vaes):
    name, jvae, params, tvae = vaes
    x = np.random.default_rng(3).uniform(
        -1, 1, (1, FRAMES[name], 32, 32, 3)).astype(np.float32)
    want_m = np.asarray(jax.jit(lambda p, v: jvae.apply(
        p, v, method=jvae.encode))(params, jnp.asarray(x)))
    with torch.no_grad():
        got_m = tvae.encode(torch.from_numpy(x)).numpy()
    assert got_m.shape == want_m.shape
    assert np.abs(want_m).max() > 0.1
    np.testing.assert_allclose(got_m, want_m, **TOL)
    z = want_m[..., :4].copy()
    want = np.asarray(jax.jit(lambda p, v: jvae.apply(
        p, v, method=jvae.decode))(params, jnp.asarray(z)))
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape and got.shape[2:] == (32, 32, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_windowed_decode_matches_jax(vaes):
    _, jvae, params, tvae = vaes
    z = np.random.default_rng(4).standard_normal(
        (1, 3, 4, 4, 4)).astype(np.float32)
    want = np.asarray(jmodel.chunk_decode(jvae, params, jnp.asarray(z),
                                          window_size=2))
    got = model.chunk_decode(tvae, torch.from_numpy(z), window_size=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
