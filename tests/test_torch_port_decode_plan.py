"""Port parity: the memory-planned VAE decode, JAX vs torch, on the CPU.

* ``plan_axis`` equals JAX's over a grid of (extent, tile_max, min_overlap)
  with ``tile_max > min_overlap`` (JAX's never returns below that), and the
  port raises there;
* ``tiled_decode_planned`` with a positional fake decoder (nearest 8x up,
  so overlapping tiles see identical pixels) is exact (atol 1e-6), and with
  a tiny VAE matches JAX's (fp32, atol 1e-4: 27 conv layers summed in
  another order);
* ``decode_settings`` equals JAX's for each (save_memory, memory, DiT
  resident);
* ``decode_latent`` takes JAX's rung (the same decode function with the
  same arguments) for every latent (hl, wl) at the 9216 budget and at
  every memory class; the decode functions are recorded, not run, on both
  sides, and JAX's device memory is patched (``_device_hbm_gb``) in the
  test, not edited.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.vae import model as jmodel
from pyramid_flow_tpu.pipeline import pyramid_pipeline as jpp
from pyramid_flow_tpu_torch.models.vae import model
from pyramid_flow_tpu_torch.pipeline import pyramid_pipeline as tpp
from pyramid_flow_tpu_torch.utils.converters import vae_state_dict_from_jax

CFG = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
           encoder_layers_per_block=(1, 1, 1, 1),
           decoder_layers_per_block=(1, 1, 1, 1), num_groups=4)


def test_plan_axis_matches_jax():
    for extent in (7, 12, 20, 48, 96, 160, 161):
        for tile_max in range(2, 100, 3):
            for ov in (0, 1, 2, 6):
                if tile_max <= ov:
                    if tile_max < extent:
                        with pytest.raises(ValueError, match="min_overlap"):
                            model.plan_axis(extent, tile_max, ov)
                    continue
                got = model.plan_axis(extent, tile_max, ov)
                assert got == jmodel.plan_axis(extent, tile_max, ov), (
                    extent, tile_max, ov)
    # the 768p plans of decode_latent and the tiling experiment
    assert model.plan_axis(160, 46, 6) == (46, [0, 38, 76, 114])
    assert model.plan_axis(160, 48, 6) == (46, [0, 38, 76, 114])
    assert model.plan_axis(96, 48, 6) == (36, [0, 30, 60])


@pytest.fixture(scope="module")
def vaes():
    jvae = jmodel.CausalVideoVAE(config=jmodel.VAEConfig(**CFG))
    # shapes only (no compile): every leaf is redrawn below
    params = jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 16, 16, 3)),
                            rng=jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)

    def draw(path, p):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, params)
    tvae = model.CausalVideoVAE(model.VAEConfig(**CFG), device="cpu")
    tvae.load_state_dict(vae_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return jvae, params, tvae


def test_planned_stitch_is_exact_with_a_positional_fake(vaes):
    _, _, tvae = vaes

    def fake(tile):
        return tile[..., :3].repeat_interleave(8, 2).repeat_interleave(8, 3)

    z = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 2, 12, 20, 4)).astype(np.float32))
    ref = fake(z)
    for th, tw in [(8, 9), (12, 7), (5, 20), (12, 20), (3, 4)]:
        out = model.tiled_decode_planned(tvae, z, tile_h=th, tile_w=tw,
                                         min_overlap=2, _decode_fn=fake)
        assert out.shape == ref.shape, (th, tw)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6,
                                   err_msg=f"tile {th}x{tw}")


@pytest.mark.parametrize("tile_h,tile_w,window", [(8, 7, 2), (5, 12, 1)])
def test_planned_decode_matches_jax(vaes, tile_h, tile_w, window):
    jvae, params, tvae = vaes
    z = np.random.default_rng(12).standard_normal(
        (1, 3, 8, 12, 4)).astype(np.float32)
    ref = np.asarray(jmodel.tiled_decode_planned(
        jvae, params, jnp.asarray(z), tile_h=tile_h, tile_w=tile_w,
        min_overlap=2, window_size=window))
    out = model.tiled_decode_planned(tvae, torch.from_numpy(z),
                                     tile_h=tile_h, tile_w=tile_w,
                                     min_overlap=2, window_size=window)
    assert out.shape == ref.shape == (1, 17, 64, 96, 3)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_decode_settings_match_jax():
    for save_memory in (False, True):
        for memory in (8.0, 16.0, 40.0, 47.9, 48.0, 80.0, 95.0):
            for resident in (False, True):
                got = dataclasses.asdict(tpp.decode_settings(
                    save_memory, memory, dit_resident=resident))
                want = jpp.decode_settings(save_memory, memory,
                                           dit_resident=resident)
                want.setdefault("px_window_budget", None)
                assert got == want, (save_memory, memory, resident)
    # the 80 GB card's plan is the one earlier decodes used
    assert tpp.decode_settings(True, 80.0) == tpp.DecodePlan()


@pytest.mark.parametrize("memory", [16.0, 80.0])
@pytest.mark.parametrize("resident", [False, True])
def test_decode_latent_takes_jax_rungs(memory, resident):
    names = ("chunk_decode", "tiled_decode", "tiled_decode_planned")
    seen = {"jax": [], "port": []}

    def recorder(side, name):
        def rec(*args, **kw):
            z = args[2] if side == "jax" else args[1]
            kw = {k: v for k, v in kw.items() if k != "_decode_fn"}
            seen[side].append((name, tuple(z.shape), kw))
            # a stand-in for the frames: only the rung is compared
            return (jnp.zeros if side == "jax" else torch.zeros)(
                (1, 1, 1, 1, 3))
        return rec

    jpipe = jpp.PyramidFlowPipeline(object(), {} if resident else None,
                                    vae=object(), vae_params={})
    tpipe = tpp.PyramidFlowPipeline(None, vae=object(), device="cpu")
    tpipe.dit = object() if resident else None
    # the rung depends on the latent's shape alone; without the
    # normalisation JAX compiles no op per shape
    jpipe.denormalize_latent = tpipe.denormalize_latent = lambda x: x
    patches = [mock.patch.object(jmodel, n, recorder("jax", n))
               for n in names]
    patches += [mock.patch.object(model, n, recorder("port", n))
                for n in names]
    patches.append(mock.patch.object(jpp, "_device_hbm_gb",
                                     lambda: memory))
    patches.append(mock.patch.object(tpp, "device_memory_gb",
                                     lambda dev: memory))
    for p in patches:
        p.start()
    try:
        # latent sizes on both sides of every rung's limit at the 9216
        # budget (untiled w2 / w1, strips at least 32 wide, the 96 x 96
        # untiled limit, the 192 x 192 one)
        rungs = set()
        for hl in (4, 48, 64, 96, 97, 143, 144, 150, 192, 193, 300):
            for wl in (16, 46, 48, 64, 96, 97, 160, 192, 193, 240):
                z = np.zeros((1, 2, hl, wl, 16), np.float32)
                seen["jax"].clear()
                seen["port"].clear()
                jpipe.decode_latent(jnp.asarray(z), save_memory=True)
                tpipe.decode_latent(torch.from_numpy(z))
                assert seen["port"] == seen["jax"], (hl, wl)
                assert len(seen["port"]) == 1
                rungs.add((seen["port"][0][0],
                           seen["port"][0][2].get("window_size")))
        if memory >= 48:  # untiled w2 up to 192 x 192, then 512 px tiles
            want = {("chunk_decode", 2), ("tiled_decode", 2)}
        elif resident:  # untiled w1 up to 96 x 96, then 384 px tiles
            want = {("chunk_decode", 1), ("tiled_decode", 2)}
        else:  # every rung of the budget, then 384 px tiles
            want = {("chunk_decode", 2), ("chunk_decode", 1),
                    ("tiled_decode_planned", 2), ("tiled_decode", 2)}
        assert rungs == want
    finally:
        for p in patches:
            p.stop()


def test_group_norm_in_frame_chunks_equals_whole(monkeypatch):
    """A large input is normalised a few frames at a time (the statistics
    are per frame): the output and the gradients equal the whole tensor's
    (fp32; atol 1e-6, the same sums over the same elements)."""
    from pyramid_flow_tpu_torch.models.vae import layers

    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, 8, 5, 6, 7), generator=gen).contiguous(
        memory_format=torch.channels_last_3d).requires_grad_()
    w, b = torch.randn(8, generator=gen), torch.randn(8, generator=gen)
    dy = torch.randn((2, 8, 5, 6, 7), generator=gen)

    def run():
        y = layers.causal_group_norm(x, w, b, 4)
        (gx,) = torch.autograd.grad((y * dy).sum(), x)
        return y.detach(), gx

    whole = run()
    monkeypatch.setattr(layers, "GN_CHUNK_ELEMENTS", 2 * 8 * 6 * 7 * 2)
    chunked = run()  # 2 frames per chunk: 2 + 2 + 1
    assert chunked[0].is_contiguous(memory_format=torch.channels_last_3d)
    for a, b_ in zip(chunked, whole):
        torch.testing.assert_close(a, b_, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [1, 2])
def test_carried_frames_are_contiguous(vaes, window):
    """Every conv's carried frames are contiguous ``[B, 2, H, W, C]`` after
    each window (the conv kernel takes its front frames so), also after a
    one-frame window, whose temporal upsampler returns a strided view."""
    _, _, tvae = vaes
    z = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 4, 6, 10, 4)).astype(np.float32))
    state = {}
    for idx, (s, e) in enumerate(model._window_starts(4, window, 1)):
        with torch.no_grad():
            tvae.decode(z[:, s:e], state, is_init=(idx == 0))
        bad = [k for k, v in state.items() if not v.is_contiguous()]
        assert not bad, (idx, bad)
