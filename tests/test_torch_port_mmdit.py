"""Port parity: the SD3 MMDiT, JAX vs torch, on the CPU.

The tiny MMDiT of tests/test_mmdit.py, every JAX leaf redrawn from a numpy
seed (its output projection starts at zero, so an unrandomised model would
compare zeros), carried to the port by ``mmdit_state_dict_from_jax`` and a
strict ``load_state_dict``. Inputs are a packed AR layout: text with masked
entries, a conditioning history over two frames, an INVALID pad and the
current clip, with per-row table crop origins (``pos_offset``) that push
some positions past the table's edge. Both sides fp32 (JAX's Pallas
attention in interpret mode).

Tolerances: the sincos table exact; the bilinear gather atol 1e-6 (the same
four fp32 products); the forward rtol 1e-4, atol 1e-4 (the flux parity
tests' bound); parameter gradients atol 2e-6, rtol 2e-3 (the DiT loss
tests' bound: a tiny network's gradients summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.mmdit import model as jmodel
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.mmdit import model
from pyramid_flow_tpu_torch.models.vae.model import CausalVideoVAE, VAEConfig
from pyramid_flow_tpu_torch.ops.flash_attention import INVALID_TIME
from pyramid_flow_tpu_torch.utils.converters import mmdit_state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(atol=2e-6, rtol=2e-3)
TINY = dict(sample_size=32, in_channels=4, num_layers=2, attention_head_dim=8,
            num_attention_heads=4, caption_projection_dim=32,
            pooled_projection_dim=24, joint_attention_dim=32,
            pos_embed_max_size=24)
LT, LC, PAD, LX = 8, 40, 17, 32  # text, history, INVALID pad, current clip


def tiny_layout(b=2, seed=0):
    """(tokens, pos, time, text, mask, pooled, timesteps, pos_offset)."""
    rng = np.random.default_rng(seed)
    l = LC + PAD + LX
    tokens = rng.standard_normal((b, l, 16)).astype(np.float32)
    time = np.concatenate([np.repeat([0, 1], LC // 2),
                           np.full(PAD, INVALID_TIME), np.full(LX, 2)])
    time = np.broadcast_to(time.astype(np.int32), (b, l)).copy()
    pos = np.abs(rng.standard_normal((b, l, 3))).astype(np.float32) * 5
    pos[..., 0] = np.where(time == INVALID_TIME, 0, time)
    text = rng.standard_normal((b, LT, 32)).astype(np.float32)
    mask = np.ones((b, LT), bool)
    mask[:, -3:] = False
    pooled = rng.standard_normal((b, 24)).astype(np.float32)
    ts = np.array([900.0, 311.5][:b], np.float32)
    offset = np.array([[4.0, 6.0], [12.5, 2.0]][:b], np.float32)
    return tokens, pos, time, text, mask, pooled, ts, offset


def tiny_mmdits(scale=0.05, seed=1):
    """The tiny JAX MMDiT, its weights redrawn from a seed, and a maker of
    the same model in the port (on the CPU)."""
    dit_j = jmodel.PyramidDiffusionMMDiT(config=jmodel.MMDiTConfig(**TINY),
                                         dtype=jnp.float32)
    shapes = jax.eval_shape(dit_j.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, tiny_layout()))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda p: jnp.asarray(
        (scale * rng.standard_normal(p.shape)).astype(np.float32)), shapes)

    def make_port(remat=False):
        dit_t = model.PyramidDiffusionMMDiT(model.MMDiTConfig(**TINY),
                                            device="cpu", remat=remat)
        dit_t.load_state_dict(mmdit_state_dict_from_jax(
            jax.tree.map(np.array, params)), strict=True)
        return dit_t

    return dit_j, params, make_port


@pytest.fixture(scope="module")
def mmdits():
    return tiny_mmdits()


def test_sincos_table_matches_jax():
    for d, g, base in ((16, 8, 4), (32, 24, 16), (1536, 192, 64)):
        np.testing.assert_array_equal(
            model.sincos_pos_embed_table(d, g, base),
            jmodel.sincos_pos_embed_table(d, g, base))


def test_bilinear_gather_matches_jax():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((12, 12, 5)).astype(np.float32)
    y = rng.uniform(-2, 14, (2, 50)).astype(np.float32)
    x = rng.uniform(-2, 14, (2, 50)).astype(np.float32)
    y[0, :4] = [0.0, 11.0, 3.0, 11.5]  # on the grid and on the edge
    want = np.asarray(jmodel._bilinear_gather(*map(jnp.asarray, (table, y,
                                                                 x))))
    got = model.bilinear_gather(*map(torch.from_numpy, (table, y, x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_forward_matches_jax_on_packed_ar_layout(mmdits):
    dit_j, params, make_port = mmdits
    inputs = tiny_layout()
    # some rows' positions fall past the 24-wide table: the gather clips
    assert (inputs[1][..., 1:] + inputs[-1][:, None]).max() > 23
    out_j = np.asarray(dit_j.apply(params, *map(jnp.asarray, inputs)))
    dit_t = make_port()
    with torch.no_grad():
        out_t = dit_t(*map(torch.from_numpy, inputs)).numpy()
    valid = inputs[2][0] != INVALID_TIME
    assert np.abs(out_j[:, valid]).max() > 1e-2
    np.testing.assert_allclose(out_t[:, valid], out_j[:, valid], **TOL)
    assert dit_t.num_attention_calls == 2
    assert dit_t.transformer_blocks[1].context_pre_only


def test_parameter_gradients_match_jax(mmdits):
    dit_j, params, make_port = mmdits
    inputs = tiny_layout()
    valid = inputs[2][0] != INVALID_TIME
    weight = np.random.default_rng(5).standard_normal(
        (2, int(valid.sum()), 16)).astype(np.float32)

    def loss_j(p):
        out = dit_j.apply(p, *map(jnp.asarray, inputs))
        return jnp.sum(out[:, valid] * weight)

    jgrads = jax.jit(jax.grad(loss_j))(params)
    dit_t = make_port()
    out = dit_t(*map(torch.from_numpy, inputs))
    (out[:, torch.from_numpy(valid)] * torch.from_numpy(weight)).sum(
        ).backward()
    ref = mmdit_state_dict_from_jax(jax.tree.map(np.array, jgrads))
    grads = {n: p.grad for n, p in dit_t.named_parameters()}
    # the sincos table is a buffer in the port (ROADMAP C2): JAX's table
    # takes a gradient, the port's none
    assert ref.keys() - grads.keys() == {"pos_embed.pos_embed"}
    assert grads.keys() < ref.keys()
    table = dit_t.pos_embed.pos_embed
    assert not table.requires_grad and table.grad is None
    assert ref["pos_embed.pos_embed"].abs().max() > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    # every parameter learns (the qk-norms too) but the last block's
    # text-query projection, whose output it discards
    dead = [n for n, g in grads.items() if not g.abs().max() > 0]
    assert dead == list(dit_t.gradient_free_parameters)


def test_converter_consumes_every_leaf(mmdits):
    _, params, make_port = mmdits
    sd = mmdit_state_dict_from_jax(jax.tree.map(np.array, params))
    n_jax = sum(np.size(p) for p in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax
    g, d = TINY["pos_embed_max_size"], 32
    assert sd["pos_embed.pos_embed"].shape == (1, g * g, d)
    assert sd["pos_embed.proj.weight"].shape == (d, 4, 2, 2)
    last = "transformer_blocks.1"
    assert f"{last}.norm1_context.linear.weight" in sd
    assert f"{last}.attn.norm_add_q.weight" in sd
    assert f"{last}.attn.to_add_out.weight" not in sd
    assert f"{last}.ff_context.net.0.proj.weight" not in sd
    assert "transformer_blocks.0.ff_context.net.2.weight" in sd
    assert "transformer_blocks.2.ff.net.2.weight" not in sd
    # a fresh port model holds the SD3 table, as the JAX model's init does
    fresh = model.PyramidDiffusionMMDiT(model.MMDiTConfig(**TINY),
                                        device="cpu")
    np.testing.assert_array_equal(
        fresh.pos_embed.pos_embed.detach().numpy().reshape(g, g, d),
        jmodel.sincos_pos_embed_table(d, g, 16))
    assert not fresh.proj_out.weight.any()


@pytest.mark.parametrize("build", [
    lambda **kw: PyramidFluxTransformer(FluxConfig(
        num_layers=1, num_single_layers=1, attention_head_dim=8,
        num_attention_heads=2, axes_dims_rope=(4, 2, 2)), **kw),
    lambda **kw: model.PyramidDiffusionMMDiT(model.MMDiTConfig(**TINY), **kw),
    lambda **kw: CausalVideoVAE(VAEConfig(
        latent_channels=4, block_out_channels=(8, 8, 16, 16),
        decoder_layers_per_block=(1, 1, 1, 1), num_groups=4), **kw),
], ids=["flux", "mmdit", "vae"])
def test_models_build_on_the_card_unless_told(build, monkeypatch):
    """Without device= a model builds on the CUDA device; with none visible
    it raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        build()
    m = build(device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())
