"""Port parity: miniFLUX blocks and the full tiny DiT, JAX vs torch.

JAX weights (every leaf redrawn from a numpy seed, so that no layer is
zero-initialised) go to the port through ``flux_state_dict_from_jax`` and a
strict ``load_state_dict``. Inputs are a packed AR layout: text with masked
entries, a conditioning history, an INVALID pad in the middle and the current
clip, with L not a multiple of 128. Both sides fp32 on the CPU (JAX's Pallas
attention in interpret mode); tolerance rtol 1e-4, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.flux import blocks as jblocks
from pyramid_flow_tpu.models.flux import model as jmodel
from pyramid_flow_tpu.ops.rope import rope_freqs as jrope_freqs
from pyramid_flow_tpu_torch.models.flux import blocks, model
from pyramid_flow_tpu_torch.ops.flash_attention import INVALID_TIME
from pyramid_flow_tpu_torch.utils.converters import flux_state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(in_channels=16, num_layers=2, num_single_layers=2,
           attention_head_dim=8, num_attention_heads=4,
           joint_attention_dim=32, pooled_projection_dim=24,
           axes_dims_rope=(4, 2, 2))
LT = 8      # text tokens (the last 3 masked out)
LC = 40     # conditioning history tokens, frames 0 and 1
PAD = 17    # INVALID pad between history and current clip
LX = 32     # current clip, frame 2


def _randomize(params, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(params)
    return jax.tree.unflatten(treedef, [
        (0.02 * rng.standard_normal(p.shape)).astype(np.float32)
        for p in leaves])


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


def _layout(b=2, seed=0):
    rng = np.random.default_rng(seed)
    l = LC + PAD + LX
    tokens = rng.standard_normal((b, l, 16)).astype(np.float32)
    pos = np.abs(rng.standard_normal((b, l, 3))).astype(np.float32) * 4
    time = np.concatenate([np.repeat([0, 1], LC // 2),
                           np.full(PAD, INVALID_TIME), np.full(LX, 2)])
    time = np.broadcast_to(time.astype(np.int32), (b, l)).copy()
    text = rng.standard_normal((b, LT, 32)).astype(np.float32)
    mask = np.ones((b, LT), bool)
    mask[:, -3:] = False
    pooled = rng.standard_normal((b, 24)).astype(np.float32)
    ts = np.array([900.0, 311.5][:b], np.float32)
    return tokens, pos, time, text, mask, pooled, ts


def test_full_tiny_dit_matches_on_packed_ar_layout():
    cfg_j = jmodel.FluxConfig(**CFG)
    dit_j = jmodel.PyramidFluxTransformer(config=cfg_j, dtype=jnp.float32)
    inputs = _layout()
    assert (LT + inputs[0].shape[1]) % 128 != 0
    params = _randomize(dit_j.init(jax.random.PRNGKey(0),
                                   *map(jnp.asarray, inputs)), 1)
    out_j = np.asarray(dit_j.apply(params, *map(jnp.asarray, inputs)))

    dit_t = model.PyramidFluxTransformer(model.FluxConfig(**CFG),
                                         device="cpu")
    dit_t.load_state_dict(flux_state_dict_from_jax(_as_np(params)),
                          strict=True)
    with torch.no_grad():
        out_t = dit_t(*map(torch.from_numpy, inputs)).numpy()
    # padded rows' outputs are unspecified (they see every key under
    # causal attention) and never read by the pipeline
    valid = inputs[2][0] != INVALID_TIME
    np.testing.assert_allclose(out_t[:, valid], out_j[:, valid], **TOL)
    assert dit_t.num_attention_calls == 4


def _block_inputs(seed=0):
    tokens, pos, time, text, mask, _, _ = _layout(seed=seed)
    rng = np.random.default_rng(seed + 1)
    b, l = tokens.shape[:2]
    x = rng.standard_normal((b, l, 32)).astype(np.float32)
    ctx = rng.standard_normal((b, LT, 32)).astype(np.float32)
    temb = rng.standard_normal((b, 32)).astype(np.float32)
    all_pos = np.concatenate([np.zeros((b, LT, 3), np.float32), pos], 1)
    cos, sin = (np.array(a) for a in jrope_freqs(jnp.asarray(all_pos),
                                                   (4, 2, 2)))
    text_time = np.where(mask, 0, INVALID_TIME).astype(np.int32)
    time_ids = np.concatenate([text_time, time], axis=1)
    return x, ctx, temb, cos, sin, time_ids


@pytest.mark.parametrize("kind", ["dual", "single"])
def test_one_block_matches(kind):
    x, ctx, temb, cos, sin, tids = _block_inputs()
    valid = tids[0] != INVALID_TIME
    if kind == "dual":
        jb = jblocks.FluxTransformerBlock(num_heads=4, head_dim=8)
        args = (x, ctx, temb, cos, sin, tids)
        tb = blocks.FluxTransformerBlock(num_heads=4, head_dim=8)
    else:
        jb = jblocks.FluxSingleTransformerBlock(num_heads=4, head_dim=8)
        h = np.concatenate([ctx, x], axis=1)
        args = (h, temb, cos, sin, tids)
        tb = blocks.FluxSingleTransformerBlock(num_heads=4, head_dim=8)
    params = _randomize(jb.init(jax.random.PRNGKey(2),
                                *map(jnp.asarray, args)), 3)
    out_j = jb.apply(params, *map(jnp.asarray, args))
    tb.load_state_dict(flux_state_dict_from_jax(_as_np(params)), strict=True)
    with torch.no_grad():
        out_t = tb(*map(torch.from_numpy, args))
    if kind == "dual":
        np.testing.assert_allclose(out_t[0].numpy()[:, valid[LT:]],
                                   np.asarray(out_j[0])[:, valid[LT:]], **TOL)
        np.testing.assert_allclose(out_t[1].numpy()[:, valid[:LT]],
                                   np.asarray(out_j[1])[:, valid[:LT]], **TOL)
    else:
        np.testing.assert_allclose(out_t.numpy()[:, valid],
                                   np.asarray(out_j)[:, valid], **TOL)


def test_converter_consumes_every_leaf():
    """Every JAX parameter lands in exactly one torch tensor, and the strict
    load has no missing or unexpected key."""
    cfg_j = jmodel.FluxConfig(**CFG)
    dit_j = jmodel.PyramidFluxTransformer(config=cfg_j)
    params = dit_j.init(jax.random.PRNGKey(0),
                        *map(jnp.asarray, _layout()))
    sd = flux_state_dict_from_jax(_as_np(params))
    n_jax = sum(np.size(p) for p in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax
    dit_t = model.PyramidFluxTransformer(model.FluxConfig(**CFG),
                                         device="cpu")
    res = dit_t.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert "transformer_blocks.1.attn.to_out.0.weight" in sd
    assert "transformer_blocks.0.ff.net.0.proj.weight" in sd
    assert "time_text_embed.timestep_embedder.linear_1.weight" in sd
