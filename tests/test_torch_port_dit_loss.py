"""Port parity for the DiT training loss, JAX vs torch, on the CPU.

A tiny miniFLUX (one dual and one single block) with JAX weights redrawn from
a numpy seed, carried to the port by ``flux_state_dict_from_jax``; the JAX
gradients come back through the same converter, so every parameter is
compared by name. The port replays JAX's draws through ``JaxDraws``. The AR
layout: latents [4, 4, 8, 8, 4], rows split (1, 2, 1) over the stages, units
(3, 3, 2), text with 2 of 8 tokens masked.

Tolerances (fp32): loss rtol 1e-5; gradients atol 2e-6 + rtol 2e-3 (a tiny
network's gradients, with Pallas attention in interpret mode on the JAX side,
summed in another order); remat on vs off atol 1e-7 (the same arithmetic,
recomputed); the overshoot probe atol 1e-3 log2 units.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.flux.model import (
    FluxConfig as JFluxConfig, PyramidFluxTransformer as JDiT)
from pyramid_flow_tpu.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as JScheduler)
from pyramid_flow_tpu.training import trainer as jtrainer
from pyramid_flow_tpu.training.telemetry import (
    make_bound_overshoot_probe as jmake_probe)
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.telemetry import (
    make_bound_overshoot_probe)
from pyramid_flow_tpu_torch.training.trainer import (
    dit_loss_fn, top_grad_offenders)
from pyramid_flow_tpu_torch.utils.converters import flux_state_dict_from_jax
from test_torch_port_training import GRAD_ATOL, GRAD_RTOL, JaxDraws

DIT = dict(in_channels=16, num_layers=1, num_single_layers=1,
           attention_head_dim=8, num_attention_heads=4,
           joint_attention_dim=32, pooled_projection_dim=24,
           axes_dims_rope=(4, 2, 2))
UNITS = (3, 3, 2)
BATCH_KEYS = ("latents", "text_emb", "text_mask", "pooled")


def tiny_batch(seed=6, b=4):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 8), bool)
    mask[:, 6:] = False
    return {
        "latents": (0.5 * rng.standard_normal((b, 4, 8, 8, 4))).astype(
            np.float32),
        "text_emb": rng.standard_normal((b, 8, 32)).astype(np.float32),
        "text_mask": mask,
        "pooled": rng.standard_normal((b, 24)).astype(np.float32),
        "null_text_emb": np.zeros((b, 8, 32), np.float32),
        "null_pooled": np.zeros((b, 24), np.float32),
    }


def tiny_dits():
    """The tiny JAX DiT, its weights redrawn from a seed (every leaf, so no
    layer is zero-initialised), and a maker of the same DiT in the port."""
    dit_j = JDiT(config=JFluxConfig(**DIT), dtype=jnp.float32)
    shapes = jax.eval_shape(
        dit_j.init, jax.random.PRNGKey(0), jnp.zeros((2, 16, 16)),
        jnp.zeros((2, 16, 3)), jnp.zeros((2, 16), jnp.int32),
        jnp.zeros((2, 8, 32)), jnp.ones((2, 8), bool), jnp.zeros((2, 24)),
        jnp.zeros((2,)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: jnp.asarray(
            (0.05 * rng.standard_normal(p.shape)).astype(np.float32)), shapes)

    def make_port(remat=False):
        dit_t = PyramidFluxTransformer(FluxConfig(**DIT), remat=remat,
                                       device="cpu")
        dit_t.load_state_dict(flux_state_dict_from_jax(
            jax.tree.map(np.array, params)), strict=True)
        return dit_t

    return dit_j, params, make_port


def grads_from_jax(tree):
    return flux_state_dict_from_jax(jax.tree.map(np.array, tree))


@pytest.fixture(scope="module")
def dits():
    return tiny_dits()


def _port_loss_and_grads(dit_t, key, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = dit_loss_fn(
        dit_t, JaxDraws(key), *(t[k] for k in BATCH_KEYS),
        PyramidFlowMatchEulerDiscreteScheduler(), (1, 2, 1), True, UNITS)
    dit_t.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         dit_t.named_parameters()}


def test_dit_loss_and_grads_match_jax(dits):
    dit_j, params, make_port = dits
    batch = tiny_batch()
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jtrainer.dit_loss_fn(
            dit_j, p, key, *(jnp.asarray(batch[k]) for k in BATCH_KEYS),
            JScheduler(), (1, 2, 1), True, UNITS)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss, grads = _port_loss_and_grads(make_port(), key, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    ref = grads_from_jax(jgrads)
    assert ref.keys() == grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    # every parameter learns, the attention projections included
    assert all(g.abs().max() > 0 for g in grads.values())
    worst = top_grad_offenders(grads, k=3)
    assert len(worst) == 3 and worst[0][1] >= worst[1][1] >= worst[2][1]


def test_remat_gives_the_same_grads(dits):
    _, _, make_port = dits
    key = jax.random.PRNGKey(8)
    loss_a, a = _port_loss_and_grads(make_port(remat=False), key,
                                     tiny_batch())
    loss_b, b = _port_loss_and_grads(make_port(remat=True), key,
                                     tiny_batch())
    assert loss_a == loss_b
    for name in a:
        torch.testing.assert_close(b[name], a[name], rtol=0, atol=1e-7)


def test_overshoot_probe_matches_jax(dits):
    dit_j, params, make_port = dits
    batch = tiny_batch()
    key = jax.random.PRNGKey(11)
    ref = float(jmake_probe(dit_j, JScheduler())(
        params, *(jnp.asarray(batch[k]) for k in BATCH_KEYS), key))
    dit_t = make_port()
    probe = make_bound_overshoot_probe(
        dit_t, PyramidFlowMatchEulerDiscreteScheduler())
    got = probe(*(torch.from_numpy(batch[k]) for k in BATCH_KEYS),
                JaxDraws(key))
    assert 0 < ref < 100
    np.testing.assert_allclose(got, ref, atol=1e-3)
    # the capture is off again after the probe
    assert all(blk.attn.capture is None for blk in
               (*dit_t.transformer_blocks, *dit_t.single_transformer_blocks))
