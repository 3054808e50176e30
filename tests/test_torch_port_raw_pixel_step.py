"""Port parity for a raw-pixel DiT train step, JAX vs torch, on the CPU.

``make_train_step(..., vae=)`` of both packages on a ``"video"`` batch: the
frozen VAE encodes the pixels, the posterior is sampled from the step's
third draw (replayed from JAX's key by ``JaxDraws``), the latents are
normalised, and one step of the tiny DiT of test_torch_port_dit_loss.py
follows. The tiny VAE (latent 4 channels, the DiT's) carries JAX weights
redrawn from a numpy seed. One step from the same state, batch 4 of 9
frames at 64x64 (2 latent frames of 8x8).

Tolerances (fp32): loss rtol 1e-5 and pre-clip grad norm rtol 1e-4, as for
the latent-batch steps; the parameters as ``adamw_close`` says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.vae import model as jvae_model
from pyramid_flow_tpu.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as JScheduler)
from pyramid_flow_tpu.training import train_state as jts
from pyramid_flow_tpu.training import trainer as jtrainer
from pyramid_flow_tpu_torch.models.vae import model as vae_model
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import make_train_step
from pyramid_flow_tpu_torch.utils.converters import vae_state_dict_from_jax
from test_torch_port_dit_loss import (
    UNITS, grads_from_jax, tiny_batch, tiny_dits)
from test_torch_port_training import JaxDraws, adamw_close
from test_torch_port_vae import CFG, _randomize

LR = 1e-3


@pytest.fixture(scope="module")
def vaes():
    jvae = jvae_model.CausalVideoVAE(config=jvae_model.VAEConfig(
        encoder_layers_per_block=(1, 1, 1, 1), **CFG))
    shapes = jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)),
        rng=jax.random.PRNGKey(1)))
    params = jax.tree.map(jnp.asarray, _randomize(shapes, 21))
    tvae = vae_model.CausalVideoVAE(vae_model.VAEConfig(
        encoder_layers_per_block=(1, 1, 1, 1), **CFG), device="cpu")
    tvae.load_state_dict(vae_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return jvae, params, tvae


def test_raw_pixel_train_step_matches_jax(vaes):
    jvae, vparams, tvae = vaes
    dit_j, params, make_port = tiny_dits()
    batch = tiny_batch()
    del batch["latents"]
    batch["video"] = np.random.default_rng(2).uniform(
        -1, 1, (4, 9, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)

    jstate = jts.create_train_state(params, jts.TrainConfig(
        learning_rate=LR))
    jstep = jtrainer.make_train_step(dit_j, JScheduler(), donate=False,
                                     vae=jvae, vae_params=vparams)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       key, num_units_per_stage=UNITS)

    dit_t = make_port()
    state = create_train_state(dit_t, TrainConfig(learning_rate=LR))
    step = make_train_step(dit_t, PyramidFlowMatchEulerDiscreteScheduler(),
                           vae=tvae)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                    JaxDraws(key), UNITS)

    np.testing.assert_allclose(m["train/loss"], float(jm["train/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["train/grad_norm"],
                               float(jm["train/grad_norm"]), rtol=1e-4)
    assert int(jstate.step) == state.step == 1
    ref = grads_from_jax(jstate.params)
    nu = grads_from_jax(jstate.opt_state[1][0].nu)
    for name, p in dit_t.named_parameters():
        adamw_close(p.detach().numpy(), ref[name].numpy(), nu[name].numpy(),
                    LR, 1)
