"""Port parity for the GAN-VAE train step, JAX vs torch, on the CPU: two
steps of ``make_vae_train_step`` from the same state with ``disc_start=1``
(step 0 with the discriminator off, step 1 with it on), for the 2D
discriminator, with ``freeze_encoder``, and with the 3D discriminator.

The tiny GAN of test_torch_port_vae_training.py (JAX's ``TINY_VAE``
geometry, full VGG16 LPIPS, ndf-8 two-layer discriminators, weights drawn
from numpy seeds), a 9-frame 32x32 clip, JAX's posterior draws replayed
through ``JaxDraws``, fp32.

Tolerances: each step's metrics rtol 1e-5 (atol 1e-7); parameters after both
steps within ``adamw_close``'s allowance taken per step: the discriminator
switching on at step 1 changes the gradients' size, and an element whose
step-0 gradient sat at rounding level may take any Adam step there
(``m/sqrt(v) = g/|g|``), so each step's allowance comes from JAX's second
moment after that step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.training import vae_trainer
from pyramid_flow_tpu_torch.utils.converters import (
    discriminator_state_dict_from_jax, vae_state_dict_from_jax)
from test_torch_port_training import GRAD_ATOL, GRAD_RTOL, JaxDraws
from test_torch_port_vae_training import (
    LR, _assert_metrics, _clip, _jax_state, _jax_step, _np, _port_state,
    tiny_gan_nets)


@pytest.fixture(scope="module")
def nets():
    return tiny_gan_nets()


def adamw_steps_close(port, ref, nus, lr):
    """``adamw_close`` (test_torch_port_training.py) with one allowance per
    step, each from the second moment ``nu`` after that step: ``1e-6 + lr *
    sum over steps of min(2, 2 * (GRAD_ATOL / sqrt(nu) + GRAD_RTOL))``."""
    port, ref = np.asarray(port), np.asarray(ref)
    allow = 1e-6
    for nu in nus:
        g = np.sqrt(np.asarray(nu, np.float64))
        allow = allow + lr * np.minimum(
            2.0, 2 * (GRAD_ATOL / np.maximum(g, 1e-30) + GRAD_RTOL))
    err = np.abs(port - ref)
    assert (err <= allow).all(), (err.max(), err[err > allow][:5])


def _nus(jstate):
    """JAX's second moments, keyed like the port: the VAE's, ``logvar``'s
    and the discriminator's."""
    gen = jstate.gen_opt_state[1][0].nu
    out = vae_state_dict_from_jax(_np({"params": gen["vae"]}))
    out["logvar"] = np.asarray(gen["logvar"])
    disc = jstate.disc_opt_state[1][0].nu
    out.update({f"disc.{k}": v for k, v in discriminator_state_dict_from_jax(
        _np({"params": disc})).items()})
    return out


@pytest.mark.parametrize("use_3d,freeze_encoder", [
    (False, False), (False, True), (True, False)],
    ids=["2d", "freeze_encoder", "3d_disc"])
def test_two_steps_match_jax(nets, use_3d, freeze_encoder):
    """Step 0: ``d_weight`` 0 and the discriminator's parameters unchanged
    (its AdamW steps on zero gradients); step 1: ``d_weight`` > 0 and every
    discriminator weight moved. The metrics of each step and every
    parameter after both (the VAE, ``logvar``, the discriminator) against
    JAX's; with ``freeze_encoder`` the encoder is unchanged."""
    key = jax.random.PRNGKey(8)
    video = _clip(1)
    jstep = _jax_step(nets, use_3d, freeze_encoder)
    jstate = _jax_state(nets, use_3d, 1)
    state = _port_state(nets, use_3d, 1)
    step = vae_trainer.make_vae_train_step(
        state.vae, nets["port_lpips"](), state.disc, use_3d_disc=use_3d,
        freeze_encoder=freeze_encoder)
    disc0 = {n: p.detach().clone() for n, p in state.disc.named_parameters()}
    enc0 = {n: p.detach().clone() for n, p in state.vae.named_parameters()
            if n.startswith(("encoder.", "quant_conv."))}
    nus = []
    for i in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(video), key)
        m = step(state, torch.from_numpy(video), JaxDraws(key))
        nus.append(_nus(jstate))
        _assert_metrics(m, jm)
        if i == 0:
            assert m["vae/d_weight"] == 0
            for n, p in state.disc.named_parameters():
                assert torch.equal(p, disc0[n]), n
        else:
            assert m["vae/d_weight"] > 0
    assert int(jstate.step) == state.step == 2
    # every weight moved (the biases before an instance norm get no
    # gradient but rounding)
    assert all(not torch.equal(p, disc0[n])
               for n, p in state.disc.named_parameters()
               if n.endswith("weight"))

    ref = vae_state_dict_from_jax(_np({"params": jstate.gen_params["vae"]}))
    ref["logvar"] = np.asarray(jstate.gen_params["logvar"])
    ref.update({f"disc.{k}": v for k, v in discriminator_state_dict_from_jax(
        _np({"params": jstate.disc_params})).items()})
    port = dict(state.vae.named_parameters())
    port["logvar"] = state.logvar
    port.update({f"disc.{n}": p for n, p in state.disc.named_parameters()})
    assert port.keys() == ref.keys()
    for name, p in port.items():
        adamw_steps_close(p.detach().numpy(), ref[name],
                          [nu[name] for nu in nus], LR)
    if freeze_encoder:  # zero gradients: a decay of lr * wd = 1e-8 rounds away
        for n, p in enc0.items():
            assert torch.equal(p, state.vae.get_parameter(n)), n
