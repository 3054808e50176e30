"""Port parity for the DiT train step, JAX vs torch, on the CPU.

``make_train_step`` of both packages, two steps from the same state on the
tiny DiT of test_torch_port_dit_loss.py, with the port replaying JAX's draws
(CFG drop, noise, timesteps) through ``JaxDraws``; ``accum_steps`` 1 (batch
4) and 2 (batch 8 as two micro-batches). Compared: loss and pre-clip grad
norm per step, the step counts, and the parameters and EMA after both steps.

Tolerances (fp32): loss rtol 1e-5; grad norm rtol 1e-4; parameters as
``adamw_close`` says (m/sqrt(v) amplifies the rounding of small gradients);
the EMA likewise with a fifth of the allowance (d = 0.9, so it carries at
most 0.19 of the parameters' deviation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as JScheduler)
from pyramid_flow_tpu.training import lr_schedules as jlr
from pyramid_flow_tpu.training import train_state as jts
from pyramid_flow_tpu.training import trainer as jtrainer
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training import lr_schedules
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import make_train_step
from test_torch_port_dit_loss import UNITS, grads_from_jax, tiny_batch, tiny_dits
from test_torch_port_training import JaxDraws, adamw_close

LR = 1e-3
SCHEDULE = (LR, 1e-6, 10, 1, 0)  # cosine: base, final, steps/epoch, epochs, warmup


@pytest.fixture(scope="module")
def dits():
    return tiny_dits()


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_make_train_step_matches_jax(dits, accum_steps):
    dit_j, params, make_port = dits
    batch = tiny_batch(b=4 * accum_steps)
    key = jax.random.PRNGKey(9)
    jstate = jts.create_train_state(params, jts.TrainConfig(
        learning_rate=LR, ema_decay=0.9,
        lr_schedule=jlr.cosine_schedule(*SCHEDULE)))
    jstep = jtrainer.make_train_step(dit_j, JScheduler(), donate=False,
                                     accum_steps=accum_steps)
    dit_t = make_port()
    state = create_train_state(dit_t, TrainConfig(
        learning_rate=LR, ema_decay=0.9,
        lr_schedule=lr_schedules.cosine_schedule(*SCHEDULE)))
    step = make_train_step(dit_t, PyramidFlowMatchEulerDiscreteScheduler(),
                           accum_steps=accum_steps)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch, key, num_units_per_stage=UNITS)
        state, m = step(state, tbatch, JaxDraws(key), UNITS)
        np.testing.assert_allclose(m["train/loss"], float(jm["train/loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["train/grad_norm"],
                                   float(jm["train/grad_norm"]), rtol=1e-4)
        assert m["train/applied"]  # the loss sits well below the gate
    assert int(jstate.step) == state.step == 2 and state.opt_count == 2
    ref = grads_from_jax(jstate.params)
    nu = grads_from_jax(jstate.opt_state[1][0].nu)
    ref_ema = grads_from_jax(jstate.ema_params)
    for name, p in dit_t.named_parameters():
        adamw_close(p.detach().numpy(), ref[name].numpy(), nu[name].numpy(),
                    LR, 2)
        # d = 0.9: the EMA carries 0.1 and 0.09 of the two steps' moves
        adamw_close(state.ema[name].numpy(), ref_ema[name].numpy(),
                    nu[name].numpy(), 0.2 * LR, 2)


def test_raw_pixel_batch_is_refused(dits):
    """Without a VAE a raw-pixel batch is refused (with one it trains:
    test_torch_port_raw_pixel_step.py)."""
    dit_t = dits[2]()
    step = make_train_step(dit_t, PyramidFlowMatchEulerDiscreteScheduler())
    with pytest.raises(ValueError, match="vae"):
        step(create_train_state(dit_t), {"video": torch.zeros(1)},
             JaxDraws(jax.random.PRNGKey(0)), UNITS)
