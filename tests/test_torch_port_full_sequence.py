"""Port parity for the full-sequence DiT training recipe, JAX vs torch, on
the CPU.

The second training recipe of the reference and the JAX package
(``scripts/train_pyramid_flow_without_ar.sh``: ``--no_temporal_pyramid``,
batch 4 split (1, 2, 1), 16 latent frames): every stage row is one clip of
all its frames, noised by ``add_pyramid_noise_stage``, and the units of the
AR recipe are not used. The tiny DiTs, batches and draw replay of
test_torch_port_dit_loss.py (miniFLUX) and test_torch_port_mmdit_pipeline.py
(MMDiT). The sharded step on a mesh is in
test_torch_port_parallel_train.py.

Tolerances (fp32), those of the AR recipe's tests: loss rtol 1e-5;
gradients atol 2e-6 + rtol 2e-3; grad norm rtol 1e-4 (the MMDiT's without
its sincos table, ROADMAP C2); parameters and EMA within ``adamw_close``;
the layout and the CLI's loss against the step's, exact.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.pipeline import noising as jnoising
from pyramid_flow_tpu.pipeline import packing as jpacking
from pyramid_flow_tpu.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as JScheduler)
from pyramid_flow_tpu.training import lr_schedules as jlr
from pyramid_flow_tpu.training import train_state as jts
from pyramid_flow_tpu.training import trainer as jtrainer
from pyramid_flow_tpu_torch.pipeline import noising, packing
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.tools import train_pyramid_flow as cli
from pyramid_flow_tpu_torch.training import lr_schedules
from pyramid_flow_tpu_torch.training import trainer
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import (
    dit_loss_fn, make_train_step)
from test_torch_port_dit_loss import (BATCH_KEYS, grads_from_jax, tiny_batch,
                                      tiny_dits)
from test_torch_port_mmdit import tiny_mmdits
from test_torch_port_mmdit_pipeline import _jax_step
from test_torch_port_train_step import LR, SCHEDULE
from test_torch_port_training import (GRAD_ATOL, GRAD_RTOL, JaxDraws,
                                      _run_cli, adamw_close)

# the recipe's clip: 16 latent frames of 48x80 (384x640), 16 channels
RECIPE_FRAMES, RECIPE_H, RECIPE_W, RECIPE_C = 16, 48, 80, 16


def test_loss_grads_and_two_steps_match_jax():
    """miniFLUX, one JAX program (its train step): the loss and every
    parameter's gradient of ``dit_loss_fn(use_temporal_pyramid=False)`` on
    the first step's CFG-dropped batch and noise draw against the first
    JAX step's (its gradient read back from Adam's first moment), every
    parameter with a nonzero gradient; then two
    ``make_train_step(use_temporal_pyramid=False)`` steps from the same
    state, the loss and grad norm of each, and the parameters and EMA
    after them."""
    dit_j, params, make_port = tiny_dits()
    batch = tiny_batch()
    key = jax.random.PRNGKey(9)
    config = dict(learning_rate=LR, ema_decay=0.9)
    jstate = jts.create_train_state(params, jts.TrainConfig(
        lr_schedule=jlr.cosine_schedule(*SCHEDULE), **config))
    jstep = jtrainer.make_train_step(dit_j, JScheduler(),
                                     use_temporal_pyramid=False, donate=False)
    dit_t = make_port()
    state = create_train_state(dit_t, TrainConfig(
        lr_schedule=lr_schedules.cosine_schedule(*SCHEDULE), **config))
    step = make_train_step(dit_t, PyramidFlowMatchEulerDiscreteScheduler(),
                           use_temporal_pyramid=False)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # the loss and gradient of the first step, as the step draws them
    draws_drop, draws_noise, _ = JaxDraws(key).fold_in(0).split(3)
    drop = draws_drop.uniform((4,)) <= 0.1
    text = [torch.where(drop.reshape((4,) + (1,) * (t.dim() - 1)), null, t)
            for t, null in ((tbatch["text_emb"], tbatch["null_text_emb"]),
                            (tbatch["text_mask"], tbatch["text_mask"]),
                            (tbatch["pooled"], tbatch["null_pooled"]))]
    loss, _ = dit_loss_fn(dit_t, draws_noise, tbatch["latents"], *text,
                          PyramidFlowMatchEulerDiscreteScheduler(), (1, 2, 1),
                          False)
    loss.backward()
    grads = {n: p.grad for n, p in dit_t.named_parameters()}
    dit_t.zero_grad(set_to_none=True)

    metrics = []
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch, key, num_units_per_stage=None)
        state, m = step(state, tbatch, JaxDraws(key), None)
        metrics.append((m, jm))
        if i == 0:  # Adam's mu = (1 - b1) x the clipped gradient
            jnorm = float(jm["train/grad_norm"])
            ref = grads_from_jax(jstate.opt_state[1][0].mu)
            ref = {n: g / (1 - state.config.beta1)
                   * max(1.0, jnorm / state.config.max_grad_norm)
                   for n, g in ref.items()}
    np.testing.assert_allclose(loss.item(), float(metrics[0][1][
        "train/loss"]), rtol=1e-5)
    assert ref.keys() == grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    assert all(g.abs().max() > 0 for g in grads.values())
    for m, jm in metrics:
        np.testing.assert_allclose(m["train/loss"], float(jm["train/loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["train/grad_norm"],
                                   float(jm["train/grad_norm"]), rtol=1e-4)
        assert m["train/applied"]
    assert int(jstate.step) == state.step == 2
    ref = grads_from_jax(jstate.params)
    nu = grads_from_jax(jstate.opt_state[1][0].nu)
    ref_ema = grads_from_jax(jstate.ema_params)
    for name, p in dit_t.named_parameters():
        adamw_close(p.detach().numpy(), ref[name].numpy(), nu[name].numpy(),
                    LR, 2)
        adamw_close(state.ema[name].numpy(), ref_ema[name].numpy(),
                    nu[name].numpy(), 0.2 * LR, 2)


def test_mmdit_train_step_matches_jax():
    """The MMDiT: one full-sequence step, its crop origin taken at each
    stage's grid; the loss, and the pre-clip grad norm without the sincos
    table (a buffer in the port, ROADMAP C2)."""
    dit_j, params, make_port = tiny_mmdits()
    batch = tiny_batch()
    key = jax.random.PRNGKey(9)
    _, jm, _, _, _, norm = _jax_step(dit_j, params, batch, key,
                                     jts.TrainConfig(),
                                     use_temporal_pyramid=False)
    dit_t = make_port()
    step = make_train_step(dit_t, PyramidFlowMatchEulerDiscreteScheduler(),
                           use_temporal_pyramid=False,
                           model_name="pyramid_mmdit")
    state, m = step(create_train_state(dit_t),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    JaxDraws(key), None)
    np.testing.assert_allclose(m["train/loss"], float(jm["train/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["train/grad_norm"], norm, rtol=1e-4)
    assert m["train/applied"] and state.step == 1


def test_recipe_layout_matches_jax():
    """At the recipe's shape each stage row is one clip of all 16 frames:
    the clips that both packages' full-sequence noising gives, and the
    positions and time ids ``clip_metadata`` gives for them, are equal.
    Stage 2 holds 16 x 960 = 15360 tokens with time ids 0..15, 960 each."""
    shape = (1, RECIPE_FRAMES, RECIPE_H, RECIPE_W, RECIPE_C)
    sched, jsched = PyramidFlowMatchEulerDiscreteScheduler(), JScheduler()
    pyramid = noising.latent_pyramid(torch.zeros(shape), 3)
    draws = noising.GeneratorDraws(torch.Generator().manual_seed(0))
    for stage in range(3):
        sb = noising.add_pyramid_noise_stage(draws, sched, pyramid, stage, 3)
        # JAX's clips traced, not run
        jsb = jax.eval_shape(
            lambda: jnoising.add_pyramid_noise_stage(
                jax.random.PRNGKey(0), jsched,
                jnoising.latent_pyramid(jnp.zeros(shape), 3), stage, 3))
        shapes = [tuple(c.shape) for c in sb.clips]
        assert shapes == [tuple(c.shape) for c in jsb.clips]
        assert shapes == [(1, RECIPE_FRAMES, RECIPE_H >> (2 - stage),
                           RECIPE_W >> (2 - stage), RECIPE_C)]
        pos, time_ids, trainable = packing.clip_metadata(shapes)
        jpos, jtime, jtrainable = jpacking.clip_metadata(shapes)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(time_ids, jtime)
        per_frame = (RECIPE_H >> (3 - stage)) * (RECIPE_W >> (3 - stage))
        assert trainable == jtrainable == RECIPE_FRAMES * per_frame
        assert time_ids.dtype == np.int32
        np.testing.assert_array_equal(
            time_ids, np.repeat(np.arange(RECIPE_FRAMES), per_frame))
    assert trainable == 15360 and per_frame == 960


def _logged_loss(out_dir):
    return json.loads((out_dir / "log.txt").read_text().splitlines()[0])[
        "train_loss"]


def test_cli_no_temporal_pyramid(tmp_path, monkeypatch):
    """``--no_temporal_pyramid --debug_tiny``, one step: it exits 0 and
    writes its checkpoint; its loss is that of
    ``make_train_step(use_temporal_pyramid=False)`` on the CLI's synthetic
    batch and draws with no units (the ones the CLI allots are unused), and
    differs from the AR run's."""
    built = []
    make = trainer.make_train_step

    def spy(dit, *args, **kw):
        built.append((copy.deepcopy(dit), args))
        return make(dit, *args, **kw)

    monkeypatch.setattr(trainer, "make_train_step", spy)
    flags = ("--epochs", "1", "--steps_per_epoch", "1",
             "--bound_probe_freq", "0")
    full, ar = tmp_path / "full", tmp_path / "ar"
    assert _run_cli(full, *flags, "--no_temporal_pyramid") == 0
    assert torch.load(full / "checkpoint-1.pt",
                      weights_only=True)["step"] == 1
    assert _run_cli(ar, *flags) == 0
    (dit, args), (_, ar_args) = built
    assert args[2] is False and ar_args[2] is True  # use_temporal_pyramid

    cli_args = cli.parse_args(["--debug_tiny", "--no_temporal_pyramid"])
    batch = cli.device_batch(cli.synthetic_batch(cli_args, dit, 0),
                             dit.config, None, torch.device("cpu"))
    step = make_train_step(dit, PyramidFlowMatchEulerDiscreteScheduler(),
                           tuple(cli_args.sample_ratios), False)
    draws = noising.GeneratorDraws(
        torch.Generator().manual_seed(cli_args.seed))
    _, m = step(create_train_state(dit), batch, draws, None)
    assert m["train/loss"] == _logged_loss(full)
    assert abs(_logged_loss(ar) - _logged_loss(full)) > 1e-3 * abs(
        _logged_loss(full))
