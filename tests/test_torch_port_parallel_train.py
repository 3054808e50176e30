"""Port parity for the sharded DiT train step, JAX vs torch, on the CPU.

The port's step runs on spawned gloo ranks (``_parallel_harness``) over a
(dp, fsdp, sp) mesh with FSDP2, each rank on its slice of the batch and
replaying JAX's draws (recorded here by :class:`RecordingDraws` from the
port's one-device step, ``_parallel_ranks.ReplayDraws`` there); JAX's ``make_train_step`` runs
the same global batch in the pytest process (its own tests show its sharded
step equal to its unsharded one: ``test_parallel_training.py``). The tiny
miniFLUX of test_torch_port_dit_loss.py (4 heads: sp=2 splits them), batch
4 over the stages (1, 2, 1), units (3, 3, 2), two steps.

JAX's ``test_sharded_train_step`` takes dp=2 x fsdp=2 x sp=2 (8 devices);
with at most 4 ranks here each shape keeps two of the axes: (1, 2, 2) and
(2, 2, 1), and (2, 1, 2) for dp beside sp.

The (1, 2, 2) shape also runs the full-sequence recipe
(``use_temporal_pyramid=False``, JAX's ``train_pyramid_flow_without_ar.sh``),
as JAX's test parametrises over both recipes.

One more configuration accumulates: ``accum_steps=2`` on a (1, 2, 1) mesh
with a global batch of 8 (JAX needs it to divide by accum x sum(ratios)),
so each rank holds all of one micro-batch and none of the other, and runs
the other's stage forwards on zero-weighted rows; held to JAX's
``make_train_step(accum_steps=2)``.

Compared: loss and pre-clip grad norm of each step (the global batch's on
every rank), and the parameters and EMA after both steps (gathered to rank
0); a checkpoint's round trip (gathered, loaded back into the shards,
gathered again) is exact. Tolerances as test_torch_port_train_step.py:
loss rtol 1e-5, grad norm rtol 1e-4, parameters ``adamw_close``, the EMA
with a fifth of its allowance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyramid_flow_tpu.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as JScheduler)
from pyramid_flow_tpu.training import train_state as jts
from pyramid_flow_tpu.training import trainer as jtrainer
from pyramid_flow_tpu_torch.models.flux.model import FluxConfig

import torch

from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import make_train_step

import _parallel_ranks as ranks
from _parallel_harness import run_ranks
from test_torch_port_dit_loss import (DIT, UNITS, grads_from_jax, tiny_batch,
                                      tiny_dits)
from test_torch_port_training import JaxDraws, adamw_close

LR = 1e-3


class RecordingDraws:
    """``JaxDraws`` that records every draw into ``table`` under the key
    ``ReplayDraws`` looks it up by: the path of split/fold_in calls, the
    kind and the shape."""

    def __init__(self, inner, table, path=()):
        self.inner, self.table, self.path = inner, table, path

    def _draw(self, kind, shape):
        t = getattr(self.inner, kind)(shape)
        self.table[(self.path, kind, tuple(shape))] = t.numpy()
        return t

    def normal(self, shape):
        return self._draw("normal", shape)

    def uniform(self, shape):
        return self._draw("uniform", shape)

    def split(self, n):
        return [RecordingDraws(d, self.table, self.path + (("split", n, i),))
                for i, d in enumerate(self.inner.split(n))]

    def fold_in(self, data):
        return RecordingDraws(self.inner.fold_in(data), self.table,
                              self.path + (("fold", int(data)),))


def record_draws(make_port, batch, key, steps=2, accum_steps=1,
                 use_temporal_pyramid=True):
    """The draws of ``steps`` one-device port steps on ``batch``: every
    rank's, which draw the global batch's."""
    table = {}
    dit = make_port()
    state = create_train_state(dit, TrainConfig(learning_rate=LR))
    step = make_train_step(dit, PyramidFlowMatchEulerDiscreteScheduler(),
                           use_temporal_pyramid=use_temporal_pyramid,
                           accum_steps=accum_steps)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = RecordingDraws(JaxDraws(key), table)
    for _ in range(steps):
        step(state, tbatch, draws, UNITS)
    return table


def jax_steps(dit_j, params, batch, key, steps=2, accum_steps=1,
              use_temporal_pyramid=True):
    """JAX's two steps on the global batch: per step (loss, grad norm),
    and the parameters, second moments and EMA after them."""
    state = jts.create_train_state(params, jts.TrainConfig(
        learning_rate=LR, ema_decay=0.9))
    step = jtrainer.make_train_step(dit_j, JScheduler(), donate=False,
                                    accum_steps=accum_steps,
                                    use_temporal_pyramid=use_temporal_pyramid)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        state, m = step(state, jbatch, key, num_units_per_stage=UNITS)
        metrics.append((float(m["train/loss"]), float(m["train/grad_norm"])))
    return (metrics, grads_from_jax(state.params),
            grads_from_jax(state.opt_state[1][0].nu),
            grads_from_jax(state.ema_params))


def check_against_jax(out, ref):
    metrics, params, nu, ema = ref
    for r in out:  # every rank reports the global step's metrics
        for (loss, gnorm), (jloss, jgnorm) in zip(r["metrics"], metrics):
            np.testing.assert_allclose(loss, jloss, rtol=1e-5)
            np.testing.assert_allclose(gnorm, jgnorm, rtol=1e-4)
    got = out[0]
    assert got["step"] == 2 and got["reloaded"]
    assert got["params"].keys() == params.keys()
    for name, p in got["params"].items():
        adamw_close(p, params[name].numpy(), nu[name].numpy(), LR, 2)
        adamw_close(got["ema"][name], ema[name].numpy(), nu[name].numpy(),
                    0.2 * LR, 2)


def make_case(use_temporal_pyramid=True):
    """The JAX model, its parameters, the port's state dict, the batch, the
    recorded draws and JAX's two steps, on one recipe."""
    dit_j, params, make_port = tiny_dits()
    batch = tiny_batch(b=4)
    key = jax.random.PRNGKey(9)
    sd = {k: v.numpy() for k, v in make_port().state_dict().items()}
    return (dit_j, params, sd, batch,
            record_draws(make_port, batch, key,
                         use_temporal_pyramid=use_temporal_pyramid),
            jax_steps(dit_j, params, batch, key,
                      use_temporal_pyramid=use_temporal_pyramid))


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.fixture(scope="module")
def full_sequence_case():
    return make_case(use_temporal_pyramid=False)


@pytest.mark.parametrize("mesh_shape,use_temporal_pyramid", [
    ((1, 2, 2), True), ((2, 1, 2), True), ((1, 2, 2), False)],
    ids=["fsdp2_sp2", "dp2_sp2", "fsdp2_sp2_full_sequence"])
def test_sharded_train_step_matches_jax(tmp_path, request, mesh_shape,
                                        use_temporal_pyramid):
    """Two steps on a 4-rank mesh: every parameter sharded where JAX's rule
    shards it at min_shard_dim 64 (the tiny model's dims are 16-32 wide:
    most fall back to dim 0), tokens sharded over sp. On the full-sequence
    recipe the second data rank of (1, 2, 2) holds none of stage 0's rows
    and runs its forward on a zero-weighted stand-in row."""
    dit_j, params, sd, batch, draws, ref = request.getfixturevalue(
        "case" if use_temporal_pyramid else "full_sequence_case")
    out = run_ranks(ranks.train_steps, 4, tmp_path, "flux",
                    FluxConfig(**DIT), sd, batch, UNITS, mesh_shape, 16,
                    draws, 2, LR, 1, use_temporal_pyramid)
    assert out[0]["stats"]["sharded_fraction"] == (
        1.0 if mesh_shape[1] > 1 else 0.0)
    check_against_jax(out, ref)


def test_accumulated_sharded_step_matches_jax(tmp_path):
    """``accum_steps=2`` on a (1, 2, 1) mesh, global batch 8: rank 0 holds
    micro-batch 0 whole and none of micro-batch 1, rank 1 the reverse."""
    dit_j, params, make_port = tiny_dits()
    batch = tiny_batch(b=8)
    key = jax.random.PRNGKey(10)
    sd = {k: v.numpy() for k, v in make_port().state_dict().items()}
    draws = record_draws(make_port, batch, key, accum_steps=2)
    assert any(("split", 2, 1) in path for path, _, _ in draws)
    ref = jax_steps(dit_j, params, batch, key, accum_steps=2)
    out = run_ranks(ranks.train_steps, 2, tmp_path, "flux",
                    FluxConfig(**DIT), sd, batch, UNITS, (1, 2, 1), 16,
                    draws, 2, LR, 2)
    check_against_jax(out, ref)

