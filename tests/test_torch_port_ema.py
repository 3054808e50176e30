"""Port parity for the EMA evaluation path.

* ``PyramidFlowPipeline.from_train_state`` with and without ``use_ema``
  after one equal step in both packages (the JAX package's
  tests/test_ema_eval.py step: every gradient one, lr 1e-2, EMA decay 0.5):
  the inference DiT's weights equal JAX's ``params`` and ``ema_params``
  within 1e-6, and the training model and its EMA are left as they were;
* ``export_ema_params``/``load_ema_params``: the newest step of an output
  directory, a given file, and ``FileNotFoundError`` on a directory without
  one;
* the training CLI's ``checkpoint-<step>-ema.pt`` loads strictly into a
  DiT and holds the run's EMA.

No generation here: the JAX package marks its two-generate check slow
(tests/test_ema_eval.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.training import train_state as jts
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.tools import train_pyramid_flow as cli
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.utils.checkpoint import (
    export_ema_params, load_ema_params)

from test_torch_port_dit_loss import grads_from_jax, tiny_dits
from test_torch_port_parallel_dcp import cli_tiny_dit


@pytest.fixture(scope="module")
def states():
    """JAX's and the port's train states after the same step."""
    _, params, make_port = tiny_dits()
    jstate = jts.create_train_state(params, jts.TrainConfig(
        learning_rate=1e-2, ema_decay=0.5))
    jstate = jstate.apply_gradients(
        jax.tree.map(jnp.ones_like, jstate.params), loss=jnp.float32(0.1))
    state = create_train_state(make_port(), TrainConfig(
        learning_rate=1e-2, ema_decay=0.5))
    assert state.apply_gradients(
        [torch.ones_like(p) for p in state.model.parameters()], 0.1)
    return jstate, state


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_from_train_state_holds_jax_weights(states, use_ema):
    jstate, state = states
    params = {n: p.detach().clone() for n, p in state.params.items()}
    ema = {n: t.clone() for n, t in state.ema.items()}
    pipe = PyramidFlowPipeline.from_train_state(
        state.model, state, use_ema=use_ema, dtype=torch.float32,
        latent_channels=4)
    assert pipe.dit is not state.model and not pipe.dit.training
    assert pipe.dtype == torch.float32 and pipe.device.type == "cpu"
    want = grads_from_jax(jstate.ema_params if use_ema else jstate.params)
    got = pipe.dit.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    # the EMA and the parameters differ after the step
    other = grads_from_jax(jstate.params if use_ema else jstate.ema_params)
    assert max((got[n] - other[n]).abs().max().item() for n in other) > 1e-4
    # the training model and its EMA are as they were
    for n, p in state.params.items():
        assert torch.equal(p, params[n]) and torch.equal(state.ema[n],
                                                         ema[n])


def test_from_train_state_casts_to_the_pipeline_dtype(states):
    _, state = states
    pipe = PyramidFlowPipeline.from_train_state(
        state.model, state, use_ema=True, dtype=torch.bfloat16)
    for name, t in pipe.dit.state_dict().items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, state.ema[name].bfloat16()), name


def test_ema_export_roundtrip(states, tmp_path):
    _, state = states
    ema = state.ema_state_dict()
    assert ema.keys() == state.model.state_dict().keys()
    with pytest.raises(FileNotFoundError, match="checkpoint-\\*-ema"):
        load_ema_params(str(tmp_path))
    path = export_ema_params(str(tmp_path), 3, ema)
    assert path == str(tmp_path / "checkpoint-3-ema.pt")
    export_ema_params(str(tmp_path), 12,
                      {n: t + 1 for n, t in ema.items()})
    (tmp_path / "checkpoint-40.pt").write_bytes(b"")  # not an export
    newest = load_ema_params(str(tmp_path))
    given = load_ema_params(path)
    for name, t in ema.items():
        assert torch.equal(given[name], t), name
        assert torch.equal(newest[name], t + 1), name


def test_cli_ema_export_loads_strictly_into_a_dit(tmp_path):
    out = tmp_path / "run"
    assert cli.main(["--debug_tiny", "--epochs", "1", "--steps_per_epoch",
                     "1", "--bound_probe_freq", "0", "--output_dir",
                     str(out)]) == 0
    assert sorted(os.listdir(out)) == ["checkpoint-1-ema.pt",
                                       "checkpoint-1.pt", "log.txt"]
    sd = load_ema_params(str(out))
    dit = cli_tiny_dit()
    dit.load_state_dict(sd, strict=True)
    full = torch.load(out / "checkpoint-1.pt", weights_only=True)
    for name, t in dit.state_dict().items():
        assert torch.equal(t, full["ema"].get(name, full["params"][name]))
