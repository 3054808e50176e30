"""Sharded checkpoints (``torch.distributed.checkpoint``), the counterpart
of the JAX package's Orbax ``save_checkpoint``/``restore_checkpoint``.

A train state of the tiny miniFLUX of test_torch_port_dit_loss.py, sharded
with FSDP2 on a (1, 2, 1) mesh of two gloo ranks, takes one step and is
saved with ``TrainState.save_sharded`` (each rank its own shards); a fresh
state on a (1, 1, 2) mesh restores it with ``load_sharded``, and so does a
fresh one-device state in this process: the state after each restore,
gathered to the one-device layout, equals the saved one exactly
(parameters, AdamW moments and counts, EMA, step). Before the save, each
rank builds ``PyramidFlowPipeline.from_train_state(use_ema=True)`` from
the sharded state (a gather every rank calls): its DiT holds the EMA
exactly. The training CLI's ``--auto_resume`` takes the newest step of
either checkpoint form, and resumes from a DCP directory.
"""

import os

import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.models.flux.model import FluxConfig
from pyramid_flow_tpu_torch.tools import train_pyramid_flow as cli
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)

import _parallel_ranks as ranks
from _parallel_harness import run_ranks
from test_torch_port_dit_loss import DIT, UNITS, tiny_batch, tiny_dits


def _assert_same(got, want):
    assert (got["step"], got["opt_count"]) == (want["step"],
                                               want["opt_count"]) == (1, 1)
    for part in ("params", "ema"):
        assert got[part].keys() == want[part].keys()
        for name, t in want[part].items():
            np.testing.assert_array_equal(got[part][name], t, err_msg=name)
    assert got["optimizer"].keys() == want["optimizer"].keys()
    for i, moments in want["optimizer"].items():
        assert got["optimizer"][i].keys() == moments.keys()
        for k, t in moments.items():
            np.testing.assert_array_equal(got["optimizer"][i][k], t)


def test_dcp_saves_on_one_mesh_and_resumes_on_another_and_alone(tmp_path):
    _, _, make_port = tiny_dits()
    sd = {k: v.numpy() for k, v in make_port().state_dict().items()}
    path = str(tmp_path / "checkpoint-1")
    out = run_ranks(ranks.dcp_save_resume, 2, tmp_path, "flux",
                    FluxConfig(**DIT), sd, tiny_batch(b=4), UNITS,
                    (1, 2, 1), (1, 1, 2), path)
    saved, resumed, ema_dit = out[0]
    # every rank built the EMA's inference DiT from the gathered shards
    for got in (ema_dit, out[1]):
        assert got.keys() == saved["ema"].keys()
        for name, t in saved["ema"].items():
            np.testing.assert_array_equal(got[name], t, err_msg=name)
    # each rank wrote its own shards
    assert sorted(f for f in os.listdir(path) if f.endswith(".distcp")) == [
        "__0_0.distcp", "__1_0.distcp"]
    _assert_same(resumed, saved)

    state = create_train_state(make_port(), TrainConfig(learning_rate=1e-3,
                                                        ema_decay=0.9))
    state.load_sharded(path)
    assert not state.sharded
    _assert_same(ranks._gathered(state), saved)


def test_auto_resume_takes_the_newest_of_either_form(tmp_path):
    assert cli.latest_checkpoint(str(tmp_path / "none")) is None
    assert cli.latest_checkpoint(str(tmp_path)) is None
    for name in ("checkpoint-2.pt", "checkpoint-6-ema.pt", "checkpoint-9",
                 "checkpoint-3.pt.tmp"):
        (tmp_path / name).write_bytes(b"")  # files: only .pt counts
    (tmp_path / "checkpoint-4").mkdir()
    assert cli.latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                       "checkpoint-4")
    (tmp_path / "checkpoint-5.pt").write_bytes(b"")
    assert cli.latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                       "checkpoint-5.pt")
    (tmp_path / "checkpoint-5").mkdir()  # a step of both forms: the dir
    assert cli.latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                       "checkpoint-5")


def test_cli_resumes_from_a_dcp_directory(tmp_path):
    """The CLI's one-step checkpoint, saved again as a DCP directory in its
    place, resumes the run, whose next step equals an uninterrupted run's
    (a ``.pt`` resume is test_torch_port_training.py's)."""
    args = ["--debug_tiny", "--steps_per_epoch", "1", "--print_freq", "1",
            "--bound_probe_freq", "0"]
    a, b = tmp_path / "a", tmp_path / "b"
    assert cli.main(args + ["--epochs", "1", "--output_dir", str(a)]) == 0
    state = create_train_state(cli_tiny_dit(), TrainConfig())
    state.load_state_dict(torch.load(a / "checkpoint-1.pt",
                                     weights_only=True))
    state.save_sharded(str(a / "checkpoint-1"))
    os.remove(a / "checkpoint-1.pt")
    assert cli.main(args + ["--epochs", "2", "--output_dir", str(a)]) == 0
    assert cli.main(args + ["--epochs", "2", "--output_dir", str(b)]) == 0
    resumed = torch.load(a / "checkpoint-2.pt", weights_only=True)
    straight = torch.load(b / "checkpoint-2.pt", weights_only=True)
    assert resumed["step"] == straight["step"] == 2
    for part in ("params", "ema"):
        for name, t in straight[part].items():
            torch.testing.assert_close(resumed[part][name], t, rtol=0,
                                       atol=0)


def cli_tiny_dit():
    """The training CLI's ``--debug_tiny`` flux DiT (its config), on the
    CPU."""
    from pyramid_flow_tpu_torch.models.flux.model import (
        PyramidFluxTransformer)
    return PyramidFluxTransformer(FluxConfig(
        in_channels=64, num_layers=2, num_single_layers=2,
        attention_head_dim=16, num_attention_heads=8,
        joint_attention_dim=64, pooled_projection_dim=32,
        axes_dims_rope=(8, 4, 4)), device="cpu")
