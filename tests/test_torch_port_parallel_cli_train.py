"""The port's DiT training CLI under ``torch.distributed.run
--nproc_per_node 2`` on the CPU (gloo), ``--debug_tiny``: two steps with
FSDP2 over ``--fsdp 0`` (all the ranks) and with ``--sp 2``, each against
the one-process CLI's two steps (the same global batches and draws): the
logged losses (rtol 1e-5) and the checkpoint's parameters and EMA (rtol
1e-4, atol 1e-6: Adam's normalised steps on gradients that differ in
rounding). The 2-rank run writes its checkpoint as a
``torch.distributed.checkpoint`` directory (each rank its shards), read
back here with ``dcp_to_torch_save``, and its EMA export gathered; the
directory then resumes in one process for two more steps, so a checkpoint
moves between world sizes.
"""

import json
import os

import pytest
import torch
from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

from pyramid_flow_tpu_torch.tools import train_pyramid_flow as cli

from test_torch_port_parallel_cli import torchrun

ARGS = ["--debug_tiny", "--steps_per_epoch", "2", "--print_freq", "1",
        "--bound_probe_freq", "1"]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    assert cli.main(ARGS + ["--epochs", "1", "--output_dir", str(out)]) == 0
    return out


def _losses(out):
    return [json.loads(x)["train_loss"]
            for x in (out / "log.txt").read_text().splitlines()]


@pytest.mark.parametrize("flags", [["--fsdp", "0"], ["--sp", "2"]],
                         ids=["fsdp", "sp"])
def test_cli_trains_on_a_mesh_and_resumes_alone(tmp_path, one_process,
                                                flags):
    out = tmp_path / "run"
    torchrun("pyramid_flow_tpu_torch.tools.train_pyramid_flow", *ARGS,
             "--epochs", "1", "--output_dir", str(out), *flags)
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-2-ema.pt",
                                       "log.txt"]
    assert sorted(f for f in os.listdir(out / "checkpoint-2")
                  if f.endswith(".distcp")) == ["__0_0.distcp",
                                                "__1_0.distcp"]
    assert _losses(out) == pytest.approx(_losses(one_process), rel=1e-5)
    dcp_to_torch_save(str(out / "checkpoint-2"), str(tmp_path / "full.pt"))
    full = torch.load(tmp_path / "full.pt", weights_only=True)
    got = {"step": int(full["counts"][0]), "params": full["model"],
           "ema": full["ema"]}
    want = torch.load(one_process / "checkpoint-2.pt", weights_only=True)
    assert got["step"] == want["step"] == 2
    assert got["params"].keys() == want["params"].keys()
    for part in ("params", "ema"):
        for name, t in got[part].items():
            torch.testing.assert_close(t, want[part][name], rtol=1e-4,
                                       atol=1e-6, msg=f"{part} {name}")
    ema = torch.load(out / "checkpoint-2-ema.pt", weights_only=True)
    assert ema.keys() == want["params"].keys()
    for name, t in ema.items():
        torch.testing.assert_close(t, want["ema"][name], rtol=1e-4,
                                   atol=1e-6, msg=f"ema export {name}")
    assert cli.main(ARGS + ["--epochs", "2", "--output_dir", str(out)]) == 0
    assert torch.load(out / "checkpoint-4.pt",
                      weights_only=True)["step"] == 4
