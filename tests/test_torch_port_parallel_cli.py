"""The port's inference and VAE training CLIs under ``torch.distributed.run
--nproc_per_node 2`` on the CPU (gloo; ``--standalone`` picks a free port).

* inference ``--sp 2``: a string prompt to PNG frames from the tiny
  release-layout checkpoint of test_torch_port_checkpoint.py (both DiT
  families), sequence parallel over two ranks; rank 0 writes the frames,
  which match the one-process CLI's frames as that file's runner test
  holds them (at most 1 in uint8, on at most 0.1% of the values);
* VAE training ``--cp 2``: one GAN step of the tiny VAE on 32-frame 32x32
  clips (16 frames per rank), every metric finite, rank 0 writes the
  checkpoint, and a second run resumes from it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port_checkpoint import PROMPT, VARIANT, write_release_dir
from test_torch_port_vae_training import _write_videos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torchrun(module, *argv, nproc=2, timeout=240):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m module argv``; returns the completed process."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", module, *argv]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=timeout, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    return res


def _frames(path):
    from PIL import Image

    names = sorted(os.listdir(path))
    return np.stack([np.asarray(Image.open(os.path.join(path, n)))
                     for n in names])


@pytest.mark.parametrize("model_name", ["pyramid_flux", "pyramid_mmdit"])
def test_inference_cli_serves_sequence_parallel(tmp_path, model_name):
    from pyramid_flow_tpu_torch.tools import inference

    root = tmp_path / "ckpt"
    write_release_dir(str(root), model_name)
    args = ["--model_path", str(root), "--variant", VARIANT, "--model_name",
            model_name, "--prompt", PROMPT, "--temp", "2", "--height", "64",
            "--width", "64", "--num_inference_steps", "1",
            "--video_num_inference_steps", "1", "--device", "cpu"]
    torchrun("pyramid_flow_tpu_torch.tools.inference", *args, "--sp", "2",
             "--output", str(tmp_path / "sp"))
    assert inference.main(args + ["--output", str(tmp_path / "one")]) == 0
    sp, one = _frames(tmp_path / "sp"), _frames(tmp_path / "one")
    assert sp.shape == one.shape == (9, 64, 64, 3)
    diff = np.abs(sp.astype(np.int16) - one.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert len(np.unique(one)) > 10


def test_vae_cli_trains_context_parallel(tmp_path):
    anno = _write_videos(tmp_path, frames=36)
    out = tmp_path / "run"
    args = ["--video_anno", anno, "--debug_tiny", "--resolution", "32",
            "--num_frames", "32", "--steps_per_epoch", "1", "--disc_start",
            "1", "--output_dir", str(out), "--print_freq", "1", "--cp", "2"]
    torchrun("pyramid_flow_tpu_torch.tools.train_video_vae", *args,
             "--epochs", "1")
    assert sorted(os.listdir(out)) == ["checkpoint-1.pt", "log.txt"]
    ckpt = torch.load(out / "checkpoint-1.pt", weights_only=True)
    assert ckpt["step"] == 1
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert all(np.isfinite(v) for v in log[0].values())
    torchrun("pyramid_flow_tpu_torch.tools.train_video_vae", *args,
             "--epochs", "2")
    assert torch.load(out / "checkpoint-2.pt", weights_only=True)["step"] == 2
