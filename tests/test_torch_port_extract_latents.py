"""Port parity for the latent-extraction tool
(``tools/extract_video_vae_latents.py``).

On a tiny release-layout directory (test_torch_port_checkpoint.py's
``write_release_dir``) and tiny clips written with cv2:

* the port's per-clip encode (``encode_clip``) against JAX's
  ``chunk_encode`` and ``tiled_encode(temporal_chunk=True)`` and
  ``gaussian_sample`` in fp32, JAX's normal draw fed in: within 1e-4;
* the port's CLI (``--device cpu``, fp32) against the JAX tool run on the
  same directory, with ``--world 2`` for both ranks and an unreadable clip
  among the items: the same rows, file names (skipped items counted),
  shapes, and latents within relative L2 2e-2. The JAX tool builds
  ``VAEConfig()`` in bf16; the test patches the config the tool builds to
  the checkpoint's tiny one (the tool stays as it is), and replays the
  tool's ``PRNGKey(0)`` posterior draws in the port, so the latents differ
  by bf16 alone;
* the rows load in the port's ``LengthGroupedVideoTextDataset`` and in
  JAX's.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.data.datasets import (
    LengthGroupedVideoTextDataset as JDataset, VideoFrameProcessor as JProc)
from pyramid_flow_tpu.models.vae import model as jvae_model
from pyramid_flow_tpu.utils import checkpoint as jcheckpoint
from pyramid_flow_tpu_torch.data.datasets import (
    LengthGroupedVideoTextDataset, VideoFrameProcessor)
from pyramid_flow_tpu_torch.models.vae import model as vae_model
from pyramid_flow_tpu_torch.tools import extract_video_vae_latents as tool
from pyramid_flow_tpu_torch.utils.checkpoint import build_vae
from pyramid_flow_tpu_torch.utils.converters import load_state_dict

from test_torch_port_checkpoint import VAE_TINY, VARIANT, write_release_dir

ROOT = Path(__file__).resolve().parents[1]
FRAMES, HEIGHT, WIDTH, TILE = 17, 32, 48, 32
SIZE = ["--num_frames", str(FRAMES), "--height", str(HEIGHT), "--width",
        str(WIDTH), "--window_size", "8"]


def _clip(path, seed, frames=20, hw=(40, 56)):
    import cv2
    rng = np.random.default_rng(seed)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 24,
                          hw[::-1])
    for _ in range(frames):
        out.write(rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    out.release()
    return str(path)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    write_release_dir(str(root), "pyramid_flux")
    clips = [_clip(root / f"clip{i}.avi", i) for i in range(4)]
    items = [{"video": clips[0], "text": "a"}, {"video": clips[1]},
             {"video": str(root / "missing.avi"), "text": "c"},
             {"video": clips[2], "text": "d"}, {"video": clips[3]}]
    anno = root / "videos.jsonl"
    anno.write_text("".join(json.dumps(x) + "\n" for x in items))
    return str(root), str(anno), clips


@pytest.mark.parametrize("tile", [0, TILE], ids=["chunk", "tiled"])
def test_per_clip_encode_matches_jax(release, tile):
    root, _, clips = release
    video, _ = VideoFrameProcessor(FRAMES, (HEIGHT, WIDTH))(clips[0])
    jvideo, _ = JProc(FRAMES, (HEIGHT, WIDTH))(clips[0])
    np.testing.assert_array_equal(video, jvideo)

    jvae = jvae_model.CausalVideoVAE(config=jvae_model.VAEConfig(
        latent_channels=4, block_out_channels=(8, 8, 16, 16),
        encoder_layers_per_block=(1, 1, 1, 1),
        decoder_layers_per_block=(1, 1, 1, 1), num_groups=4))
    params = jcheckpoint.load_pretrained_components(root, VARIANT)["vae"]
    x = jnp.asarray(jvideo)[None]
    if tile:
        moments = jvae_model.tiled_encode(jvae, params, x, tile,
                                          temporal_chunk=True, window_size=8)
    else:
        moments = jvae_model.chunk_encode(jvae, params, x, 8)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    want = np.asarray(jvae_model.gaussian_sample(moments, sub)[0])
    draw = np.array(jax.random.normal(sub, want.shape))

    vae = build_vae(root, load_state_dict(os.path.join(
        root, "causal_video_vae")), dtype=torch.float32, device="cpu")
    got = tool.encode_clip(vae, video, torch.from_numpy(draw)[None], 8,
                           tile)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (3, HEIGHT // 8, WIDTH // 8, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


class JaxToolDraws:
    """The JAX tool's posterior draws in order: ``rng, sub =
    split(rng)`` per encoded clip from ``PRNGKey(0)``, in the tool's bf16."""

    def __init__(self):
        self.rng = jax.random.PRNGKey(0)
        self.sample = vae_model.gaussian_sample

    def __call__(self, moments, generator):
        self.rng, sub = jax.random.split(self.rng)
        shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
        draw = jax.random.normal(sub, shape, jnp.bfloat16)
        return self.sample(moments, torch.from_numpy(
            np.asarray(draw, np.float32)))


def _run_jax_tool(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_tools_extract", ROOT / "tools" / "extract_video_vae_latents.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    tiny = jvae_model.VAEConfig(
        latent_channels=VAE_TINY.latent_channels,
        block_out_channels=VAE_TINY.block_out_channels,
        encoder_layers_per_block=VAE_TINY.encoder_layers_per_block,
        decoder_layers_per_block=VAE_TINY.decoder_layers_per_block,
        num_groups=VAE_TINY.num_groups)
    with mock.patch.object(sys, "argv", ["x"] + argv), \
            mock.patch.object(jvae_model, "VAEConfig", lambda: tiny):
        module.main()


def _rows(path):
    return [json.loads(x) for x in Path(path).read_text().splitlines()]


def test_cli_matches_the_jax_tool(release, tmp_path, capfd):
    root, anno, _ = release
    draws = {0: JaxToolDraws(), 1: JaxToolDraws()}  # each rank's own
    out = {}
    for who in ("port", "jax"):
        for rank in (0, 1):
            d = tmp_path / who
            argv = ["--model_path", root, "--anno_file", anno,
                    "--output_dir", str(d / "lat"), "--output_anno",
                    str(d / f"anno{rank}.jsonl"), "--rank", str(rank),
                    "--world", "2", *SIZE]
            if who == "port":
                with mock.patch.object(vae_model, "gaussian_sample",
                                       draws[rank]):
                    assert tool.main(argv + ["--device", "cpu"]) == 0
            else:
                _run_jax_tool(argv)
        out[who] = tmp_path / who
    assert capfd.readouterr().err.count("skip ") == 2  # one per tool
    for rank in (0, 1):
        port = _rows(out["port"] / f"anno{rank}.jsonl")
        jax_ = _rows(out["jax"] / f"anno{rank}.jsonl")
        assert len(port) == len(jax_) == 2
        for p, j in zip(port, jax_):
            assert os.path.basename(p.pop("latent")) == \
                os.path.basename(j.pop("latent"))
            assert p == j
    names = sorted(os.listdir(out["port"] / "lat"))
    assert names == sorted(os.listdir(out["jax"] / "lat")) == [
        "latent_0_0000000.npy", "latent_0_0000002.npy",
        "latent_1_0000000.npy", "latent_1_0000001.npy"]
    for name in names:
        got = np.load(out["port"] / "lat" / name)
        want = np.load(out["jax"] / "lat" / name)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (3, HEIGHT // 8, WIDTH // 8, 4)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-2, (name, rel)

    # the rows load in both packages' datasets
    for cls in (LengthGroupedVideoTextDataset, JDataset):
        ds = cls(str(out["port"] / "anno0.jsonl"), max_frames=16,
                 latent_channels=4, load_text_fea=False)
        item = ds.get(0)
        assert item["latent"].shape == (3, HEIGHT // 8, WIDTH // 8, 4)
        assert item["text"] == "a"


def test_cli_tiles(release, tmp_path):
    """``--tile`` writes the rows of every readable clip, each latent of
    the untiled encode's shape."""
    root, anno, _ = release
    assert tool.main(["--model_path", root, "--anno_file", anno,
                      "--output_dir", str(tmp_path), "--output_anno",
                      str(tmp_path / "anno.jsonl"), "--tile", str(TILE),
                      *SIZE, "--device", "cpu"]) == 0
    rows = _rows(tmp_path / "anno.jsonl")
    assert [os.path.basename(r["latent"]) for r in rows] == [
        f"latent_0_{i:07d}.npy" for i in (0, 1, 3, 4)]
    for r in rows:
        assert np.load(r["latent"]).shape == (3, HEIGHT // 8, WIDTH // 8, 4)
