"""Port parity for checkpoint loading and the string-prompt entry points.

* the port's own safetensors reader against ``safetensors.torch`` (bit for
  bit, dtypes kept), torch pickles, a sharded directory, and the T5
  embedding's two names;
* ``load_model_config`` against the JAX package's for the three kinds;
* a tiny checkpoint directory in the released layout, written from the
  port's own modules for each DiT family: the JAX package's
  ``load_pretrained_components`` reads back every written tensor exactly
  (through the port's JAX->torch converters), and
  ``PyramidFlowRunner.from_pretrained`` on the CPU in fp32 agrees with JAX's
  runner on ``generate("a cat walks on grass")`` with JAX's noise replayed:
  latents within atol 5e-4 and uint8 frames within one level on at most
  0.1% of values (the tolerances of test_torch_port_pipeline.py);
* the inference CLI writes PNG frames, the training CLI trains from the
  checkpoint on raw text (and raw pixels), its ``fill_text_features``
  agrees with JAX's, and ``extract_text_features`` writes the JAX tool's
  ``.npz`` files, within relative 1e-4.
"""

import dataclasses
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
from safetensors.torch import load_file, save_file

from pyramid_flow_tpu.models.text import encoder as jencoder
from pyramid_flow_tpu.pipeline.runner import PyramidFlowRunner as JRunner
from pyramid_flow_tpu.utils import checkpoint as jcheckpoint
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.mmdit.model import (
    MMDiTConfig, PyramidDiffusionMMDiT)
from pyramid_flow_tpu_torch.models.text.clip import (
    CLIPTextConfig, CLIPTextEncoder)
from pyramid_flow_tpu_torch.models.text.encoder import build_text_encoder
from pyramid_flow_tpu_torch.models.text.t5 import T5Config, T5Encoder
from pyramid_flow_tpu_torch.models.vae.model import CausalVideoVAE, VAEConfig
from pyramid_flow_tpu_torch.pipeline.runner import PyramidFlowRunner
from pyramid_flow_tpu_torch.tools import extract_text_features as extract
from pyramid_flow_tpu_torch.tools import inference
from pyramid_flow_tpu_torch.tools import train_pyramid_flow as train_cli
from pyramid_flow_tpu_torch.utils import checkpoint
from pyramid_flow_tpu_torch.utils.converters import (
    clip_state_dict_from_jax, flux_state_dict_from_jax, load_state_dict,
    mmdit_state_dict_from_jax, read_safetensors, t5_state_dict_from_jax,
    vae_state_dict_from_jax)
from test_torch_port_pipeline import JaxNoise
from test_torch_port_text import (
    CLIP_TINY, PROMPTS, T5_TINY, clip_config_json, rel_err, t5_config_json,
    write_json, write_tokenizers)

ROOT = Path(__file__).resolve().parents[1]
VARIANT = "diffusion_transformer_384p"
PROMPT = "a cat walks on grass"
GEN = dict(height=64, width=64, temp=1, num_inference_steps=[1, 1, 1],
           video_num_inference_steps=[1, 1, 1], guidance_scale=7.0,
           video_guidance_scale=5.0)
VAE_TINY = VAEConfig(latent_channels=4, block_out_channels=(8, 8, 16, 16),
                     encoder_layers_per_block=(1, 1, 1, 1),
                     decoder_layers_per_block=(1, 1, 1, 1), num_groups=4)
FLUX_TINY = FluxConfig(in_channels=16, num_layers=1, num_single_layers=1,
                       attention_head_dim=8, num_attention_heads=4,
                       joint_attention_dim=32, pooled_projection_dim=24,
                       axes_dims_rope=(4, 2, 2))
# pooled 24 = CLIP-L's projection 12 + CLIP-G's 12
MMDIT_TINY = MMDiTConfig(sample_size=32, in_channels=4, num_layers=2,
                         attention_head_dim=8, num_attention_heads=4,
                         caption_projection_dim=32, pooled_projection_dim=24,
                         joint_attention_dim=32, pos_embed_max_size=24)


# ------------------------------------------------------- the file reader
def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w_bf16": torch.randn((5, 7), generator=g).bfloat16(),
        "w_f32": torch.randn((3, 2, 4), generator=g),
        "b_f16": torch.randn((9,), generator=g).half(),
        "idx": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "i32": torch.arange(3, dtype=torch.int32),
        "flag": torch.tensor([True, False, True]),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros((0, 4)),
    }


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _assert_identical(got, want):
    """Same keys, dtypes, shapes and bytes."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
        assert torch.equal(_bits(got[k]), _bits(w)), k


def test_read_safetensors_matches_safetensors_bit_for_bit(tmp_path):
    sd = _tensors()
    path = str(tmp_path / "one.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    _assert_identical(read_safetensors(path), load_file(path))
    _assert_identical(load_state_dict(path), sd)


def test_load_state_dict_reads_a_sharded_dir_and_torch_files(tmp_path):
    a, b = _tensors(1), _tensors(2)
    shards = tmp_path / "sharded"
    shards.mkdir()
    save_file({k + ".0": v for k, v in a.items()},
              str(shards / "model-00001-of-00002.safetensors"))
    save_file({k + ".1": v for k, v in b.items()},
              str(shards / "model-00002-of-00002.safetensors"))
    (shards / "config.json").write_text("{}")
    want = {**load_file(str(shards / "model-00001-of-00002.safetensors")),
            **load_file(str(shards / "model-00002-of-00002.safetensors"))}
    _assert_identical(load_state_dict(str(shards)), want)

    torch.save({"state_dict": a}, tmp_path / "wrapped.bin")
    torch.save(b, tmp_path / "plain.pt")
    _assert_identical(load_state_dict(str(tmp_path / "wrapped.bin")), a)
    _assert_identical(load_state_dict(str(tmp_path / "plain.pt")), b)


def test_reader_refuses_other_dtypes_and_truncated_files(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    save_file({"x": torch.zeros(3, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        read_safetensors(path)
    path = str(tmp_path / "cut.safetensors")
    save_file({"x": torch.ones(64)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 8)
    with pytest.raises(ValueError):
        read_safetensors(path)


def test_t5_embedding_under_either_name_loads(tmp_path):
    t5 = T5Encoder(T5Config(**T5_TINY), device="cpu")
    sd = t5.state_dict()
    only = {("encoder.embed_tokens.weight" if k == "shared.weight" else k): v
            for k, v in sd.items()}
    both = {**sd, "encoder.embed_tokens.weight": sd["shared.weight"].clone()}
    for name, variant in (("only", only), ("both", both)):
        d = tmp_path / name / "text_encoder_2"
        d.mkdir(parents=True)
        save_file({k: v.contiguous() for k, v in variant.items()},
                  str(d / "model.safetensors"))
        comps = checkpoint.load_text_components(str(tmp_path / name))
        T5Encoder(T5Config(**T5_TINY), device="cpu").load_state_dict(
            comps["t5"], strict=True)
        assert torch.equal(comps["t5"]["shared.weight"], sd["shared.weight"])


@pytest.mark.parametrize("kind,raw", [
    ("flux", {"in_channels": 16, "num_layers": 3, "num_single_layers": 5,
              "axes_dims_rope": [4, 2, 2], "guidance_embeds": False,
              "_class_name": "PyramidFluxTransformer", "patch_size": 1}),
    ("mmdit", {"sample_size": 64, "num_layers": 4,
               "pos_embed_max_size": 48, "caption_projection_dim": 64,
               "pos_embed_type": "sincos"}),
    ("vae", {"latent_channels": 8, "block_out_channels": [8, 8, 16, 16],
             "layers_per_block": [1, 1, 1, 1],
             "decoder_layers_per_block": [1, 2, 1, 2], "num_groups": 4,
             "spatial_down_sample": [True, True, True, False]}),
    ("vae", None),
])
def test_load_model_config_matches_jax(tmp_path, kind, raw):
    if raw is not None:
        (tmp_path / "config.json").write_text(json.dumps(raw))
    got = checkpoint.load_model_config(str(tmp_path), kind)
    want = jcheckpoint.load_model_config(str(tmp_path), kind)
    fields = dataclasses.asdict(got)
    assert fields == {k: getattr(want, k) for k in fields}


def test_load_model_config_refuses_what_the_port_does_not_build(tmp_path):
    """A block type the port has no module for raises, naming the field and
    the type, before any model is built (guidance_embeds and the VAE's
    down-sample flags are built now: test_torch_port_surface.py)."""
    (tmp_path / "config.json").write_text(json.dumps(
        {"down_block_types": ["DownEncoderBlock2D", "DownEncoderBlock1D",
                              "DownEncoderBlockCausal3D",
                              "DownEncoderBlockCausal3D"]}))
    with pytest.raises(ValueError,
                       match="down_block_types.*DownEncoderBlock1D"):
        checkpoint.load_model_config(str(tmp_path), "vae")
    (tmp_path / "config.json").write_text(json.dumps(
        {"mid_block_type": "UNetMidBlock3D"}))
    with pytest.raises(ValueError, match="mid_block_type.*UNetMidBlock3D"):
        checkpoint.load_model_config(str(tmp_path), "vae")


# ------------------------------------------- a release-layout directory
@torch.no_grad()
def _randomize(module, gen, std=0.02):
    """N(0, std) weights and biases, 1 + N(0, std) norm weights; the
    MMDiT's sincos table, a buffer, keeps its values."""
    for name, p in module.named_parameters():
        p.normal_(0.0, std, generator=gen)
        if p.dim() == 1 and "norm" in name and name.endswith("weight"):
            p.add_(1.0)


@torch.no_grad()
def _randomize_text(module, gen):
    """Linear weights N(0, 1 / fan_in), embeddings N(0, 1), the relative
    bias N(0, 0.5^2), norm weights 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    for name, p in module.named_parameters():
        if "embedding" in name or name == "shared.weight":
            p.normal_(0.0, 1.0, generator=gen)
        elif "relative_attention_bias" in name:
            p.normal_(0.0, 0.5, generator=gen)
        elif p.dim() == 2:
            p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
        elif "norm" in name and name.endswith("weight"):
            p.normal_(1.0, 0.1, generator=gen)
        else:
            p.normal_(0.0, 0.1, generator=gen)


def _save(sd, d, shards=1, dtype=None):
    """``sd`` as safetensors in ``d``, split over ``shards`` files."""
    os.makedirs(d, exist_ok=True)
    keys = sorted(sd)
    for i in range(shards):
        part = {k: (sd[k].to(dtype) if dtype else sd[k]).contiguous()
                for k in keys[i::shards]}
        name = ("diffusion_pytorch_model.safetensors" if shards == 1 else
                f"model-{i + 1:05d}-of-{shards:05d}.safetensors")
        save_file(part, os.path.join(d, name))


def write_release_dir(root, model_name):
    """The released layout at tiny size, from the port's modules with
    seeded random weights: the DiT (stored in bf16), the VAE, the text
    encoders (the T5 in two shards), their config.json files and offline
    tokenizers. Returns {component: state dict as written}."""
    gen = torch.Generator().manual_seed(3)
    written = {}
    if model_name == "pyramid_flux":
        dit, cfg = PyramidFluxTransformer(FLUX_TINY, device="cpu"), FLUX_TINY
    else:
        dit = PyramidDiffusionMMDiT(MMDIT_TINY, device="cpu")
        cfg = MMDIT_TINY
    _randomize(dit, gen)
    written["dit"] = {k: v.bfloat16() for k, v in dit.state_dict().items()}
    _save(written["dit"], os.path.join(root, VARIANT))
    write_json(os.path.join(root, VARIANT), dataclasses.asdict(cfg))

    vae = CausalVideoVAE(VAE_TINY, device="cpu")
    _randomize(vae, gen, std=0.1)
    written["vae"] = vae.state_dict()
    _save(written["vae"], os.path.join(root, "causal_video_vae"))
    write_json(os.path.join(root, "causal_video_vae"),
               dataclasses.asdict(VAE_TINY))

    flux = model_name == "pyramid_flux"
    proj = dict(use_projection=not flux, projection_dim=12)
    clips = [("text_encoder", "clip", CLIPTextConfig(**CLIP_TINY, **proj))]
    if not flux:
        clips.append(("text_encoder_2", "clip_g", CLIPTextConfig(
            **{**CLIP_TINY, "hidden_size": 32}, **proj)))
    for sub, name, ccfg in clips:
        m = CLIPTextEncoder(ccfg, device="cpu")
        _randomize_text(m, gen)
        written[name] = m.state_dict()
        _save(written[name], os.path.join(root, sub))
        write_json(os.path.join(root, sub), clip_config_json(ccfg))
    t5_cfg = T5Config(**T5_TINY)
    t5 = T5Encoder(t5_cfg, device="cpu")
    _randomize_text(t5, gen)
    written["t5"] = t5.state_dict()
    sub = "text_encoder_2" if flux else "text_encoder_3"
    _save(written["t5"], os.path.join(root, sub), shards=2)
    write_json(os.path.join(root, sub), t5_config_json(t5_cfg))
    write_tokenizers(root, model_name)
    return written


@pytest.fixture(scope="module", params=["pyramid_flux", "pyramid_mmdit"])
def release_dir(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    written = write_release_dir(str(root), request.param)
    return request.param, str(root), written


_FROM_JAX = {"vae": vae_state_dict_from_jax, "clip": clip_state_dict_from_jax,
             "clip_g": clip_state_dict_from_jax, "t5": t5_state_dict_from_jax}


def test_jax_loader_reads_back_every_written_tensor(release_dir):
    """The JAX package's loader consumes the port-written directory whole:
    carried back by the port's converters, each component holds exactly
    the tensors written, no key more or less. The port's own loader gives
    them back in their stored dtypes."""
    model_name, root, written = release_dir
    comps = jcheckpoint.load_pretrained_components(root, VARIANT, model_name)
    assert sorted(comps) == sorted(written)
    ported = checkpoint.load_pretrained_components(root, VARIANT, model_name)
    assert sorted(ported) == sorted(written)
    dit_from_jax = (flux_state_dict_from_jax if model_name == "pyramid_flux"
                    else mmdit_state_dict_from_jax)
    for name, want in written.items():
        conv = dit_from_jax if name == "dit" else _FROM_JAX[name]
        back = conv(jax.tree.map(np.asarray, comps[name]))
        assert sorted(back) == sorted(want), name
        _assert_identical(ported[name], want)
        for k, w in want.items():
            assert torch.equal(back[k], w.float()), (name, k)


@pytest.fixture(scope="module")
def runners(release_dir):
    model_name, root, _ = release_dir
    port = PyramidFlowRunner.from_pretrained(
        root, VARIANT, model_name, dtype=torch.float32, device="cpu")
    jrunner = JRunner.from_pretrained(root, VARIANT, model_name,
                                      dtype=jnp.float32)
    return port, jrunner


def test_from_pretrained_loads_strictly_in_layout(runners, release_dir):
    model_name, _, written = release_dir
    port, _ = runners
    pipe = port.pipeline
    assert pipe.model_name == model_name and pipe.latent_channels == 4
    for k, w in written["dit"].items():
        assert torch.equal(pipe.dit.state_dict()[k], w.float()), k
    # loaded by copy: the VAE's conv weights keep the layout the conv
    # kernel reads
    w = pipe.vae.decoder.conv_in.conv.weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d)
    assert not w.is_contiguous()
    te = port.text_encoder
    assert type(te).__name__ == ("FluxTextEncoder"
                                 if model_name == "pyramid_flux"
                                 else "SD3TextEncoder")


def test_runner_generate_matches_jax(runners):
    port, jrunner = runners
    want = np.asarray(jrunner.generate(PROMPT, seed=0, output_type="latent",
                                       **GEN))
    got = port.generate(PROMPT, noise=JaxNoise(0), output_type="latent",
                        **GEN)
    assert got.shape == want.shape == (1, 1, 8, 8, 4)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)

    ref = np.asarray(jrunner.pipeline.decode_latent(jnp.asarray(want)))
    frames = port.pipeline.decode_latent(got).numpy()
    assert frames.shape == ref.shape == (1, 1, 64, 64, 3)
    diff = np.abs(frames.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert len(np.unique(ref)) > 10


# ----------------------------------------------------------------- tools
@pytest.mark.parametrize("i2v", [False, True])
def test_inference_cli_writes_png_frames(release_dir, tmp_path, i2v, capfd):
    """PNG frames, then ``video.mp4`` at ``--fps``; where imageio has no
    ffmpeg plugin (as on the CPU test machines) the CLI keeps the PNG
    frames and reports the fallback on stderr, as JAX's CLI does."""
    from PIL import Image

    model_name, root, _ = release_dir
    out = tmp_path / "out"
    argv = ["--model_path", root, "--variant", VARIANT, "--model_name",
            model_name, "--prompt", PROMPT, "--temp", "2", "--height", "64",
            "--width", "64", "--num_inference_steps", "1",
            "--video_num_inference_steps", "1", "--output", str(out),
            "--device", "cpu", "--fps", "12"]
    assert inference.parse_args(argv).fps == 12
    assert inference.parse_args(argv[:-2]).fps == 24
    if i2v:
        img = np.random.default_rng(0).integers(0, 256, (80, 96, 3))
        Image.fromarray(img.astype(np.uint8)).save(tmp_path / "in.png")
        argv += ["--input_image", str(tmp_path / "in.png")]
    assert inference.main(argv) == 0
    names = sorted(os.listdir(out))
    pngs = [f"frame_{i:04d}.png" for i in range(9)]
    err = capfd.readouterr().err
    if "video.mp4" in names:
        assert names == pngs + ["video.mp4"]
        assert f"wrote {out}/video.mp4" in err
    else:
        assert names == pngs
        assert "mp4 export unavailable" in err
    frame = np.asarray(Image.open(out / pngs[-1]))
    assert frame.shape == (64, 64, 3) and frame.dtype == np.uint8


def test_this_machine_takes_the_mp4_fallback(tmp_path, capfd):
    """The writer on this machine's imageio, which has no ffmpeg plugin:
    the PNG frames and the reported fallback, and the npz stack in memory
    (test_torch_port_serve.py decodes it)."""
    from pyramid_flow_tpu_torch.utils import video_io

    frames = np.random.default_rng(1).integers(0, 256, (3, 16, 24, 3),
                                               dtype=np.uint8)
    assert video_io.save_frames(frames, str(tmp_path), fps=8) is None
    assert sorted(os.listdir(tmp_path)) == [f"frame_{i:04d}.png"
                                            for i in range(3)]
    assert "mp4 export unavailable" in capfd.readouterr().err
    body, ctype = video_io.video_bytes(frames, fps=8)
    assert ctype == video_io.NPZ
    np.testing.assert_array_equal(video_io.frames_from_bytes(body, ctype),
                                  frames)


def test_inference_cli_refuses_sequence_parallelism(tmp_path):
    """Outside torchrun ``--sp 2`` exits asking for it (it serves under
    torchrun: test_torch_port_parallel_cli.py)."""
    with pytest.raises(SystemExit, match="torchrun"):
        inference.main(["--model_path", str(tmp_path), "--sp", "2",
                        "--device", "cpu"])


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_text_encoder(root, model_name):
    comps = jcheckpoint.load_pretrained_components(
        root, VARIANT, model_name, load_vae=False)
    if model_name == "pyramid_flux":
        return jencoder.FluxTextEncoder(comps["clip"], comps["t5"], root,
                                        dtype=jnp.float32)
    return jencoder.SD3TextEncoder(comps["clip"], comps["clip_g"],
                                   comps["t5"], root, dtype=jnp.float32)


def test_fill_text_features_matches_jax(release_dir):
    model_name, root, _ = release_dir
    te = build_text_encoder(checkpoint.load_text_components(root, model_name),
                            root, model_name, dtype=torch.float32,
                            device="cpu")
    batch = {"latents": np.zeros((3, 1, 8, 8, 4), np.float32),
             "text": PROMPTS}
    got = train_cli.fill_text_features(batch, te)
    want = _jax_tool("train_pyramid_flow").fill_text_features(
        batch, _jax_text_encoder(root, model_name))
    assert sorted(got) == sorted(want)
    for k in ("text_emb", "pooled"):
        assert got[k].dtype == want[k].dtype == np.float32
        assert rel_err(got[k], want[k]) < 1e-4, k
    np.testing.assert_array_equal(got["text_mask"], want["text_mask"])


@pytest.mark.parametrize("extra", [[], ["--load_vae"]])
def test_training_cli_trains_from_the_checkpoint_on_raw_text(
        release_dir, tmp_path, extra):
    """Two steps from the checkpoint's DiT, the text encoders run over each
    batch's prompts (and with ``--load_vae`` the VAE encodes raw pixels)."""
    model_name, root, written = release_dir
    out = tmp_path / "run"
    assert train_cli.main([
        "--debug_tiny", "--model_path", root, "--model_variant", VARIANT,
        "--model_name", model_name, "--load_text_encoder", *extra,
        "--epochs", "1", "--steps_per_epoch", "2", "--output_dir", str(out),
        "--print_freq", "1", "--bound_probe_freq", "1"]) == 0
    log = [json.loads(line) for line in (out / "log.txt").read_text()
           .splitlines() if line.strip()]
    assert log and all(np.isfinite(row["train_loss"]) for row in log)
    ema = torch.load(out / "checkpoint-2-ema.pt", weights_only=True)
    assert sorted(ema) == sorted(written["dit"])


def test_extract_text_features_matches_jax_tool(release_dir, tmp_path):
    """The port's tool and the JAX tool (its encoders in fp32) write the
    same files: null_text.npz and one .npz per item, and the annotation."""
    model_name, root, _ = release_dir
    anno = tmp_path / "anno.jsonl"
    anno.write_text("".join(json.dumps({"text": p, "video": f"v{i}.mp4"})
                            + "\n" for i, p in enumerate(PROMPTS)))
    outs = {}
    for who in ("port", "jax"):
        d = tmp_path / who
        argv = ["--model_path", root, "--model_name", model_name,
                "--anno_file", str(anno), "--output_dir", str(d / "fea"),
                "--output_anno", str(d / "anno.jsonl"), "--batch_size", "2"]
        if who == "port":
            assert extract.main(argv + ["--device", "cpu"]) == 0
        else:
            tool = _jax_tool("extract_text_features")
            cls = (jencoder.FluxTextEncoder if model_name == "pyramid_flux"
                   else jencoder.SD3TextEncoder)

            class Fp32(cls):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **{**kw, "dtype": jnp.float32})

            with mock.patch.object(sys, "argv", ["x"] + argv), \
                    mock.patch.object(jencoder, cls.__name__, Fp32):
                tool.main()
        outs[who] = d
    port_rows = [json.loads(x) for x in
                 (outs["port"] / "anno.jsonl").read_text().splitlines()]
    jax_rows = [json.loads(x) for x in
                (outs["jax"] / "anno.jsonl").read_text().splitlines()]
    assert len(port_rows) == len(jax_rows) == len(PROMPTS)
    for p, j in zip(port_rows, jax_rows):
        assert os.path.basename(p.pop("text_fea")) == \
            os.path.basename(j.pop("text_fea"))
        assert p == j
    names = sorted(os.listdir(outs["jax"] / "fea"))
    assert names == sorted(os.listdir(outs["port"] / "fea"))
    assert len(names) == 1 + len(PROMPTS)
    for name in names:
        got = np.load(outs["port"] / "fea" / name)
        want = np.load(outs["jax"] / "fea" / name)
        assert sorted(got.files) == sorted(want.files) == [
            "pooled_prompt_embed", "prompt_attention_mask", "prompt_embed"]
        for k in want.files:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, (name, k)
        np.testing.assert_array_equal(got["prompt_attention_mask"],
                                      want["prompt_attention_mask"])
        for k in ("prompt_embed", "pooled_prompt_embed"):
            assert rel_err(got[k], want[k]) < 1e-4, (name, k)
