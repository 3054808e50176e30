"""Port parity for GAN-VAE training, JAX vs torch, on the CPU: LPIPS, the
PatchGAN discriminators, ``decode_features``, the generator and
discriminator gradients, the
adaptive loss weight, the conv routing rule and the training CLI (two full
steps of ``make_vae_train_step`` are in test_torch_port_vae_train_step.py).

JAX's ``TINY_VAE`` geometry (tests/test_vae_training.py) with its weights
redrawn from a numpy seed, so that every layer carries signal, carried to the
port by ``vae_state_dict_from_jax``; JAX's LPIPS (full VGG16) and small
discriminators (ndf 8, 2 layers), their weights drawn the same way (LPIPS's
heads non-negative, as the released ones), carried over by
``lpips_state_dict_from_jax`` and ``discriminator_state_dict_from_jax``. The
clip is 9 frames of 32x32 (2 latent frames): JAX's own test takes 3 frames,
which decode to 1, and its losses then broadcast that one frame against the
three. The port replays JAX's posterior draws through ``JaxDraws``. fp32.

Tolerances: LPIPS and the discriminators rtol 1e-5 (atol 1e-7); gradients
atol 2e-6, rtol 2e-3 (the DiT tests'); the steps' metrics rtol 1e-5 (atol
1e-7).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.vae import model as jmodel
from pyramid_flow_tpu.models.vae.discriminator import (
    PatchDiscriminator2D as JDisc2D, PatchDiscriminator3D as JDisc3D)
from pyramid_flow_tpu.models.vae.lpips import LPIPS as JLPIPS
from pyramid_flow_tpu.models.vae.lpips import convert_lpips
from pyramid_flow_tpu.training import vae_trainer as jtrainer
from pyramid_flow_tpu_torch.models.vae import layers, model
from pyramid_flow_tpu_torch.models.vae.discriminator import (
    PatchDiscriminator2D, PatchDiscriminator3D)
from pyramid_flow_tpu_torch.models.vae.lpips import LPIPS, SLICES
from pyramid_flow_tpu_torch.ops import causal_conv3d as cc
from pyramid_flow_tpu_torch.tools import train_video_vae as cli
from pyramid_flow_tpu_torch.training import vae_trainer
from pyramid_flow_tpu_torch.utils.converters import (
    discriminator_state_dict_from_jax, lpips_state_dict_from_jax,
    vae_state_dict_from_jax)
from test_torch_port_training import GRAD_ATOL, GRAD_RTOL, JaxDraws
from test_torch_port_vae import _randomize

TINY = dict(latent_channels=2, block_out_channels=(4, 4, 8, 8),
            encoder_layers_per_block=(1, 1, 1, 1),
            decoder_layers_per_block=(1, 1, 1, 1), num_groups=2)
CLIP = (1, 9, 32, 32, 3)
TOL = dict(rtol=1e-5, atol=1e-7)
LR = 1e-4  # lr * wd = 1e-8: a step of zero gradients leaves fp32 weights
DISC = dict(ndf=8, n_layers=2)


def _clip(seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal(CLIP)).clip(-1, 1).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def tiny_gan_nets():
    """JAX's modules and variables, and makers of the port's twins."""
    jvae = jmodel.CausalVideoVAE(config=jmodel.VAEConfig(**TINY))
    shapes = jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros(CLIP), rng=jax.random.PRNGKey(1)))
    vae_params = jax.tree.map(jnp.asarray, _randomize(shapes, 3))
    frame = jnp.zeros(CLIP[:1] + CLIP[2:])
    jlpips = JLPIPS()
    lpips_params = _randomize(jax.eval_shape(
        jlpips.init, jax.random.PRNGKey(0), frame, frame), 4)
    # non-negative heads, as the released ones are
    lpips_params = jax.tree_util.tree_map_with_path(
        lambda path, p: np.abs(p) if path[-2].key.startswith("lin_") else p,
        lpips_params)
    discs = {False: JDisc2D(**DISC), True: JDisc3D(**DISC)}
    disc_params = {
        use_3d: _randomize(jax.eval_shape(
            discs[use_3d].init, jax.random.PRNGKey(0),
            jnp.zeros(CLIP) if use_3d else frame), 5 + use_3d)
        for use_3d in (False, True)}

    def port_vae():
        vae = model.CausalVideoVAE(model.VAEConfig(**TINY), device="cpu")
        vae.load_state_dict(vae_state_dict_from_jax(_np(vae_params)),
                            strict=True)
        return vae

    def port_lpips():
        lpips = LPIPS(device="cpu")
        lpips.load_state_dict(lpips_state_dict_from_jax(_np(lpips_params)),
                              strict=True)
        return lpips

    def port_disc(use_3d):
        cls = PatchDiscriminator3D if use_3d else PatchDiscriminator2D
        disc = cls(**DISC, device="cpu")
        disc.load_state_dict(discriminator_state_dict_from_jax(
            _np(disc_params[use_3d])), strict=True)
        return disc

    return dict(jvae=jvae, vae_params=vae_params, jlpips=jlpips,
                lpips_params=lpips_params, discs=discs,
                disc_params=disc_params, port_vae=port_vae,
                port_lpips=port_lpips, port_disc=port_disc)


@pytest.fixture(scope="module")
def nets():
    return tiny_gan_nets()


# ------------------------------------------------------------------ LPIPS
def test_lpips_matches_jax_and_is_zero_on_equal_inputs(nets):
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((3, 32, 32, 3))).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(
        np.float32)
    ref = np.asarray(nets["jlpips"].apply(nets["lpips_params"],
                                          jnp.asarray(x), jnp.asarray(y)))
    lpips = nets["port_lpips"]()
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y)
    out = lpips(xt, yt)
    assert out.shape == ref.shape == (3, 1, 1, 1)
    assert ref.min() > 1e-2
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    same = lpips(yt, yt)
    assert not same.any()
    # frozen, and differentiable in its inputs
    out.sum().backward()
    assert xt.grad.abs().max() > 0
    assert not any(p.requires_grad for p in lpips.parameters())


def test_vgg_lpips_layout_loads_strict():
    """A ``vgg_lpips.pth``-layout dict (the keys of JAX's own converter
    test: VGG16 ``features`` indices, ``lin{k}.model.1``) loads strict into
    the port and, through JAX's ``convert_lpips``, gives JAX's output."""
    rng = np.random.default_rng(0)
    sd, idx, cin = {}, 0, 3
    for s, channels in enumerate(SLICES):
        for c in channels:
            sd[f"net.slice{s + 1}.{idx}.weight"] = (0.1 * rng.standard_normal(
                (c, cin, 3, 3)) / np.sqrt(cin)).astype(np.float32)
            sd[f"net.slice{s + 1}.{idx}.bias"] = (0.01 * rng.standard_normal(
                c)).astype(np.float32)
            idx, cin = idx + 2, c
        idx += 1
    for k, channels in enumerate(SLICES):
        sd[f"lin{k}.model.1.weight"] = np.abs(rng.standard_normal(
            (1, channels[-1], 1, 1))).astype(np.float32)
    lpips = LPIPS(device="cpu")
    lpips.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    x = (0.3 * rng.standard_normal((2, 32, 32, 3))).astype(np.float32)
    y = (0.5 * x).astype(np.float32)
    ref = np.asarray(JLPIPS().apply(convert_lpips(sd), jnp.asarray(x),
                                    jnp.asarray(y)))
    out = lpips(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert ref.min() > 0
    np.testing.assert_allclose(out, ref, **TOL)


# ---------------------------------------------------------- discriminators
@pytest.mark.parametrize("use_3d", [False, True], ids=["2d", "3d"])
def test_discriminator_matches_jax(nets, use_3d):
    x = _clip(2) if use_3d else _clip(2)[0]
    ref = np.asarray(nets["discs"][use_3d].apply(nets["disc_params"][use_3d],
                                                 jnp.asarray(x)))
    out = nets["port_disc"](use_3d)(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape and ref.shape[-1] == 1
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls,shape,params", [
    (PatchDiscriminator2D, (2, 256, 256, 3), 6_959_553),
    (PatchDiscriminator3D, (1, 17, 64, 64, 3), 11_056_065)],
    ids=["2d", "3d"])
def test_release_discriminators(cls, shape, params):
    """ndf 64 with 4 layers (2D) and 3 (3D): the parameter counts, N(0,
    0.02) weights, zero biases and one logit channel."""
    disc = cls(device="cpu")
    assert sum(p.numel() for p in disc.parameters()) == params
    w = disc.conv_0.weight
    assert abs(w.std().item() - 0.02) < 2e-3 and not disc.conv_0.bias.any()
    with torch.no_grad():
        assert disc(torch.zeros(shape)).shape[-1] == 1


# ------------------------------------------------------------------- VAE
def test_decode_features_then_conv_out_is_decode(nets):
    vae = nets["port_vae"]()
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 2, 4, 4, 2)).astype(np.float32))
    with torch.no_grad():
        feats = vae.decode_features(z)
        via = vae.decoder.conv_out(feats).permute(0, 2, 3, 4, 1)
        want = vae.decode(z)
    assert feats.shape == (1, 4, 9, 32, 32)
    assert feats.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(via, want, rtol=0, atol=0)


# ------------------------------------------------------------ train step
def _jax_state(nets, use_3d, disc_start):
    cfg = jtrainer.VAETrainConfig(disc_start=disc_start, learning_rate=LR,
                                  disc_learning_rate=LR)
    return jtrainer.create_vae_train_state(
        nets["vae_params"], nets["disc_params"][use_3d], cfg)


def _port_state(nets, use_3d, disc_start):
    vae, disc = nets["port_vae"](), nets["port_disc"](use_3d)
    cfg = vae_trainer.VAETrainConfig(disc_start=disc_start, learning_rate=LR,
                                     disc_learning_rate=LR)
    return vae_trainer.create_vae_train_state(vae, disc, cfg)


def _jax_step(nets, use_3d, freeze_encoder=False, grads_only=False):
    return jtrainer.make_vae_train_step(
        nets["jvae"], nets["jlpips"], nets["lpips_params"],
        nets["discs"][use_3d], use_3d_disc=use_3d,
        freeze_encoder=freeze_encoder, donate=False, grads_only=grads_only)


def _assert_metrics(got, want):
    assert got.keys() == {k for k in want if not k.startswith("_")}
    for k, v in got.items():
        np.testing.assert_allclose(v, float(want[k]), **TOL, err_msg=k)


def test_gan_gradients_match_jax(nets):
    """``grads_only`` with the discriminator on (``disc_start=0``): the
    generator's gradients (the VAE's and ``logvar``'s, through the adaptive
    weight) and the discriminator's, against JAX's."""
    key = jax.random.PRNGKey(7)
    video = _clip()
    jg, jd, jm = _jax_step(nets, False, grads_only=True)(
        _jax_state(nets, False, 0), jnp.asarray(video), key)
    state = _port_state(nets, False, 0)
    step = vae_trainer.make_vae_train_step(
        state.vae, nets["port_lpips"](), state.disc, grads_only=True)
    tg, td, tm = step(state, torch.from_numpy(video), JaxDraws(key))
    _assert_metrics(tm, jm)
    assert tm["vae/d_weight"] > 0
    ref_vae = vae_state_dict_from_jax(_np({"params": jg["vae"]}))
    ref_disc = discriminator_state_dict_from_jax(_np({"params": jd}))
    assert tg["vae"].keys() == ref_vae.keys() and td.keys() == ref_disc.keys()
    for got, ref in ((tg["vae"], ref_vae), (td, ref_disc)):
        for name, g in got.items():
            assert g.abs().max() > 0, name
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=name)
    np.testing.assert_allclose(tg["logvar"].item(), float(jg["logvar"]),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert state.step == 0


def test_adaptive_loss_weight_matches_jax():
    jw, tw = jtrainer.AdaptiveLossWeight(), vae_trainer.AdaptiveLossWeight()
    rng = np.random.default_rng(4)
    for _ in range(3):
        t = rng.uniform(0, 1, 6).astype(np.float32)
        loss = rng.uniform(0.1, 5, 6).astype(np.float32)
        np.testing.assert_allclose(tw.weight(torch.from_numpy(t)).numpy(),
                                   np.asarray(jw.weight(jnp.asarray(t))),
                                   rtol=1e-6)
        jw.update(jnp.asarray(t), jnp.asarray(loss))
        tw.update(torch.from_numpy(t), torch.from_numpy(loss))
    np.testing.assert_allclose(tw.bucket_losses.numpy(),
                               np.asarray(jw.bucket_losses), rtol=1e-6)


# ------------------------------------------------------------ conv routing
def test_convs_are_admitted_by_their_compute_dtype():
    """The release VAE with fp32 weights (on the meta device: no memory):
    none of its convs computes in bf16 as it stands, and under a bf16
    compute dtype (CUDA autocast) the 20 + 34 admitted convs take the
    kernel route, as a bf16 VAE's do."""
    vae = model.CausalVideoVAE(device="meta")
    assert model.kernel_conv_count(vae) == 0
    assert model.kernel_conv_count(vae.encoder, torch.bfloat16) == 20
    assert model.kernel_conv_count(vae.decoder, torch.bfloat16) == 34
    assert model.kernel_conv_count(vae, torch.bfloat16) == 54
    assert model.kernel_conv_count(vae, torch.float16) == 0
    bf16 = model.CausalVideoVAE(dtype=torch.bfloat16, device="meta")
    assert model.kernel_conv_count(bf16) == 54
    conv = vae.decoder.up_blocks[0].resnets[0].conv1
    assert cc.compute_dtype(conv.conv.weight) == torch.float32
    assert conv.admits(torch.bfloat16) and not conv.uses_kernel
    assert not vae.decoder.conv_out.admits(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_convs_take_the_plain_version(monkeypatch, dtype):
    """On the CPU an admitted bf16 conv runs the plain version (never the
    kernel's wrapper) and an fp32 one ``F.conv3d``, as before."""
    def refuse(*args):
        raise AssertionError("the kernel route on a CPU tensor")

    monkeypatch.setattr(cc.CausalConv3dFunction, "apply", refuse)
    gen = torch.Generator().manual_seed(0)
    conv = layers.CausalConv3d(64, 128, (3, 3, 3), dtype=dtype)
    with torch.no_grad():
        conv.conv.weight.normal_(0, 0.05, generator=gen)
    conv.to(memory_format=torch.channels_last_3d)
    assert cc.compute_dtype(conv.conv.weight) == dtype
    assert conv.uses_kernel == (dtype == torch.bfloat16)
    x = torch.randn((1, 64, 3, 6, 5), generator=gen).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        y = conv(x)
        ref = cc.causal_conv3d_reference(
            x.permute(0, 2, 3, 4, 1).float(), conv.conv.weight.float(),
            conv.conv.bias.float()).permute(0, 4, 1, 2, 3)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), ref, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------- CLI
def _write_videos(tmp_path, n=2, frames=12):
    import cv2
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        path = str(tmp_path / f"clip{i}.avi")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24,
                              (40, 36))
        for _ in range(frames):
            out.write(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8))
        out.release()
        lines.append(json.dumps({"video": path}))
    anno = tmp_path / "videos.jsonl"
    anno.write_text("\n".join(lines) + "\n")
    return str(anno)


def _run_cli(out, anno, *extra):
    return cli.main(["--video_anno", anno, "--debug_tiny",
                     "--resolution", "32", "--num_frames", "9",
                     "--steps_per_epoch", "2", "--disc_start", "1",
                     "--output_dir", str(out), "--print_freq", "1", *extra])


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """2 steps from an annotation file write checkpoint-2; a second run
    resumes there and takes steps 3-4, the discriminator on from step 1."""
    anno = _write_videos(tmp_path)
    out = tmp_path / "run"
    assert _run_cli(out, anno, "--epochs", "1") == 0
    assert sorted(os.listdir(out)) == ["checkpoint-2.pt", "log.txt"]
    ckpt = torch.load(out / "checkpoint-2.pt", weights_only=True)
    assert ckpt["step"] == 2
    assert "decoder.conv_out.conv.weight" in ckpt["vae"]
    assert "conv_out.weight" in ckpt["disc"]
    assert _run_cli(out, anno, "--epochs", "2") == 0
    resumed = torch.load(out / "checkpoint-4.pt", weights_only=True)
    assert resumed["step"] == 4
    assert not torch.equal(resumed["vae"]["decoder.conv_out.conv.weight"],
                           ckpt["vae"]["decoder.conv_out.conv.weight"])
    assert not torch.equal(resumed["disc"]["conv_out.weight"],
                           ckpt["disc"]["conv_out.weight"])
    log = (out / "log.txt").read_text()
    assert "d_weight" in log


@pytest.mark.parametrize("flags", [["--cp", "2"], ["--dp", "2"]],
                         ids=["cp", "dp"])
def test_cli_names_the_roadmap_item_of_unported_flags(tmp_path, flags):
    with pytest.raises(SystemExit) as exc:
        _run_cli(tmp_path / "run", "unused.jsonl", *flags)
    assert "A11" in str(exc.value)
