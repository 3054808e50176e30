"""Port parity: the rest of the JAX package's surface, on the CPU.

* the guidance-embedded miniFLUX (``FluxConfig.guidance_embeds``): a tiny
  DiT's forward vs JAX's at two guidance scales (fp32, rtol/atol 1e-4 on
  the valid rows), the converter's ``guidance_embedder`` keys, and the
  error without ``guidance``; the pipeline refuses such a DiT;
* ``DDPMCosineScheduler`` vs JAX's (``alpha_cumprod`` over scalers,
  ``timesteps``, ``add_noise``, ``step`` with JAX's draw replayed; fp32,
  atol 1e-6) and ``get_scheduler``;
* ``resize_bilinear`` and ``downsample_pyramid`` vs JAX's (atol 1e-6);
* ``utils.profiling`` on the CPU;
* each new tool exits 1 without a card;
* configs built from ``config.json``: the guidance DiT, and the VAE's
  down-sample flags and block types (equal to JAX's reading), and the
  release-layout VAE loader's refusal of 2D twins, naming the keys.
"""

import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.flux import model as jflux
from pyramid_flow_tpu.ops import resample as jresample
from pyramid_flow_tpu.schedulers import cosine_ddpm as jddpm
from pyramid_flow_tpu.utils import checkpoint as jcheckpoint
from pyramid_flow_tpu_torch.models.flux import model as flux
from pyramid_flow_tpu_torch.models.vae.model import CausalVideoVAE
from pyramid_flow_tpu_torch.ops import resample
from pyramid_flow_tpu_torch.ops.flash_attention import INVALID_TIME
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.schedulers import (
    SCHEDULER_REGISTRY, DDPMCosineScheduler,
    PyramidFlowMatchEulerDiscreteScheduler, get_scheduler)
from pyramid_flow_tpu_torch.tools import (exp_conv_stack, exp_decode_scan,
                                          exp_vae_tiling, profile_768p)
from pyramid_flow_tpu_torch.utils import checkpoint, profiling
from pyramid_flow_tpu_torch.utils.converters import flux_state_dict_from_jax

FLUX = dict(in_channels=16, num_layers=1, num_single_layers=2,
            attention_head_dim=8, num_attention_heads=2,
            joint_attention_dim=32, pooled_projection_dim=24,
            axes_dims_rope=(4, 2, 2), guidance_embeds=True)


def _flux_inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    lt, lc, pad, lx = 6, 12, 5, 16
    l = lc + pad + lx
    time = np.concatenate([np.repeat([0, 1], lc // 2),
                           np.full(pad, INVALID_TIME), np.full(lx, 2)])
    mask = np.ones((b, lt), bool)
    mask[:, -2:] = False
    return (rng.standard_normal((b, l, 16)).astype(np.float32),
            (np.abs(rng.standard_normal((b, l, 3))) * 4).astype(np.float32),
            np.broadcast_to(time.astype(np.int32), (b, l)).copy(),
            rng.standard_normal((b, lt, 32)).astype(np.float32), mask,
            rng.standard_normal((b, 24)).astype(np.float32),
            np.array([900.0, 311.5][:b], np.float32))


def _jax_vae_config(directory) -> dict:
    """JAX's reading of a VAE ``config.json`` (lists as tuples)."""
    want = jcheckpoint.load_model_config(str(directory), "vae")
    return {f.name: (tuple(v) if isinstance(v, list) else v)
            for f in dataclasses.fields(want)
            for v in [getattr(want, f.name)]}


@pytest.fixture(scope="module")
def guidance_dits():
    jdit = jflux.PyramidFluxTransformer(config=jflux.FluxConfig(**FLUX),
                                        dtype=jnp.float32)
    inputs = _flux_inputs()
    params = jax.eval_shape(jdit.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, inputs),
                            guidance=jnp.full((2,), 7.0))
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree.flatten(params)
    params = jax.tree.unflatten(treedef, [
        (0.05 * rng.standard_normal(p.shape)).astype(np.float32)
        for p in leaves])
    tdit = flux.PyramidFluxTransformer(flux.FluxConfig(**FLUX), device="cpu")
    sd = flux_state_dict_from_jax(jax.tree.map(np.asarray, params))
    assert "time_text_embed.guidance_embedder.linear_2.weight" in sd
    tdit.load_state_dict(sd, strict=True)
    return jdit, params, tdit, inputs


def test_guidance_dit_matches_jax(guidance_dits):
    jdit, params, tdit, inputs = guidance_dits
    apply = jax.jit(lambda p, g, *a: jdit.apply(p, *a, guidance=g))
    valid = inputs[2][0] != INVALID_TIME
    outs = []
    for g in (np.array([3.0, 9.0], np.float32),
              np.array([7.0, 7.0], np.float32)):
        want = np.asarray(apply(params, jnp.asarray(g),
                                *map(jnp.asarray, inputs)))
        with torch.no_grad():
            got = tdit(*map(torch.from_numpy, inputs),
                       guidance=torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got[:, valid], want[:, valid], rtol=1e-4,
                                   atol=1e-4)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-4  # guidance is read


def test_guidance_dit_raises_without_guidance(guidance_dits):
    _, _, tdit, inputs = guidance_dits
    with pytest.raises(ValueError, match="guidance"):
        tdit(*map(torch.from_numpy, inputs))
    with pytest.raises(ValueError, match="guidance_embeds"):
        PyramidFlowPipeline(tdit, device="cpu")


def test_guidance_dit_and_vae_flags_build_from_config_json(tmp_path,
                                                           guidance_dits):
    _, _, tdit, _ = guidance_dits
    variant = tmp_path / "diffusion_transformer_384p"
    variant.mkdir()
    (variant / "config.json").write_text(json.dumps(
        dict(FLUX, axes_dims_rope=list(FLUX["axes_dims_rope"]))))
    dit = checkpoint.build_dit(str(tmp_path), variant.name, "pyramid_flux",
                               tdit.state_dict(), dtype=torch.float32,
                               device="cpu")
    assert dit.config.guidance_embeds and dit.config == tdit.config
    # the encoder's down-sample flags: no temporal downsampling in block 1
    vae_cfg = dict(latent_channels=4, block_out_channels=[8, 8, 16, 16],
                   layers_per_block=[1, 1, 1, 1],
                   decoder_layers_per_block=[1, 1, 1, 1], num_groups=4,
                   spatial_down_sample=[True, True, True, False],
                   temporal_down_sample=[True, False, True, False])
    vae_dir = tmp_path / "causal_video_vae"
    vae_dir.mkdir()
    (vae_dir / "config.json").write_text(json.dumps(vae_cfg))
    got = checkpoint.load_model_config(str(vae_dir), "vae")
    assert dataclasses.asdict(got) == _jax_vae_config(vae_dir)
    src = CausalVideoVAE(got, device="cpu")
    vae = checkpoint.build_vae(str(tmp_path), src.state_dict(),
                               dtype=torch.float32, device="cpu")
    assert [len(b.temporal_downsamplers) for b in vae.encoder.down_blocks] \
        == [1, 0, 1, 0]
    x = torch.zeros((1, 5, 16, 16, 3))
    with torch.no_grad():
        assert vae.encode(x).shape == (1, 2, 2, 2, 8)  # 5 -> 3 -> 3 -> 2


def test_release_vae_loader_refuses_2d_twins_by_key(tmp_path):
    cfg = dict(latent_channels=4, block_out_channels=[8, 8, 16, 16],
               layers_per_block=[1, 1, 1, 1],
               decoder_layers_per_block=[1, 1, 1, 1], num_groups=4,
               down_block_types=["DownEncoderBlock2D"] * 4,
               up_block_types=["UpDecoderBlockCausal3D"] * 4,
               mid_block_type="UNetMidBlock2D")
    vae_dir = tmp_path / "causal_video_vae"
    vae_dir.mkdir()
    (vae_dir / "config.json").write_text(json.dumps(cfg))
    got = checkpoint.load_model_config(str(vae_dir), "vae")
    assert dataclasses.asdict(got) == _jax_vae_config(vae_dir)
    sd = CausalVideoVAE(got, device="cpu").state_dict()
    with pytest.raises(ValueError, match=r"encoder\.down_blocks\.0\."
                                         r"resnets\.0\.conv1\.weight"):
        checkpoint.build_vae(str(tmp_path), sd, dtype=torch.float32,
                             device="cpu")


@pytest.mark.parametrize("scaler", [0.5, 1.0, 2.0])
def test_cosine_ddpm_matches_jax(scaler):
    j = jddpm.DDPMCosineScheduler(scaler=scaler)
    p = get_scheduler("ddpm_cosine", scaler=scaler)
    assert p == DDPMCosineScheduler(scaler=scaler)
    t = np.linspace(0, 1, 11).astype(np.float32)
    np.testing.assert_allclose(p.alpha_cumprod(torch.from_numpy(t)).numpy(),
                               np.asarray(j.alpha_cumprod(t)), atol=1e-6)
    np.testing.assert_array_equal(p.timesteps(6), j.timesteps(6))
    rng = np.random.default_rng(int(scaler * 10))
    x = rng.standard_normal((3, 2, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((3, 2, 4, 4)).astype(np.float32)
    tt = np.array([0.9, 0.5, 0.2], np.float32)
    tp = np.array([0.7, 0.3, 0.0], np.float32)  # the last row's final step
    np.testing.assert_allclose(
        p.add_noise(torch.from_numpy(x), torch.from_numpy(eps), tt).numpy(),
        np.asarray(j.add_noise(x, eps, tt)), atol=1e-6)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j.step(eps, tt, tp, x, key))
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = p.step(torch.from_numpy(eps), tt, tp, torch.from_numpy(x),
                 noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # a generator draws the noise; t_prev = 0 adds none
    g = torch.Generator().manual_seed(0)
    a = p.step(torch.from_numpy(eps), tt, tp, torch.from_numpy(x), noise=g)
    np.testing.assert_allclose(a[2].numpy(), want[2], atol=1e-5, rtol=1e-5)


def test_scheduler_registry():
    assert set(SCHEDULER_REGISTRY) == {"pyramid_flow_match", "ddpm_cosine"}
    assert isinstance(get_scheduler("pyramid_flow_match"),
                      PyramidFlowMatchEulerDiscreteScheduler)
    with pytest.raises(KeyError, match="unknown scheduler"):
        get_scheduler("ddim")


@pytest.mark.parametrize("size", [(6, 10), (12, 20), (5, 7), (24, 40),
                                  (9, 31)])
def test_resize_bilinear_matches_jax(size):
    x = np.random.default_rng(5).standard_normal(
        (2, 3, 12, 20)).astype(np.float32)
    want = np.asarray(jresample.resize_bilinear(jnp.asarray(x), *size))
    got = resample.resize_bilinear(torch.from_numpy(x), *size).numpy()
    assert got.shape == want.shape == (2, 3) + size
    np.testing.assert_allclose(got, want, atol=1e-6)
    # and torch's own bilinear resize without antialiasing
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=size, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("noise_scale", [False, True])
def test_downsample_pyramid_matches_jax(noise_scale):
    x = np.random.default_rng(6).standard_normal(
        (1, 2, 16, 24, 4)).astype(np.float32)
    want = jresample.downsample_pyramid(jnp.asarray(x), 2, noise_scale)
    got = resample.downsample_pyramid(torch.from_numpy(x), 2, noise_scale)
    assert [g.shape[2] for g in got] == [4, 8, 16]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_profiling_on_the_cpu(tmp_path):
    calls = iter(range(0, 100, 5))
    counters = {"ticks": lambda: next(calls)}
    with profiling.recording() as rec:
        for _ in range(2):
            with profiling.span("outer", trace_id=7, counters=counters,
                                phase="denoise") as outer:
                with profiling.span("inner"):
                    torch.ones(4) * 2
                outer.set(done=True)
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass
    spans = rec.spans()
    assert [(s.name, s.parent, s.trace_id) for s in spans] == [
        ("outer", None, 7), ("inner", 0, 7), ("outer", None, 7),
        ("inner", 2, 7)]
    assert spans[0].attrs == {"phase": "denoise", "done": True, "ticks": 5}
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns <= spans[1].end_ns \
        <= spans[0].end_ns <= spans[2].start_ns
    assert profiling.span("outer") is profiling.span("inner")  # off again
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("matmul_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and "matmul_span" in files[0].read_text()
    assert profiling.allocator_calls() == 0


def test_tools_exit_without_a_card(capsys):
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        for tool, name in ((profile_768p, "profile_768p"),
                           (exp_vae_tiling, "exp_vae_tiling"),
                           (exp_conv_stack, "exp_conv_stack"),
                           (exp_decode_scan, "exp_decode_scan")):
            assert tool.main([]) == 1
            assert f"{name}: no CUDA device" in capsys.readouterr().err


def test_offload_is_a_no_op():
    pipe = PyramidFlowPipeline(None, device="cpu")
    assert pipe.enable_sequential_cpu_offload() is pipe
