"""Port parity for the MMDiT's paths, JAX vs torch, on the CPU: T2V
``generate``, I2V ``generate_i2v``, the train step, the overshoot probe and
the training CLI.

The tiny MMDiT of test_torch_port_mmdit.py (JAX weights redrawn from a numpy
seed, carried over by ``mmdit_state_dict_from_jax``). ``generate`` replays
JAX's draws through ``JaxNoise`` (test_torch_port_pipeline.py), the train
step and the probe through ``JaxDraws`` (test_torch_port_training.py). The
port keeps the sincos table as a buffer where JAX trains it (ROADMAP C2):
the train step is held to JAX's on every other parameter. The
JAX pipeline is given the tiny table's size (``pos_embed_max_size=24``); the
port reads it from the DiT's config.

Tolerances (fp32): latents atol 5e-4, T2V and I2V (the flux ``generate``
test's bound: about 30 DiT forwards summed in another order, fed back
through the AR history); the train step's loss rtol 1e-5 and grad norm
rtol 1e-4 (the flux train-step test's; JAX's norm less the table's
gradient); parameters after a step within ``adamw_close``; the probe atol
1e-3 log2 units (the flux probe test's).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline as JPipeline)
from pyramid_flow_tpu.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as JScheduler)
from pyramid_flow_tpu.training import train_state as jts
from pyramid_flow_tpu.training import trainer as jtrainer
from pyramid_flow_tpu.training.telemetry import (
    make_bound_overshoot_probe as jmake_probe,
    mmdit_pos_offset_fn as jmmdit_pos_offset_fn)
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.pipeline.noising import LATENT_NORMS
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.telemetry import (
    make_bound_overshoot_probe, mmdit_pos_offset_fn)
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import make_train_step
from test_torch_port_dit_loss import BATCH_KEYS, UNITS, tiny_batch
from test_torch_port_mmdit import TINY, tiny_mmdits
from test_torch_port_pipeline import JaxNoise
from pyramid_flow_tpu_torch.utils.converters import mmdit_state_dict_from_jax
from test_torch_port_training import JaxDraws, _run_cli, adamw_close

SEED = 13
GEN = dict(height=64, width=64, temp=3, num_inference_steps=[2, 2, 2],
           video_num_inference_steps=[1, 1, 1])


@pytest.fixture(scope="module")
def mmdits():
    return tiny_mmdits()


def _text():
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), bool)
    mask[:, 6:] = False
    pooled = rng.standard_normal((1, 24)).astype(np.float32)
    return emb, mask, pooled


def test_generate_latents_match_jax(mmdits):
    dit_j, params, make_port = mmdits
    jpipe = JPipeline(dit_j, params, model_name="pyramid_mmdit",
                      latent_channels=4, dtype=jnp.float32,
                      pos_embed_max_size=TINY["pos_embed_max_size"])
    emb, mask, pooled = _text()
    want = np.asarray(jpipe.generate(
        jax.random.PRNGKey(SEED), *map(jnp.asarray, (emb, mask, pooled)),
        jnp.asarray(emb) * 0, jnp.asarray(mask), jnp.asarray(pooled) * 0,
        output_type="latent", **GEN))
    tpipe = PyramidFlowPipeline(make_port(), latent_channels=4,
                                dtype=torch.float32,
                                model_name="pyramid_mmdit")
    emb, mask, pooled = map(torch.from_numpy, _text())
    got = tpipe.generate(None, emb, mask, pooled, emb * 0, mask, pooled * 0,
                         noise=JaxNoise(SEED), output_type="latent", **GEN)
    assert got.shape == want.shape == (1, 3, 8, 8, 4)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_generate_i2v_latents_match_jax(mmdits):
    """Image-to-video from the same raw image latent, the port replaying
    JAX's key splits from unit 1 on; unit 0 is the image normalised by the
    MMDiT's own latent norms."""
    dit_j, params, make_port = mmdits
    jpipe = JPipeline(dit_j, params, model_name="pyramid_mmdit",
                      latent_channels=4, dtype=jnp.float32,
                      pos_embed_max_size=TINY["pos_embed_max_size"])
    img = np.random.default_rng(3).standard_normal(
        (1, 1, 8, 8, 4)).astype(np.float32)
    emb, mask, pooled = _text()
    want = np.asarray(jpipe.generate_i2v(
        jax.random.PRNGKey(SEED), jnp.asarray(img), *map(jnp.asarray, (
            emb, mask, pooled, emb * 0, mask, pooled * 0)),
        output_type="latent", **GEN))
    tpipe = PyramidFlowPipeline(make_port(), latent_channels=4,
                                dtype=torch.float32,
                                model_name="pyramid_mmdit")
    got = tpipe.generate_i2v(
        None, torch.from_numpy(img), *map(torch.from_numpy, (
            emb, mask, pooled, emb * 0, mask, pooled * 0)),
        noise=JaxNoise(SEED, first_unit=1), output_type="latent", **GEN)
    assert got.shape == want.shape == (1, 3, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)
    shift, scale = LATENT_NORMS["pyramid_mmdit"]
    np.testing.assert_allclose(got[:, :1].numpy(), (img - shift) * scale,
                               rtol=1e-6)
    np.testing.assert_allclose(got[:, :1].numpy(), (img - 0.1490) / 1.8415,
                               rtol=1e-6)


def _tiny_flux():
    return PyramidFluxTransformer(FluxConfig(
        in_channels=16, num_layers=1, num_single_layers=1,
        attention_head_dim=8, num_attention_heads=2, axes_dims_rope=(4, 2, 2)),
        device="cpu")


def test_model_name_selects_norms_and_must_match_the_dit(mmdits):
    """The DiT's class names its family; the pipeline takes the family's
    latent norms from it, and a ``model_name`` given as well must match."""
    _, _, make_port = mmdits
    mmdit = make_port()
    for pipe in (PyramidFlowPipeline(mmdit, model_name="pyramid_mmdit"),
                 PyramidFlowPipeline(mmdit)):
        assert pipe.model_name == "pyramid_mmdit"
        assert (pipe.vae_shift_factor, pipe.vae_scale_factor) == \
            LATENT_NORMS["pyramid_mmdit"]
        x = torch.ones((1, 1, 2, 2, 4))
        torch.testing.assert_close(pipe.normalize_latent(x),
                                   (x - 0.1490) / 1.8415)
    flux = _tiny_flux()
    assert PyramidFlowPipeline(flux).model_name == "pyramid_flux"
    with pytest.raises(ValueError, match="PyramidFluxTransformer"):
        PyramidFlowPipeline(flux, model_name="pyramid_mmdit")
    with pytest.raises(ValueError, match="PyramidDiffusionMMDiT"):
        PyramidFlowPipeline(mmdit, model_name="pyramid_flux")
    with pytest.raises(ValueError, match="unknown model_name"):
        PyramidFlowPipeline(mmdit, model_name="pyramid_sd3")


def test_make_train_step_refuses_another_family(mmdits):
    """``make_train_step`` normalises raw pixels for the DiT's own family
    and refuses a ``model_name`` that names the other one."""
    _, _, make_port = mmdits
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    with pytest.raises(ValueError, match="PyramidDiffusionMMDiT"):
        make_train_step(make_port(), sched, model_name="pyramid_flux")
    with pytest.raises(ValueError, match="PyramidFluxTransformer"):
        make_train_step(_tiny_flux(), sched, model_name="pyramid_mmdit")


def test_dits_state_their_latent_width_and_stage_inputs(mmdits):
    """Each DiT class gives its latent width and the extra forward inputs
    of a stage: none for flux, the MMDiT's table crop origin (JAX's rule,
    ``(G - h // 2) // 2``) for the MMDiT."""
    _, _, make_port = mmdits
    mmdit, flux = make_port(), _tiny_flux()
    assert (mmdit.latent_channels, flux.latent_channels) == (4, 4)
    assert flux.stage_inputs(3, 8, 12, "cpu") == ()
    (origin,) = mmdit.stage_inputs(3, 8, 12, "cpu")
    g = TINY["pos_embed_max_size"]
    want = torch.tensor([[(g - 4) // 2, (g - 6) // 2]] * 3,
                        dtype=torch.float32)
    torch.testing.assert_close(origin, want, rtol=0, atol=0)


TABLE = "pos_embed.pos_embed"


def _jax_step(dit_j, params, batch, key, config, **step_kw):
    """One JAX train step: (state after it, metrics, the parameters, Adam's
    mu and nu and the pre-clip gradient norm without the sincos table, all
    keyed like the port). JAX's table is a parameter; its raw gradient is
    read back from the first step's mu = (1 - b1) * clipped gradient.
    ``step_kw`` go to JAX's ``make_train_step``."""
    jstate = jts.create_train_state(params, config)
    jstep = jtrainer.make_train_step(dit_j, JScheduler(), donate=False,
                                     model_name="pyramid_mmdit", **step_kw)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       key, num_units_per_stage=UNITS)
    adam = jstate.opt_state[1][0]
    tree = lambda t: mmdit_state_dict_from_jax(  # noqa: E731
        jax.tree.map(np.array, t))
    mu, nu = tree(adam.mu), tree(adam.nu)
    norm = float(jm["train/grad_norm"])
    g_table = mu[TABLE].double() / (1 - config.beta1) * max(
        1.0, norm / config.max_grad_norm)
    norm_wo_table = math.sqrt(norm ** 2 - g_table.square().sum().item())
    return jstate, jm, tree(jstate.params), mu, nu, norm_wo_table


def test_train_step_loss_matches_jax(mmdits):
    """The loss, and the pre-clip gradient norm without the sincos table,
    which the port keeps as a buffer (ROADMAP C2)."""
    dit_j, params, make_port = mmdits
    batch = tiny_batch()
    key = jax.random.PRNGKey(9)
    _, jm, _, _, _, norm = _jax_step(dit_j, params, batch, key,
                                     jts.TrainConfig())
    dit_t = make_port()
    step = make_train_step(dit_t, PyramidFlowMatchEulerDiscreteScheduler(),
                           model_name="pyramid_mmdit")
    state, m = step(create_train_state(dit_t),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    JaxDraws(key), UNITS)
    np.testing.assert_allclose(m["train/loss"], float(jm["train/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["train/grad_norm"], norm, rtol=1e-4)
    assert m["train/grad_norm"] < float(jm["train/grad_norm"])
    assert m["train/applied"] and state.step == 1


def test_train_step_matches_jax_but_the_sincos_table(mmdits):
    """ROADMAP C2, the port's deliberate divergence: one step at a clip
    that does not bind, so each parameter's AdamW step is its own. Every
    parameter of the port is within ``adamw_close`` of JAX's after it; the
    port's table, a buffer, has not moved, where JAX's (a parameter, with
    its gradient and weight decay) has."""
    dit_j, params, make_port = mmdits
    batch = tiny_batch()
    key = jax.random.PRNGKey(9)
    lr = 1e-3
    _, jm, ref, _, nu, norm = _jax_step(
        dit_j, params, batch, key,
        jts.TrainConfig(learning_rate=lr, max_grad_norm=1e9))
    dit_t = make_port()
    table = dit_t.pos_embed.pos_embed.clone()
    step = make_train_step(dit_t, PyramidFlowMatchEulerDiscreteScheduler(),
                           model_name="pyramid_mmdit")
    state, m = step(create_train_state(dit_t, TrainConfig(
                        learning_rate=lr, max_grad_norm=1e9)),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    JaxDraws(key), UNITS)
    assert m["train/applied"] and norm < 1e9
    np.testing.assert_allclose(m["train/grad_norm"], norm, rtol=1e-4)
    names = dict(dit_t.named_parameters())
    assert TABLE not in names and TABLE in dit_t.state_dict()
    assert set(ref) - set(names) == {TABLE}
    for name, p in names.items():
        adamw_close(p.detach().numpy(), ref[name].numpy(), nu[name].numpy(),
                    lr, 1)
    torch.testing.assert_close(dit_t.pos_embed.pos_embed, table, rtol=0,
                               atol=0)
    assert (ref[TABLE] - table).abs().max() > 0.1 * lr


def test_overshoot_probe_matches_jax(mmdits):
    dit_j, params, make_port = mmdits
    batch = tiny_batch()
    key = jax.random.PRNGKey(11)
    g = TINY["pos_embed_max_size"]
    ref = float(jmake_probe(dit_j, JScheduler(),
                            pos_offset_fn=jmmdit_pos_offset_fn(g))(
        params, *(jnp.asarray(batch[k]) for k in BATCH_KEYS), key))
    probe = make_bound_overshoot_probe(
        make_port(), PyramidFlowMatchEulerDiscreteScheduler(),
        pos_offset_fn=mmdit_pos_offset_fn(g))
    got = probe(*(torch.from_numpy(batch[k]) for k in BATCH_KEYS),
                JaxDraws(key))
    assert 0 < ref < 100
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_cli_trains_the_mmdit_and_resumes(tmp_path):
    """``--model_name pyramid_mmdit --debug_tiny``: 2 steps write
    checkpoint-2; a second run resumes there and its steps 3-4 equal those
    of an uninterrupted 4-step run."""
    a, b = tmp_path / "a", tmp_path / "b"
    flags = ("--model_name", "pyramid_mmdit", "--batch_size", "4")
    assert _run_cli(a, *flags, "--epochs", "1", "--bound_probe_freq", "1") == 0
    ckpt = torch.load(a / "checkpoint-2.pt", weights_only=True)
    ema = torch.load(a / "checkpoint-2-ema.pt", weights_only=True)
    assert ckpt["step"] == 2
    assert ema["pos_embed.pos_embed"].shape == (1, 192 * 192, 128)
    assert "transformer_blocks.1.attn.norm_add_k.weight" in ema
    assert "transformer_blocks.1.attn.to_add_out.weight" not in ema
    assert _run_cli(a, *flags, "--epochs", "2",
                    "--bound_probe_freq", "0") == 0
    assert _run_cli(b, *flags, "--epochs", "2",
                    "--bound_probe_freq", "0") == 0
    resumed = torch.load(a / "checkpoint-4.pt", weights_only=True)
    straight = torch.load(b / "checkpoint-4.pt", weights_only=True)
    assert resumed["step"] == straight["step"] == 4
    for name, t in straight["params"].items():
        torch.testing.assert_close(resumed["params"][name], t, rtol=0, atol=0)
    assert not torch.equal(straight["params"]["pos_embed.proj.weight"],
                           ckpt["params"]["pos_embed.proj.weight"])
    assert sorted(os.listdir(b)) == [
        "checkpoint-2-ema.pt", "checkpoint-2.pt", "checkpoint-4-ema.pt",
        "checkpoint-4.pt", "log.txt"]
