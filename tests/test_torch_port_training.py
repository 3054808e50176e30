"""Port parity for the training slice's pieces, JAX vs torch, on the CPU:
scheduler lookups, packing, the AR-unit allocator, lr schedules, pyramid
noising, the train state against optax, and the training CLI.

Every random draw the port makes goes through a draw source; ``JaxDraws``
(tests/torch_port_training_utils.py) wraps a JAX key and splits it where the
JAX code splits its keys, so the port's noising sees JAX's own draws.
The DiT loss and train step are in test_torch_port_dit_loss.py and
test_torch_port_train_step.py.

Tolerances (fp32 on the CPU):
* tables, packing and draws: exact; the lr schedules rtol 1e-5 (JAX
  evaluates them in fp32, the port in Python floats);
* noising: atol 1e-6 (the same arithmetic on the same draws);
* the optimizer against optax: moments and EMA rtol 1e-5, counts exact;
  parameters as ``adamw_close`` says (m/sqrt(v) amplifies the rounding of
  small gradients).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.pipeline import noising as jnoising
from pyramid_flow_tpu.pipeline import packing as jpacking
from pyramid_flow_tpu.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler as JScheduler)
from pyramid_flow_tpu.training import lr_schedules as jlr
from pyramid_flow_tpu.training import train_state as jts
from pyramid_flow_tpu.training import trainer as jtrainer
from pyramid_flow_tpu_torch.pipeline import noising, packing
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.tools import train_pyramid_flow as cli
from pyramid_flow_tpu_torch.training import lr_schedules
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.training.trainer import stage_row_split

LR = 1e-3


GRAD_ATOL, GRAD_RTOL = 2e-6, 2e-3  # gradients vs JAX (DiT tests)


class JaxDraws:
    """A draw source over a JAX key: ``split``/``fold_in`` are JAX's, and
    ``normal``/``uniform`` are JAX's draws from the key, as CPU tensors."""

    def __init__(self, key):
        self.key = key

    def normal(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.key,
                                                           tuple(shape))))

    def uniform(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(self.key,
                                                            tuple(shape))))

    def split(self, n):
        return [JaxDraws(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data):
        return JaxDraws(jax.random.fold_in(self.key, data))


def adamw_close(port, ref, nu, lr, steps):
    """Parameters after ``steps`` AdamW steps against optax's. An update is
    lr * m/sqrt(v) per step, and m/sqrt(v) carries about twice the relative
    error of the gradient, which for a gradient of size |g| ~ sqrt(nu) is
    (GRAD_ATOL / |g| + GRAD_RTOL), capped at 2 (a sign flip). So each element
    may differ by 1e-6 + steps * lr * min(2, 2 * (GRAD_ATOL / sqrt(nu) +
    GRAD_RTOL)): tight where the gradient is well resolved, up to 2 * lr per
    step where it sits at rounding level."""
    port, ref = np.asarray(port), np.asarray(ref)
    g = np.sqrt(np.asarray(nu, np.float64))
    rel = np.minimum(2.0, 2 * (GRAD_ATOL / np.maximum(g, 1e-30) + GRAD_RTOL))
    allow = 1e-6 + steps * lr * rel
    err = np.abs(port - ref)
    assert (err <= allow).all(), (err.max(), err[err > allow][:5])


# ------------------------------------------------------------ tables, packing
def test_sample_stage_timesteps_match():
    js, ts = JScheduler(), PyramidFlowMatchEulerDiscreteScheduler()
    u = np.random.default_rng(0).random(64).astype(np.float32)
    u[:3] = [0.0, 0.9999999, 0.5]
    for stage in range(3):
        jt, jr = js.sample_stage_timesteps(jnp.asarray(u), stage)
        tt, tr = ts.sample_stage_timesteps(torch.from_numpy(u), stage)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_pack_clips_matches():
    rng = np.random.default_rng(1)
    clips = [rng.standard_normal(s).astype(np.float32) for s in
             ((2, 3, 4, 4, 4), (2, 1, 8, 8, 4), (2, 1, 16, 16, 4))]
    jt, jp, jtime, jn = jpacking.pack_clips([jnp.asarray(c) for c in clips])
    tt, tp, ttime, tn = packing.pack_clips([torch.from_numpy(c)
                                            for c in clips])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ttime, jtime)
    assert tn == jn == 64


def test_sample_stage_length_matches():
    for rank in (0, 3, 9):
        for step in range(7):
            for kw in ({}, dict(max_units=16), dict(max_temporal_length=5),
                       dict(frame_per_unit=2, max_units=4)):
                assert noising.sample_stage_length(rank, step, **kw) == \
                    jnoising.sample_stage_length(rank, step, **kw)
    # the trainer's release-shape rotation
    assert [noising.sample_stage_length(0, s, 3, 31, 1, 8, max_units=16)
            for s in range(3)] == [[16, 16, 1], [16, 16, 9], [15, 15, 16]]


def test_lr_schedules_match():
    for port, ref in (
            (lr_schedules.cosine_schedule(1e-3, 1e-6, 7, 3, 5, 1e-5),
             jlr.cosine_schedule(1e-3, 1e-6, 7, 3, 5, 1e-5)),
            (lr_schedules.constant_with_warmup(2e-4, 4, 1e-6),
             jlr.constant_with_warmup(2e-4, 4, 1e-6))):
        for step in range(30):
            np.testing.assert_allclose(port(step), float(ref(step)),
                                       rtol=1e-5, atol=0)


def test_stage_row_split():
    assert stage_row_split(8, (1, 2, 1)) == jtrainer.stage_row_split(
        8, (1, 2, 1)) == [(0, 2), (2, 4), (6, 2)]
    with pytest.raises(ValueError):
        stage_row_split(6, (1, 2, 1))


# ------------------------------------------------------------------ noising
def _latents(shape=(2, 6, 16, 16, 4), seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_stage_batch(port, ref):
    assert len(port.clips) == len(ref.clips)
    for a, b in zip(port.clips, ref.clips):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in ((port.timesteps, ref.timesteps), (port.ratios, ref.ratios),
                 (port.targets, ref.targets)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_noise_pyramid_and_endpoints_match():
    key = jax.random.PRNGKey(5)
    shape = (2, 3, 16, 16, 4)
    jn = jnoising.noise_pyramid(key, shape, 3)
    tn = noising.noise_pyramid(JaxDraws(key), shape, 3)
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    x = _latents(shape)
    jl = jnoising.latent_pyramid(jnp.asarray(x), 3)
    tl = noising.latent_pyramid(torch.from_numpy(x), 3)
    js, ts = JScheduler(), PyramidFlowMatchEulerDiscreteScheduler()
    for stage in range(3):
        for a, b in zip(noising.stage_endpoints(ts, stage, 3, tl, tn),
                        jnoising.stage_endpoints(js, stage, 3, jl, jn)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(
        noising.normalize_latent(torch.from_numpy(x)).numpy(),
        np.asarray(jnoising.normalize_latent(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_add_pyramid_noise_stage_matches(stage):
    key = jax.random.PRNGKey(10 + stage)
    x = _latents()
    ref = jnoising.add_pyramid_noise_stage(
        key, JScheduler(), jnoising.latent_pyramid(jnp.asarray(x), 3),
        stage, 3)
    port = noising.add_pyramid_noise_stage(
        JaxDraws(key), PyramidFlowMatchEulerDiscreteScheduler(),
        noising.latent_pyramid(torch.from_numpy(x), 3), stage, 3)
    _assert_stage_batch(port, ref)


@pytest.mark.parametrize("num_units", [1, 2, 5, 9])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_add_ar_noise_stage_matches(stage, num_units):
    """1 unit (no history), 2 (the corrupted last clip only), 5 (at stage 2:
    a stage-1 clip, then the stage-0 remainder; at stages 0 and 1 the
    remainder at once), 9 (clamped to the clip's 6 units)."""
    key = jax.random.PRNGKey(20 + stage)
    x = _latents()
    ref = jnoising.add_ar_noise_stage(
        key, JScheduler(), jnoising.latent_pyramid(jnp.asarray(x), 3),
        stage, 3, num_units, 1, 1 / 3)
    port = noising.add_ar_noise_stage(
        JaxDraws(key), PyramidFlowMatchEulerDiscreteScheduler(),
        noising.latent_pyramid(torch.from_numpy(x), 3), stage, 3, num_units,
        1, 1 / 3)
    _assert_stage_batch(port, ref)
    assert len(port.clips) == {1: 1, 2: 2}.get(num_units, 3 + (stage == 2))


def test_generator_draws_repeat_per_fold():
    a = noising.GeneratorDraws(torch.Generator().manual_seed(3))
    x1 = a.fold_in(7).normal((4,))
    a.normal((5,))  # the parent's own draws do not move a fold
    torch.testing.assert_close(a.fold_in(7).normal((4,)), x1, rtol=0, atol=0)
    assert not torch.equal(a.fold_in(8).normal((4,)), x1)


# -------------------------------------------------------------- train state
class _Tree(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            setattr(self, name, torch.nn.Parameter(torch.from_numpy(a.copy())))


def _adam_state(opt_state):
    return opt_state[1][0]  # chain(clip, adamw(scale_by_adam, ...))


def test_apply_gradients_matches_optax():
    """Three steps, the second anomalous (loss >= 2): parameters, Adam
    moments, the update count (which drives the schedule) and the EMA."""
    rng = np.random.default_rng(4)
    arrays = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "s": rng.standard_normal((2, 2, 3)).astype(np.float32)}
    grads = [{k: (scale * rng.standard_normal(a.shape)).astype(np.float32)
              for k, a in arrays.items()} for scale in (1.0, 0.3, 0.05)]
    losses = (0.5, 2.5, 0.7)  # clipped, anomalous, unclipped
    jcfg = jts.TrainConfig(
        learning_rate=LR, ema_decay=0.9,
        lr_schedule=jlr.cosine_schedule(LR, 1e-6, 5, 1, 1, 1e-4))
    jstate = jts.create_train_state(
        jax.tree.map(jnp.asarray, arrays), jcfg)
    model = _Tree(arrays)
    state = create_train_state(model, TrainConfig(
        learning_rate=LR, ema_decay=0.9,
        lr_schedule=lr_schedules.cosine_schedule(LR, 1e-6, 5, 1, 1, 1e-4)))
    applied = []
    for g, loss in zip(grads, losses):
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, g),
                                        jnp.float32(loss))
        applied.append(state.apply_gradients(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, loss))
    assert applied == [True, False, True]
    adam = _adam_state(jstate.opt_state)
    assert int(jstate.step) == state.step == 3
    assert int(adam.count) == state.opt_count == 2
    for name, p in model.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == 2
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(adam.mu[name]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[name]),
                                   rtol=1e-5, atol=1e-7)
        adamw_close(p.detach().numpy(), jstate.params[name],
                    adam.nu[name], LR, 2)
        np.testing.assert_allclose(state.ema[name].numpy(),
                                   np.asarray(jstate.ema_params[name]),
                                   rtol=1e-5, atol=1e-6)


def test_anomalous_loss_leaves_state_alone():
    model = _Tree({"w": np.ones((2, 2), np.float32)})
    state = create_train_state(model, TrainConfig(ema_interval=2))
    for loss in (float("nan"), float("inf"), 2.0):
        assert not state.apply_gradients([torch.ones(2, 2)], loss)
    assert state.step == 3 and state.opt_count == 0
    assert not state.optimizer.state
    torch.testing.assert_close(model.w.detach(), torch.ones(2, 2))


# ---------------------------------------------------------------------- CLI
def _run_cli(tmp, *extra):
    return cli.main(["--debug_tiny", "--steps_per_epoch", "2",
                     "--output_dir", str(tmp), "--print_freq", "1",
                     *extra])


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """2 steps write checkpoint-2; a second run resumes there and its steps
    3-4 equal those of an uninterrupted 4-step run."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert _run_cli(a, "--epochs", "1", "--bound_probe_freq", "1") == 0
    assert sorted(os.listdir(a)) == ["checkpoint-2-ema.pt", "checkpoint-2.pt",
                                     "log.txt"]
    ckpt = torch.load(a / "checkpoint-2.pt", weights_only=True)
    assert ckpt["step"] == 2
    ema = torch.load(a / "checkpoint-2-ema.pt", weights_only=True)
    assert "transformer_blocks.0.attn.to_q.weight" in ema
    assert _run_cli(a, "--epochs", "2") == 0
    assert _run_cli(b, "--epochs", "2") == 0
    resumed = torch.load(a / "checkpoint-4.pt", weights_only=True)
    straight = torch.load(b / "checkpoint-4.pt", weights_only=True)
    assert resumed["step"] == straight["step"] == 4
    for name, t in straight["params"].items():
        torch.testing.assert_close(resumed["params"][name], t, rtol=0,
                                   atol=0)
    assert not torch.equal(straight["params"]["x_embedder.weight"],
                           ckpt["params"]["x_embedder.weight"])


def test_cli_trains_from_an_annotation_file(tmp_path):
    """``--anno_file``: pre-extracted latents ([C, T, H, W] .npy) and text
    features (.npz) through the port's numpy data loaders."""
    import json
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        lat, fea = tmp_path / f"lat{i}.npy", tmp_path / f"fea{i}.npz"
        np.save(lat, rng.standard_normal((16, 3, 16, 16)).astype(np.float32))
        np.savez(fea, prompt_embed=rng.standard_normal((8, 64)).astype(
                     np.float32),
                 prompt_attention_mask=np.arange(8) < 6,
                 pooled_prompt_embed=rng.standard_normal(32).astype(
                     np.float32))
        lines.append(json.dumps({"latent": str(lat), "text_fea": str(fea)}))
    anno = tmp_path / "anno.jsonl"
    anno.write_text("\n".join(lines) + "\n")
    out = tmp_path / "run"
    assert _run_cli(out, "--epochs", "1", "--steps_per_epoch", "1",
                    "--anno_file", str(anno), "--bound_probe_freq", "0") == 0
    assert torch.load(out / "checkpoint-1.pt", weights_only=True)["step"] == 1


@pytest.mark.parametrize("flags,item", [
    (["--model_path", "x"], "A8"), (["--load_vae"], "A8"),
    (["--load_text_encoder"], "A8"),
    (["--sp", "2"], "A11"), (["--fsdp", "2"], "A11"), (["--dp", "2"], "A11")])
def test_cli_names_the_roadmap_item_of_unported_flags(tmp_path, flags, item):
    """The A8 and A11 flags are ported and no longer name their ROADMAP
    item. Without a checkpoint the A8 flags exit asking for one
    (test_torch_port_checkpoint.py trains from one); outside torchrun the
    A11 flags exit asking for it (test_torch_port_parallel_cli.py trains
    under it)."""
    with pytest.raises(SystemExit) as exc:
        _run_cli(tmp_path, *flags)
    msg = str(exc.value)
    assert item not in msg
    assert ("--model_path" if item == "A8" else "torchrun") in msg


def test_cli_module_runs(tmp_path):
    """``python -m`` entry point: one step of the tiny run exits 0."""
    res = subprocess.run(
        [sys.executable, "-m", "pyramid_flow_tpu_torch.tools.train_pyramid_flow",
         "--debug_tiny", "--epochs", "1", "--steps_per_epoch", "1",
         "--output_dir", str(tmp_path), "--bound_probe_freq", "0"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    assert "saved checkpoint-1" in res.stderr
