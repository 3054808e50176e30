"""Port parity for the DiTs' classic-softmax route: ``bounded_softmax=False``
on either DiT, and ``--classic_softmax`` on the three CLIs, against the JAX
package run under ``PF_BOUNDED_SOFTMAX=0``.

* a tiny miniFLUX, JAX's parameters through ``flux_state_dict_from_jax``
  (every leaf redrawn from a numpy seed, the qk-norm gains 1 + N(0, 0.02)),
  on a packed AR layout: JAX's forward under ``PF_BOUNDED_SOFTMAX=0`` (its
  classic Pallas forward in interpret mode) against the port with
  ``bounded_softmax=False``, within 1e-4; then with the qk-norm gains
  scaled until JAX's ``bounded_softmax_overshoot`` (its training
  telemetry's reading) is above 150 log2 units: JAX's classic route and the
  port's still agree within 1e-4, while JAX's bounded route does not (its
  shift underflows the rows beyond the envelope), which is what the route
  is for;
* a spy on ``sp_flash_attention``: every attention call of both DiT families
  passes ``bounded=False`` on the classic route and True by default,
  whether the route is set when the DiT is built or after, through
  ``PyramidFlowPipeline.from_pretrained``, ``PyramidFlowRunner.
  from_pretrained`` and ``from_train_state``, and through each CLI's
  ``--classic_softmax``: the inference CLI, the serving app (``--debug_tiny``
  through ``main``, and a ``--model_path`` app's loader) and the training
  CLI (both families, the overshoot probe on);
* the training CLI's overshoot warning names ``--classic_softmax`` on the
  bounded route.

JAX decides the softmax form when it traces, so each route's forward is one
jit, traced with the variable already set: one compile per route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.flux import model as jmodel
from pyramid_flow_tpu.training.telemetry import overshoot_from_telemetry
from pyramid_flow_tpu_torch.models.flux import blocks
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.mmdit.model import (
    MMDiTConfig, PyramidDiffusionMMDiT)
from pyramid_flow_tpu_torch.ops.flash_attention import INVALID_TIME
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.pipeline.runner import PyramidFlowRunner
from pyramid_flow_tpu_torch.tools import inference, serve
from pyramid_flow_tpu_torch.tools import train_pyramid_flow as train_cli
from pyramid_flow_tpu_torch.training import telemetry
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.utils.converters import flux_state_dict_from_jax

from test_torch_port_checkpoint import VARIANT, write_release_dir
from test_torch_port_flux import CFG, _layout
from test_torch_port_mmdit import TINY as MMDIT_TINY, tiny_layout

TOL = dict(rtol=1e-4, atol=1e-4)
QK_NORMS = ("norm_q", "norm_k", "norm_added_q", "norm_added_k")
OUT_OF_ENVELOPE_LOG2 = 150.0  # well past the ~120 where the shift underflows
REQ = dict(height=64, width=64, temp=1, num_inference_steps=[1, 1, 1],
           video_num_inference_steps=[1, 1, 1], guidance_scale=7.0,
           video_guidance_scale=5.0)


# ----------------------------------------------------- parity against JAX
def _is_qk_norm(path) -> bool:
    keys = [getattr(p, "key", None) for p in path]
    return keys[-1] == "scale" and any(k in QK_NORMS for k in keys)


def _jax_params(dit_j, inputs):
    """Every leaf N(0, 0.05) from a numpy seed, the qk-norm gains 1 +
    N(0, 0.02), as a trained model holds them."""
    shapes = jax.eval_shape(dit_j.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, inputs))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(
            ((1.0 if _is_qk_norm(path) else 0.0)
             + (0.02 if _is_qk_norm(path) else 0.05)
             * rng.standard_normal(p.shape)).astype(np.float32)), shapes)


def _scale_qk_norms(params, gain):
    return jax.tree_util.tree_map_with_path(
        lambda path, p: p * gain if _is_qk_norm(path) else p, params)


def _port(params, bounded_softmax):
    dit = PyramidFluxTransformer(FluxConfig(**CFG), device="cpu",
                                 bounded_softmax=bounded_softmax)
    dit.load_state_dict(flux_state_dict_from_jax(
        jax.tree.map(np.array, params)), strict=True)
    return dit


def _port_overshoot(dit, inputs):
    """The port's probe reading: every attention's post-RoPE (q, k) of batch
    row 0 through ``bounded_softmax_overshoot``."""
    from pyramid_flow_tpu_torch.ops.flash_attention import (
        bounded_softmax_overshoot)

    tensors = [torch.from_numpy(x) for x in inputs]
    with torch.no_grad(), dit.capture_qk() as captured:
        dit(*tensors)
    tq = _time_q(inputs)[:1]
    return max(bounded_softmax_overshoot(q, k, torch.from_numpy(tq)).item()
               for q, k in captured)


def _time_q(inputs):
    text_time = np.where(inputs[4], 0, INVALID_TIME).astype(np.int32)
    return np.concatenate([text_time, inputs[2]], axis=1)


def _jax_route(dit_j, monkeypatch, classic):
    """A jitted JAX forward returning (output, telemetry), traced on the
    route the environment selects."""
    if classic:
        monkeypatch.setenv("PF_BOUNDED_SOFTMAX", "0")
    else:
        monkeypatch.delenv("PF_BOUNDED_SOFTMAX", raising=False)
    fwd = jax.jit(lambda p, *a: dit_j.apply(p, *a, mutable=["telemetry"]))
    return fwd


def test_classic_route_matches_jax_inside_and_outside_the_envelope(
        monkeypatch):
    inputs = _layout()
    dit_j = jmodel.PyramidFluxTransformer(config=jmodel.FluxConfig(**CFG),
                                          dtype=jnp.float32)
    params = _jax_params(dit_j, inputs)
    valid = inputs[2][0] != INVALID_TIME
    tq = jnp.asarray(_time_q(inputs)[:1])

    classic = _jax_route(dit_j, monkeypatch, classic=True)
    # inside the envelope
    out_j, mut = classic(params, *map(jnp.asarray, inputs))
    inside = float(overshoot_from_telemetry(mut["telemetry"], tq))
    assert inside < 100.0
    with torch.no_grad():
        out_t = _port(params, False)(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(out_t.numpy()[:, valid],
                               np.asarray(out_j)[:, valid], **TOL)

    # scale the qk-norm gains until the port's probe reads past the
    # envelope, then hold JAX's reading to it too
    gain = 2.0
    while _port_overshoot(_port(_scale_qk_norms(params, gain), False),
                          inputs) <= OUT_OF_ENVELOPE_LOG2:
        gain *= 1.25
    far = _scale_qk_norms(params, gain)
    out_jc, mut = classic(far, *map(jnp.asarray, inputs))
    over = float(overshoot_from_telemetry(mut["telemetry"], tq))
    assert over > OUT_OF_ENVELOPE_LOG2, (gain, over)
    with torch.no_grad():
        out_tc = _port(far, False)(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(out_tc.numpy()[:, valid],
                               np.asarray(out_jc)[:, valid], **TOL)

    bounded = _jax_route(dit_j, monkeypatch, classic=False)
    out_jb, _ = bounded(far, *map(jnp.asarray, inputs))
    out_jb = np.asarray(out_jb)[:, valid]
    assert not np.allclose(out_jb, out_tc.numpy()[:, valid], **TOL), (
        "the bounded route held outside its envelope", gain, over)
    # inside the envelope the bounded route is the classic one's
    out_jb_in, _ = bounded(params, *map(jnp.asarray, inputs))
    np.testing.assert_allclose(np.asarray(out_jb_in)[:, valid],
                               np.asarray(out_j)[:, valid], **TOL)


# ---------------------------------------------------------- the route spy
@pytest.fixture
def routes(monkeypatch):
    """The ``bounded`` of every DiT attention call (both families' blocks
    call ``flux.blocks.sp_flash_attention``)."""
    seen = []
    real = blocks.sp_flash_attention

    def spy(*args, bounded=None, **kw):
        seen.append(bounded)
        return real(*args, bounded=bounded, **kw)

    monkeypatch.setattr(blocks, "sp_flash_attention", spy)
    return seen


def _tiny(family, **kw):
    torch.manual_seed(0)
    if family == "flux":
        return (PyramidFluxTransformer(FluxConfig(**CFG), device="cpu", **kw),
                _layout())
    return (PyramidDiffusionMMDiT(MMDiTConfig(**MMDIT_TINY), device="cpu",
                                  **kw), tiny_layout())


@pytest.mark.parametrize("family", ["flux", "mmdit"])
def test_every_attention_takes_the_dit_route(routes, family):
    dit, inputs = _tiny(family, bounded_softmax=False)
    n = dit.num_attention_calls
    tensors = [torch.from_numpy(x) for x in inputs]
    with torch.no_grad():
        dit(*tensors)
    assert routes == [False] * n
    # set after the build, and under remat (the recompute too)
    dit.bounded_softmax = True
    dit.remat = True
    dit(*tensors).sum().backward()
    assert routes[n:] == [True] * (2 * n)
    dit.bounded_softmax = False
    dit(*tensors).sum().backward()
    assert routes[3 * n:] == [False] * (2 * n)
    assert _tiny(family)[0].bounded_softmax is True


@pytest.fixture(scope="module")
def release_dirs(tmp_path_factory):
    out = {}
    for name in ("pyramid_flux", "pyramid_mmdit"):
        root = tmp_path_factory.mktemp(name)
        write_release_dir(str(root), name)
        out[name] = str(root)
    return out


@pytest.mark.parametrize("model_name", ["pyramid_flux", "pyramid_mmdit"])
def test_from_pretrained_and_from_train_state_pass_the_route(
        routes, release_dirs, model_name):
    root = release_dirs[model_name]
    kw = dict(dtype=torch.float32, device="cpu")
    pipe = PyramidFlowPipeline.from_pretrained(
        root, VARIANT, model_name, load_vae=False, bounded_softmax=False, **kw)
    assert pipe.dit.bounded_softmax is False
    runner = PyramidFlowRunner.from_pretrained(
        root, VARIANT, model_name, bounded_softmax=False, **kw)
    runner.generate("a cat walks on grass", output_type="latent", **REQ)
    assert routes and set(routes) == {False}
    assert PyramidFlowPipeline.from_pretrained(
        root, VARIANT, model_name, load_vae=False, **kw).dit.bounded_softmax

    # from a train state: the training DiT's route
    dit = runner.pipeline.dit.train()
    state = create_train_state(dit, TrainConfig(learning_rate=1e-4))
    for route in (False, True):
        dit.bounded_softmax = route
        assert PyramidFlowPipeline.from_train_state(
            dit, state, dtype=torch.float32).dit.bounded_softmax is route


def test_inference_cli_flag(routes, release_dirs, tmp_path):
    argv = ["--model_path", release_dirs["pyramid_flux"], "--variant",
            VARIANT, "--prompt", "a cat walks on grass", "--temp", "1",
            "--height", "64", "--width", "64", "--num_inference_steps", "1",
            "--video_num_inference_steps", "1", "--device", "cpu",
            "--output", str(tmp_path / "out")]
    assert inference.main(argv + ["--classic_softmax"]) == 0
    # 3 stages x 1 step x 2 attentions of the tiny miniFLUX
    assert routes == [False] * 6
    assert inference.main(argv) == 0
    assert routes[6:] == [True] * 6


class _OneRequest:
    """A server whose ``serve_forever`` answers one request and returns."""

    def __init__(self, app, host, port):
        self.app, self.server_address = app, (host, port)

    def serve_forever(self):
        self.app.handle(dict(prompt="a bird", temp=1, height=64, width=64,
                             num_inference_steps=1,
                             video_num_inference_steps=1))

    def server_close(self):
        pass


def test_serving_app_flag(routes, release_dirs, monkeypatch):
    monkeypatch.setattr(serve, "make_server", _OneRequest)
    assert serve.main(["--debug_tiny", "--classic_softmax"]) == 0
    assert routes == [False] * 6
    assert serve.main(["--debug_tiny"]) == 0
    assert routes[6:] == [True] * 6

    # a --model_path app's loader (on the CPU here, where the app itself
    # refuses to load without a card)
    monkeypatch.setattr(serve.ServingApp, "device",
                        property(lambda self: torch.device("cpu")))
    app = serve.ServingApp(serve.parse_args(
        ["--model_path", release_dirs["pyramid_flux"], "--variant", VARIANT,
         "--classic_softmax"]))
    del routes[:]
    app.generate(dict(prompt="a bird", temp=1, height=64, width=64,
                      num_inference_steps=1, video_num_inference_steps=1))
    assert app.pipelines[VARIANT].dit.bounded_softmax is False
    assert routes == [False] * 6


@pytest.mark.parametrize("model_name", ["pyramid_flux", "pyramid_mmdit"])
def test_training_cli_flag_and_warning(routes, model_name, tmp_path, capfd,
                                       monkeypatch):
    argv = ["--debug_tiny", "--model_name", model_name, "--epochs", "1",
            "--steps_per_epoch", "1",
            "--gradient_checkpointing", "--bound_probe_freq", "1",
            "--save_ckpt_freq", "1000"]
    # every reading warns: the bounded route names the remedy
    monkeypatch.setattr(telemetry, "OVERSHOOT_WARN_LOG2", -1.0)
    assert train_cli.main(argv + ["--output_dir", str(tmp_path / "b")]) == 0
    err = capfd.readouterr().err
    assert "restart this run with --classic_softmax" in err
    assert routes and set(routes) == {True}
    n = len(routes)  # remat forwards and recomputes of 3 stages, the probe
    assert train_cli.main(argv + ["--classic_softmax", "--output_dir",
                                  str(tmp_path / "c")]) == 0
    err = capfd.readouterr().err
    assert routes[n:] == [False] * n
    # the probe ran on the classic route too, which needs no warning
    assert "bound_overshoot_log2" in err and "WARNING" not in err


def test_route_is_saved_in_no_state_dict_or_config():
    dit, _ = _tiny("flux", bounded_softmax=False)
    fresh, _ = _tiny("flux")
    assert dit.state_dict().keys() == fresh.state_dict().keys()
    assert dit.config == fresh.config
