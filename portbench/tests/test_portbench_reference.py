"""The plain reference against the port's CPU path at tiny widths, and the
comparison against the faults a served request can have.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import seeded  # noqa: E402
from portbench.reference import dit as ref_dit  # noqa: E402
from portbench.reference import t2v as ref_t2v  # noqa: E402
from portbench.reference.pyramid import Layout  # noqa: E402
from portbench.tests.tiny import CONFIGS, tiny_run, tiny_spec  # noqa: E402


def _port_dit(family, cfg):
    if family == "flux":
        from pyramid_flow_tpu_torch.models.flux.model import (
            FluxConfig, PyramidFluxTransformer)
        return PyramidFluxTransformer(FluxConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.items()}), device="cpu")
    from pyramid_flow_tpu_torch.models.mmdit.model import (
        MMDiTConfig, PyramidDiffusionMMDiT)
    return PyramidDiffusionMMDiT(MMDiTConfig(**cfg), device="cpu")


@pytest.mark.parametrize("family", ["flux", "mmdit"])
@pytest.mark.parametrize("unit,stage", [(0, 0), (2, 1), (3, 2)])
def test_dit_forward_matches_the_port(family, unit, stage):
    """The reference forward against the port's DiT in float32 on the CPU,
    on the same seeded weights and a packed layout of the pipeline's."""
    cfg = CONFIGS[family]["dit"]
    specs = ref_dit.param_specs(family, cfg)
    port = _port_dit(family, cfg)
    seeded.load_into(port, seeded.seeded_weights(specs, 9, 1, "cpu",
                                                 torch.float32))
    W = dict(seeded.seeded_weights(specs, 9, 1, "cpu", torch.float32))
    lay = Layout(unit, stage, 16, 16)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randn((2, lay.length, 64), generator=g)
    pos = torch.as_tensor(lay.positions)[None].expand(2, -1, -1)
    times = torch.as_tensor(lay.time_ids)[None].expand(2, -1)
    text = torch.randn((2, 8, cfg["joint_attention_dim"]), generator=g)
    mask = torch.arange(8)[None].expand(2, -1) < torch.tensor([[5], [8]])
    pooled = torch.randn((2, cfg["pooled_projection_dim"]), generator=g)
    t = torch.tensor([900.0, 120.0])
    extra = port.stage_inputs(2, lay.h, lay.w, "cpu")
    with torch.no_grad():
        want = port(tokens, pos, times.int(), text, mask, pooled, t, *extra)
    got = ref_dit.forward(family, cfg, W, tokens, pos, times, text, mask,
                          pooled, t, lay.h, lay.w)
    cur = slice(-lay.current, None)
    assert ref_t2v.rel(got[:, cur], want[:, cur]) < 1e-5


@pytest.mark.parametrize("family", ["flux", "mmdit"])
def test_plain_request_follows_the_port(family):
    """The reference's own request (float32) feeds its DiT what the port's
    pipeline fed it and gets back what the port got, forward by forward."""
    bench, spec = tiny_spec(family, seconds=2.0)
    tg = bench.generator(spec.generator)
    cell = tg.Cell(spec)
    cell.window()
    req, noise = cell.requests[0], cell.noises[0]
    cfg = spec.config["dit"]
    W = dict(seeded.seeded_weights(ref_dit.param_specs(family, cfg),
                                   spec.seed, tg.TAG_DIT, "cpu",
                                   torch.float32))
    text = tuple(torch.cat([n, p]) for n, p in zip(cell.neg, cell.pos))
    units = {f["unit"] for f in req.forwards}
    plain = ref_t2v.plain_request(family, cfg, W, noise, text, cell.tr,
                                  len(units), torch.float32,
                                  ref_dit.Precision())
    assert len(plain.forwards) > 20
    for a, b in zip(plain.forwards, req.forwards):
        assert (a["unit"], a["stage"], a["step"]) == (
            b["unit"], b["stage"], b["step"])
        assert ref_t2v.rel(a["cur"], b["cur"]) < 1e-5
        assert ref_t2v.rel(a["v"], b["v"]) < 1e-4
        if "cond" in a and a["unit"]:
            assert ref_t2v.rel(a["cond"], b["cond"]) < 1e-5


@pytest.mark.parametrize("family", ["flux", "mmdit"])
def test_sound_run_is_correct(family):
    out = tiny_run(family, seconds=1.5)
    assert out["correct"], out["checks"]
    assert all(c["value"] < 1e-4 for c in out["checks"].values())


def _wrap(monkeypatch, obj, name, make):
    monkeypatch.setattr(obj, name, make(getattr(obj, name)))


def _dit_classes():
    from pyramid_flow_tpu_torch.models.flux.model import \
        PyramidFluxTransformer
    from pyramid_flow_tpu_torch.models.mmdit.model import \
        PyramidDiffusionMMDiT
    return PyramidFluxTransformer, PyramidDiffusionMMDiT


def fault_unchanged_step(monkeypatch):
    """Each Euler step returns its state unchanged."""
    from pyramid_flow_tpu_torch.pipeline import pyramid_pipeline as pp
    _wrap(monkeypatch, pp, "unpatchify",
          lambda f: lambda *a, **k: torch.zeros_like(f(*a, **k)))


def fault_half_batch(monkeypatch):
    """The DiT computes half of its CFG batch (the positive row) and hands
    it out for both."""
    for cls in _dit_classes():
        _wrap(monkeypatch, cls, "forward", lambda f: lambda self, *a: (
            f(self, *[x[1:] for x in a]).repeat(2, 1, 1)))


def fault_altered_unit(monkeypatch):
    """A unit's result is altered where it is produced: one latent pixel of
    its last stage changes."""
    from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import \
        PyramidFlowPipeline

    def make(f):
        def altered(*a, **k):
            out = f(*a, **k)
            out[-1] = out[-1].clone()
            out[-1][..., 0, 0, :] += 1.0
            return out
        return altered
    _wrap(monkeypatch, PyramidFlowPipeline, "generate_one_unit", make)


def fault_altered_token(monkeypatch):
    """One output token of every DiT forward is altered."""
    def make(f):
        def altered(self, *a):
            out = f(self, *a).clone()
            out[:, -1] += 1.0
            return out
        return altered
    for cls in _dit_classes():
        _wrap(monkeypatch, cls, "forward", make)


@pytest.mark.parametrize("fault", [fault_unchanged_step, fault_half_batch,
                                   fault_altered_unit, fault_altered_token])
@pytest.mark.parametrize("family", ["flux", "mmdit"])
def test_fault_makes_the_run_incorrect(family, fault, monkeypatch):
    """The whole run but the look for a card, with the timed path broken
    underneath: ``correct`` comes out false."""
    fault(monkeypatch)
    out = tiny_run(family, seconds=1.5)
    assert not out["correct"], out["checks"]


def test_sound_training_run_is_correct():
    out = tiny_run("flux", seconds=1.0, cell="flux-train-ar-384p")
    assert out["correct"], out["checks"]
    assert all(c["value"] < 1e-4 for c in out["checks"].values())


def fault_state_unchanged(monkeypatch):
    """The train step returns its state unchanged."""
    from pyramid_flow_tpu_torch.training.train_state import TrainState

    def unchanged(self, grads, loss):
        self.step += 1
        return True
    monkeypatch.setattr(TrainState, "apply_gradients", unchanged)


def fault_train_half_batch(monkeypatch):
    """Half of the batch is left out and the loss is the mean over the
    rest."""
    from pyramid_flow_tpu_torch.training import trainer

    def make(f):
        def half(dit, draws, latents, text, mask, pooled, *rest):
            h = latents.shape[0] // 2
            return f(dit, draws, latents[:h], text[:h], mask[:h], pooled[:h],
                     *rest)
        return half
    _wrap(monkeypatch, trainer, "dit_loss_fn", make)


@pytest.mark.parametrize("fault", [fault_state_unchanged,
                                   fault_train_half_batch,
                                   fault_altered_token])
def test_fault_makes_the_training_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    out = tiny_run("flux", seconds=1.0, cell="flux-train-ar-384p")
    assert not out["correct"], out["checks"]
