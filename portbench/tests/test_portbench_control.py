"""The control: the plain reference put in the program's place at the next
precision below the configuration's bf16, float8 (e4m3, one scale per
tensor, on both operands of every product and on the tokens where the
program casts them to bf16), judged by the same comparison. It has to come
out not correct.

On the CPU at tiny widths; on the card at the cell's own size (marked
``gpu``, run on the chip):

    python -m pytest portbench/tests/test_portbench_control.py -q -s -m gpu
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import seeded  # noqa: E402
from portbench.harness.cell import Bench  # noqa: E402
from portbench.reference import dit as ref_dit  # noqa: E402
from portbench.reference import t2v as ref_t2v  # noqa: E402
from portbench.tests.tiny import tiny_spec  # noqa: E402

FP8 = torch.float8_e4m3fn
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def control_readings(spec, units: int) -> dict:
    """Judge the control's first ``units`` units of a request made from the
    run's seed as a run makes it (the same weights, text and draws)."""
    tg = Bench(ROOT).generator(spec.generator)
    fam, cfg, dev = spec.config["family"], spec.config["dit"], spec.device
    dtype = getattr(torch, spec.config["dtype"])
    tr = tg._traffic(spec.traffic)
    pos, neg = tg._text(spec, spec.traffic, dtype)
    text = tuple(torch.cat([n, p]).float() if n.is_floating_point()
                 else torch.cat([n, p]) for n, p in zip(neg, pos))
    noise = ref_t2v.make_noise(
        tr, seeded.generator(spec.seed, tg.TAG_NOISE, dev))
    W = {n: w.float() for n, w in seeded.seeded_weights(
        ref_dit.param_specs(fam, cfg), spec.seed, tg.TAG_DIT, dev, dtype)}
    with torch.no_grad():
        req = ref_t2v.plain_request(fam, cfg, W, noise, text, tr, units, FP8,
                                    ref_dit.Precision(FP8))
        return ref_t2v.judge(fam, cfg, W, req, noise, text, tr,
                             seeded.sub_seed(spec.seed, tg.TAG_SAMPLE),
                             spec.traffic["dit_samples"], dtype)


@pytest.mark.parametrize("family", ["flux", "mmdit"])
def test_control_fails_at_tiny_size(family):
    _, spec = tiny_spec(family, dtype="bfloat16")
    got = control_readings(spec, units=3)
    limits = spec.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["flux-t2v-384p-5s", "sd3-t2v-384p-5s"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_cell_size(cell, seed):
    """Two units of the cell's request (the first at 20 steps per stage,
    the second at 10) at 384 x 640 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = Bench(ROOT)
    spec = bench.spec(cell, seed, 0.0, False, "cuda:0")
    t0 = time.perf_counter()
    got = control_readings(spec, units=2)
    limits = spec.workload["limits"]
    print("control " + json.dumps(dict(cell=cell, seed=seed, readings=got,
                                       limits=limits,
                                       seconds=time.perf_counter() - t0)))
    assert any(got[k] > limits[k] for k in limits), got


def training_readings(spec, variants=("control", "half_batch",
                                      "altered_token")) -> dict:
    """The comparison's numbers for the reference put in the program's
    place: at float8 (the control) and with each planted fault, against the
    sound float32 reference, over the cell's first steps on the run's
    weights, batches and draws."""
    tg = Bench(ROOT).generator(spec.generator)
    from portbench.reference import train as ref_train

    fam, cfg, dev = spec.config["family"], spec.config["dit"], spec.device
    p = spec.traffic
    specs = ref_dit.param_specs(fam, cfg)
    n = p["setup_steps"]
    units = [ref_train.stage_units(k, p["frames"]) for k in range(n)]
    seed = seeded.sub_seed(spec.seed, tg.TAG_DRAWS)

    def run(P=ref_dit.Precision(), fault=""):
        W = dict(seeded.seeded_weights(specs, spec.seed, tg.TAG_DIT, dev,
                                       torch.float32))
        out = ref_train.train_steps(
            fam, cfg, W, [tg._batch(spec, p, k) for k in range(n)], units,
            seed, tg._ref_params(p), P, fault)
        out["change"] = tg.change_norms(W, specs, spec.seed, dev)
        return out

    sound = run()
    got = {}
    for v in variants:
        planted = (run(P=ref_dit.Precision(FP8)) if v == "control"
                   else run(fault=v))
        got[v] = ref_train.judge(planted, sound)
    return got


def test_training_control_and_faults_fail_at_tiny_size():
    _, spec = tiny_spec("flux", cell="flux-train-ar-384p")
    got = training_readings(spec)
    limits = spec.workload["limits"]
    for v, r in got.items():
        assert any(r[k] > limits[k] for k in limits), (v, r)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_and_faults_fail_at_cell_size(seed):
    """The cell's first steps at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = Bench(ROOT).spec("flux-train-ar-384p", seed, 0.0, False, "cuda:0")
    t0 = time.perf_counter()
    got = training_readings(spec)
    limits = spec.workload["limits"]
    print("control " + json.dumps(dict(cell=spec.name, seed=seed,
                                       readings=got, limits=limits,
                                       seconds=time.perf_counter() - t0)))
    for v, r in got.items():
        assert any(r[k] > limits[k] for k in limits), (v, r)
