"""The control of ``wan14b-t2v-384p-5s``: ``reference/wan.py`` put in the
program's place at float8 (e4m3, one scale per tensor, on both operands of
every product and on the tokens where the program casts them to bf16),
judged by the cell's comparison. It has to come out not correct.

On the CPU at tiny widths; on the card at the cell's own size (marked
``gpu``; two units of the cell's request, the weights held in bf16):

    python -m pytest portbench/tests/test_portbench_wan_control.py -q -s -m gpu
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
from portbench.reference import t2v as ref_t2v  # noqa: E402
from portbench.reference import wan as ref_wan  # noqa: E402
from portbench.reference.dit import Precision  # noqa: E402
from portbench.tests.tiny import VAE  # noqa: E402

CELL = "wan14b-t2v-384p-5s"
FP8 = torch.float8_e4m3fn
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def control_readings(spec, units: int) -> dict:
    """Judge the control's first ``units`` units of a request made from the
    run's seed as a run makes it (the same weights, text and draws)."""
    tg = Bench(ROOT).generator(spec.generator)
    cfg, dev = spec.config["dit"], spec.device
    dtype = getattr(torch, spec.config["dtype"])
    tr = tg.base._traffic(spec.traffic)
    pos, neg = tg._text(spec, spec.traffic, dtype)
    text = tuple(torch.cat([n, p]).float() if n.is_floating_point()
                 else torch.cat([n, p]) for n, p in zip(neg, pos))
    noise = ref_t2v.make_noise(
        tr, seeded.generator(spec.seed, tg.TAG_NOISE, dev))
    W = dict(seeded.seeded_weights(ref_wan.param_specs(cfg), spec.seed,
                                   tg.TAG_DIT, dev, dtype))
    with torch.no_grad():
        req = ref_wan.plain_request(cfg, W, noise, text, tr, units, FP8,
                                    Precision(FP8))
        return ref_wan.judge(cfg, W, req, noise, text, tr,
                             seeded.sub_seed(spec.seed, tg.TAG_SAMPLE),
                             spec.traffic["dit_samples"], dtype)


def test_control_fails_at_tiny_size():
    bench = Bench(ROOT)
    cfg = bench.config(bench.workload(CELL)["config"])
    cfg.update(vae=dict(cfg["vae"], **VAE), dit=dict(
        cfg["dit"], dim=256, ffn_dim=512, num_heads=2, num_layers=4,
        text_len=16, text_dim=64))
    spec = bench.spec(CELL, 2 ** 31 + 11, 1.0, False, "cpu", config=cfg)
    spec.traffic.update(temp=4, height=64, width=64, steps=[2, 2, 2],
                        video_steps=[2, 2, 2], text_len=8, text_valid=6,
                        dit_samples=3)
    got = control_readings(spec, units=3)
    limits = spec.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_cell_size(seed):
    """Two units of the cell's request (the first at 20 steps per stage,
    the second at 10) at 384 x 640 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size")
    spec = Bench(ROOT).spec(CELL, seed, 0.0, False, "cuda:0")
    t0 = time.perf_counter()
    got = control_readings(spec, units=2)
    limits = spec.workload["limits"]
    print("control " + json.dumps(dict(cell=CELL, seed=seed, readings=got,
                                       limits=limits,
                                       seconds=time.perf_counter() - t0)))
    assert any(got[k] > limits[k] for k in limits), got
