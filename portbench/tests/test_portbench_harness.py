"""The harness on the CPU: discovery by file name, the yardstick's
arithmetic on known shapes, the result line, and what the benchmark loads.

    python -m pytest portbench/tests -q
"""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import cell as harness  # noqa: E402
from portbench.harness import seeded, yardstick  # noqa: E402
from portbench.reference import dit as ref_dit  # noqa: E402
from portbench.reference.pyramid import INVALID_TIME, Layout  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_in_benchmark_json_has_its_files():
    bench = harness.Bench(ROOT)
    for w in BENCH["workloads"]:
        spec = bench.spec(w["name"], 1, 1.0, False, "cpu")
        assert (spec.workload["config"], spec.workload["traffic"]) == (
            w["config"], w["traffic"])
        assert hasattr(bench.generator(spec.generator), "Cell")
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for m in BENCH["per_layer"]:
        assert callable(bench.reader(m["name"]))
        assert bench.reader(m["name"])({}) is None  # nothing to read


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A throwaway workload file in another checkout is found by its name
    alone, with the existing configuration and traffic generator."""
    (tmp_path / "portbench").mkdir()
    for kind in ("configs", "traffic", "metrics"):  # what the cell reuses
        shutil.copytree(ROOT / "portbench" / kind,
                        tmp_path / "portbench" / kind)
    (tmp_path / "portbench" / "workloads").mkdir()
    src = BENCH["workloads"][0]
    wl = json.loads((ROOT / "portbench" / "workloads"
                     / f"{src['name']}.json").read_text())
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / f"{wl['traffic']}.json").read_text())
    (tmp_path / "portbench" / "traffic" / "throwaway-mix.json").write_text(
        json.dumps(dict(mix, temp=8)))
    (tmp_path / "portbench" / "workloads" / "throwaway.json").write_text(
        json.dumps(dict(wl, traffic="throwaway-mix")))
    doc = dict(BENCH, workloads=BENCH["workloads"] + [
        dict(src, name="throwaway", traffic="throwaway-mix",
             why="a test's cell")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = harness.Bench(tmp_path)
    spec = bench.spec("throwaway", 5, 1.0, False, "cpu")
    assert spec.traffic["temp"] == 8 and spec.generator == mix["generator"]
    assert spec.config == bench.config(src["config"])
    assert {m["name"] for m in bench.metrics("end_to_end", "throwaway")} >= {
        "setup_s"}


def test_visible_pairs_and_attention_work():
    # text 0 0 INVALID, then frames 0 0 1 1 and one pad
    t = np.array([0, 0, INVALID_TIME, 0, 0, 1, 1, INVALID_TIME])
    # valid: four at time 0 (see 4 each), two at time 1 (see 6 each)
    assert yardstick.visible_pairs(t) == 4 * 4 + 2 * 6
    flops, nbytes = yardstick.attention_work(t, heads=3, head_dim=64, rows=2)
    assert flops == 4 * 64 * 3 * 28 * 2
    assert nbytes == 4 * 2 * 3 * 8 * 64 * 2
    assert yardstick.bound_seconds(989e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.busy_seconds([(0, 10), (5, 20), (30, 40)]) == 30e-9


@pytest.mark.parametrize("family,cfg", [
    ("flux", dict(in_channels=64, num_layers=1, num_single_layers=2,
                  attention_head_dim=32, num_attention_heads=2,
                  joint_attention_dim=48, pooled_projection_dim=24,
                  axes_dims_rope=[8, 12, 12])),
    ("mmdit", dict(sample_size=16, patch_size=2, in_channels=16,
                   num_layers=2, attention_head_dim=32,
                   num_attention_heads=2, caption_projection_dim=64,
                   pooled_projection_dim=24, joint_attention_dim=48,
                   pos_embed_max_size=32))])
def test_matmul_flops_count_every_product_of_the_forward(family, cfg):
    """The yardstick's count from names and shapes equals the products the
    reference forward runs, counted as it runs them."""
    count = []

    class Counting(ref_dit.Precision):
        def mm(self, x, w, b=None):
            count.append(2 * x[..., 0].numel() * w.shape[0] * w.shape[1])
            return super().mm(x, w, b)

    specs = ref_dit.param_specs(family, cfg)
    W = {n: w.float() for n, w in seeded.seeded_weights(
        specs, 3, 1, "cpu", torch.float32)}
    text, latent = 5, 16
    lay = torch.zeros((1, latent, 3))
    lay[0, :, 1] = torch.arange(latent) // 4
    lay[0, :, 2] = torch.arange(latent) % 4
    ref_dit.forward(family, cfg, W, torch.randn(1, latent, 64), lay,
                    torch.zeros((1, latent), dtype=torch.long),
                    torch.randn(1, text, 48), torch.ones(1, text, dtype=bool),
                    torch.randn(1, 24), torch.tensor([500.0]), 8, 8,
                    Counting())
    assert sum(count) == yardstick.matmul_flops(specs, text, latent)


def test_layout_matches_the_bench_request():
    """The last unit's stage 2 of a 384x640 request: 128 text tokens, the
    padded history and one 24 x 40 frame of 960 tokens, 3072 in all (3068
    before the padding)."""
    lay = Layout(15, 2, 48, 80)
    assert lay.current == 960
    assert 128 + lay.length == 3072
    assert 128 + lay.history + lay.current == 3068
    assert (lay.time_ids[lay.history:lay.budget] == INVALID_TIME).all()
    assert (lay.time_ids[-960:] == 15).all()


def test_result_line_format():
    """The object run.py prints: the contract's keys, checks last."""
    from portbench.tests.tiny import tiny_run

    out = tiny_run("flux", trace=False, seconds=0.5)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"t2v_latent_frames_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out, allow_nan=False)


def test_traced_line_reports_per_layer_metrics():
    from portbench.tests.tiny import tiny_run

    out = tiny_run("mmdit", trace=True, seconds=1.5)
    names = {m["name"] for m in BENCH["per_layer"]}
    assert set(out["metrics"]) <= names
    assert {"forward_host_ms.t2v", "pipeline_self_share.t2v",
            "mfu.t2v"} <= set(out["metrics"])
    assert "breakdown" in out and "window_s" in out["device"]


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, env=env, check=True)
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    """Importing the entry point, the harness, every traffic generator and
    metric, and the reference loads neither JAX nor the JAX package
    (top-level names compared whole: the port's name begins with it)."""
    loaded = _modules_after(
        "import portbench.run, portbench.reference.t2v\n"
        "from portbench.harness.cell import Bench\n"
        "b = Bench()\n"
        "[b.generator(b.spec(w['name'], 1, 1, False, 'cpu').generator) "
        "for w in b.doc['workloads']]\n"
        "[b.reader(m['name']) for m in b.doc['per_layer']]\n"
        "import portbench.traffic\n"
        "from portbench.tests.tiny import tiny_run\n"
        "tiny_run('flux', trace=False, seconds=0.2)")
    assert not loaded & set(harness.BANNED)
    assert "pyramid_flow_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after(
        "import portbench.reference.t2v, portbench.reference.dit, "
        "portbench.reference.pyramid")
    assert not loaded & (set(harness.BANNED) | {"pyramid_flow_tpu_torch"})


def test_banned_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyramid_flow_tpu_torch_x", sys)
    assert "pyramid_flow_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "pyramid_flow_tpu.models", sys)
    assert harness.banned_modules() == ["pyramid_flow_tpu"]


def test_seeded_weights_are_the_same_on_both_sides():
    specs = [("a.weight", (3, 4)), ("b.norm.weight", (4,)), ("c", (7,))]
    one = dict(seeded.seeded_weights(specs, 2 ** 31 + 7, 1, "cpu",
                                      torch.bfloat16))
    two = dict(seeded.seeded_weights(specs, 2 ** 31 + 7, 1, "cpu",
                                      torch.bfloat16))
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert math.isclose(one["b.norm.weight"].float().mean().item(), 1.0,
                        abs_tol=0.1)
    other = dict(seeded.seeded_weights(specs, 2 ** 31 + 8, 1, "cpu",
                                       torch.bfloat16))
    assert not torch.equal(one["a.weight"], other["a.weight"])
