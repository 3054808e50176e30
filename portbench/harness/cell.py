"""Finding a cell's pieces by name, running it, and its result line.

Everything of one configuration, traffic mix or per-layer metric is a file
of its own, found by the name ``BENCHMARK.json`` gives it:

* ``portbench/workloads/<cell>.json``: the configuration's and the traffic
  mix's names, the chips, the limits of the comparison;
* ``portbench/configs/<config>.json``: the model's sizes and dtype;
* ``portbench/traffic/<mix>.json``: a traffic mix, the parameters that its
  generator (``"generator"``) reads;
* ``portbench/traffic/<generator>.py``: a ``Cell(spec)`` class whose
  constructor is the set-up, with ``window()`` returning the end-to-end
  metrics it measures, ``attempted``, ``failed``, ``summary`` (spans,
  counters and the profiled stretch, for the readers) and ``check()``
  returning each compared number;
* ``portbench/metrics/<metric>.py``: ``read(summary)``, the metric's value,
  or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

ROOT = Path(__file__).resolve().parents[2]
BANNED = ("jax", "jaxlib", "flax", "optax", "pyramid_flow_tpu")


@dataclass
class Spec:
    name: str
    workload: dict
    traffic: dict  # the mix's parameters
    generator: str
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device


def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names under
    ``root/portbench``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def entry(self, cell: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == cell:
                return w
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")

    def workload(self, cell: str) -> dict:
        return self._json("workloads", cell)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def generator(self, name: str):
        return _load_module(self.dir / "traffic" / f"{name}.py")

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return _load_module(self.dir / "metrics" / f"{metric}.py").read

    def metrics(self, kind: str, cell: str):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.doc[kind]
                if cell in m.get("workloads", [cell])]

    def spec(self, cell: str, seed: int, seconds: float, trace: bool,
             device, config: Optional[dict] = None) -> Spec:
        entry, wl = self.entry(cell), self.workload(cell)
        for key in ("config", "traffic", "chips"):
            if wl[key] != entry[key]:
                raise ValueError(f"{cell}: the workload file's {key} is "
                                 f"{wl[key]}, BENCHMARK.json's {entry[key]}")
        cfg = config if config is not None else self.config(wl["config"])
        mix = self._json("traffic", wl["traffic"])
        generator = mix.pop("generator")
        return Spec(cell, wl, mix, generator, cfg, seed, seconds, trace,
                    torch.device(device))


def banned_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX, its libraries, and the JAX package (compared whole, so the port,
    whose name begins with it, is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def run(bench: Bench, spec: Spec, t_start: float, clock) -> dict:
    """Set-up, window and comparison of one run; returns the result line's
    object (``checks`` last)."""
    cell_cls = bench.generator(spec.generator).Cell
    cell = cell_cls(spec)
    setup_s = clock() - t_start
    cuda = spec.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(spec.device)
        torch.cuda.reset_peak_memory_stats(spec.device)
    e2e = cell.window()
    # the window's peak, read by the traffic generator as the window closes
    # (a traced run goes on to profile), else now
    peak = cell.summary.setdefault(
        "peak_mem_bytes",
        torch.cuda.max_memory_allocated(spec.device) if cuda else 0)
    checks = cell.check()
    limits = spec.workload["limits"]
    if set(checks) != set(limits):
        raise KeyError(f"compared {sorted(checks)}, limits for "
                       f"{sorted(limits)}")
    correct = bool(cell.finishes) and all(
        checks[k] <= limits[k] for k in checks)
    e2e["setup_s"] = setup_s
    kind = "per_layer" if spec.trace else "end_to_end"
    metrics: Dict[str, dict] = {}
    for m in bench.metrics(kind, spec.name):
        value = (bench.reader(m["name"])(cell.summary) if spec.trace
                 else e2e[m["name"]])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else spec.device.type,
              "kind": torch.cuda.get_device_name(spec.device) if cuda
              else "cpu",
              "count": spec.workload["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": cell.attempted,
           "failed": cell.failed, "metrics": metrics, "device": device}
    if spec.trace and "busy_s" in cell.summary:
        device.update(busy_s=cell.summary["busy_s"],
                      window_s=cell.summary["traced_wall_s"])
        out["breakdown"] = {"device_ops": cell.summary["device_ops"],
                            "idle_gaps": cell.summary["idle_gaps"]}
    # a number that is not finite is printed as null (and is not correct)
    out["checks"] = {k: {"value": checks[k] if math.isfinite(checks[k])
                         else None, "limit": limits[k]}
                     for k in sorted(checks)}
    return out
