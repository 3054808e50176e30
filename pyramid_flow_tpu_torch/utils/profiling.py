"""Profiling and tracing on the CUDA card.

* :func:`trace`: a ``torch.profiler`` trace of the enclosed region (CPU and,
  with a card, CUDA activities), written to ``log_dir`` in TensorBoard's
  format (one ``*.pt.trace.json`` per trace).
* :func:`annotate`: a named span in that trace (``record_function``).
* :class:`PhaseTimer`: host seconds per named phase, with the device of the
  tensors named in ``block_on`` synchronised at the end of each phase.
* :func:`device_memory_stats`: bytes in use, their peak and the memory
  size of each visible CUDA device (``torch.cuda.memory_stats``); empty with
  no card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["trace", "annotate", "PhaseTimer", "device_memory_stats"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region with ``torch.profiler`` (CPU activities,
    and CUDA ones when a card is visible) and write it under ``log_dir``
    for TensorBoard's profiler plugin. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named span visible in the profiler's timeline."""
    return torch.profiler.record_function(name)


def _synchronize(tensors) -> None:
    """Wait for the CUDA devices that hold any of ``tensors`` (a tensor, or
    a list, tuple or dict of them); CPU tensors need no wait."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Host seconds and calls per phase; ``phase(name, block_on=x)``
    synchronises ``x``'s CUDA device before it reads the clock."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "  ".join(f"{k}: {v:.2f}s/{self.counts[k]}x" for k, v in rows)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}``
    for each visible CUDA device (the caching allocator's bytes, its peak,
    and the device's total memory); ``{}`` without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
