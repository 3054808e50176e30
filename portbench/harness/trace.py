"""Spans on the host clock and a bounded stretch under the profiler.

Host spans come from hooks the benchmark attaches to the program's modules
at run time; nothing is written to disk. The profiled stretch is read from
the profiler's raw events in memory: the device's busy time (the union of
its operations' intervals), the device time of whatever a named host range
launched (a launch whose host call starts inside the range, so a kernel
counts by where it was launched from, not by its name), the operations that
took most time, and the longest idle gaps with what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from .yardstick import busy_seconds

NAME_CHARS = 120  # of an operation's name in the breakdown


class ForwardSpans:
    """Host time between a module's forward pre-hook and its hook."""

    def __init__(self, module: torch.nn.Module):
        self.durations: List[float] = []
        self._t = 0.0
        self._handles = [
            module.register_forward_pre_hook(self._pre),
            module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        self._t = time.perf_counter()

    def _post(self, module, args, out):
        self.durations.append(time.perf_counter() - self._t)

    def close(self):
        for h in self._handles:
            h.remove()


@contextlib.contextmanager
def wrapped(modules_and_names, label: str):
    """Wrap each ``module.name`` function in a profiler range ``label`` for
    the duration of the block."""
    saved = []
    for mod, name in modules_and_names:
        fn = getattr(mod, name)

        def ranged(*a, _fn=fn, **k):
            with torch.profiler.record_function(label):
                return _fn(*a, **k)

        saved.append((mod, name, fn))
        setattr(mod, name, ranged)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _events(prof):
    res = prof.profiler.kineto_results
    return res.events() if res is not None else []


def read_profile(prof, label: str, top: int = 10, also=()
                 ) -> Dict[str, object]:
    """Summary of a finished ``torch.profiler.profile`` run; the labelled
    device time is what was launched inside the ``label`` ranges and the
    host operations whose names contain one of ``also`` (an autograd
    node's backward, say)."""
    from torch.autograd import DeviceType

    device, ranges, launches, host_ops = [], [], {}, []
    for e in _events(prof):
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, start + dur, e.name(),
                               e.correlation_id(), e.linked_correlation_id()))
        elif e.is_user_annotation():
            if e.name() == label:
                ranges.append((start, start + dur))
        elif "aunch" in e.name():
            launches[e.correlation_id()] = start
        else:
            host_ops.append((start, start + dur, e.name(),
                             e.correlation_id()))
            if any(a in e.name() for a in also):
                ranges.append((start, start + dur))
    busy = busy_seconds((s, t) for s, t, *_ in device)
    ranges = _merged(ranges)
    starts = [r[0] for r in ranges]
    frontend = {c: s for s, _, _, c in host_ops}

    def in_range(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < ranges[i][1]

    labelled = 0.0
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name, corr, linked in device:
        by_name[name[:NAME_CHARS]] += (t - s) / 1e9
        host = launches.get(corr, frontend.get(linked))
        if host is not None and in_range(host):
            labelled += (t - s) / 1e9
    window = ((max(t for _, t, *_ in device) - min(s for s, *_ in device))
              / 1e9 if device else 0.0)
    return dict(busy_s=busy, device_window_s=window, labelled_device_s=labelled,
                device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
                idle_gaps=_idle_gaps(device, host_ops, top),
                device_events=len(device))


def _merged(intervals) -> List[List[int]]:
    """The union of [start, end) intervals as sorted disjoint ones."""
    merged: List[List[int]] = []
    for s, t, *_ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _idle_gaps(device, host_ops, top) -> List[Tuple[str, float]]:
    """The longest gaps between the device's busy intervals, each named by
    the innermost host operation running at its middle."""
    merged = _merged(device)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) // 2)
                   for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    ops = sorted(host_ops)
    starts = [o[0] for o in ops]
    out = []
    for length, mid in gaps:
        i = bisect.bisect_right(starts, mid) - 1
        name = "no host operation"
        for j in range(i, max(i - 5000, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        out.append((name[:NAME_CHARS], length / 1e9))
    return out


def start_profile():
    """A running profiler of the host and the device."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profile(prof) -> None:
    prof.__exit__(None, None, None)


def attention_sites():
    """The DiTs' attention-core call in each module that calls it (the
    MMDiT's blocks import the flux blocks' ``_attention``)."""
    from pyramid_flow_tpu_torch.models.flux import blocks as flux_blocks
    from pyramid_flow_tpu_torch.models.mmdit import blocks as mmdit_blocks
    return [(flux_blocks, "_attention"), (mmdit_blocks, "_attention")]
