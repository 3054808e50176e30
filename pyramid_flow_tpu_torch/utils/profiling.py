"""Profiling and tracing on the CUDA card.

* :func:`trace`: a ``torch.profiler`` trace of the enclosed region (CPU and,
  with a card, CUDA activities), written to ``log_dir`` in TensorBoard's
  format (one ``*.pt.trace.json`` per trace).
* :func:`annotate`: a named span in that trace (``record_function``).
* :func:`span` and :func:`recording`: the program's own spans. The pipeline,
  the DiTs and the trainer open a span at each of their layer boundaries;
  inside a ``recording()`` block each span appends a :class:`Span` to the
  block's :class:`Recorder`, and outside one it costs one module-level
  check. Times are ``time.time_ns()``, the Unix nanoseconds that the torch
  profiler stamps its events with, so spans and a device trace share one
  axis; while a profiler runs, each span is also a ``record_function``
  range of the same name.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

__all__ = ["trace", "annotate", "span", "recording", "Recorder", "Span",
           "allocator_calls", "ALLOCATOR"]


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


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index of the enclosing span in
    the recorder's list (None at the top); ``trace_id`` is given to a span
    or taken from its parent (the request number in the pipeline, the train
    state's ``step`` in training); ``attrs`` holds the span's attributes
    and each counter's change between its ends."""
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: Optional[int]
    trace_id: Optional[int]
    attrs: dict


class Recorder:
    """The spans of one ``recording()`` block, in the order they opened.
    The open spans are one stack, so spans nest on one thread, as the
    pipeline's and the trainer's do."""

    def __init__(self):
        self._records: List[list] = []
        self._open: List[int] = []  # indices of the spans not yet closed

    def spans(self) -> List[Span]:
        """The closed spans and the open ones (whose ``end_ns`` is None)."""
        return [Span(*r) for r in self._records]


_recorder: Optional[Recorder] = None


class _NullSpan:
    """What :func:`span` returns while nothing records: one shared
    object."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("rec", "name", "trace_id", "counters", "attrs", "index",
                 "base", "ranged")

    def __init__(self, rec: Recorder, name: str, trace_id, counters, attrs):
        self.rec, self.name, self.trace_id = rec, name, trace_id
        self.counters, self.attrs = counters, attrs
        self.ranged = None

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else None
        tid = self.trace_id
        if tid is None and parent is not None:
            tid = rec._records[parent][4]
        if self.counters:
            self.base = {k: read() for k, read in self.counters.items()}
        if torch._C._autograd._profiler_enabled():
            self.ranged = torch.profiler.record_function(self.name)
            self.ranged.__enter__()
        self.index = len(rec._records)
        rec._open.append(self.index)
        rec._records.append([self.name, time.time_ns(), None, parent, tid,
                             self.attrs])
        return self

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        rec = self.rec
        rec._records[self.index][2] = time.time_ns()
        rec._open.pop()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        if self.counters:
            for k, read in self.counters.items():
                self.attrs[k] = read() - self.base[k]
        return False


def span(name: str, trace_id: Optional[int] = None,
         counters: Optional[Dict[str, Callable[[], int]]] = None, **attrs):
    """A context manager around one piece of the program's work, recorded
    while a ``recording()`` block is open. ``counters`` maps attribute
    names to functions read at both ends (only while recording); the
    difference lands in ``attrs``. The yielded span's ``set(**attrs)`` adds
    attributes from inside it."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _Span(rec, name, trace_id, counters, attrs)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record every span opened inside the block; yields the recorder.
    Nothing is written anywhere."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = rec = Recorder()
    try:
        yield rec
    finally:
        _recorder = None


def allocator_calls() -> int:
    """The caching allocator's ``cudaMalloc`` and ``cudaFree`` calls so far
    on the current CUDA device (``num_device_alloc`` + ``num_device_free``);
    0 before CUDA is initialised."""
    if not torch.cuda.is_initialized():
        return 0
    stats = torch.cuda.memory_stats()
    return stats.get("num_device_alloc", 0) + stats.get("num_device_free", 0)


ALLOCATOR = {"allocator_calls": allocator_calls}
