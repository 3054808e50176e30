"""Piecewise CUDA-graph replay of a DiT forward in serving.

A serving forward launches thousands of small kernels (4,549 for miniFLUX at
CFG batch 2), and issuing them from Python takes longer than the card takes
to run them. :class:`ForwardGraphs` captures a forward once per layout as
one CUDA graph per stretch between two attentions: the embedders and the
first block up to its attention's q, k and v, then each stretch from one
attention's output to the next attention's q, k and v, and the last one to
the output (58 graphs for miniFLUX, 25 for the MMDiT, 81 for Wan). While it
captures, the DiT's attention sites (``models.attention_site``) call the
capture in place of their attention; each such seam records the site's
static q, k, v and output, the attention function's module and name, and
its other arguments as the site passed them. A replay copies the inputs
into the layout's static buffers, replays each graph in turn, and between
two graphs calls ``getattr(module, name)(q, k, v, *rest)`` eagerly, looked
up at each call. So the hand-written flash forward is launched, counted
(``flash_fwd_cuda.launches``) and wrapped as in an eager forward,
``num_attention_calls`` times per forward, whatever the family. Each
attention's q, k and v come from the fused kernel of ``ops.qk_norm_rope``,
and each block's norms and residuals from that of ``ops.residual_norm``,
recorded in the graphs; a replay adds the launches its graphs hold to each
kernel's ``launches``, so the counts are the kernels that ran.

When: a forward is graphed only on CUDA tensors, with autograd off (no_grad
or inference mode), outside autocast, without an sp group, with no
``capture_qk`` and no ``ops.composition.composition()`` open, and on a stream
that is not capturing already (:func:`bypass_reason`). Every other forward
(training, telemetry, Ulysses SP, reference forwards, the CPU) runs the
eager body as it is. Of the forwards that may be
graphed, a layout's first runs eagerly, its second is captured (then
replayed for its result) and the later ones replay. The layout is the
inputs' shapes, dtypes and device and the DiT's ``bounded_softmax``.

Memory: every layout's graphs allocate from one private pool, and the
static buffers (the inputs, and the q, k, v and attention output handed
across each seam) are one per role and shape, shared by every seam and
every layout. That is safe because a forward reads nothing that an earlier
forward left: its inputs are copied in, each buffer is written before it is
read, the output is cloned, and forwards run one at a time in stream order.
The cache belongs to the DiT, so dropping the DiT frees it. A parameter or
buffer whose storage changed (``.to()``, a tensor assigned in its place)
drops it before the next forward; an in-place update of the weights is read
by the next replay.
"""

from __future__ import annotations

import dataclasses
import types
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.composition import composing
from ..ops.qk_norm_rope import qk_norm_rope_cuda
from ..ops.residual_norm import residual_norm_cuda

__all__ = ["ForwardGraphs", "GRAPH_FORWARDS", "bypass_reason"]

# the hand-written kernels a graph records, whose launches a replay counts
COUNTED = (qk_norm_rope_cuda, residual_norm_cuda)

# forwards that could be graphed, by how they ran: replayed (graphs that
# existed), captured (then replayed) and eager (a layout's first)
GRAPH_FORWARDS = {"replay": 0, "capture": 0, "eager": 0}


def bypass_reason(dit, tokens: torch.Tensor) -> Optional[str]:
    """Why a forward of ``dit`` on ``tokens`` runs eagerly whatever its
    layout, or None when it may be graphed."""
    if torch.is_grad_enabled():
        return "grad"
    if torch.is_autocast_enabled("cuda"):
        return "autocast"  # its cast cache would outlive the capture
    if dit.sites.sp_group is not None:
        return "sp"
    if dit.sites.capture is not None:
        return "capture_qk"
    if composing():
        return "composition"  # a graph would keep the composed chains
    if not tokens.is_cuda:
        return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


@dataclasses.dataclass
class _Seam:
    """One attention between two graphs: its static inputs and output, and
    the call that fills the output, ``getattr(module, name)(q, k, v,
    *rest)``."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    o: torch.Tensor
    module: types.ModuleType
    name: str
    rest: tuple


@dataclasses.dataclass
class _Layout:
    inputs: Tuple[Optional[torch.Tensor], ...] = ()
    graphs: List = dataclasses.field(default_factory=list)
    seams: List[_Seam] = dataclasses.field(default_factory=list)
    out: Optional[torch.Tensor] = None
    launches: Tuple[int, ...] = ()  # of each COUNTED kernel, the graphs


class _Capture:
    """Captures one forward's graphs: the attention sites call it in place
    of their attention, which ends the running graph and starts the next."""

    def __init__(self, owner: "ForwardGraphs"):
        self.owner = owner
        self.graphs: List = []
        self.seams: List[_Seam] = []

    def begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        self.graphs.append(graph)
        graph.capture_begin(pool=self.owner.pool,
                            capture_error_mode="thread_local")

    def end(self) -> None:
        self.graphs[-1].capture_end()

    def abort(self) -> None:
        """End a capture that raised, so the stream can run again."""
        if torch.cuda.is_current_stream_capturing():
            try:
                self.end()
            except RuntimeError:
                pass  # the capture was invalidated; the stream is free

    def __call__(self, module, name, q, k, v, rest):
        buffer = self.owner.buffer
        qkv = [buffer(role, t.shape, t.dtype, t.device)
               for role, t in zip("qkv", (q, k, v))]
        o = buffer("o", (*q.shape[:-1], v.shape[-1]), q.dtype, q.device)
        for static, t in zip(qkv, (q, k, v)):
            static.copy_(t)
        self.end()
        self.seams.append(_Seam(*qkv, o, module, name, rest))
        self.begin()
        return o


class ForwardGraphs:
    """A DiT's graphs, one set per layout; see the module docstring."""

    def __init__(self):
        self.clear()

    def __reduce__(self):
        # a copy of the DiT (deepcopy, pickle) starts with no graphs: they
        # read the original's weights
        return ForwardGraphs, ()

    def clear(self) -> None:
        """Drop every graph and buffer."""
        self.layouts: Dict[tuple, _Layout] = {}
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.pool = None
        self.stream = None
        self.weights: List[tuple] = []

    def buffer(self, role, shape, dtype, device) -> torch.Tensor:
        """The static buffer of ``role`` at this shape, dtype and device."""
        key = (role, tuple(shape), dtype, device)
        buf = self.buffers.get(key)
        if buf is None:
            buf = self.buffers[key] = torch.empty(shape, dtype=dtype,
                                                  device=device)
        return buf

    def _weights_moved(self, dit) -> bool:
        """Whether a parameter or buffer of ``dit`` is no longer the tensor,
        or the storage, that the graphs read."""
        for slots, name, ref, ptr in self.weights:
            t = slots.get(name)
            if t is None or t is not ref() or t.data_ptr() != ptr:
                return True
        return False

    def __call__(self, dit, body: Callable, args: tuple, span):
        """``body(*args)``, the eager forward, or its graphs' replay; sets
        the span's ``graph`` attribute to how it ran."""
        if bypass_reason(dit, args[0]) is not None:
            span.set(graph="eager")
            return body(*args)
        if self.weights and self._weights_moved(dit):
            self.clear()
        key = (dit.bounded_softmax,
               tuple(None if a is None else (a.shape, a.dtype, a.device)
                     for a in args))
        layout = self.layouts.get(key)
        if layout is None:
            self.layouts[key] = _Layout()
            GRAPH_FORWARDS["eager"] += 1
            span.set(graph="eager")
            return body(*args)
        # static buffers are plain tensors, whatever the caller's mode
        with torch.inference_mode(False), torch.no_grad():
            if not layout.graphs:
                self._capture(dit, body, args, layout)
                mode = "capture"
            else:
                mode = "replay"
            GRAPH_FORWARDS[mode] += 1
            span.set(graph=mode)
            return self._replay(layout, args)

    def _capture(self, dit, body, args, layout: _Layout) -> None:
        device = args[0].device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)  # capture needs its own
            self.weights = [
                (slots, name, weakref.ref(t), t.data_ptr())
                for m in dit.modules() for slots in (m._parameters, m._buffers)
                for name, t in slots.items() if t is not None]
        inputs = tuple(None if a is None else
                       self.buffer(("input", i), a.shape, a.dtype, device)
                       for i, a in enumerate(args))
        capture = _Capture(self)
        captured = [kernel.captured for kernel in COUNTED]
        with dit.sites.seamed(capture), torch.cuda.stream(self.stream):
            try:
                capture.begin()
                out = body(*inputs)
                capture.end()
            except BaseException:
                capture.abort()
                raise
        layout.inputs, layout.out = inputs, out
        layout.graphs, layout.seams = capture.graphs, capture.seams
        layout.launches = tuple(kernel.captured - n
                                for kernel, n in zip(COUNTED, captured))

    def _replay(self, layout: _Layout, args) -> torch.Tensor:
        for static, a in zip(layout.inputs, args):
            if static is not None:
                static.copy_(a)
        for graph, s in zip(layout.graphs, layout.seams):
            graph.replay()
            s.o.copy_(getattr(s.module, s.name)(s.q, s.k, s.v, *s.rest))
        layout.graphs[-1].replay()
        for kernel, n in zip(COUNTED, layout.launches):
            kernel.launches += n
        return layout.out.clone()
