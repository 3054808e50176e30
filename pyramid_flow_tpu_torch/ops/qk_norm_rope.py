"""An attention site's q, k and v from their projections, in the attention's
layout: the qk RMS norms, RoPE and the text/latent concatenation in one pass.

What it computes, per slot (q, k or v of one site): the slot's sources
``[B, L_i, H * Dh]`` (the projections' outputs, text first), each
RMS-normalised in fp32 with its own gain and eps over the norm group the
gain's size names (one head, ``Dh``: miniFLUX and SD3; the whole token,
``H * Dh``: Wan), joined along the sequence, rotated by RoPE's interleaved
pairs in fp32 where the slot asks for it, and rounded once to
``[B, H, L_0 + L_1, Dh]``. A slot without norms (v) is a plain copy into
that layout.

Three versions:

* :func:`qk_norm_rope_composed`, what the attention modules ran before the
  kernel, and run still on the CPU and inside
  ``ops.composition.composition()``: the ``RMSNorm`` modules, ``torch.cat``
  and :func:`~.rope.apply_rope`, with a bf16 rounding after the norm;
  differentiable;
* :func:`qk_norm_rope_reference`, the kernel's plain version: the same
  arithmetic in fp32 with one final rounding;
* the CUDA kernel in ``csrc/qk_norm_rope.cu``, one launch per site for all
  of its slots, launched by :func:`qk_norm_rope_cuda`.

:func:`qkv_heads` is the attention modules' entry. On CUDA tensors it
launches the kernel, or raises: the kernel takes bf16 only and has no
backward. A caller that needs the differentiable chain on the card asks for
it by running inside ``ops.composition.composition()``: the train step (its
forwards and backward, a remat block's recompute included),
``capture_qk``'s telemetry, and reference forwards in fp32. On CPU tensors
it runs the composition, so the CPU runs as it did, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.cuda_build import load_library
from .composition import composing
from .rope import apply_rope

__all__ = ["Slot", "qkv_heads", "split_heads", "qk_norm_rope_composed",
           "qk_norm_rope_reference", "qk_norm_rope_cuda", "check_slots",
           "kernel_library", "QK_LAUNCHES"]

KERNEL_SOURCES = ("qk_norm_rope.cu",)
MAX_SLOTS = 3
VEC = 8  # features per thread of the kernel: one 16-byte load
MAX_WIDTH = 8 * 1024  # a token's features over a block's 1024 threads


class Slot(NamedTuple):
    """One output of a site: ``sources`` ``[B, L_i, H * Dh]``, text first;
    ``norms`` one RMS norm module per source (its ``weight`` the gain, of
    ``Dh`` or ``H * Dh`` entries, and ``eps``), or None for a plain copy;
    ``rope``: rotate by the site's cos/sin."""
    sources: Tuple[torch.Tensor, ...]
    norms: Optional[Tuple[torch.nn.Module, ...]] = None
    rope: bool = False


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, L, H * Dh]`` -> the view ``[B, H, L, Dh]``."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def qk_norm_rope_composed(slots: Sequence[Slot], num_heads: int, cos=None,
                          sin=None) -> List[torch.Tensor]:
    """The attention modules' own chain: each source's ``RMSNorm`` (over a
    head, after the split into heads; over the token, before it), rounded to
    the sources' dtype, ``torch.cat`` of two sources' heads, then
    :func:`~.rope.apply_rope`. Under autograd it is differentiable."""
    out = []
    for slot in slots:
        head_dim = slot.sources[0].shape[-1] // num_heads
        parts = []
        for i, src in enumerate(slot.sources):
            if slot.norms is None:
                parts.append(split_heads(src, num_heads))
            elif slot.norms[i].weight.shape[-1] == head_dim:
                parts.append(slot.norms[i](split_heads(src, num_heads)))
            else:
                parts.append(split_heads(slot.norms[i](src), num_heads))
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
        out.append(apply_rope(t, cos, sin) if slot.rope else t)
    return out


def qk_norm_rope_reference(slots: Sequence[Slot], num_heads: int, cos=None,
                           sin=None) -> List[torch.Tensor]:
    """The kernel's plain version: :func:`qk_norm_rope_composed` on the
    sources in fp32 (where the norms and RoPE round nothing), rounded once
    to the sources' dtype, contiguous ``[B, H, L, Dh]``."""
    check_slots(slots, num_heads, cos, sin)
    wide = [s._replace(sources=tuple(t.float() for t in s.sources))
            for s in slots]
    return [t.to(s.sources[0].dtype).contiguous() for s, t in zip(
        slots, qk_norm_rope_composed(wide, num_heads, cos, sin))]


def check_slots(slots: Sequence[Slot], num_heads: int, cos=None,
                sin=None) -> None:
    """Raise on slots the kernel does not take: 1-3 slots, each of 1-2
    ``[B, L_i, W]`` sources of one dtype and device with one B and W, bf16
    and contiguous for a CUDA launch; ``W`` a multiple of ``num_heads``,
    ``Dh = W / H`` a multiple of 8 (8 times a power of two up to 256 with
    per-head norms) and
    ``W`` at most 8192; a norm per source with a ``Dh`` or ``W`` wide gain
    in the sources' dtype; a rotated slot's cos/sin ``[B, L_0 + L_1, Dh /
    2]`` fp32 with contiguous rows."""
    if not 1 <= len(slots) <= MAX_SLOTS:
        raise ValueError(f"1 to {MAX_SLOTS} slots, got {len(slots)}")
    first = slots[0].sources[0]
    if first.dim() != 3:
        raise ValueError(f"sources must be [B, L, H * Dh], got "
                         f"{tuple(first.shape)}")
    b, _, width = first.shape
    if width % num_heads or (width // num_heads) % VEC or width > MAX_WIDTH:
        raise ValueError(f"width {width} over {num_heads} heads: the head "
                         f"dim must be a multiple of {VEC} and the width at "
                         f"most {MAX_WIDTH}")
    head_dim = width // num_heads
    cuda = first.is_cuda
    for slot in slots:
        if not 1 <= len(slot.sources) <= 2:
            raise ValueError(f"a slot takes 1 or 2 sources, got "
                             f"{len(slot.sources)}")
        if slot.norms is not None and len(slot.norms) != len(slot.sources):
            raise ValueError("one norm per source")
        if slot.rope and slot.norms is None:
            raise ValueError("a rotated slot is a normalised one")
        for i, src in enumerate(slot.sources):
            if src.dim() != 3 or src.shape[0] != b or src.shape[2] != width:
                raise ValueError(f"source {tuple(src.shape)} is not "
                                 f"[{b}, L, {width}]")
            if src.device != first.device or src.dtype != first.dtype:
                raise ValueError(f"sources differ in device or dtype: "
                                 f"{src.device} {src.dtype}, {first.device} "
                                 f"{first.dtype}")
            if cuda and src.dtype != torch.bfloat16:
                raise TypeError(f"the kernel takes bf16 sources, got "
                                f"{src.dtype}")
            if cuda and (not src.is_contiguous() or src.data_ptr() % 16):
                raise ValueError("sources must be contiguous and 16-byte "
                                 "aligned")
            if slot.norms is None:
                continue
            gain = slot.norms[i].weight
            if gain.shape != slot.norms[0].weight.shape:
                raise ValueError("a slot's gains share one norm group")
            if gain.shape not in ((head_dim,), (width,)):
                raise ValueError(f"gain {tuple(gain.shape)}: the norm group "
                                 f"is a head ({head_dim}) or the token "
                                 f"({width})")
            lanes = head_dim // VEC  # a head's threads, within one warp
            if gain.shape == (head_dim,) and (lanes > 32
                                              or lanes & (lanes - 1)):
                raise ValueError(f"per-head norms take a head dim of {VEC} "
                                 f"times a power of two, at most {32 * VEC}; "
                                 f"got {head_dim}")
            if gain.device != first.device or gain.dtype != first.dtype:
                raise TypeError(f"gain {gain.dtype} on {gain.device}; the "
                                f"sources {first.dtype} on {first.device}")
            if cuda and (not gain.is_contiguous() or gain.data_ptr() % 16):
                raise ValueError("gains must be contiguous and 16-byte "
                                 "aligned")
        if slot.rope:
            joint = sum(s.shape[1] for s in slot.sources)
            for name, t in (("cos", cos), ("sin", sin)):
                if t is None or t.shape != (b, joint, head_dim // 2):
                    raise ValueError(
                        f"{name} must be [{b}, {joint}, {head_dim // 2}], got "
                        f"{None if t is None else tuple(t.shape)}")
                if t.dtype != torch.float32 or t.device != first.device:
                    raise TypeError(f"{name} must be fp32 on {first.device}")
                if cuda and (t.stride(2) != 1 or t.stride(1) != head_dim // 2
                             or t.stride(0) % 4 or t.data_ptr() % 16):
                    raise ValueError(f"{name} rows must be contiguous and "
                                     f"16-byte aligned")
            if cos.stride() != sin.stride():
                raise ValueError("cos and sin must share their strides")


def qkv_heads(slots: Sequence[Slot], num_heads: int, cos=None, sin=None
              ) -> List[torch.Tensor]:
    """The site's slots as ``[B, H, L, Dh]``: on CUDA tensors the kernel,
    which raises on what it does not take; inside ``composition()`` or on
    the CPU, :func:`qk_norm_rope_composed`."""
    if composing() or not slots[0].sources[0].is_cuda:
        return qk_norm_rope_composed(slots, num_heads, cos, sin)
    return qk_norm_rope_cuda(slots, num_heads, cos, sin)


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    lib = load_library("qk_norm_rope", KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pf_qk_norm_rope.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, p,
                                    ctypes.c_longlong, p]
    lib.pf_qk_norm_rope.restype = ctypes.c_int
    return lib


def qk_norm_rope_cuda(slots: Sequence[Slot], num_heads: int, cos=None,
                      sin=None) -> List[torch.Tensor]:
    """Launch the kernel once for all ``slots``; returns their contiguous
    ``[B, H, L, Dh]`` outputs. ``qk_norm_rope_cuda.launches`` counts the
    launches; a call under CUDA-graph capture records the kernel without
    launching it and counts in ``.captured`` instead (whoever replays the
    graph adds its launches)."""
    check_slots(slots, num_heads, cos, sin)
    tensors = [t for s in slots for t in s.sources]
    tensors += [n.weight for s in slots if s.norms for n in s.norms]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the qk_norm_rope kernel has no backward: run the "
                           "forward without autograd, or inside "
                           "ops.composition.composition()")
    first = slots[0].sources[0]
    if first.device.type != "cuda":
        raise ValueError(f"qk_norm_rope_cuda takes CUDA tensors, got "
                         f"{first.device}")
    b, _, width = first.shape
    if b * sum(t.shape[1] for s in slots for t in s.sources) >= 2 ** 31:
        raise ValueError("more tokens than one grid holds")
    head_dim = width // num_heads
    n = MAX_SLOTS
    srcs, gains = (ctypes.c_void_p * (2 * n))(), (ctypes.c_void_p * (2 * n))()
    dsts = (ctypes.c_void_p * n)()
    lens, eps = (ctypes.c_int * (2 * n))(), (ctypes.c_float * (2 * n))()
    groups, ropes = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    outs = []
    for s, slot in enumerate(slots):
        joint = sum(t.shape[1] for t in slot.sources)
        out = torch.empty((b, num_heads, joint, head_dim), dtype=first.dtype,
                          device=first.device)
        outs.append(out)
        dsts[s] = out.data_ptr()
        for i, src in enumerate(slot.sources):
            srcs[2 * s + i], lens[2 * s + i] = src.data_ptr(), src.shape[1]
            if slot.norms is not None:
                gain = slot.norms[i].weight
                gains[2 * s + i] = gain.data_ptr()
                eps[2 * s + i] = slot.norms[i].eps
                groups[s] = gain.shape[0]
        ropes[s] = int(slot.rope)
    rotates = any(slot.rope for slot in slots)
    lib = kernel_library()
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pf_qk_norm_rope(
            srcs, gains, dsts, lens, eps, groups, ropes, len(slots), b, width,
            head_dim, cos.data_ptr() if rotates else None,
            sin.data_ptr() if rotates else None,
            cos.stride(0) if rotates else 0, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"qk_norm_rope kernel launch failed: CUDA error "
                           f"{err}")
    if capturing:
        qk_norm_rope_cuda.captured += 1
    else:
        qk_norm_rope_cuda.launches += 1
    return outs


qk_norm_rope_cuda.launches = 0
qk_norm_rope_cuda.captured = 0
# a span counter (``utils.profiling.span``): the kernel's launches
QK_LAUNCHES = {"qk_launches": lambda: qk_norm_rope_cuda.launches}
