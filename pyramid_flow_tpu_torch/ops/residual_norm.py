"""A DiT block's residual update and the LayerNorm after it, in one pass.

What it computes, on a stream ``x`` ``[B, L, D]`` (bf16 on miniFLUX and
SD3; fp32 on Wan, whose residual stream stays fp32): the residual ``x' = x
+ gate * y`` (``gate`` ``[B, 1, D]`` in the stream's dtype; ``x + y`` without
one; ``x`` itself without ``y``), then, when a :class:`Norm` is given,
``h = LN(x') * (1 + scale) + shift`` (adaLN's modulation, ``scale`` and
``shift`` ``[B, 1, D]``) or ``LN(x') * weight + bias`` (a LayerNorm's own
affine parameters). It returns ``(x', h)``, ``h`` None without a norm.

Three versions:

* :func:`residual_norm_composed`, what the blocks ran before the kernel, and
  run still on the CPU and inside ``ops.composition.composition()``: PyTorch's
  ``x + gate * y``, ``F.layer_norm`` on the stream upcast to fp32, the
  modulation in the stream's dtype, a cast; differentiable;
* :func:`residual_norm_reference`, the kernel's plain version: ``x'`` in
  fp32 rounded to the stream's dtype, the norm and modulation on it in fp32
  with one final rounding;
* the CUDA kernel in ``csrc/residual_norm.cu``, one launch per call,
  launched by :func:`residual_norm_cuda`.

:func:`residual_norm` is the blocks' entry. On CUDA tensors it launches the
kernel, or raises: the kernel writes ``h`` in bf16 and has no backward.
Inside ``ops.composition.composition()`` (the one switch for both fused
kernels: the train step, ``capture_qk``, fp32 reference forwards) and on
CPU tensors it runs the composition, so the CPU runs as it did, bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_library
from .composition import composing

__all__ = ["Norm", "residual_norm", "residual_norm_composed",
           "residual_norm_reference", "residual_norm_cuda", "check_operands",
           "kernel_library", "NORM_LAUNCHES"]

KERNEL_SOURCES = ("residual_norm.cu",)
VEC = 8  # features per vector of the kernel: one 16-byte bf16 load
MAX_WIDTH = 8 * 1024  # a row over a block's 128 threads, 8 vectors each


class Norm(NamedTuple):
    """The LayerNorm after the residual, over the last dim with ``eps``:
    ``LN(x) * (1 + scale) + shift``, ``scale`` and ``shift`` ``[B, 1, D]``
    in the stream's dtype (adaLN's modulation), or with ``affine``
    ``LN(x) * scale + shift``, a LayerNorm's own weight and bias ``[D]``."""
    shift: torch.Tensor
    scale: torch.Tensor
    eps: float = 1e-6
    affine: bool = False


def residual_norm_composed(x, y=None, gate=None, norm: Optional[Norm] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The blocks' own chain: ``x + gate * y`` in PyTorch's promotion, the
    LayerNorm of the stream upcast to fp32, the modulation in the stream's
    dtype (an affine norm stays fp32), then ``h`` cast to ``dtype`` when it
    is given. Under autograd it is differentiable."""
    if y is not None:
        x = x + (y if gate is None else gate * y)
    if norm is None:
        return x, None
    if norm.affine:
        h = F.layer_norm(x.float(), x.shape[-1:], norm.scale.float(),
                         norm.shift.float(), norm.eps)
    else:
        h = (F.layer_norm(x.float(), x.shape[-1:], eps=norm.eps).to(x.dtype)
             * (1 + norm.scale) + norm.shift)
    return x, h if dtype is None else h.to(dtype)


def residual_norm_reference(x, y=None, gate=None, norm: Optional[Norm] = None,
                            dtype: Optional[torch.dtype] = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's plain version: ``x'`` computed in fp32 (a product, then
    a sum) and rounded to the stream's dtype; the norm of that ``x'`` and
    its modulation in fp32, rounded once to ``dtype`` (the stream's when
    None); both contiguous."""
    check_operands(x, y, gate, norm, dtype)
    xf = x.float()
    if y is not None:
        yf = y.float()
        xf = xf + (yf if gate is None else gate.float() * yf)
    x_out = xf.to(x.dtype).contiguous()
    if norm is None:
        return x_out, None
    if norm.affine:
        h = F.layer_norm(x_out.float(), x.shape[-1:], norm.scale.float(),
                         norm.shift.float(), norm.eps)
    else:
        h = (F.layer_norm(x_out.float(), x.shape[-1:], eps=norm.eps)
             * (1 + norm.scale.float()) + norm.shift.float())
    return x_out, h.to(dtype or x.dtype).contiguous()


def _rows_ok(t: torch.Tensor) -> bool:
    """A ``[B, L, D]`` tensor whose rows lie contiguous, one after the
    other within a batch row, at 16-byte aligned addresses."""
    return (t.stride(2) == 1 and (t.shape[1] <= 1 or t.stride(1) == t.shape[2])
            and (t.stride(0) * t.element_size()) % 16 == 0
            and t.data_ptr() % 16 == 0)


def check_operands(x, y=None, gate=None, norm: Optional[Norm] = None,
                   dtype: Optional[torch.dtype] = None) -> None:
    """Raise on operands the kernel does not take: ``x`` ``[B, L, D]``, ``D``
    a multiple of 8 up to 8192; ``y`` of ``x``'s shape; ``gate`` (only with
    ``y``) and a modulation's ``scale`` and ``shift`` ``[B, 1, D]`` in ``x``'s
    dtype, an affine norm's ``[D]``; all on ``x``'s device; a residual, a
    norm or both. For a CUDA launch besides: ``x`` bf16 or fp32 with
    contiguous rows (its batch stride free), ``y`` bf16 and contiguous, an
    affine norm's weight and bias bf16, ``h`` (``dtype``, the stream's when
    None) bf16, and every operand 16-byte aligned."""
    if x.dim() != 3:
        raise ValueError(f"the stream must be [B, L, D], got {tuple(x.shape)}")
    b, _, width = x.shape
    if width % VEC or not VEC <= width <= MAX_WIDTH:
        raise ValueError(f"width {width}: a multiple of {VEC} up to "
                         f"{MAX_WIDTH}")
    if y is None and (gate is not None or norm is None):
        raise ValueError("a gate needs a residual, and a call needs a "
                         "residual or a norm")
    cuda = x.is_cuda
    if cuda and x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes a bf16 or fp32 stream, got "
                        f"{x.dtype}")
    if cuda and (dtype or x.dtype) != torch.bfloat16 and norm is not None:
        raise TypeError(f"the kernel writes h in bf16, asked for "
                        f"{dtype or x.dtype}")
    if cuda and not _rows_ok(x):
        raise ValueError("the stream's rows must be contiguous and 16-byte "
                         "aligned")
    if y is not None:
        if y.shape != x.shape or y.device != x.device:
            raise ValueError(f"y {tuple(y.shape)} on {y.device} is not the "
                             f"stream's {tuple(x.shape)} on {x.device}")
        if cuda and y.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes a bf16 y, got {y.dtype}")
        if cuda and (not y.is_contiguous() or y.data_ptr() % 16):
            raise ValueError("y must be contiguous and 16-byte aligned")
    vectors = [("gate", gate)] if gate is not None else []
    if norm is not None:
        vectors += [("shift", norm.shift), ("scale", norm.scale)]
    for name, t in vectors:
        affine = norm is not None and norm.affine and name != "gate"
        want = (width,) if affine else (b, 1, width)
        if tuple(t.shape) != want or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}: "
                             f"expected {want} on {x.device}")
        if not cuda:
            continue
        if t.dtype != (torch.bfloat16 if affine else x.dtype):
            raise TypeError(f"{name} is {t.dtype}; the kernel takes the "
                            f"stream's dtype ({x.dtype}), bf16 for an "
                            f"affine norm")
        if (t.stride(-1) != 1 or (not affine and (
                t.stride(0) * t.element_size()) % 16)
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must have contiguous, 16-byte "
                             f"aligned rows")


def residual_norm(x, y=None, gate=None, norm: Optional[Norm] = None,
                  dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(x + gate * y, h)``: on CUDA tensors the kernel, which raises on
    what it does not take; inside ``ops.composition.composition()`` or on the
    CPU, :func:`residual_norm_composed`."""
    if composing() or not x.is_cuda:
        return residual_norm_composed(x, y, gate, norm, dtype)
    return residual_norm_cuda(x, y, gate, norm, dtype)


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    lib = load_library("residual_norm", KERNEL_SOURCES)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pf_residual_norm.argtypes = [p, ll, i, p, p, ll, p, ll, p, ll, i, p,
                                     p, ctypes.c_float, i, i, i, p]
    lib.pf_residual_norm.restype = ctypes.c_int
    return lib


def residual_norm_cuda(x, y=None, gate=None, norm: Optional[Norm] = None,
                       dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel once; returns ``(x', h)``, each a fresh contiguous
    tensor (``x`` itself when there is no residual, ``h`` None without a
    norm). ``residual_norm_cuda.launches`` counts the launches; a call on a
    stream of no rows (a sequence-parallel rank's empty text shard) returns
    empty outputs and launches nothing; a call under CUDA-graph capture
    records the kernel without launching it and counts in ``.captured``
    instead (whoever replays the graph adds its launches)."""
    check_operands(x, y, gate, norm, dtype)
    operands = [x, y, gate] + ([norm.shift, norm.scale] if norm else [])
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError("the residual_norm kernel has no backward: run "
                           "the forward without autograd, or inside "
                           "ops.composition.composition()")
    if x.device.type != "cuda":
        raise ValueError(f"residual_norm_cuda takes CUDA tensors, got "
                         f"{x.device}")
    b, l, width = x.shape
    if b * l >= 2 ** 31:
        raise ValueError("more rows than one grid holds")
    out_x = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
        if y is not None else None
    h = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device) \
        if norm is not None else None
    if b * l == 0:
        return (x if out_x is None else out_x), h

    def ptr(t):
        return None if t is None else t.data_ptr()

    def batch(t):
        return 0 if t is None or t.dim() == 1 else t.stride(0)

    shift = None if norm is None else norm.shift
    scale = None if norm is None else norm.scale
    lib = kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pf_residual_norm(
            x.data_ptr(), x.stride(0), int(x.dtype == torch.float32), ptr(y),
            ptr(gate), batch(gate), ptr(scale), batch(scale), ptr(shift),
            batch(shift), int(norm is not None and norm.affine), ptr(out_x),
            ptr(h), norm.eps if norm is not None else 0.0, b, l, width,
            stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"residual_norm kernel launch failed: CUDA error "
                           f"{err}")
    if capturing:
        residual_norm_cuda.captured += 1
    else:
        residual_norm_cuda.launches += 1
    return (x if out_x is None else out_x), h


residual_norm_cuda.launches = 0
residual_norm_cuda.captured = 0
# a span counter (``utils.profiling.span``): the kernel's launches
NORM_LAUNCHES = {"norm_launches": lambda: residual_norm_cuda.launches}
