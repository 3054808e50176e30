"""The causal VAE's 3x3x3 stride-1 convolution.

What it computes, for ``x`` ``[B, T, H, W, C]`` (channels-last, the JAX
package's layout) and the Conv3d ``weight`` ``[Co, C, 3, 3, 3]``: a conv that
is causal in time (two frames in front of ``x``: zeros, or the carried
``front`` ``[B, 2, H, W, C]`` of a streaming window), SAME (zero) padded in
space, plus ``bias`` ``[Co]``. Out: ``[B, T, H, W, Co]``.

Two versions:

* :func:`causal_conv3d_reference`, the plain PyTorch version: the sum of the
  27 shifted taps' matmuls in fp32, which is what the TPU kernel's body
  computes;
* the CUDA kernel in ``csrc/causal_conv3d.cu``, an implicit GEMM for Hopper
  (TMA-fed, warp-specialised ``wgmma``, bf16 products and fp32 sums) over
  16 x 16-pixel tiles that reads the front frames from their own tensor and
  skips the taps before the first frame when there are none, launched by
  :func:`causal_conv3d_cuda`.

The gradient: :func:`causal_conv3d_backward` is the plain backward, over the
front-padded input with SAME padding in space (``torch.nn.grad``'s
``conv3d_input`` and ``conv3d_weight`` on channels-last tensors, and the sum
of ``dy`` for the bias). The JAX VAE's conv has no Pallas backward (XLA
differentiates its convs), so there is no TPU kernel to port here.
:class:`CausalConv3dFunction` launches the kernel forward and takes that
backward, so a conv routed to the kernel passes gradients to ``x``, the
front frames, the weight and the bias.

:func:`supports_kernel` is the one rule for which convs the kernel takes,
given the dtype the conv computes in (:func:`compute_dtype`: CUDA autocast's
dtype while it is on for a CUDA weight, else the weight's), so an fp32
master weight under bf16 autocast is admitted as a bf16 one is.
:func:`causal_conv3d` takes the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel, or raises if the kernel does not take the
input. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_library

__all__ = ["causal_conv3d", "causal_conv3d_reference", "causal_conv3d_cuda",
           "causal_conv3d_backward", "CausalConv3dFunction",
           "supports_kernel", "compute_dtype", "kernel_library", "TILE_K",
           "TILE_N"]

KERNEL_SOURCES = ("causal_conv3d.cu",)
TILE_K = 64   # input channels per K step of the kernel (one 128-byte row)
TILE_N = 128  # output channels per block


def supports_kernel(in_channels: int, out_channels: int,
                    kernel_size: Sequence[int], stride: Sequence[int],
                    dtype: torch.dtype) -> bool:
    """Whether the kernel computes this conv: 3x3x3, stride 1, computing in
    bf16 (``dtype``, see :func:`compute_dtype`), input channels a multiple
    of ``TILE_K`` and output channels of ``TILE_N``. On the release VAE that
    is every resnet, mid-block and upsampler conv; the 3-, 16- and
    32-channel ends and the strided downsamplers are not."""
    return (tuple(kernel_size) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
            and dtype == torch.bfloat16 and in_channels % TILE_K == 0
            and out_channels % TILE_N == 0)


def compute_dtype(weight: torch.Tensor) -> torch.dtype:
    """The dtype a conv with this weight computes in: CUDA autocast's while
    it is on and the weight is on a CUDA device, else the weight's own (a
    CPU conv computes as before, whatever CUDA autocast says)."""
    if weight.is_cuda and torch.is_autocast_enabled("cuda"):
        return torch.get_autocast_dtype("cuda")
    return weight.dtype


def _check_shapes(x, weight, bias, front):
    if x.dim() != 5:
        raise ValueError(f"x must be [B, T, H, W, C], got {tuple(x.shape)}")
    b, _, h, w, c = x.shape
    if weight.dim() != 5 or weight.shape[1:] != (c, 3, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not [Co, {c}, 3, "
                         "3, 3]")
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match weight")
    if front is not None and front.shape != (b, 2, h, w, c):
        raise ValueError(f"front {tuple(front.shape)} is not "
                         f"{(b, 2, h, w, c)}")


def causal_conv3d_reference(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor,
                            front: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain version: 27 shifted-tap matmuls summed in fp32 (fp64 for
    fp64 inputs), plus the bias; the result in ``x``'s dtype."""
    _check_shapes(x, weight, bias, front)
    b, t, h, w, c = x.shape
    if front is None:
        front = x.new_zeros((b, 2, h, w, c))
    acc = torch.promote_types(x.dtype, torch.float32)
    with torch.autocast(x.device.type, enabled=False):
        xp = torch.cat([front.to(x.dtype), x], dim=1).to(acc)
        xp = F.pad(xp, (0, 0, 1, 1, 1, 1))  # SAME: one pixel in W and H
        wf = weight.to(acc)
        out = bias.to(acc).expand(b, t, h, w, -1).clone()
        for kt in range(3):
            for kh in range(3):
                for kw in range(3):
                    out += torch.matmul(
                        xp[:, kt:kt + t, kh:kh + h, kw:kw + w],
                        wf[:, :, kt, kh, kw].t())
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built and loaded conv kernel library (built on first call)."""
    lib = load_library("causal_conv3d", KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pf_causal_conv3d.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.pf_causal_conv3d.restype = ctypes.c_int
    return lib


def causal_conv3d_cuda(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor,
                       front: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel. ``x`` and ``front`` bf16 contiguous
    channels-last, ``weight`` bf16 in ``torch.channels_last_3d`` (physically
    ``[Co, 3, 3, 3, C]``), ``bias`` any float dtype (the kernel adds it in
    fp32). ``causal_conv3d_cuda.launches`` counts the launches."""
    _check_shapes(x, weight, bias, front)
    b, t, h, w, c = x.shape
    co = weight.shape[0]
    if not supports_kernel(c, co, weight.shape[2:], (1, 1, 1), x.dtype):
        raise ValueError(f"the conv kernel takes bf16 with input channels a "
                         f"multiple of {TILE_K} and output channels of "
                         f"{TILE_N}; got {x.dtype}, {c} -> {co}")
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv3d_cuda takes CUDA tensors, got "
                         f"{x.device}")
    tensors = [("x", x, torch.contiguous_format), ("weight", weight,
                                                   torch.channels_last_3d)]
    if front is not None:
        tensors.append(("front", front, torch.contiguous_format))
    for name, tensor, fmt in tensors:
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on {x.device}")
        if tensor.dtype != torch.bfloat16:
            raise TypeError(f"the conv kernel takes {name} as bf16, got "
                            f"{tensor.dtype}")
        if not tensor.is_contiguous(memory_format=fmt):
            raise ValueError(f"{name} must be contiguous in {fmt}")
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((b, t, h, w, co), dtype=x.dtype, device=x.device)
    lib = kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pf_causal_conv3d(
            x.data_ptr(), front.data_ptr() if front is not None else None,
            weight.data_ptr(), bias32.data_ptr(), y.data_ptr(), b, t, h, w,
            c, co, stream)
    if err != 0:
        raise RuntimeError(f"causal_conv3d kernel launch failed: CUDA error "
                           f"{err}")
    causal_conv3d_cuda.launches += 1
    return y


causal_conv3d_cuda.launches = 0


def causal_conv3d_backward(x: torch.Tensor, weight: torch.Tensor,
                           front: Optional[torch.Tensor], dy: torch.Tensor, *,
                           input_grad: bool = True, weight_grad: bool = True):
    """The plain gradient of the causal conv, ``(dx, dfront, dweight,
    dbias)``, for ``dy`` ``[B, T, H, W, Co]``.

    The conv is a valid conv in time and a SAME conv in space over the
    front-padded input ``cat(front or zeros, x)``, so ``torch.nn.grad``'s
    ``conv3d_input`` and ``conv3d_weight`` with padding ``(0, 1, 1)`` give
    that input's gradient, sliced back into ``dfront`` (None without
    ``front``) and ``dx``, and the weight's, in the weight's memory layout;
    ``dbias`` is the sum of ``dy`` (fp32 sums, in ``dy``'s dtype). The
    tensors go to the convolutions as channels-last views, without copies.
    ``input_grad=False`` or ``weight_grad=False`` leaves those gradients
    None."""
    b, t, h, w, c = x.shape
    if dy.shape != (b, t, h, w, weight.shape[0]):
        raise ValueError(f"dy {tuple(dy.shape)} does not match the output "
                         f"{(b, t, h, w, weight.shape[0])}")
    dy_ncdhw = dy.contiguous().permute(0, 4, 1, 2, 3)
    xp = torch.cat([x.new_zeros((b, 2, h, w, c)) if front is None
                    else front.to(x.dtype), x], dim=1)
    dx = dfront = dweight = None
    if input_grad:
        dxp = torch.nn.grad.conv3d_input(
            (b, c, t + 2, h, w), weight, dy_ncdhw, padding=(0, 1, 1))
        dxp = dxp.permute(0, 2, 3, 4, 1)
        dx = dxp[:, 2:].contiguous()
        if front is not None:
            dfront = dxp[:, :2].contiguous()
    if weight_grad:
        fmt = (torch.channels_last_3d if weight.is_contiguous(
            memory_format=torch.channels_last_3d) else torch.contiguous_format)
        dweight = torch.nn.grad.conv3d_weight(
            xp.permute(0, 4, 1, 2, 3), weight.shape, dy_ncdhw,
            padding=(0, 1, 1)).contiguous(memory_format=fmt)
    dbias = dy.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(dy.dtype)
    return dx, dfront, dweight, dbias


class CausalConv3dFunction(torch.autograd.Function):
    """The kernel forward with the plain gradient: ``forward`` launches K5
    through :func:`causal_conv3d_cuda` (its checks, raises and launch
    counter), ``backward`` is :func:`causal_conv3d_backward`. Under
    ``torch.no_grad`` nothing is saved.

    ``apply(x, weight, bias, front)``; ``front`` may be None."""

    @staticmethod
    def forward(ctx, x, weight, bias, front):
        y = causal_conv3d_cuda(x, weight, bias, front)
        ctx.save_for_backward(x, weight, front)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, front = ctx.saved_tensors
        need_x, need_w, need_b, need_f = ctx.needs_input_grad
        dx, dfront, dweight, dbias = causal_conv3d_backward(
            x, weight, front, dy, input_grad=need_x or need_f,
            weight_grad=need_w)
        return (dx if need_x else None, dweight,
                dbias.to(ctx.bias_dtype) if need_b else None,
                dfront if need_f else None)


def causal_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  front: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The causal 3x3x3 stride-1 conv, differentiable in every input: the
    plain version under autograd for CPU tensors, the kernel with the plain
    gradient (:class:`CausalConv3dFunction`) for CUDA tensors, or an error
    if the kernel does not take them."""
    if x.device.type == "cpu":
        return causal_conv3d_reference(x, weight, bias, front)
    return CausalConv3dFunction.apply(x, weight, bias, front)
