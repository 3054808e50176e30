"""Flash attention with temporal-causal time-id masking.

Every token carries an int32 time id. Text tokens have t=0; padding carries
``INVALID_TIME``. The mask is

  causal=True :  visible[q, k] = (time_k <= time_q) & (time_k != INVALID)
  causal=False:  visible[q, k] = (time_k != INVALID)

A query row with no visible key outputs zeros. Under ``causal`` a padded
query row (t = INVALID) sees every key; its output is unspecified, and
callers mask it downstream.

Two versions of one function live here:

* :func:`attention_reference`, the plain PyTorch version: fp32 scores, a
  masked softmax and an explicit zero for rows with no visible key.
* the CUDA kernel in ``csrc/flash_fwd.cu`` (bounded and classic softmax,
  head dims 64 and 128, bf16), launched by :func:`flash_fwd_cuda`.

:func:`flash_attention` takes the plain version only for CPU tensors. For a
CUDA tensor it launches the kernel, or raises if the kernel does not take
the input; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils.cuda_build import load_library

__all__ = ["flash_attention", "attention_reference", "flash_fwd_cuda",
           "INVALID_TIME"]

INVALID_TIME = 2**30
LOG2E = 1.4426950408889634
EMPTY_ROW_LSE = 3e38  # lse of a row with no visible key
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_SOURCES = ("flash_fwd.cu",)


def attention_reference(q, k, v, time_q, time_kv=None, *, causal=True,
                        sm_scale=None, return_lse=False):
    """Plain attention with the kernel's mask semantics.

    q, k, v: ``[B, H, L, D]``; time ids ``[B, L]``. Scores, softmax and the
    p.v product are fp32; the output has v's dtype. With ``return_lse`` also
    returns the natural-log ``lse`` ``[B, H, Lq]`` (fp32; ``3e38`` for rows
    with no visible key)."""
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    visible = (time_kv != INVALID_TIME)[:, None, None, :]
    if causal:
        visible = visible & (time_kv[:, None, None, :]
                             <= time_q[:, None, :, None])
    visible = visible.expand(s.shape)
    any_visible = visible.any(dim=-1, keepdim=True)
    # a row with no visible key would softmax to NaN: give it zero scores
    # here and zero probabilities below
    s = s.masked_fill(~visible & any_visible, float("-inf"))
    p = torch.softmax(s, dim=-1) * any_visible
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(v.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).masked_fill(~any_visible[..., 0],
                                                 EMPTY_ROW_LSE)
    return o, lse


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    lib = load_library("flash_fwd", KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pf_flash_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                 ctypes.c_float, i, i, p]
    lib.pf_flash_fwd.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, k, v, time_q, time_kv):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, D]")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != (b, h, lk, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if lq == 0 or lk == 0:
        raise ValueError("empty sequence")
    if time_q.shape != (b, lq) or time_kv.shape != (b, lk):
        raise ValueError("time ids must be [B, Lq] and [B, Lk]")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16),
                           ("time_q", time_q, torch.int32),
                           ("time_kv", time_kv, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"the flash kernel takes {name} as {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_fwd_cuda(q, k, v, time_q, time_kv, *, causal: bool,
                   sm_scale: float, bounded: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA forward kernel. Returns ``(o, lse)``.

    q, k, v ``[B, H, L, D]`` bf16 contiguous on one CUDA device, D in
    (64, 128); time ids ``[B, L]`` int32. ``bounded`` shifts the softmax by
    the per-row bound ``|q_i| * max|k| * sm_scale * log2(e) + 1`` (computed
    here in fp32 over all keys, padding included) instead of a running max;
    it is exact while the bound stays within ~120 log2 units of the true row
    max, which RMS-normalised q and k guarantee. ``flash_fwd_cuda.launches``
    counts the launches."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_cuda takes CUDA tensors, got {q.device}")
    _check_kernel_inputs(q, k, v, time_q, time_kv)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if bounded:
        qn = q.float().square().sum(-1).sqrt()
        kmax = k.float().square().sum(-1).sqrt().amax(-1, keepdim=True)
        mb = (qn * kmax * (sm_scale * LOG2E) + 1.0).contiguous()
    else:
        mb = None
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pf_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), time_q.data_ptr(),
            time_kv.data_ptr(), mb.data_ptr() if bounded else None,
            o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d,
            float(sm_scale * LOG2E), int(causal), int(bounded), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _fwd(q, k, v, time_q, time_kv, causal: bool, sm_scale: float,
         bounded: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the kernel for CUDA tensors, the plain version for CPU
    tensors. The plain version computes the same mathematical lse for both
    softmax forms."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, time_q, time_kv, causal=causal,
                                   sm_scale=sm_scale, return_lse=True)
    return flash_fwd_cuda(q, k, v, time_q, time_kv, causal=causal,
                          sm_scale=sm_scale, bounded=bounded)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    time_q: torch.Tensor,
                    time_kv: Optional[torch.Tensor] = None, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    bounded: Optional[bool] = None) -> torch.Tensor:
    """Flash attention with temporal-causal time-id masking.

    Args:
      q, k, v: ``[B, H, L, D]``.
      time_q: ``[B, Lq]`` int32 token times; ``INVALID_TIME`` marks padding.
      time_kv: ``[B, Lk]``; defaults to ``time_q`` (self-attention).
      causal: temporal-causal (``t_k <= t_q``) vs bidirectional-over-valid.
      bounded: the bounded-softmax form, for RMS-normalised q and k (the
        DiT passes True); the default is the classic online softmax.

    Returns ``[B, H, Lq, D]``; padded-query rows are unspecified.
    """
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    o, _ = _fwd(q, k, v, time_q, time_kv, causal, float(sm_scale),
                bool(bounded))
    return o
