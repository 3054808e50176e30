"""Flash attention with temporal-causal time-id masking.

Every token carries an int32 time id. Text tokens have t=0; padding carries
``INVALID_TIME``. The mask is

  causal=True :  visible[q, k] = (time_k <= time_q) & (time_k != INVALID)
  causal=False:  visible[q, k] = (time_k != INVALID)

A query row with no visible key outputs zeros. Under ``causal`` a padded
query row (t = INVALID) sees every key; its output is unspecified, and
callers mask it downstream.

Two versions of the forward and of the backward live here:

* :func:`attention_reference` and :func:`attention_backward_reference`, the
  plain PyTorch versions in fp32: a masked softmax with an explicit zero for
  rows with no visible key, and the gradient recomputed from the saved lse;
* the CUDA kernels in ``csrc/flash_fwd.cu`` (bounded and classic softmax)
  and ``csrc/flash_bwd.cu`` (delta, then dK/dV and dQ), TMA-fed and
  warp-specialised ``wgmma`` for Hopper, each of which classifies its
  tiles by :func:`tile_types`' rule (64-row by 128-key tiles in the
  forward, 64 by 64 in the backward), head dims 64 and 128, bf16,
  launched by :func:`flash_fwd_cuda` and :func:`flash_bwd_cuda`.

A third forward, ``csrc/flash_fwd_hn.cu`` (:func:`flash_fwd_hn_cuda`), is
the bounded forward with ``hs`` heads per block, head dim 64: the forward
kernel's block (``csrc/flash_fwd_block.cuh``) with one consumer warpgroup
per head and one producer for all of them, so each head's output is the
one-head kernel's, bit for bit. Only the ``tools/exp_flash_h2`` experiment
runs it, and its plain version is ``attention_reference(...,
return_lse=True)``.

:func:`flash_attention` is differentiable through
:class:`FlashAttentionFunction`, the counterpart of the JAX package's
``_flash`` custom VJP. It takes the plain versions only for CPU tensors. For
a CUDA tensor it launches the kernels, or raises if a kernel does not take
the input; it never falls back.

The backward's contract, as on the TPU: a padded query row (t = INVALID)
carries a zero upstream gradient. Under ``causal`` such a row sees every
key, so a nonzero gradient there would leak into dK and dV.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils.cuda_build import load_library

__all__ = ["flash_attention", "attention_reference",
           "attention_backward_reference", "bounded_softmax_overshoot",
           "flash_fwd_cuda", "flash_bwd_cuda", "flash_fwd_hn_cuda",
           "flash_fwd_hn_resources", "FlashAttentionFunction", "tile_types",
           "INVALID_TIME", "TILE_SKIP", "TILE_FULL", "TILE_MASKED",
           "FWD_TILE_Q", "FWD_TILE_K", "FORWARD_LAUNCHES"]

INVALID_TIME = 2**30
LOG2E = 1.4426950408889634
EMPTY_ROW_LSE = 3e38  # lse of a row with no visible key
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_SOURCES = ("flash_fwd.cu",)
BWD_KERNEL_SOURCES = ("flash_bwd.cu",)
HN_KERNEL_SOURCES = ("flash_fwd_hn.cu",)
HN_HEADS_PER_BLOCK = (1, 2, 3, 4, 6)  # the hs values the kernel is built for
WARPGROUP = 128  # threads of a block's producer, and of each head's consumer
# tile types, as the JAX package's TILE_*
TILE_SKIP, TILE_FULL, TILE_MASKED = 0, 1, 2
# the forward kernel's tiles: query rows per block, keys per k-tile
FWD_TILE_Q, FWD_TILE_K = 64, 128


def tile_types(time_q: torch.Tensor, time_kv: torch.Tensor, bq: int, bk: int,
               causal: bool) -> torch.Tensor:
    """``[B, Lq]``, ``[B, Lk]`` time ids -> ``[B, ceil(Lq / bq), ceil(Lk /
    bk)]`` int32 tile types: ``TILE_SKIP`` (no key of the k-tile is visible
    to a valid query of the q-tile), ``TILE_FULL`` (every key visible to
    every query: no mask) or ``TILE_MASKED``. The rule of the JAX package's
    ``_tile_types``, with the ragged edges padded with ``INVALID_TIME`` as the
    TPU wrapper pads them; the forward kernel applies it to each (64-row,
    128-key) tile, ``bq = FWD_TILE_Q`` and ``bk = FWD_TILE_K``."""
    def tiles(t, size):
        pad = -t.shape[1] % size
        t = torch.cat([t, t.new_full((t.shape[0], pad), INVALID_TIME)], 1)
        return t.reshape(t.shape[0], -1, size)

    tq, tk = tiles(time_q, bq), tiles(time_kv, bk)
    qmin = tq.amin(-1)[:, :, None]
    qmax_valid = torch.where(tq == INVALID_TIME, -1, tq).amax(-1)[:, :, None]
    kmin, kmax = tk.amin(-1)[:, None, :], tk.amax(-1)[:, None, :]
    if causal:
        skip = kmin > qmax_valid
        full = kmax <= qmin
    else:
        skip = (kmin == INVALID_TIME) | (qmax_valid < 0)
        full = (kmax != INVALID_TIME).expand_as(skip)
    return torch.where(skip, TILE_SKIP,
                       torch.where(full, TILE_FULL, TILE_MASKED)).int()


def attention_reference(q, k, v, time_q, time_kv=None, *, causal=True,
                        sm_scale=None, return_lse=False):
    """Plain attention with the kernel's mask semantics.

    q, k, v: ``[B, H, L, D]``; time ids ``[B, L]``. Scores, softmax and the
    p.v product are fp32; the output has v's dtype. With ``return_lse`` also
    returns the natural-log ``lse`` ``[B, H, Lq]`` (fp32; ``3e38`` for rows
    with no visible key). Autocast is off inside, so the fp32 math stays fp32
    in a bf16 autocast region."""
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        return _attention_reference(q, k, v, time_q, time_kv, causal,
                                    sm_scale, return_lse)


def _attention_reference(q, k, v, time_q, time_kv, causal, sm_scale,
                         return_lse):
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


def attention_backward_reference(q, k, v, time_q, time_kv, o, lse, do, *,
                                 causal=True, sm_scale=None):
    """Plain gradient of attention, with the backward kernels' semantics.

    All inputs ``[B, H, L, D]`` (time ids ``[B, L]``, ``lse`` ``[B, H, Lq]``
    from the forward). fp32 math: ``p = exp(s - lse)`` where the mask holds
    (``tk <= tq`` causal, ``tk != INVALID`` otherwise), so rows with
    ``lse = 3e38`` get ``p = 0``; ``delta = rowsum(o * do)``; ``ds = p * (dp
    - delta) * sm_scale``. Returns ``(dq, dk, dv)`` in the dtypes of q, k, v.
    """
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
        if causal:
            mask = time_kv[:, None, None, :] <= time_q[:, None, :, None]
        else:
            mask = (time_kv != INVALID_TIME)[:, None, None, :]
        p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
        delta = (of * dof).sum(-1, keepdim=True)
        ds = p * (dp - delta) * sm_scale
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bounded_softmax_overshoot(q, k, time_q, time_kv=None, *, causal=True,
                              sm_scale=None, chunk=256) -> torch.Tensor:
    """Max over valid query rows of ``bound - true_max_score`` in log2
    units, the slack of the bounded forward's shift (exact while it stays
    well under ~120). Plain torch in fp32, ``chunk`` query rows at a time so
    the score matrix never materialises at real sequence lengths. Returns a
    0-dim fp32 tensor."""
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        q32, k32 = q.float(), k.float()
        qn = q32.square().sum(-1).sqrt()
        kmax = k32.square().sum(-1).sqrt().amax(-1, keepdim=True)
        mb = qn * kmax * (sm_scale * LOG2E) + 1.0
        vis_k = (time_kv != INVALID_TIME)[:, None, None, :]
        worst = torch.tensor(float("-inf"), device=q.device)
        for i in range(0, q.shape[2], chunk):
            ti = time_q[:, i:i + chunk]
            s = torch.einsum("bhqd,bhkd->bhqk", q32[:, :, i:i + chunk],
                             k32) * (sm_scale * LOG2E)
            vis = vis_k
            if causal:
                vis = vis & (time_kv[:, None, None, :] <= ti[:, None, :, None])
            smax = s.masked_fill(~vis, float("-inf")).amax(-1)
            valid_q = (ti != INVALID_TIME)[:, None, :]
            over = (mb[:, :, i:i + chunk] - smax).masked_fill(
                ~valid_q, float("-inf"))
            worst = torch.maximum(worst, over.amax())
    return worst


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built and loaded forward kernel library (built on first call)."""
    lib = load_library("flash_fwd", KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pf_flash_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                 ctypes.c_float, i, i, p]
    lib.pf_flash_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_kernel_library() -> ctypes.CDLL:
    """The built and loaded backward kernel library (built on first call)."""
    lib = load_library("flash_bwd", BWD_KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pf_flash_bwd.argtypes = [p] * 12 + [i] * 5 + [ctypes.c_float, i, p]
    lib.pf_flash_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def hn_kernel_library() -> ctypes.CDLL:
    """The built and loaded heads-per-block forward library (built on first
    call)."""
    lib = load_library("flash_fwd_hn", HN_KERNEL_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pf_flash_fwd_hn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                    ctypes.c_float, i, i, p]
    lib.pf_flash_fwd_hn.restype = ctypes.c_int
    lib.pf_flash_fwd_hn_info.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.pf_flash_fwd_hn_info.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def flash_fwd_hn_resources(hs: int, causal: bool = True) -> dict:
    """What a block of the heads-per-block forward needs and what the card
    gives, read from the built kernel of (hs, causal): ``registers`` per
    thread at launch, ``threads`` per block (128 * (hs + 1): a consumer
    warpgroup per head and the producer's), ``max_threads`` (the most a
    block of this kernel can launch with at its registers),
    ``shared_bytes`` (static plus dynamic) and ``shared_limit`` (the card's
    opt-in limit per block). ``fits`` says whether a block can launch."""
    if hs not in HN_HEADS_PER_BLOCK:
        raise ValueError(f"the heads-per-block forward is built for hs in "
                         f"{HN_HEADS_PER_BLOCK}, got {hs}")
    info = (ctypes.c_int * 5)()
    err = hn_kernel_library().pf_flash_fwd_hn_info(hs, int(causal), info)
    if err != 0:
        raise RuntimeError(f"flash_fwd_hn info failed: CUDA error {err}")
    regs, max_threads, static, dynamic, limit = info
    threads = WARPGROUP * (hs + 1)
    return dict(hs=hs, registers=regs, threads=threads,
                max_threads=max_threads, shared_bytes=static + dynamic,
                shared_limit=limit,
                fits=threads <= max_threads and static + dynamic <= limit)


def _check_tensors(ref, specs):
    """Each ``(name, tensor, dtype)`` on ``ref``'s device, of ``dtype``,
    contiguous and 16-byte aligned."""
    for name, t, dtype in specs:
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, q on {ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"the flash kernel takes {name} as {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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
    _check_tensors(q, (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                       ("v", v, torch.bfloat16),
                       ("time_q", time_q, torch.int32),
                       ("time_kv", time_kv, torch.int32)))


def flash_fwd_cuda(q, k, v, time_q, time_kv, *, causal: bool,
                   sm_scale: float, bounded: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA forward kernel. Returns ``(o, lse)``.

    q, k, v ``[B, H, L, D]`` bf16 contiguous on one CUDA device, D in
    (64, 128); time ids ``[B, L]`` int32. ``bounded`` shifts the softmax by
    the per-row bound ``|q_i| * max|k| * sm_scale * log2(e) + 1`` (fp32 sums
    over all keys, padding included, computed on the card by the library
    just before the kernel) instead of a running max;
    it is exact while the bound stays within ~120 log2 units of the true row
    max, which RMS-normalised q and k guarantee. ``flash_fwd_cuda.launches``
    counts the launches of both forms, ``.classic_launches`` those of the
    classic one."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_cuda takes CUDA tensors, got {q.device}")
    _check_kernel_inputs(q, k, v, time_q, time_kv)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    # the bounded form's row bounds, which the library writes and then reads
    mb = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
          if bounded else None)
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
    flash_fwd_cuda.classic_launches += not bounded
    return o, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.classic_launches = 0
# a span counter (``utils.profiling.span``): the flash forward's launches
FORWARD_LAUNCHES = {"attn_launches": lambda: flash_fwd_cuda.launches}


def flash_fwd_hn_cuda(q, k, v, time_q, time_kv, *, causal: bool,
                      sm_scale: float, hs: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bounded forward with ``hs`` heads per block. Returns
    ``(o, lse)``, as ``flash_fwd_cuda(..., bounded=True)``.

    q, k, v ``[B, H, L, 64]`` bf16 contiguous on one CUDA device, ``H`` a
    multiple of ``hs``; time ids ``[B, L]`` int32. An ``hs`` whose block
    does not fit the card (:func:`flash_fwd_hn_resources`) is refused before
    any launch. ``flash_fwd_hn_cuda.launches`` counts the launches."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_hn_cuda takes CUDA tensors, got "
                         f"{q.device}")
    _check_kernel_inputs(q, k, v, time_q, time_kv)
    b, h, lq, d = q.shape
    if d != 64:
        raise ValueError(f"the heads-per-block forward takes head dim 64, "
                         f"got {d}")
    if h % hs:
        raise ValueError(f"{h} heads do not split into blocks of hs={hs}")
    res = flash_fwd_hn_resources(hs, bool(causal))
    if not res["fits"]:
        raise ValueError(
            f"hs={hs} does not fit: a block of {res['threads']} threads at "
            f"{res['registers']} registers each can launch with at most "
            f"{res['max_threads']} threads, and needs {res['shared_bytes']} "
            f"of {res['shared_limit']} bytes of shared memory")
    mb = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = hn_kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pf_flash_fwd_hn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), time_q.data_ptr(),
            time_kv.data_ptr(), mb.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, lq, k.shape[2], float(sm_scale * LOG2E), int(causal), hs,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_hn kernel launch failed: CUDA error "
                           f"{err}")
    flash_fwd_hn_cuda.launches += 1
    return o, lse


flash_fwd_hn_cuda.launches = 0


def flash_bwd_cuda(q, k, v, time_q, time_kv, o, lse, do, *,
                   causal: bool, sm_scale: float,
                   delta: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA backward. Returns ``(dq, dk, dv)``.

    q, k, v, o, do ``[B, H, L, D]`` bf16 contiguous on one CUDA device, D in
    (64, 128); time ids ``[B, L]`` int32; ``lse`` ``[B, H, Lq]`` fp32, the
    forward's (natural log). Padded query rows must carry ``do = 0``. The
    library computes ``delta = rowsum(o * do)`` on the card, then launches
    the dK/dV kernel and the dQ kernel; ``delta``, a ``[B, H, Lq]`` fp32
    tensor, receives it if given (scratch otherwise).
    ``flash_bwd_cuda.dkv_launches`` and ``.dq_launches`` count the launches
    of the two."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_cuda takes CUDA tensors, got {q.device}")
    _check_kernel_inputs(q, k, v, time_q, time_kv)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if lse.shape != (b, h, lq):
        raise ValueError("lse must be [B, H, Lq]")
    if delta is None:
        delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if delta.shape != (b, h, lq):
        raise ValueError("delta must be [B, H, Lq]")
    _check_tensors(q, (("o", o, torch.bfloat16), ("do", do, torch.bfloat16),
                       ("lse", lse, torch.float32),
                       ("delta", delta, torch.float32)))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = bwd_kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pf_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), time_q.data_ptr(), time_kv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, lq, lk, d, float(sm_scale), int(causal),
            stream)
    if err != 0:
        why = {-1: "sizes refused", -2: "tensor map refused"}.get(
            err, f"CUDA error {err}")
        raise RuntimeError(f"flash_bwd kernel launch failed: {why}")
    flash_bwd_cuda.dkv_launches += 1
    flash_bwd_cuda.dq_launches += 1
    return dq, dk, dv


flash_bwd_cuda.dkv_launches = 0
flash_bwd_cuda.dq_launches = 0


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


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its gradient, the counterpart of JAX's ``_flash``
    custom VJP: the forward saves ``(q, k, v, time_q, time_kv, o, lse)``,
    the backward recomputes the probabilities from ``lse``. One backward
    serves the bounded and the classic forward, whose lse is the same
    number. CPU tensors take the plain versions, CUDA tensors the kernels.

    ``apply(q, k, v, time_q, time_kv, causal, sm_scale, bounded)``."""

    @staticmethod
    def forward(ctx, q, k, v, time_q, time_kv, causal, sm_scale, bounded):
        o, lse = _fwd(q, k, v, time_q, time_kv, causal, sm_scale, bounded)
        ctx.save_for_backward(q, k, v, time_q, time_kv, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, time_q, time_kv, o, lse = ctx.saved_tensors
        do = do.contiguous()  # arrives strided from the heads transpose
        if q.device.type == "cpu":
            dq, dk, dv = attention_backward_reference(
                q, k, v, time_q, time_kv, o, lse, do, causal=ctx.causal,
                sm_scale=ctx.sm_scale)
        else:
            dq, dk, dv = flash_bwd_cuda(
                q, k, v, time_q, time_kv, o, lse, do, causal=ctx.causal,
                sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None, None


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

    Returns ``[B, H, Lq, D]``; padded-query rows are unspecified and must
    carry a zero gradient. Differentiable in q, k and v.
    """
    if time_kv is None:
        time_kv = time_q
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttentionFunction.apply(q, k, v, time_q, time_kv,
                                        bool(causal), float(sm_scale),
                                        bool(bounded))
