// Flash-attention forward with time-id masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel_bounded` (bounded softmax) and
// `_fwd_kernel` (classic online softmax) of
// pyramid_flow_tpu/ops/flash_attention.py. The two are one kernel here; the
// template flag kBounded picks the softmax shift. What it computes, and the
// per-q-tile work, are in flash_fwd_tile.cuh (shared with the heads-per-block
// forward, flash_fwd_hn.cu); this file launches one block per
// (b, h, 64-row q-tile).
//
// Differences from the TPU kernels, none of which changes the result beyond
// rounding:
//   * The TPU kernel scales q by sm_scale * log2(e) in bf16 before q.k; this
//     kernel scales the fp32 scores instead.
//   * The TPU kernel gets l from a ones column appended to v; here l is summed
//     directly from the bf16-rounded p, which is the same sum.
//   * The TPU wrapper pads L to block multiples; this kernel masks the ragged
//     edge itself (rows past L load as zeros, keys past L count as INVALID).
//   * The TPU per-tile type table becomes block skipping: a k-tile is skipped
//     when no valid query (t_q != INVALID) of the q-tile can see any of its
//     keys. Every other tile is masked element by element.
//
// What bounds it on an H100: at head dim 64 the two products do 4 * 64 = 256
// flops per score, and each 64-key K/V tile a block loads (16 KiB) serves 64
// query rows, 64 flops per byte; every q-tile of a head reads the same tiles,
// so they mostly come from L2. The limit is the tensor cores plus the
// per-score exp2/mask work of the CUDA cores, not device memory. This first
// version keeps the design simple: one block
// of 4 warps per (b, h, 64-row q-tile), q fragments held in registers,
// synchronous 16-byte loads of each 64-key K/V tile into shared memory, bf16
// mma.sync.m16n8k16 with fp32 accumulation, and a loop over k-tiles in place
// of the TPU's sequential grid axis. It runs well below the tensor cores'
// peak (PERF.md has the measured rate): while a K/V tile loads, the tensor
// cores wait, and mma.sync cannot reach wgmma's rate. Faster variants (wgmma,
// TMA, a pipelined K/V ring, warp specialisation, unmasked fast tiles) build
// on the same contract.
//
// Entry point: pf_flash_fwd (plain C interface, bound with ctypes). It
// returns cudaGetLastError() after the launch.

#include "flash_fwd_tile.cuh"

namespace {

using pf::kBK;
using pf::kBQ;
using pf::kThreads;

template <int D, bool kBounded, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ time_q,
                 const int* __restrict__ time_kv,
                 const float* __restrict__ mb,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 int H, int Lq, int Lk, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * (D + 8)];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * (D + 8)];
  __shared__ int s_tk[kBK];
  __shared__ int s_qmax;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  pf::fwd_tile<D, kBounded, kCausal>(
      q + bh * Lq * D, k + bh * Lk * D, v + bh * Lk * D,
      time_q + static_cast<size_t>(b) * Lq,
      time_kv + static_cast<size_t>(b) * Lk, kBounded ? mb + bh * Lq : nullptr,
      o + bh * Lq * D, lse + bh * Lq, Lq, Lk, blockIdx.x * kBQ, scale_log2,
      Ks, Vs, s_tk, &s_qmax, threadIdx.x, threadIdx.x);
}

template <int D, bool kBounded, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* time_q,
           const void* time_kv, const void* mb, void* o, void* lse, int B,
           int H, int Lq, int Lk, float scale_log2, cudaStream_t stream) {
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D, kBounded, kCausal><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(time_q),
      static_cast<const int*>(time_kv), static_cast<const float*>(mb),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Lq, Lk,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(bool bounded, bool causal, const void* q, const void* k,
             const void* v, const void* time_q, const void* time_kv,
             const void* mb, void* o, void* lse, int B, int H, int Lq, int Lk,
             float scale_log2, cudaStream_t stream) {
  if (bounded) {
    return causal ? launch<D, true, true>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream)
                  : launch<D, true, false>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream);
  }
  return causal ? launch<D, false, true>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream)
                : launch<D, false, false>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream);
}

}  // namespace

// q, k, v, o: [B, H, L, D] bf16, contiguous. time_q [B, Lq], time_kv [B, Lk]
// int32. mb [B, H, Lq] fp32 (read only when bounded). lse [B, H, Lq] fp32.
// scale_log2 = sm_scale * log2(e). Returns a cudaError_t value (0 = success).
extern "C" int pf_flash_fwd(const void* q, const void* k, const void* v,
                            const void* time_q, const void* time_kv,
                            const void* mb, void* o, void* lse, int B, int H,
                            int Lq, int Lk, int D, float scale_log2,
                            int causal, int bounded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return dispatch<64>(bounded != 0, causal != 0, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
  }
  if (D == 128) {
    return dispatch<128>(bounded != 0, causal != 0, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
