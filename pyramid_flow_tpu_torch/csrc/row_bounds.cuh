// The bounded forward's per-row softmax shift, computed on the card just
// before the attention kernel that reads it (flash_fwd.cu, flash_fwd_hn.cu):
//
//   mb[b, h, i] = |q_i| * max_j |k_j| * scale_log2 + 1
//
// over all Lk keys of the head, padding included, with the squares of the
// bf16 values summed in fp32. One block per (b, h): its threads first take
// the largest squared key norm, then write the bound of every query row.
// D / 8 lanes share a row, each loading 16 bytes, so a warp reads 512
// contiguous bytes per load, and each thread keeps kUnroll loads in flight.
// The rows are read once; nothing is staged in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pf {

constexpr int kBoundThreads = 512;

// The sum of squares of the 8 bf16 values in one 16-byte word, in fp32.
__device__ __forceinline__ float sumsq8(uint4 w) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
  }
  return s;
}

// The sum of `s` over the kLanes aligned lanes of one row (every lane of
// the warp takes part).
template <int kLanes>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int D>
__global__ void __launch_bounds__(kBoundThreads)
row_bounds_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  float* __restrict__ mb, int Lq, int Lk, float scale_log2) {
  constexpr int kLanes = D / 8;                   // 16-byte words per row
  constexpr int kRows = kBoundThreads / kLanes;   // rows per load of the block
  constexpr int kUnroll = 4;
  const size_t bh = blockIdx.x;
  const uint4* kr = reinterpret_cast<const uint4*>(k) + bh * Lk * kLanes;
  const uint4* qr = reinterpret_cast<const uint4*>(q) + bh * Lq * kLanes;
  const int part = threadIdx.x % kLanes;
  const int row = threadIdx.x / kLanes;

  float kmax = 0.f;  // the largest squared key norm
  for (int base = 0; base < Lk; base += kRows * kUnroll) {
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * kRows + row;
      s[u] = r < Lk ? sumsq8(__ldg(kr + static_cast<size_t>(r) * kLanes + part)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) kmax = fmaxf(kmax, row_sum<kLanes>(s[u]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) kmax = fmaxf(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
  __shared__ float warp_max[kBoundThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = kmax;
  __syncthreads();
  kmax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kBoundThreads / 32; ++w) kmax = fmaxf(kmax, warp_max[w]);
  const float kscale = sqrtf(kmax) * scale_log2;

  for (int base = 0; base < Lq; base += kRows * kUnroll) {
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * kRows + row;
      s[u] = r < Lq ? sumsq8(__ldg(qr + static_cast<size_t>(r) * kLanes + part)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float ss = row_sum<kLanes>(s[u]);
      const int r = base + u * kRows + row;
      if (part == 0 && r < Lq) mb[bh * Lq + r] = fmaf(sqrtf(ss), kscale, 1.f);
    }
  }
}

// Writes the bounds of q, k [BH, L, D] bf16 into mb [BH, Lq] fp32 on
// `stream`. Returns a cudaError_t value (0 = success).
template <int D>
int launch_row_bounds(const void* q, const void* k, void* mb, int BH, int Lq, int Lk,
                      float scale_log2, cudaStream_t stream) {
  row_bounds_kernel<D><<<BH, kBoundThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(mb), Lq, Lk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pf
