// The time-id tile rule shared by the TMA-fed attention kernels
// (flash_fwd.cu, flash_bwd.cu): the rule of the TPU's `_tile_types`, which
// a producer warp applies to each (q-tile, k-tile) pair before it loads
// anything, so that SKIP pairs are never loaded and FULL pairs run without
// the per-element mask.

#pragma once

namespace pf {

constexpr int kInvalidTime = 1 << 30;
enum : int { kSkip = 0, kFull = 1, kMasked = 2 };  // as TILE_* on the TPU

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The pair's type: qmin over the q-tile's rows (INVALID and rows past Lq
// included), qmax over its valid rows (-1 if none), kmin and kmax over the
// k-tile's keys (past Lk: INVALID). SKIP when no valid query can see a key
// of the k-tile; FULL when every query sees every key.
template <bool kCausal>
__device__ __forceinline__ int tile_type(int qmin, int qmax, int kmin, int kmax) {
  if (kCausal) {
    if (kmin > qmax) return kSkip;
    return kmax <= qmin ? kFull : kMasked;
  }
  if (kmin == kInvalidTime || qmax < 0) return kSkip;
  return kmax != kInvalidTime ? kFull : kMasked;
}

}  // namespace pf
