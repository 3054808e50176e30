// Flash-attention forward with time-id masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel_bounded` (bounded softmax) and
// `_fwd_kernel` (classic online softmax) of
// pyramid_flow_tpu/ops/flash_attention.py. The two are one kernel here; the
// template flag kBounded picks the softmax shift. What it computes, and the
// design of its block, are in flash_fwd_block.cuh: this kernel is that block
// with one head per block (one consumer warpgroup and one producer
// warpgroup, of which one warp works), 128-key tiles in a ring of 3 stages,
// and two blocks per SM.
//   * 64-row q-tiles give short layouts (stage 0) enough blocks to fill
//     the card, and two blocks per SM overlap one block's exp2 with the
//     other's products. (Blocks of two consumer warpgroups on the 128 rows
//     of one head, one block per SM, ran slower on the card.)
//
// Differences from the TPU kernels, none of which changes the result beyond
// rounding: q is not pre-scaled in bf16 (the fp32 scores are scaled); l is
// summed from the bf16-rounded p instead of a ones column of v; the ragged
// edge is masked here instead of padded by the wrapper.
//
// What bounds it on an H100: at head dim 64 the two products do 4 * 64 = 256
// flops per score, and each 128-key K/V tile a block loads (32 KiB) serves
// 64 query rows; every q-tile of a head reads the same tiles, mostly
// from L2. The limit is the tensor cores plus the per-score exp2 (and, on
// MASKED tiles, the compare and select) of the CUDA cores, not memory.
//
// Entry point: pf_flash_fwd (plain C interface, bound with ctypes). It
// returns a cudaError_t value after the launch (0 = success).

#include "flash_fwd_block.cuh"
#include "row_bounds.cuh"

namespace {

using namespace pf;

constexpr int kBK = 128;     // keys per k-tile
constexpr int kStages = 3;   // K/V ring: the tile in P.V, the tile in Q.K^T, one loading
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer's
template <int D>
using Smem = FwdSmem<D, kBK, kStages, 1>;
static_assert(2 * (Smem<64>::kLaunchBytes + 1024) <= 233472, "two blocks per SM at D = 64");
static_assert(Smem<128>::kLaunchBytes <= 232448, "one block per SM at D = 128");

// two blocks of 256 threads per SM start at 128 registers a thread; the
// producer gives back all but 24, the consumer takes 232
template <int D, bool kBounded, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const int* __restrict__ time_q, const int* __restrict__ time_kv,
                 const float* __restrict__ mb, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk, float scale_log2) {
  fwd_block<D, kBK, kStages, 1, 24, 232, kBounded, kCausal>(
      &map_q, &map_k, &map_v, time_q, time_kv, mb, o, lse, H, Lq, Lk, scale_log2);
}

template <int D, bool kBounded, bool kCausal>
int launch(const CUtensorMap* maps, const void* time_q, const void* time_kv, const void* mb,
           void* o, void* lse, int B, int H, int Lq, int Lk, float scale_log2,
           cudaStream_t stream) {
  constexpr int kBytes = Smem<D>::kLaunchBytes;
  auto kernel = flash_fwd_kernel<D, kBounded, kCausal>;
  // once per device and instance: the forward launches thousands of times per request
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t attr = opt_in_smem(kernel, kBytes, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Lq + kFwdBQ - 1) / kFwdBQ, H, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const int*>(time_q),
      static_cast<const int*>(time_kv), static_cast<const float*>(mb),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Lq, Lk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(bool bounded, bool causal, const CUtensorMap* maps, const void* time_q,
             const void* time_kv, const void* mb, void* o, void* lse, int B, int H, int Lq,
             int Lk, float scale_log2, cudaStream_t s) {
  if (bounded) {
    return causal ? launch<D, true, true>(maps, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s)
                  : launch<D, true, false>(maps, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
  }
  return causal ? launch<D, false, true>(maps, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s)
                : launch<D, false, false>(maps, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
}

}  // namespace

// q, k, v, o: [B, H, L, D] bf16, contiguous, 16-byte aligned. time_q [B, Lq],
// time_kv [B, Lk] int32. mb [B, H, Lq] fp32: when bounded, the row bounds
// are written there and then read by the attention kernel (unused when
// classic). lse [B, H, Lq] fp32. scale_log2 = sm_scale * log2(e). Returns a
// cudaError_t value (0 = success).
extern "C" int pf_flash_fwd(const void* q, const void* k, const void* v,
                            const void* time_q, const void* time_kv,
                            void* mb, void* o, void* lse, int B, int H,
                            int Lq, int Lk, int D, float scale_log2,
                            int causal, int bounded, void* stream) {
  if ((D != 64 && D != 128) || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || H > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3];
  if (!encode_fwd_maps(maps, q, k, v, B * H, Lq, Lk, D, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bounded) {
    const int err = D == 64 ? pf::launch_row_bounds<64>(q, k, mb, B * H, Lq, Lk, scale_log2, s)
                            : pf::launch_row_bounds<128>(q, k, mb, B * H, Lq, Lk, scale_log2, s);
    if (err != 0) return err;
  }
  return D == 64 ? dispatch<64>(bounded != 0, causal != 0, maps, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s)
                 : dispatch<128>(bounded != 0, causal != 0, maps, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
}
