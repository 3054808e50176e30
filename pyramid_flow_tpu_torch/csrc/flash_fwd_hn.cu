// Bounded-softmax flash-attention forward with `hs` heads per block, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel_bounded_hn` of
// tools/exp_flash_h2.py (its wrapper `flash_h2`): the bounded forward of
// flash_fwd.cu with time-id masking, head dim 64, bf16 in, o bf16 and
// natural-log lse fp32 out (o = 0 and lse = 3e38 on a row with no visible
// key). It is the block of flash_fwd_block.cuh with HS consumer
// warpgroups, one per head, and one producer warpgroup: K1 with a wider
// producer. The producer loads the q tiles of all HS heads, reads each
// k-tile's time ids and classifies the tile once for all of them, and fills
// one stage with the K and V of every head under one barrier, which is what
// the TPU kernel shares between its heads (types_ref, tq_ref, tk_ref).
// Every consumer runs K1's consumer on its head's slice of the stage, so
// each head's o and lse are K1's, bit for bit.
//
// What bounds it on an H100: as K1, the tensor cores plus the per-score exp2
// and mask work, not device memory. On the TPU a grid cell of hs heads lets
// one head's matrix-unit work overlap another's exp2 pass; here the HS
// consumers of a block overlap the same way on one SM, as K1's two blocks
// per SM do, and the block's cost is resources. Per block, with D = 64:
//
//   hs  threads  keys/tile  stages  shared bytes  launch regs  consumer regs
//    1    256       128        3       109,136        128          232   (2 blocks/SM)
//    2    384       128        3       215,632        168          232
//    3    512        64        3       173,904        128          160
//    4    640        64        3       231,248         96          112
//    6    896        64        2       247,352         72           80   (does not fit)
//
// More heads leave each consumer fewer registers (see Hn below). hs = 6
// needs more shared memory than a block may have (48 KiB of q tiles and two
// 96 KiB stages), so pf_flash_fwd_hn_info reports it and the wrapper
// refuses it before any launch.
//
// Entry points (plain C interface, bound with ctypes): pf_flash_fwd_hn, which
// returns cudaGetLastError() after the launch, and pf_flash_fwd_hn_info.

#include "flash_fwd_block.cuh"
#include "row_bounds.cuh"

namespace {

using namespace pf;

constexpr int kD = 64;
constexpr int kProducerRegs = 24;

// The block of hs heads. From hs = 3 the 64-key tile halves the S and P a
// consumer holds; at hs = 6 two stages are all there is room for. A thread
// starts with the SM's 65,536 registers over the resident threads, in the
// 8-register steps a warp is given them; setmaxnreg can hand out only what
// the block got, so each consumer takes the block's registers less the
// producer's 24, shared by the hs consumers (at most K1's 232).
template <int HS>
struct Hn {
  static constexpr int kThreads = 128 * (HS + 1);
  static constexpr int kBK = HS <= 2 ? 128 : 64;
  static constexpr int kStages = HS <= 4 ? 3 : 2;
  static constexpr int kBlocksPerSM = HS == 1 ? 2 : 1;
  static constexpr int kLaunchRegs = (65536 / (kThreads * kBlocksPerSM)) & ~7;
  static constexpr int kShare = ((HS + 1) * kLaunchRegs - kProducerRegs) / HS & ~7;
  static constexpr int kConsumerRegs = kShare < 232 ? kShare : 232;
  static constexpr int kSmemBytes = FwdSmem<kD, kBK, kStages, HS>::kLaunchBytes;
};

template <bool kCausal, int HS>
__global__ void __launch_bounds__(Hn<HS>::kThreads, Hn<HS>::kBlocksPerSM)
flash_fwd_hn_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const int* __restrict__ time_q, const int* __restrict__ time_kv,
                    const float* __restrict__ mb, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int H, int Lq, int Lk, float scale_log2) {
  fwd_block<kD, Hn<HS>::kBK, Hn<HS>::kStages, HS, kProducerRegs, Hn<HS>::kConsumerRegs, true,
            kCausal>(&map_q, &map_k, &map_v, time_q, time_kv, mb, o, lse, H, Lq, Lk,
                     scale_log2);
}

template <bool kCausal, int HS>
int launch(const void* q, const void* k, const void* v, const void* time_q,
           const void* time_kv, void* mb, void* o, void* lse, int B, int H, int Lq, int Lk,
           float scale_log2, cudaStream_t stream) {
  constexpr int kBytes = Hn<HS>::kSmemBytes;
  auto kernel = flash_fwd_hn_kernel<kCausal, HS>;
  // once per device and instance, as flash_fwd.cu
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t attr = opt_in_smem(kernel, kBytes, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // setmaxnreg hands out only the registers the block started with: refuse
  // a build whose count at launch would leave a consumer waiting for them
  static const bool regs_ok = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(
                                         &flash_fwd_hn_kernel<kCausal, HS>)) == cudaSuccess &&
           a.numRegs * Hn<HS>::kThreads >= 128 * (kProducerRegs + HS * Hn<HS>::kConsumerRegs);
  }();
  if (!regs_ok) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap maps[3];
  if (!encode_fwd_maps(maps, q, k, v, B * H, Lq, Lk, kD, Hn<HS>::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bounds = launch_row_bounds<kD>(q, k, mb, B * H, Lq, Lk, scale_log2, stream);
  if (bounds != 0) return bounds;
  const dim3 grid((Lq + kFwdBQ - 1) / kFwdBQ, H / HS, B);
  kernel<<<grid, Hn<HS>::kThreads, kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const int*>(time_q),
      static_cast<const int*>(time_kv), static_cast<const float*>(mb),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Lq, Lk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// info[0..4] of the kernel of (causal, HS), as pf_flash_fwd_hn_info
template <int HS>
int info_of(int causal, int* info) {
  const void* fn = causal ? reinterpret_cast<const void*>(&flash_fwd_hn_kernel<true, HS>)
                          : reinterpret_cast<const void*>(&flash_fwd_hn_kernel<false, HS>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = attr.maxThreadsPerBlock;
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = Hn<HS>::kSmemBytes;
  info[4] = optin;
  return 0;
}

template <int HS>
int launch_hs(int causal, const void* q, const void* k, const void* v, const void* time_q,
              const void* time_kv, void* mb, void* o, void* lse, int B, int H, int Lq, int Lk,
              float scale_log2, cudaStream_t s) {
  return causal ? launch<true, HS>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk,
                                   scale_log2, s)
                : launch<false, HS>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk,
                                    scale_log2, s);
}

}  // namespace

// info[0..4] of the kernel of (causal, hs): registers per thread at launch,
// the most threads a block of it can launch with, static shared memory, the
// dynamic shared memory a block needs, and the device's opt-in limit of
// shared memory per block (bytes). Returns a cudaError_t value
// (cudaErrorInvalidValue for an hs that is not built).
extern "C" int pf_flash_fwd_hn_info(int hs, int causal, int* info) {
  switch (hs) {
    case 1: return info_of<1>(causal, info);
    case 2: return info_of<2>(causal, info);
    case 3: return info_of<3>(causal, info);
    case 4: return info_of<4>(causal, info);
    case 6: return info_of<6>(causal, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v, o: [B, H, L, 64] bf16, contiguous, 16-byte aligned, H a multiple
// of hs. time_q [B, Lq], time_kv [B, Lk] int32. mb, lse: [B, H, Lq] fp32; the
// row bounds (row_bounds.cuh) are written to mb, then read by the kernel.
// scale_log2 = sm_scale * log2(e). Returns a cudaError_t value (0 = success).
extern "C" int pf_flash_fwd_hn(const void* q, const void* k, const void* v,
                               const void* time_q, const void* time_kv,
                               void* mb, void* o, void* lse, int B,
                               int H, int Lq, int Lk, float scale_log2,
                               int causal, int hs, void* stream) {
  if (hs <= 0 || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || H % hs != 0 || H / hs > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hs) {
    case 1: return launch_hs<1>(causal, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
    case 2: return launch_hs<2>(causal, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
    case 3: return launch_hs<3>(causal, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
    case 4: return launch_hs<4>(causal, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
    case 6: return launch_hs<6>(causal, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
