// Bounded-softmax flash-attention forward with `hs` heads per block, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel_bounded_hn` of
// tools/exp_flash_h2.py (its wrapper `flash_h2`): the bounded forward of
// flash_fwd.cu with time-id masking, head dim 64, bf16 in, o bf16 and
// natural-log lse fp32 out (o = 0 and lse = 3e38 on a row with no visible
// key). What it computes is in flash_fwd_tile.cuh.
//
// On the TPU the kernel puts hs heads in one grid cell so that one head's
// matrix-unit work can overlap another head's exp2 pass, and one tile-type
// table and one copy of each tile's time ids serve all hs heads. Here a block
// holds hs groups of 4 warps, one group per head, all at the same 64-row
// q-tile of the same batch row and walking the same k-tiles in step: the
// k-tile's time ids are loaded into shared memory once per block and its
// skip decision is taken once for all hs heads, which is what the TPU kernel
// shares (types_ref, tq_ref, tk_ref). Each group keeps its own q fragments
// in registers and its own K and V tiles in shared memory.
//
// What bounds it on an H100: the tensor cores plus the per-score exp2 and
// mask work, not device memory. On Hopper the warps of
// different heads already overlap on an SM when they sit in different
// blocks, so grouping heads buys no overlap the scheduler did not have; what
// it costs is resources per block. A group takes 128 threads at the
// registers the compiler gives the tile body (no launch bound caps them) and
// 18 KiB of shared memory, so 128 * hs threads must fit the SM's 65,536
// registers and hs * 18 KiB its 227 KiB: this is the card's counterpart of
// the TPU's VMEM limit on hs. pf_flash_fwd_hn_info reports both, and the
// wrapper refuses an hs that does not fit before any launch.
//
// Entry points (plain C interface, bound with ctypes): pf_flash_fwd_hn, which
// returns cudaGetLastError() after the launch, and pf_flash_fwd_hn_info.

#include "flash_fwd_tile.cuh"
#include "row_bounds.cuh"

namespace {

constexpr int kD = 64;
constexpr int kTileElems = pf::kBK * (kD + 8);

template <bool kCausal, int HS>
__global__ void flash_fwd_hn_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    const int* __restrict__ time_q,
                                    const int* __restrict__ time_kv,
                                    const float* __restrict__ mb,
                                    __nv_bfloat16* __restrict__ o,
                                    float* __restrict__ lse, int H, int Lq,
                                    int Lk, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tk[pf::kBK];
  __shared__ int s_qmax;
  const int group = threadIdx.x / pf::kThreads;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem) + group * 2 * kTileElems;
  __nv_bfloat16* Vs = Ks + kTileElems;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y * HS + group;
  pf::fwd_tile<kD, true, kCausal>(
      q + bh * Lq * kD, k + bh * Lk * kD, v + bh * Lk * kD,
      time_q + static_cast<size_t>(b) * Lq,
      time_kv + static_cast<size_t>(b) * Lk, mb + bh * Lq, o + bh * Lq * kD,
      lse + bh * Lq, Lq, Lk, blockIdx.x * pf::kBQ, scale_log2, Ks, Vs, s_tk,
      &s_qmax, threadIdx.x % pf::kThreads, threadIdx.x);
}

template <bool kCausal, int HS>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&flash_fwd_hn_kernel<kCausal, HS>);
}

// The kernel of (causal, hs), or nullptr for an hs that is not built.
const void* find_kernel(int causal, int hs) {
  switch (hs) {
    case 1: return causal ? kernel_ptr<true, 1>() : kernel_ptr<false, 1>();
    case 2: return causal ? kernel_ptr<true, 2>() : kernel_ptr<false, 2>();
    case 3: return causal ? kernel_ptr<true, 3>() : kernel_ptr<false, 3>();
    case 4: return causal ? kernel_ptr<true, 4>() : kernel_ptr<false, 4>();
    case 6: return causal ? kernel_ptr<true, 6>() : kernel_ptr<false, 6>();
    default: return nullptr;
  }
}

}  // namespace

// info[0..4] of the kernel of (causal, hs): registers per thread, the most
// threads a block of it can launch with, static shared memory, the dynamic
// shared memory a block of hs groups needs, and the device's opt-in limit of
// shared memory per block (bytes). Returns a cudaError_t value.
extern "C" int pf_flash_fwd_hn_info(int hs, int causal, int* info) {
  const void* fn = find_kernel(causal, hs);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  info[3] = hs * pf::group_smem_bytes<kD>();
  info[4] = optin;
  return 0;
}

// q, k, v, o: [B, H, L, 64] bf16, contiguous, H a multiple of hs. time_q
// [B, Lq], time_kv [B, Lk] int32. mb, lse: [B, H, Lq] fp32; the row bounds
// (row_bounds.cuh) are written to mb, then read by the kernel. scale_log2 =
// sm_scale * log2(e). Returns a cudaError_t value (0 = success).
extern "C" int pf_flash_fwd_hn(const void* q, const void* k, const void* v,
                               const void* time_q, const void* time_kv,
                               void* mb, void* o, void* lse, int B,
                               int H, int Lq, int Lk, float scale_log2,
                               int causal, int hs, void* stream) {
  const void* fn = find_kernel(causal, hs);
  if (fn == nullptr || H % hs != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = hs * pf::group_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bounds = pf::launch_row_bounds<kD>(q, k, mb, B * H, Lq, Lk, scale_log2,
                                                static_cast<cudaStream_t>(stream));
  if (bounds != 0) return bounds;
  const dim3 grid((Lq + pf::kBQ - 1) / pf::kBQ, H / hs, B);
  const dim3 block(pf::kThreads * hs);
  void* args[] = {&q, &k, &v, &time_q, &time_kv, &mb, &o, &lse, &H, &Lq, &Lk,
                  &scale_log2};
  err = cudaLaunchKernel(fn, grid, block, args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
