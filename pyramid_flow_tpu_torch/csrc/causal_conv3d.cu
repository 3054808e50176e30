// Causal 3x3x3 stride-1 convolution of the causal video VAE, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (launched by
// `pallas_causal_conv3d`) of pyramid_flow_tpu/ops/causal_conv3d.py.
//
// What it computes, for x [B, T, H, W, C] and the front frames F [B, 2, H, W, C]
// (zeros when the caller passes none, as the TPU kernel pads them):
//   let X = F ++ x along time (T + 2 frames), zero-padded by 1 pixel in H, W;
//   y[b, t, h, w, n] = bias[n] + sum_{kt, kh, kw, c}
//                      X[b, t + kt, h + kh, w + kw, c] * wt[n, kt, kh, kw, c]
// in bf16 with fp32 accumulation: causal in time, SAME (zero) padding in
// space. The front frames are read from their own pointer, so the caller never
// concatenates them onto x.
//
// Design: an implicit GEMM. M is a tile of 128 output pixels of one (b, t)
// frame (consecutive in the row-major H*W order), N a tile of 128 output
// channels, and K runs over (tap, 32-channel chunk), 27 * C / 32 steps. Each
// step gathers the A tile (the 128 pixels shifted by the tap, zero where the
// tap falls outside the frame or before the first front frame) and the B tile
// (the tap's 32 input channels of 128 output channels) into shared memory with
// 16-byte cp.async copies, zero-filled in hardware for masked rows, through a
// ring of 3 stages so that the copies of step k + 2 overlap the products of
// step k. 8 warps, 4 along M by 2 along N, each own a 32 x 64 fp32
// accumulator and run bf16 mma.sync.m16n8k16 on ldmatrix fragments. The bias
// is added in the epilogue, and ragged H*W tiles are masked at the store.
//
// Weights are [Co, 3, 3, 3, C] (torch's Conv3d weight in channels_last_3d),
// so the B tile's channels are contiguous; activations are channels-last, so
// the A tile's are too.
//
// Left behind from the TPU kernel: its DMA over aligned W windows with the
// +7 W pad, its (hb, wb) VMEM budget and its 128-channel lane rule.
//
// What bounds it on an H100: the full-resolution decoder conv, 128 -> 128
// channels at 384x640 over a 16-frame window, needs 2 * 27 * 128 * 128 * 16 *
// 384 * 640 = 3.5e12 flops, 3.5 ms at the H100 SXM's published 989 TFLOP/s
// bf16 dense peak (at its 700 W limit), and moves about 2.1 GB of bf16 in
// and out, 0.63 ms at 3.35 TB/s: the tensor cores bound it. Each A tile is
// read by 27 taps and each B tile by every M tile, and both mostly hit
// L1/L2; what keeps this first version well below the peak is mma.sync
// (wgmma and TMA are a later step) and the gather's address arithmetic.
//
// Entry point: pf_causal_conv3d (plain C interface, bound with ctypes). It
// returns a cudaError_t value after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 128;      // output channels per block
constexpr int kBK = 32;       // input channels per K step
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kThreads = 256; // 8 warps: 4 along M x 2 along N
constexpr int kStride = kBK + 8;  // smem row stride (80 bytes): ldmatrix without bank conflicts
constexpr int kTileElems = kBM * kStride;
constexpr int kSmemBytes = kStages * 2 * kTileElems * 2;
constexpr int kTaps = 27;

static_assert(kBM == kBN, "A and B tiles share one loader layout");
static_assert(kBM * kBK / 8 == 2 * kThreads, "each thread copies two 16-byte chunks per tile");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
causal_conv3d_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ front,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y,
                     int T, int H, int W, int C, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kStages * kTileElems;

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int bt = blockIdx.z;
  const int b = bt / T;
  const int t = bt % T;

  // The loader: this thread copies rows lr and lr + 64 of each tile, 16-byte
  // chunk lc of the row's 32 channels.
  const int lr = tid >> 2;
  const int lc = (tid & 3) * 8;
  int ph[2], pw[2];
  bool pin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + lr + 64 * i;
    pin[i] = p < HW;
    ph[i] = p / W;
    pw[i] = p % W;
  }
  const int kcn = C / kBK;
  const int nk = kTaps * kcn;
  const size_t frame = static_cast<size_t>(HW) * C;

  auto load_stage = [&](int slot, int kiter) {
    const int tap = kiter / kcn;
    const int c0 = (kiter - tap * kcn) * kBK + lc;
    const int kt = tap / 9;
    const int kh = (tap / 3) % 3 - 1;
    const int kw = tap % 3 - 1;
    // input frame t + kt - 2 of x; before x's first frame, a front frame
    const int f = t + kt - 2;
    const __nv_bfloat16* base = nullptr;
    if (f >= 0) {
      base = x + (static_cast<size_t>(b) * T + f) * frame;
    } else if (front != nullptr) {
      base = front + (static_cast<size_t>(b) * 2 + f + 2) * frame;
    }
    __nv_bfloat16* as = As + slot * kTileElems;
    __nv_bfloat16* bs = Bs + slot * kTileElems;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      const int hh = ph[i] + kh;
      const int ww = pw[i] + kw;
      const bool ok = base != nullptr && pin[i] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src =
          ok ? base + (static_cast<size_t>(hh) * W + ww) * C + c0 : x;
      cp_async16(as + r * kStride + lc, src, ok ? 16 : 0);
      const __nv_bfloat16* wsrc =
          wt + (static_cast<size_t>(n0 + r) * kTaps + tap) * C + c0;
      cp_async16(bs + r * kStride + lc, wsrc, 16);
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp & 3) * 32;   // the warp's rows of the M tile
  const int wn = (warp >> 2) * 64;  // and columns of the N tile
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step k's tiles are in; every warp is done with step k - 1
    const int kn = k + kStages - 1;
    if (kn < nk) load_stage(kn % kStages, kn);
    cp_async_commit();

    const __nv_bfloat16* as = As + (k % kStages) * kTileElems;
    const __nv_bfloat16* bs = Bs + (k % kStages) * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * kStride + kk + (lane >> 4) * 8);
      }
      uint32_t bf[8][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride + kk +
                           ((lane >> 3) & 1) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }

  // epilogue: bias, bf16, store the pixels inside the frame
  const int g = lane >> 2;
  const int t4 = lane & 3;
  __nv_bfloat16* yb = y + static_cast<size_t>(bt) * HW * Co;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = n0 + wn + ni * 8 + t4 * 2;
    const float b0 = bias[col];
    const float b1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = m0 + wm + mi * 16 + g;
      if (row < HW) {
        *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<size_t>(row) * Co + col) =
            __floats2bfloat162_rn(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
      }
      if (row + 8 < HW) {
        *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<size_t>(row + 8) * Co + col) =
            __floats2bfloat162_rn(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
      }
    }
  }
}

}  // namespace

// x [B, T, H, W, C] bf16; front [B, 2, H, W, C] bf16 or null (zero frames);
// wt [Co, 3, 3, 3, C] bf16; bias [Co] fp32; y [B, T, H, W, Co] bf16; all
// contiguous and 16-byte aligned, C % 32 == 0 and Co % 128 == 0.
extern "C" int pf_causal_conv3d(const void* x, const void* front, const void* wt,
                                const void* bias, void* y, int B, int T, int H,
                                int W, int C, int Co, void* stream) {
  if (C % kBK != 0 || Co % kBN != 0 || B * T > 65535 || B <= 0 || T <= 0 || H <= 0 ||
      W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      causal_conv3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H * W + kBM - 1) / kBM, Co / kBN, B * T);
  causal_conv3d_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(front),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), T, H, W, C, Co);
  return static_cast<int>(cudaGetLastError());
}
