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
// space. The front frames are read from their own tensor, so the caller
// never concatenates them onto x.
//
// Design: an implicit GEMM, warp-specialised, on a persistent grid (one
// block per SM walks the output tiles).
//   * M is a square of 16 x 16 output pixels of one (b, t) frame, N 128
//     output channels, and K runs over (tap, 64-channel chunk): one chunk is
//     one 128-byte swizzle row. The 256-pixel tile halves the weight bytes
//     each product needs from L2 against a 128-pixel one.
//   * One producer thread TMA-loads each K step into a ring of kStages
//     stages guarded by full/empty mbarriers: the A tile is the box of x (a
//     4-D tensor map over (C, W, H, frames)) at (c0, w0 + kw - 1, h0 + kh - 1,
//     frame), and TMA fills the part of the box outside the frame with zeros,
//     which is the SAME padding, with no per-pixel address or predicate in
//     the kernel; the B tile is the box of the weights (a 2-D map over their
//     physical [Co, 27 * C]) at (tap * C + c0, n0).
//   * A tap that reads a frame before x's first reads the front frames
//     through their own map; without front frames those taps are skipped
//     (2/3 of the K loop at t = 0, 1/3 at t = 1), not multiplied by zeros.
//   * Two consumer warpgroups, 128 pixels (8 rows) each, run two wgmma
//     m64n128k16 per 16 channels with both operands in shared memory and keep
//     one K step's products in flight while the next stage is awaited.
//   * Epilogue: the fp32 bias, bf16, a store clipped at the frame's edge.
//     The producer is already loading the next tile meanwhile.
//   * setmaxnreg gives the producer's registers to the consumers.
//
// Weights are [Co, 3, 3, 3, C] (torch's Conv3d weight in channels_last_3d),
// activations channels-last, so both tiles' channels are contiguous.
//
// Left behind from the TPU kernel: its DMA over aligned W windows with the
// +7 W pad, its (hb, wb) VMEM budget and its 128-channel lane rule.
//
// What bounds it on an H100: the full-resolution decoder conv, 128 -> 128
// channels at 384x640 over a 16-frame window, needs 2 * 27 * 128 * 128 * 16 *
// 384 * 640 = 3.5e12 flops, 3.5 ms at the H100 SXM's published 989 TFLOP/s
// bf16 dense peak (at its 700 W limit), and moves about 2.1 GB of bf16 in
// and out, 0.63 ms at 3.35 TB/s: the tensor cores bound it. Each A box is
// read by 27 taps and each B tile by every M tile, and both mostly hit L2.
//
// Entry point: pf_causal_conv3d (plain C interface, bound with ctypes). It
// returns a cudaError_t value after the launch (0 = success).

#include "hopper.cuh"

namespace {

using namespace pf;

constexpr int kTileH = 16;             // output rows per tile
constexpr int kTileW = 16;             // output columns per tile
constexpr int kBM = kTileH * kTileW;   // output pixels per tile
constexpr int kBN = 128;               // output channels per tile
constexpr int kBK = 64;                // input channels per K step
constexpr int kStages = 4;
constexpr int kConsumers = 2;          // warpgroups of 128 pixels (8 rows) each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kATile = kBM * kBK * 2;  // 32 KiB
constexpr int kBTile = kBN * kBK * 2;  // 16 KiB
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

static_assert(kBM == kConsumers * 128, "two m64 wgmma row blocks per consumer warpgroup");
static_assert(kTileW * 4 == 64, "an m64 row block is 4 whole rows of the tile");

struct Shape {
  int T, H, W, C, Co;
  int tiles_h, tiles_w, tiles_n, ntiles;
  int front;  // front frames given
};

// (frame b * T + t, first row, first column, first output channel) of a tile;
// the output-channel tiles of one pixel tile are neighbours in the walk.
__device__ __forceinline__ void tile_coords(int tile, const Shape& s, int& bt, int& h0, int& w0,
                                            int& n0) {
  n0 = (tile % s.tiles_n) * kBN;
  tile /= s.tiles_n;
  w0 = (tile % s.tiles_w) * kTileW;
  tile /= s.tiles_w;
  h0 = (tile % s.tiles_h) * kTileH;
  bt = tile / s.tiles_h;
}

// The first temporal tap that reads a frame: without front frames, the taps
// before x's first frame are skipped.
__device__ __forceinline__ int first_tap_t(int t, int front) { return front ? 0 : max(0, 2 - t); }

__global__ void __launch_bounds__(kThreads, 1)
causal_conv3d_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_front,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, Shape s) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int chunks = s.C / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 4);  // one lane per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    regs_dealloc<40>();
    if (threadIdx.x != kConsumers * 128) return;  // one thread loads
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x) {
      int bt, h0, w0, n0;
      tile_coords(tile, s, bt, h0, w0, n0);
      const int b = bt / s.T;
      const int t = bt - b * s.T;
      int kt = first_tap_t(t, s.front), tap9 = 0, chunk = 0;
      const int nk = (3 - kt) * 9 * chunks;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* a = smem + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        const int kh = tap9 / 3;
        const int kw = tap9 - kh * 3;
        const int f = t + kt - 2;  // the input frame of x; < 0: a front frame
        if (f >= 0) {
          tma_load_4d(a, &map_x, &full[stage], chunk * kBK, w0 + kw - 1, h0 + kh - 1,
                      b * s.T + f);
        } else {
          tma_load_4d(a, &map_front, &full[stage], chunk * kBK, w0 + kw - 1, h0 + kh - 1,
                      b * 2 + f + 2);
        }
        tma_load_2d(a + kATile, &map_w, &full[stage], (kt * 9 + tap9) * s.C + chunk * kBK, n0);
        if (++chunk == chunks) {
          chunk = 0;
          if (++tap9 == 9) {
            tap9 = 0;
            ++kt;
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<232>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int qd = lane & 3;
    int stage = 0;
    uint32_t phase = 0;
    float acc[2][kBN / 2];  // the warpgroup's two 64-pixel row blocks
    for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x) {
      int bt, h0, w0, n0;
      tile_coords(tile, s, bt, h0, w0, n0);
      const int t = bt % s.T;
      const int nk = (3 - first_tap_t(t, s.front)) * 9 * chunks;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
      int prev = -1;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a = smem + stage * kStageBytes + wg * (kATile / kConsumers);
        const unsigned char* bt_ = smem + stage * kStageBytes + kATile;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db = desc_sw128(bt_ + kk * 32, 16, 1024);
          wgmma_m64n128k16_ss(acc[0], desc_sw128(a + kk * 32, 16, 1024), db, 1);
          wgmma_m64n128k16_ss(acc[1], desc_sw128(a + 64 * 128 + kk * 32, 16, 1024), db, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      reg_fence(acc[0]);
      reg_fence(acc[1]);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: the thread's pixels are rows h0 + 8 wg + 4 r + warp (row
      // block r), columns w0 + g and w0 + g + 8; its channels n0 + 8 j +
      // 2 qd + {0, 1}
      const float* bn = bias + n0 + qd * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = h0 + wg * 8 + r * 4 + warp;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int w = w0 + g + 8 * i;
          if (h < s.H && w < s.W) {
            __nv_bfloat16* row =
                y + ((static_cast<size_t>(bt) * s.H + h) * s.W + w) * s.Co + n0 + qd * 2;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j) {
              const float2 bj = *reinterpret_cast<const float2*>(bn + j * 8);
              *reinterpret_cast<__nv_bfloat162*>(row + j * 8) = __floats2bfloat162_rn(
                  acc[r][4 * j + 2 * i] + bj.x, acc[r][4 * j + 2 * i + 1] + bj.y);
            }
          }
        }
      }
    }
  }
}

}  // namespace

// x [B, T, H, W, C] bf16; front [B, 2, H, W, C] bf16 or null (zero frames);
// wt [Co, 3, 3, 3, C] bf16; bias [Co] fp32; y [B, T, H, W, Co] bf16; all
// contiguous and 16-byte aligned, C % 64 == 0 and Co % 128 == 0.
extern "C" int pf_causal_conv3d(const void* x, const void* front, const void* wt,
                                const void* bias, void* y, int B, int T, int H,
                                int W, int C, int Co, void* stream) {
  if (C <= 0 || C % kBK != 0 || Co <= 0 || Co % kBN != 0 || B <= 0 || T <= 0 || H <= 0 ||
      W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s;
  s.T = T;
  s.H = H;
  s.W = W;
  s.C = C;
  s.Co = Co;
  s.tiles_h = (H + kTileH - 1) / kTileH;
  s.tiles_w = (W + kTileW - 1) / kTileW;
  s.tiles_n = Co / kBN;
  s.front = front != nullptr;
  const long long ntiles = static_cast<long long>(B) * T * s.tiles_h * s.tiles_w * s.tiles_n;
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  s.ntiles = static_cast<int>(ntiles);

  CUtensorMap maps[3];
  const uint64_t c = C, w = W, h = H;
  const uint64_t dx[4] = {c, w, h, static_cast<uint64_t>(B) * T};
  const uint64_t df[4] = {c, w, h, static_cast<uint64_t>(B) * 2};
  const uint64_t sx[3] = {c * 2, w * c * 2, h * w * c * 2};
  const uint32_t bx[4] = {kBK, kTileW, kTileH, 1};
  const uint64_t dw[2] = {27 * c, static_cast<uint64_t>(Co)};
  const uint64_t sw[1] = {27 * c * 2};
  const uint32_t bw[2] = {kBK, kBN};
  if (!encode_map(&maps[0], x, 4, dx, sx, bx) ||
      !encode_map(&maps[1], front != nullptr ? front : x, 4, front != nullptr ? df : dx, sx,
                  bx) ||
      !encode_map(&maps[2], wt, 2, dw, sw, bw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once per device, as the flash kernels
  static std::atomic<bool> smem_set[pf::kMaxDevices];
  cudaError_t err = pf::opt_in_smem(causal_conv3d_kernel, kSmemBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  const int grid = static_cast<int>(ntiles < sms ? ntiles : (sms > 0 ? sms : 1));
  causal_conv3d_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), s);
  return static_cast<int>(cudaGetLastError());
}
