// Flash-attention backward with time-id masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_bwd_dkv_kernel` (K3) and `_bwd_dq_kernel`
// (K4) of pyramid_flow_tpu/ops/flash_attention.py, and the TPU wrapper's
// `delta = sum(o * do)`. One backward serves both forward forms (bounded and
// classic softmax): it consumes the natural-log lse the forward saved, which
// is the same number for both.
//
// What it computes, per (batch b, head h), with the forward's o and lse:
//   delta_i       = sum_d o_id * do_id                     (fp32 sums of bf16 products)
//   visible(i, j) = causal ? t_k[j] <= t_q[i] : t_k[j] != INVALID    (INVALID = 2^30)
//   p(i, j)       = visible ? exp(q_i . k_j * sm_scale - lse_i) : 0  (fp32)
//   dv_j          = sum_i p(i, j) do_i                     (p rounded to bf16)
//   ds(i, j)      = p(i, j) * (do_i . v_j - delta_i) * sm_scale
//   dk_j          = sum_i ds(i, j) q_i                     (ds rounded to bf16)
//   dq_i          = sum_j ds(i, j) k_j
// with bf16 operands and fp32 sums, as the TPU kernels do. Under causal a
// padded query row (t_q = INVALID) sees every key, as on the TPU; the caller's
// contract is that such rows carry a zero upstream gradient (do = 0, so
// delta = 0 exactly), which makes their every term zero. A row with no
// visible key has lse = 3e38, so its p underflows to exactly 0.
//
// Three launches on the caller's stream, no atomics, so the result is
// deterministic bit for bit:
//   * bwd_delta_kernel: delta, D / 8 lanes per row, each loading 16 bytes of
//     o and of do (no fp32 copies of either);
//   * flash_bwd_dkv_kernel (K3): one block per (64-key tile, head, batch
//     row). A producer warp TMA-loads the tile's K and V once, then walks
//     the 64-row q-tiles: it classifies each against the k-tile by the
//     forward's rule (tile_walk.cuh), drops SKIP tiles before loading them,
//     and TMA-loads Q and dO of every other one into a ring of kStages
//     stages, with the tile's t_q, lse * log2(e), delta, first row and type
//     written beside them under the same full barrier. The consumer
//     warpgroup computes S^T = K Q^T and dP^T = V dO^T (wgmma, both operands
//     K-major in shared memory), P^T = exp2(S^T scale log2(e) - lse log2(e))
//     (masked only on MASKED tiles) in registers, where the accumulator
//     already has the A-fragment layout, dV += P^T dO with dO read
//     transposed (MN-major), dS^T = P^T (dP^T - delta) sm_scale in
//     registers, and dK += dS^T Q with Q read transposed. dK and dV stay in
//     fp32 registers and are written once.
//   * flash_bwd_dq_kernel (K4): one block per (64-row q-tile, head, batch
//     row). The producer loads Q and dO once and walks the 64-key k-tiles
//     with the same rule, TMA-loading K, V and the tile's t_k into the
//     ring; the consumer computes S = Q K^T, dP = dO V^T, dS in registers
//     and dQ += dS K with K read transposed; dQ is written once.
// Q, K, V and dO are read through 3-D tensor maps (D, L, B * H), so rows
// past L load as zeros; keys past Lk count as INVALID, rows past Lq get
// lse = +inf (p = 0) and delta = 0, and neither is written.
//
// Design. At head dim 64 a block is one consumer warpgroup and one
// producer warpgroup (one warp of which works), two blocks per SM;
// setmaxnreg gives the producer's registers to the consumers (dK, dV, S^T,
// dP^T and two sets of bf16 fragments: about 160 registers in K3). The
// products of one tile are issued so that the tensor cores overlap the CUDA
// cores' work: dP^T runs while P^T is computed, dV while dS^T is, and the
// next tile's S^T and dP^T are issued before this tile's dK (or dQ) is
// waited for, so a stage is released one tile late (kStages = 3: the tile
// whose last product runs, the tile in use, one loading). At head dim 128
// the block holds 128 KiB of shared memory and its accumulators twice as
// many registers, so it runs one block per SM, without setmaxnreg, and
// waits for each tile's last product before the next tile.
//
// What bounds it on an H100: per (q-tile, k-tile) pair K3 does four 64 x 64
// x D products (S, dP, dV, dK) and K4 three (S, dP, dQ), on tiles that
// mostly come from L2, beside an exp2 and about ten fp32 operations per
// score; the tensor cores and that per-score work are the limit, not device
// memory.
//
// Entry point: pf_flash_bwd (plain C interface, bound with ctypes): delta,
// then K3, then K4. It returns 0 on success (see its comment for the rest).

#include "hopper.cuh"
#include "row_bounds.cuh"
#include "tile_walk.cuh"

namespace {

using namespace pf;

constexpr int kTile = 64;      // rows of every tile: keys (K3's k-tile) or queries
constexpr int kStages = 3;     // the ring of Q/dO (K3) or K/V (K4) tiles
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer's
constexpr int kDeltaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base: two resident [64 x D]
// tiles (K and V in K3, Q and dO in K4), the ring of two tiles per stage,
// and per stage three 64-long rows of 4-byte values (K3: t_q, lse * log2(e),
// delta; K4: t_k in the first).
template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;                   // 64-wide swizzle atoms of a row
  static constexpr int kTileBytes = kHalves * kTile * 128;  // [kHalves][64 rows][64]
  static constexpr int kStage = 2 * kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRows = kStage + kStages * kStageBytes;
  static constexpr int kInfo = kRows + kStages * 3 * kTile * 4;  // [kStages]: first row, type
  static constexpr int kBars = kInfo + kStages * 8;               // full, empty, resident
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kLaunchBytes = kBytes + 1024;              // slack for the alignment
};
static_assert(2 * (Smem<64>::kLaunchBytes + 1024) <= 233472, "two blocks per SM at D = 64");
static_assert(Smem<128>::kLaunchBytes <= 232448, "one block per SM at D = 128");

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// A [64 x 64] fp32 accumulator as the bf16 A fragments of four 16-deep
// k-steps: accumulator columns 16 kk .. 16 kk + 15 are k-step kk.
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack2f(c[8 * kk + 0], c[8 * kk + 1]);
    f[kk][1] = pack2f(c[8 * kk + 2], c[8 * kk + 3]);
    f[kk][2] = pack2f(c[8 * kk + 4], c[8 * kk + 5]);
    f[kk][3] = pack2f(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// c[64 x 64] = A B^T over D: A a resident tile, B a ring tile, both
// K-major [kHalves][64 rows][64].
template <int D>
__device__ __forceinline__ void issue_abt(float (&c)[32], const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kTile * 128 + (kk % 4) * 32;
    wgmma_m64n64k16_ss(c, desc_sw128(a + off, 16, 1024), desc_sw128(b + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc[64 x D] += F[64 x 64] B over 64 rows of B: F as register fragments,
// B a [kHalves][64 rows][64] tile read transposed (its rows are the k
// dimension, its D columns the n dimension).
template <int D>
__device__ __forceinline__ void issue_fb(float (&acc)[D / 2], const uint32_t (&f)[4][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * 128, kTile * 128, 1024);
    if constexpr (D == 64) {
      wgmma_m64n64k16_rs_tb(acc, f[kk], db);
    } else {
      wgmma_m64n128k16_rs_tb(acc, f[kk], db);
    }
  }
  wgmma_commit();
}

// Rows r (acc[4 j + 0..1]) and r + 8 (acc[4 j + 2..3]) of a [64 x D] fp32
// accumulator to a row-major [L, D] bf16 matrix; rows at or past L are not
// written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2], int r,
                                           int L, int qd) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= L) continue;
    __nv_bfloat16* row = out + static_cast<size_t>(r + 8 * h) * D + qd * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* res) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&full[i], 32);  // the producer warp's lanes
    mbar_init(&empty[i], 4);  // one lane per consumer warp
  }
  mbar_init(res, 1);
  mbar_fence_init();
}

// The dot products of the 8 bf16 pairs of two 16-byte words, in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]);
    const float2 y = __bfloat1622float2(pb[i]);
    s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
  }
  return s;
}

// delta of `rows` rows of D: D / 8 lanes per row.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
bwd_delta_kernel(const uint4* __restrict__ o, const uint4* __restrict__ dout,
                 float* __restrict__ delta, int rows) {
  constexpr int kLanes = D / 8;
  const int part = threadIdx.x % kLanes;
  const int row = blockIdx.x * (kDeltaThreads / kLanes) + threadIdx.x / kLanes;
  float s = 0.f;
  if (row < rows) {
    const size_t i = static_cast<size_t>(row) * kLanes + part;
    s = dot8(o[i], dout[i]);
  }
  s = row_sum<kLanes>(s);
  if (part == 0 && row < rows) delta[row] = s;
}

// K3: dK and dV of one 64-key tile.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const int* __restrict__ time_q, const int* __restrict__ time_kv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int H, int Lq, int Lk, float sm_scale, float scale_log2) {
  using S = Smem<D>;
  constexpr bool kPipe = D == 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int* s_rows = reinterpret_cast<int*>(smem + S::kRows);
  int* s_info = reinterpret_cast<int*>(smem + S::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  // the earliest keys (seen by the most queries under causal) start first
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int* tq = time_q + static_cast<size_t>(b) * Lq;
  const int* tk = time_kv + static_cast<size_t>(b) * Lk;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_barriers(full, empty, kvbar);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    if constexpr (kPipe) regs_dealloc<24>();
    if (threadIdx.x >= 160) return;  // one warp loads
    int kmin = kInvalidTime, kmax = 0;
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      const int t = k0 + r < Lk ? tk[k0 + r] : kInvalidTime;
      kmin = min(kmin, t);
      kmax = max(kmax, t);
    }
    kmin = warp_min(kmin);
    kmax = warp_max(kmax);
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * S::kTileBytes);
      for (int hf = 0; hf < S::kHalves; ++hf) {
        tma_load_3d(smem + hf * kTile * 128, &map_k, kvbar, hf * 64, k0, bh);
        tma_load_3d(smem + S::kTileBytes + hf * kTile * 128, &map_v, kvbar, hf * 64, k0, bh);
      }
    }
    const float* lse_bh = lse + static_cast<size_t>(bh) * Lq;
    const float* delta_bh = delta + static_cast<size_t>(bh) * Lq;
    int stage = 0;
    uint32_t phase = 0;
    const int nq = (Lq + kTile - 1) / kTile;
    for (int qt = 0; qt <= nq; ++qt) {
      const int q0 = qt * kTile;
      const int r = lane * 2;  // this lane's two rows of the q-tile
      int t0 = kInvalidTime, t1 = kInvalidTime, type = kSkip;
      if (qt < nq) {
        if (q0 + r < Lq) t0 = tq[q0 + r];
        if (q0 + r + 1 < Lq) t1 = tq[q0 + r + 1];
        const int qmin = warp_min(min(t0, t1));
        const int qmax = warp_max(max(t0 != kInvalidTime ? t0 : -1, t1 != kInvalidTime ? t1 : -1));
        type = tile_type<kCausal>(qmin, qmax, kmin, kmax);
        if (type == kSkip) continue;
      }
      mbar_wait(&empty[stage], phase ^ 1);
      if (qt < nq) {
        int* rows = s_rows + stage * 3 * kTile;
        float* rl = reinterpret_cast<float*>(rows + kTile);
        float* rd = reinterpret_cast<float*>(rows + 2 * kTile);
        const bool in0 = q0 + r < Lq, in1 = q0 + r + 1 < Lq;
        *reinterpret_cast<int2*>(rows + r) = make_int2(t0, t1);
        *reinterpret_cast<float2*>(rl + r) =
            make_float2(in0 ? lse_bh[q0 + r] * kLog2e : INFINITY,
                        in1 ? lse_bh[q0 + r + 1] * kLog2e : INFINITY);
        *reinterpret_cast<float2*>(rd + r) =
            make_float2(in0 ? delta_bh[q0 + r] : 0.f, in1 ? delta_bh[q0 + r + 1] : 0.f);
      }
      if (lane == 0) {
        s_info[stage * 2 + 0] = qt < nq ? q0 : -1;
        s_info[stage * 2 + 1] = type;
      }
      if (lane == 0 && qt < nq) {
        unsigned char* st = smem + S::kStage + stage * S::kStageBytes;
        mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
        for (int hf = 0; hf < S::kHalves; ++hf) {
          tma_load_3d(st + hf * kTile * 128, &map_q, &full[stage], hf * 64, q0, bh);
          tma_load_3d(st + S::kTileBytes + hf * kTile * 128, &map_do, &full[stage], hf * 64, q0,
                      bh);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    if constexpr (kPipe) regs_alloc<232>();
    const int warp = threadIdx.x / 32;
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int qd = lane & 3;  // column pair within the quad
    const int kr0 = k0 + warp * 16 + g;  // this thread's keys: kr0 and kr0 + 8
    const int tk0 = kr0 < Lk ? tk[kr0] : kInvalidTime;
    const int tk1 = kr0 + 8 < Lk ? tk[kr0 + 8] : kInvalidTime;

    float dk_acc[D / 2], dv_acc[D / 2];
    float s[32], dp[32];     // S^T then P^T, and dP^T: 64 keys x 64 queries
    uint32_t pf[4][4], df[4][4];  // P^T and dS^T as bf16 A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    const unsigned char* ks = smem;
    const unsigned char* vs = smem + S::kTileBytes;
    mbar_wait(kvbar, 0);

    int stage = 0;
    uint32_t phase = 0;
    int pending = -1;  // the stage whose dK product may still run
    while (true) {
      mbar_wait(&full[stage], phase);
      if (s_info[stage * 2 + 0] < 0) break;
      const bool masked = s_info[stage * 2 + 1] == kMasked;
      const int cur = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      const unsigned char* qs = smem + S::kStage + cur * S::kStageBytes;
      const unsigned char* dos = qs + S::kTileBytes;
      const int* rt = s_rows + cur * 3 * kTile;
      const float* rl = reinterpret_cast<const float*>(rt + kTile);
      const float* rd = reinterpret_cast<const float*>(rt + 2 * kTile);

      wgmma_fence();
      issue_abt<D>(s, ks, qs);    // S^T = K Q^T
      issue_abt<D>(dp, vs, dos);  // dP^T = V dO^T
      wgmma_wait<1>();            // S^T, and the previous tile's dK, are done
      reg_fence(s);
      if (pending >= 0) release(pending);

      // P^T: rows are keys, columns queries (8 j + 2 qd + {0, 1})
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(rl + j * 8 + qd * 2);
        s[4 * j + 0] = exp2f(fmaf(s[4 * j + 0], scale_log2, -l.x));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale_log2, -l.y));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale_log2, -l.x));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale_log2, -l.y));
        if (masked) {
          const int2 t = *reinterpret_cast<const int2*>(rt + j * 8 + qd * 2);
          const bool v0 = kCausal ? tk0 <= t.x : tk0 != kInvalidTime;
          const bool v1 = kCausal ? tk0 <= t.y : tk0 != kInvalidTime;
          const bool v2 = kCausal ? tk1 <= t.x : tk1 != kInvalidTime;
          const bool v3 = kCausal ? tk1 <= t.y : tk1 != kInvalidTime;
          s[4 * j + 0] = v0 ? s[4 * j + 0] : 0.f;
          s[4 * j + 1] = v1 ? s[4 * j + 1] : 0.f;
          s[4 * j + 2] = v2 ? s[4 * j + 2] : 0.f;
          s[4 * j + 3] = v3 ? s[4 * j + 3] : 0.f;
        }
      }
      to_frags(pf, s);
      wgmma_fence();
      issue_fb<D>(dv_acc, pf, dos);  // dV += P^T dO
      wgmma_wait<1>();               // dP^T is done
      reg_fence(dp);

      // dS^T = P^T (dP^T - delta) sm_scale
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(rd + j * 8 + qd * 2);
        dp[4 * j + 0] = s[4 * j + 0] * (dp[4 * j + 0] - d.x) * sm_scale;
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y) * sm_scale;
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x) * sm_scale;
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y) * sm_scale;
      }
      to_frags(df, dp);
      wgmma_fence();
      issue_fb<D>(dk_acc, df, qs);  // dK += dS^T Q
      if constexpr (kPipe) {
        pending = cur;
      } else {
        wgmma_wait<0>();
        release(cur);
      }
    }
    wgmma_wait<0>();
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    const size_t base = static_cast<size_t>(bh) * Lk * D;
    store_rows<D>(dk + base, dk_acc, kr0, Lk, qd);
    store_rows<D>(dv + base, dv_acc, kr0, Lk, qd);
  }
}

// K4: dQ of one 64-row q-tile.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const int* __restrict__ time_q, const int* __restrict__ time_kv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk, float sm_scale,
                    float scale_log2) {
  using S = Smem<D>;
  constexpr bool kPipe = D == 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int* s_rows = reinterpret_cast<int*>(smem + S::kRows);
  int* s_info = reinterpret_cast<int*>(smem + S::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // the latest q-tiles (the most visible keys under causal) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int* tq = time_q + static_cast<size_t>(b) * Lq;
  const int* tk = time_kv + static_cast<size_t>(b) * Lk;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_barriers(full, empty, qbar);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    if constexpr (kPipe) regs_dealloc<24>();
    if (threadIdx.x >= 160) return;  // one warp loads
    int qmin = kInvalidTime, qmax = -1;
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      const int t = q0 + r < Lq ? tq[q0 + r] : kInvalidTime;
      qmin = min(qmin, t);
      if (t != kInvalidTime) qmax = max(qmax, t);
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * S::kTileBytes);
      for (int hf = 0; hf < S::kHalves; ++hf) {
        tma_load_3d(smem + hf * kTile * 128, &map_q, qbar, hf * 64, q0, bh);
        tma_load_3d(smem + S::kTileBytes + hf * kTile * 128, &map_do, qbar, hf * 64, q0, bh);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    const int nk = (Lk + kTile - 1) / kTile;
    for (int kt = 0; kt <= nk; ++kt) {
      const int k0 = kt * kTile;
      const int r = lane * 2;  // this lane's two keys of the k-tile
      int t0 = kInvalidTime, t1 = kInvalidTime, type = kSkip;
      if (kt < nk) {
        if (k0 + r < Lk) t0 = tk[k0 + r];
        if (k0 + r + 1 < Lk) t1 = tk[k0 + r + 1];
        type = tile_type<kCausal>(qmin, qmax, warp_min(min(t0, t1)), warp_max(max(t0, t1)));
        if (type == kSkip) continue;
      }
      mbar_wait(&empty[stage], phase ^ 1);
      if (kt < nk) {
        *reinterpret_cast<int2*>(s_rows + stage * 3 * kTile + r) = make_int2(t0, t1);
      }
      if (lane == 0) {
        s_info[stage * 2 + 0] = kt < nk ? k0 : -1;
        s_info[stage * 2 + 1] = type;
      }
      if (lane == 0 && kt < nk) {
        unsigned char* st = smem + S::kStage + stage * S::kStageBytes;
        mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
        for (int hf = 0; hf < S::kHalves; ++hf) {
          tma_load_3d(st + hf * kTile * 128, &map_k, &full[stage], hf * 64, k0, bh);
          tma_load_3d(st + S::kTileBytes + hf * kTile * 128, &map_v, &full[stage], hf * 64, k0,
                      bh);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    if constexpr (kPipe) regs_alloc<232>();
    const int warp = threadIdx.x / 32;
    const int g = lane >> 2;
    const int qd = lane & 3;
    const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    const int r1 = r0 + 8;
    const size_t row_base = static_cast<size_t>(bh) * Lq;
    const int tq0 = r0 < Lq ? tq[r0] : kInvalidTime;
    const int tq1 = r1 < Lq ? tq[r1] : kInvalidTime;
    const float l0 = r0 < Lq ? lse[row_base + r0] * kLog2e : INFINITY;
    const float l1 = r1 < Lq ? lse[row_base + r1] * kLog2e : INFINITY;
    const float d0 = r0 < Lq ? delta[row_base + r0] : 0.f;
    const float d1 = r1 < Lq ? delta[row_base + r1] : 0.f;

    float dq_acc[D / 2];
    float s[32], dp[32];  // S then P, and dP: 64 rows x 64 keys
    uint32_t df[4][4];    // dS as bf16 A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    const unsigned char* qs = smem;
    const unsigned char* dos = smem + S::kTileBytes;
    mbar_wait(qbar, 0);

    int stage = 0;
    uint32_t phase = 0;
    int pending = -1;  // the stage whose dQ product may still run
    while (true) {
      mbar_wait(&full[stage], phase);
      if (s_info[stage * 2 + 0] < 0) break;
      const bool masked = s_info[stage * 2 + 1] == kMasked;
      const int cur = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      const unsigned char* ks = smem + S::kStage + cur * S::kStageBytes;
      const unsigned char* vs = ks + S::kTileBytes;
      const int* rt = s_rows + cur * 3 * kTile;

      wgmma_fence();
      issue_abt<D>(s, qs, ks);    // S = Q K^T
      issue_abt<D>(dp, dos, vs);  // dP = dO V^T
      wgmma_wait<1>();            // S, and the previous tile's dQ, are done
      reg_fence(s);
      if (pending >= 0) release(pending);

#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j + 0] = exp2f(fmaf(s[4 * j + 0], scale_log2, -l0));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale_log2, -l0));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale_log2, -l1));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale_log2, -l1));
        if (masked) {
          const int2 t = *reinterpret_cast<const int2*>(rt + j * 8 + qd * 2);
          const bool v0 = kCausal ? t.x <= tq0 : t.x != kInvalidTime;
          const bool v1 = kCausal ? t.y <= tq0 : t.y != kInvalidTime;
          const bool v2 = kCausal ? t.x <= tq1 : t.x != kInvalidTime;
          const bool v3 = kCausal ? t.y <= tq1 : t.y != kInvalidTime;
          s[4 * j + 0] = v0 ? s[4 * j + 0] : 0.f;
          s[4 * j + 1] = v1 ? s[4 * j + 1] : 0.f;
          s[4 * j + 2] = v2 ? s[4 * j + 2] : 0.f;
          s[4 * j + 3] = v3 ? s[4 * j + 3] : 0.f;
        }
      }
      wgmma_wait<0>();  // dP is done
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dp[4 * j + 0] = s[4 * j + 0] * (dp[4 * j + 0] - d0) * sm_scale;
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d0) * sm_scale;
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d1) * sm_scale;
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d1) * sm_scale;
      }
      to_frags(df, dp);
      wgmma_fence();
      issue_fb<D>(dq_acc, df, ks);  // dQ += dS K
      if constexpr (kPipe) {
        pending = cur;
      } else {
        wgmma_wait<0>();
        release(cur);
      }
    }
    wgmma_wait<0>();
    reg_fence(dq_acc);
    store_rows<D>(dq + row_base * D, dq_acc, r0, Lq, qd);
  }
}

// Q, K, V and dO as (D, L, B * H) bf16 maps with boxes of 64 x 64 rows.
bool encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, const void* dout,
                 int BH, int Lq, int Lk, int D) {
  const uint64_t dq[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lq),
                          static_cast<uint64_t>(BH)};
  const uint64_t dk[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lk),
                          static_cast<uint64_t>(BH)};
  const uint64_t sq[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lq) * D * 2};
  const uint64_t sk[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lk) * D * 2};
  const uint32_t box[3] = {64, kTile, 1};
  return encode_map(&maps[0], q, 3, dq, sq, box) && encode_map(&maps[1], k, 3, dk, sk, box) &&
         encode_map(&maps[2], v, 3, dk, sk, box) && encode_map(&maps[3], dout, 3, dq, sq, box);
}

struct Args {
  const int *time_q, *time_kv;
  const float *lse, *delta;
  int B, H, Lq, Lk;
  float sm_scale;
};

template <int D, bool kCausal>
int launch(const CUtensorMap* maps, const Args& a, void* dq, void* dk, void* dv,
           cudaStream_t stream) {
  constexpr int kBytes = Smem<D>::kLaunchBytes;
  auto dkv = flash_bwd_dkv_kernel<D, kCausal>;
  auto dqk = flash_bwd_dq_kernel<D, kCausal>;
  // once per device and instance: the backward launches hundreds of times per train step
  static std::atomic<bool> dkv_set[kMaxDevices], dq_set[kMaxDevices];
  cudaError_t attr = opt_in_smem(dkv, kBytes, dkv_set);
  if (attr == cudaSuccess) attr = opt_in_smem(dqk, kBytes, dq_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float scale_log2 = a.sm_scale * kLog2e;
  dkv<<<dim3((a.Lk + kTile - 1) / kTile, a.H, a.B), kThreads, kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.time_q, a.time_kv, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.H, a.Lq, a.Lk,
      a.sm_scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3((a.Lq + kTile - 1) / kTile, a.H, a.B), kThreads, kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.time_q, a.time_kv, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.H, a.Lq, a.Lk, a.sm_scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_delta(const void* o, const void* dout, void* delta, int rows, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kDeltaThreads / (D / 8);
  bwd_delta_kernel<D><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kDeltaThreads, 0, stream>>>(
      static_cast<const uint4*>(o), static_cast<const uint4*>(dout), static_cast<float*>(delta),
      rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout: [B, H, L, D] bf16, contiguous, 16-byte aligned (o and
// dout [B, H, Lq, D]). time_q [B, Lq], time_kv [B, Lk] int32. lse [B, H, Lq]
// fp32, the forward's natural-log lse. delta [B, H, Lq] fp32 scratch: the
// library writes rowsum(o * dout) there and the two kernels read it. dq
// [B, H, Lq, D], dk and dv [B, H, Lk, D] bf16. Returns 0 on success, -1 if
// the sizes are refused, -2 if cuTensorMapEncodeTiled refuses a map, else the
// cudaError_t value of the launch that failed.
extern "C" int pf_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* time_q, const void* time_kv,
                            const void* lse, void* delta, void* dq, void* dk, void* dv, int B,
                            int H, int Lq, int Lk, int D, float sm_scale, int causal,
                            void* stream) {
  if ((D != 64 && D != 128) || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || H > 65535 ||
      B > 65535) {
    return -1;
  }
  CUtensorMap maps[4];
  if (!encode_maps(maps, q, k, v, dout, B * H, Lq, Lk, D)) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H * Lq;
  int err = D == 64 ? launch_delta<64>(o, dout, delta, rows, s)
                    : launch_delta<128>(o, dout, delta, rows, s);
  if (err != 0) return err;
  const Args a{static_cast<const int*>(time_q), static_cast<const int*>(time_kv),
               static_cast<const float*>(lse), static_cast<const float*>(delta), B, H, Lq, Lk,
               sm_scale};
  if (D == 64) {
    return causal ? launch<64, true>(maps, a, dq, dk, dv, s)
                  : launch<64, false>(maps, a, dq, dk, dv, s);
  }
  return causal ? launch<128, true>(maps, a, dq, dk, dv, s)
                : launch<128, false>(maps, a, dq, dk, dv, s);
}
