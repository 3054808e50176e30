// Flash-attention forward with time-id masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel_bounded` (bounded softmax) and
// `_fwd_kernel` (classic online softmax) of
// pyramid_flow_tpu/ops/flash_attention.py. The two are one kernel here; the
// template flag kBounded picks the softmax shift.
//
// What it computes, per (batch b, head h, query row i):
//   visible(i, j) = causal ? t_k[j] <= t_q[i] : t_k[j] != INVALID   (INVALID = 2^30)
//   s(i, j)       = q_i . k_j * sm_scale * log2(e)                   (log2 domain)
//   bounded:  shift_i = mb_i, a per-row upper bound of s(i, .), written by
//             row_bounds.cuh just before (|q_i| * max_j |k_j| * sm_scale *
//             log2(e) + 1)
//   classic:  shift_i = running max of the visible s(i, .)
//   p(i, j)       = visible ? exp2(s(i, j) - shift_i) : 0, rounded to bf16
//   l_i           = sum_j p(i, j) in fp32
//   o_i           = sum_j p(i, j) v_j / l_i          (bf16 operands, fp32 sum)
//   lse_i         = shift_i * ln 2 + ln l_i          (natural log)
//   A row with l_i = 0 (no visible key) writes o_i = 0 and lse_i = 3e38.
// Keys at or past Lk count as INVALID; rows at or past Lq are not written.
//
// Design. One block per (64-row q-tile, head, batch row), two blocks per
// SM: one consumer warpgroup and one producer warpgroup, of which one warp
// works.
//   * The producer loads the q tile once, then walks the k-tiles of 128 keys:
//     it reads their time ids and classifies each against the q tile by the
//     rules of the TPU's `_tile_types` (SKIP, FULL, MASKED; tile_walk.cuh).
//     It drops SKIP tiles and TMA-loads K and V of every other one into a
//     ring of kStages stages, with the tile's time ids, its first key and
//     its type written beside them under the same full barrier. A stage
//     whose first key is -1 ends the walk.
//   * The consumer runs a FULL tile without the per-element compare and
//     select; a MASKED tile pays it.
//   * S = Q K^T is a wgmma with both operands in shared memory (K-major,
//     128-byte swizzle); P is rounded to bf16 in registers, where the S
//     accumulator already has the A-fragment layout, and O += P V is a wgmma
//     with P in registers and V read transposed (MN-major) from its stage.
//   * The P V of tile j is issued after the Q K^T of tile j + 1 and runs
//     while the exp2 of tile j + 1 is computed; the classic form rescales O
//     after it (the bounded form's shift is fixed, so it never rescales).
//   * setmaxnreg gives the producer's registers to the consumers.
//   * Q, K and V are read through 3-D tensor maps (D, L, B * H), so rows past
//     L load as zeros instead of the next head's rows.
//   * 64-row q-tiles give short layouts (stage 0) enough blocks to fill
//     the card, and two blocks per SM overlap one block's exp2 with the
//     other's products. (Blocks of two consumer warpgroups, 128 rows, one
//     per SM, ran slower on the card, and one warpgroup could hold a stage
//     that the other no longer fed.)
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

#include "hopper.cuh"
#include "row_bounds.cuh"
#include "tile_walk.cuh"

namespace {

using namespace pf;

constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 128;     // keys per k-tile
constexpr int kStages = 3;   // K/V ring: the tile in P.V, the tile in Q.K^T, one loading
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer's
constexpr float kEmptyLse = 3e38f;
constexpr float kLn2 = 0.6931471805599453f;
// Initial running max of the classic form (as INIT_M_VALUE on the TPU): far
// below any score, yet finite, so exp2(m_old - m_new) never sees inf - inf.
constexpr float kInitM = -0.35f * 3.402823466e38f;

// Shared memory, in bytes from a 1024-aligned base.
template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;                  // 64-wide swizzle atoms of a row
  static constexpr int kQBytes = kHalves * kBQ * 128;     // [kHalves][64 rows][64]
  static constexpr int kTileBytes = kHalves * kBK * 128;  // K or V: [kHalves][128 keys][64]
  static constexpr int kStageBytes = 2 * kTileBytes;      // K, then V
  static constexpr int kKV = kQBytes;
  static constexpr int kTimes = kKV + kStages * kStageBytes;  // [kStages][kBK] time ids
  static constexpr int kInfo = kTimes + kStages * kBK * 4;    // [kStages]: k0, type
  static constexpr int kBars = kInfo + kStages * 8;           // full, empty, q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kLaunchBytes = kBytes + 1024;          // slack for the alignment
};
static_assert(2 * (Smem<64>::kLaunchBytes + 1024) <= 233472, "two blocks per SM at D = 64");
static_assert(Smem<128>::kLaunchBytes <= 232448, "one block per SM at D = 128");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat16 a = __float2bfloat16_rn(lo);
  const __nv_bfloat16 b = __float2bfloat16_rn(hi);
  sum += __bfloat162float(a) + __bfloat162float(b);
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

template <int D, bool kBounded, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const int* __restrict__ time_q, const int* __restrict__ time_kv,
                 const float* __restrict__ mb, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk, float scale_log2) {
  using S = Smem<D>;
  constexpr int kHalves = S::kHalves;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int* s_times = reinterpret_cast<int*>(smem + S::kTimes);
  int* s_info = reinterpret_cast<int*>(smem + S::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // the latest q-tiles (the most visible keys under causal) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int* tq = time_q + static_cast<size_t>(b) * Lq;
  const int* tk = time_kv + static_cast<size_t>(b) * Lk;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);  // the producer warp's lanes
      mbar_init(&empty[i], 4);  // one lane per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x >= 160) return;  // one warp loads
    // the q-tile's qmin and largest valid time
    int qmin = kInvalidTime, qmax = -1;
#pragma unroll
    for (int r = lane; r < kBQ; r += 32) {
      const int t = q0 + r < Lq ? tq[q0 + r] : kInvalidTime;
      qmin = min(qmin, t);
      if (t != kInvalidTime) qmax = max(qmax, t);
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, S::kQBytes);
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load_3d(smem + hf * kBQ * 128, &map_q, qbar, hf * 64, q0, bh);
    }
    int stage = 0;
    uint32_t phase = 0;
    const int nk = (Lk + kBK - 1) / kBK;
    for (int kt = 0; kt <= nk; ++kt) {
      const int k0 = kt * kBK;
      int t4[4], type = kSkip;
      if (kt < nk) {
        int kmin = kInvalidTime, kmax = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + lane * 4 + i;
          t4[i] = key < Lk ? tk[key] : kInvalidTime;
          kmin = min(kmin, t4[i]);
          kmax = max(kmax, t4[i]);
        }
        type = tile_type<kCausal>(qmin, qmax, warp_min(kmin), warp_max(kmax));
        if (type == kSkip) continue;
      }
      mbar_wait(&empty[stage], phase ^ 1);
      if (kt < nk) {
        *reinterpret_cast<int4*>(s_times + stage * kBK + lane * 4) =
            make_int4(t4[0], t4[1], t4[2], t4[3]);
      }
      if (lane == 0) {
        s_info[stage * 2 + 0] = kt < nk ? k0 : -1;
        s_info[stage * 2 + 1] = type;
      }
      if (lane == 0 && kt < nk) {
        unsigned char* ks = smem + S::kKV + stage * S::kStageBytes;
        mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_3d(ks + hf * kBK * 128, &map_k, &full[stage], hf * 64, k0, bh);
          tma_load_3d(ks + S::kTileBytes + hf * kBK * 128, &map_v, &full[stage], hf * 64, k0,
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
    regs_alloc<232>();
    const int warp = threadIdx.x / 32;
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int qd = lane & 3;  // column pair within the quad
    const int r0 = q0 + warp * 16 + g;
    const int r1 = r0 + 8;
    const int tq0 = r0 < Lq ? tq[r0] : kInvalidTime;
    const int tq1 = r1 < Lq ? tq[r1] : kInvalidTime;

    float m0 = kInitM, m1 = kInitM;  // softmax shift, log2 domain
    if (kBounded) {
      m0 = r0 < Lq ? mb[static_cast<size_t>(bh) * Lq + r0] : 0.f;
      m1 = r1 < Lq ? mb[static_cast<size_t>(bh) * Lq + r1] : 0.f;
    }
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators
    float acc[D / 2];          // O: 64 rows x D
    float s[kBK / 2];          // S, then P in fp32: 64 rows x 128 keys
    uint32_t p[kBK / 16][4];   // P in bf16: one A fragment per 16 keys
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(qbar, 0);

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    // O += P V of the tile in stage st
    auto issue_pv = [&](int st) {
      const unsigned char* vs = smem + S::kKV + st * S::kStageBytes + S::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = desc_sw128(vs + kk * 16 * 128, kBK * 128, 1024);
        if constexpr (D == 64) {
          wgmma_m64n64k16_rs_tb(acc, p[kk], db);
        } else {
          wgmma_m64n128k16_rs_tb(acc, p[kk], db);
        }
      }
      wgmma_commit();
    };

    int stage = 0;
    uint32_t phase = 0;
    int pv_stage = -1;  // the stage whose V the P in registers multiplies
    while (true) {
      mbar_wait(&full[stage], phase);
      if (s_info[stage * 2 + 0] < 0) break;
      const bool masked = s_info[stage * 2 + 1] == kMasked;
      const int cur = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }

      // S = Q K^T, then the pending tile's P V behind it
      const unsigned char* ks = smem + S::kKV + cur * S::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * kBK * 128 + (kk % 4) * 32;
        wgmma_m64n128k16_ss(s, desc_sw128(smem + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024),
                            desc_sw128(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (pv_stage >= 0) {
        issue_pv(pv_stage);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      reg_fence(s);

      // scale to the log2 domain; on MASKED tiles, masked scores become
      // -inf, whose exp2 is exactly 0 against any finite shift
      if (masked) {
        const int* st = s_times + cur * kBK;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const int2 tkc = *reinterpret_cast<const int2*>(st + j * 8 + qd * 2);
          const bool v00 = kCausal ? tkc.x <= tq0 : tkc.x != kInvalidTime;
          const bool v01 = kCausal ? tkc.y <= tq0 : tkc.y != kInvalidTime;
          const bool v10 = kCausal ? tkc.x <= tq1 : tkc.x != kInvalidTime;
          const bool v11 = kCausal ? tkc.y <= tq1 : tkc.y != kInvalidTime;
          s[4 * j + 0] = v00 ? s[4 * j + 0] * scale_log2 : -INFINITY;
          s[4 * j + 1] = v01 ? s[4 * j + 1] * scale_log2 : -INFINITY;
          s[4 * j + 2] = v10 ? s[4 * j + 2] * scale_log2 : -INFINITY;
          s[4 * j + 3] = v11 ? s[4 * j + 3] * scale_log2 : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) s[i] *= scale_log2;
      }
      float a0 = 1.f, a1 = 1.f;  // the classic form's rescale of O and l
      if (!kBounded) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0);
        const float mn1 = fmaxf(m1, mx1);
        a0 = exp2f(m0 - mn0);
        a1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[4 * j + 0] = exp2f(s[4 * j + 0] - m0);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - m0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - m1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - m1);
      }

      // the pending P V is done: its stage goes back, P may be rewritten
      if (pv_stage >= 0) {
        wgmma_wait<0>();
        reg_fence(acc);
        release(pv_stage);
      }
      if (!kBounded) {
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 0] *= a0;
          acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1;
          acc[4 * j + 3] *= a1;
        }
      }
      // p rounded to bf16: S's accumulator columns 16 kk .. 16 kk + 15 are
      // the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1], l0);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3], l1);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5], l0);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7], l1);
      }
      pv_stage = cur;
    }
    if (pv_stage >= 0) {
      wgmma_fence();
      issue_pv(pv_stage);
      wgmma_wait<0>();
      reg_fence(acc);
      release(pv_stage);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    if (r0 < Lq) {
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Lq + r0) * D + qd * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 0] * inv0, acc[4 * j + 1] * inv0);
      }
      if (qd == 0) lse[static_cast<size_t>(bh) * Lq + r0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kEmptyLse;
    }
    if (r1 < Lq) {
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Lq + r1) * D + qd * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
      if (qd == 0) lse[static_cast<size_t>(bh) * Lq + r1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kEmptyLse;
    }
  }
}

// The three tensor maps: Q, K, V as (D, L, B * H) bf16, boxes of 64 x 64
// (Q) and 64 x 128 (K, V).
bool encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, int BH, int Lq,
                 int Lk, int D) {
  const uint64_t dq[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lq),
                          static_cast<uint64_t>(BH)};
  const uint64_t dk[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lk),
                          static_cast<uint64_t>(BH)};
  const uint64_t sq[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lq) * D * 2};
  const uint64_t sk[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lk) * D * 2};
  const uint32_t bq[3] = {64, kBQ, 1};
  const uint32_t bk[3] = {64, kBK, 1};
  return encode_map(&maps[0], q, 3, dq, sq, bq) && encode_map(&maps[1], k, 3, dk, sk, bk) &&
         encode_map(&maps[2], v, 3, dk, sk, bk);
}

template <int D, bool kBounded, bool kCausal>
int launch(const CUtensorMap* maps, const void* time_q, const void* time_kv, const void* mb,
           void* o, void* lse, int B, int H, int Lq, int Lk, float scale_log2,
           cudaStream_t stream) {
  constexpr int kBytes = Smem<D>::kLaunchBytes;
  auto kernel = flash_fwd_kernel<D, kBounded, kCausal>;
  // once per process and instance: the forward launches thousands of times
  // per request, and the port runs on one card
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
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
  if (!encode_maps(maps, q, k, v, B * H, Lq, Lk, D)) {
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
