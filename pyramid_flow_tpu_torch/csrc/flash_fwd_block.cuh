// The TMA-fed, warp-specialised wgmma block of the flash-attention forward,
// shared by the one-head-per-block forward (flash_fwd.cu: K1 bounded, K2
// classic) and the bounded forward with HS heads per block (flash_fwd_hn.cu:
// K6). The two kernels are this block at HS = 1 and HS > 1: the same
// producer, walking the tiles once for all HS heads, and the same consumer,
// one warpgroup per head, so K6 computes what K1 computes for each head,
// rounding included.
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
// The block: one per (64-row q-tile, group of HS heads, batch row). HS
// consumer warpgroups (threads 0 .. 128 HS - 1; warpgroup g owns head
// blockIdx.y * HS + g), then one producer warpgroup of which one warp works.
//   * The producer TMA-loads the HS q tiles under one barrier, then walks the
//     k-tiles of kBK keys. The time ids are per batch row, so every head of
//     the block sees the same SKIP/FULL/MASKED sequence: the producer reads a
//     k-tile's time ids and classifies it once (tile_walk.cuh, the rule of
//     the TPU's `_tile_types`; what the TPU kernel shares through types_ref,
//     tq_ref and tk_ref). It drops SKIP tiles and TMA-loads K and V of the
//     other ones, for all HS heads, into one stage of a ring of kStages
//     stages, under one full barrier that expects HS stage slices of bytes
//     (a TMA box counts its zero-filled rows too, so the count does not
//     depend on L). The tile's time ids, first key and type are written once
//     beside them. A stage whose first key is -1 ends the walk.
//   * Consumer g reads its head's slice of every stage. S = Q K^T is a
//     wgmma with both operands in shared memory (K-major, 128-byte swizzle);
//     P is rounded to bf16 in registers, where the S accumulator already has
//     the A-fragment layout, and O += P V is a wgmma with P in registers and
//     V read transposed (MN-major). The P V of tile j is issued after the
//     Q K^T of tile j + 1 and runs while the exp2 of tile j + 1 is computed;
//     the classic form rescales O after it (the bounded form's shift is
//     fixed, so it never rescales). A FULL tile runs without the
//     per-element compare and select; a MASKED tile pays it.
//   * The first tile is taken before the loop, so that every wgmma of the
//     loop is issued on every pass and no branch joins two paths with
//     different products in flight (such a join made ptxas serialise the
//     wgmmas, warning C7518).
//   * setmaxnreg gives the producer's registers to the consumers.
//   * Q, K and V are read through 3-D tensor maps (D, L, B * H), so rows
//     past L load as zeros instead of the next head's rows.
//
// Why it cannot deadlock. Each stage's empty barrier counts one arrival from
// each consumer warp (4 HS), so the producer refills a stage only after every
// consumer has released it, and every consumer waits on the same stages in
// the same order. A consumer waiting for tile m holds one stage, tile m - 1
// (its P V is pending); it has released every earlier one. Let m be the
// tile the slowest consumer waits for. If the producer has loaded it, that
// consumer moves. If not, the producer waits to load a tile n <= m into
// the stage of tile n - kStages <= m - 2, which every consumer has
// released, so the producer moves. kStages >= 2 is all this needs. The
// end-of-walk stage is written once and never reused, so every consumer
// sees it. (Two warpgroups that each classified their own half of a 128-row
// q-tile would walk different sequences of stages; that is not this block.)

#pragma once

#include "hopper.cuh"
#include "tile_walk.cuh"

namespace pf {

constexpr int kFwdBQ = 64;  // query rows per block
constexpr float kFwdEmptyLse = 3e38f;
constexpr float kFwdLn2 = 0.6931471805599453f;
// Initial running max of the classic form (as INIT_M_VALUE on the TPU): far
// below any score, yet finite, so exp2(m_old - m_new) never sees inf - inf.
constexpr float kFwdInitM = -0.35f * 3.402823466e38f;

// Shared memory of a block, in bytes from a 1024-aligned base: the HS q
// tiles, the K/V ring (stage s holds head g's K then V at
// kKV + s * kStageBytes + g * kHeadBytes), the time ids and the info of
// each stage, the barriers.
template <int D, int kBK, int kStages, int HS>
struct FwdSmem {
  static constexpr int kHalves = D / 64;                  // 64-wide swizzle atoms of a row
  static constexpr int kQBytes = kHalves * kFwdBQ * 128;  // one head: [kHalves][64 rows][64]
  static constexpr int kTileBytes = kHalves * kBK * 128;  // K or V: [kHalves][kBK keys][64]
  static constexpr int kHeadBytes = 2 * kTileBytes;       // one head's K, then V
  static constexpr int kStageBytes = HS * kHeadBytes;
  static constexpr int kKV = HS * kQBytes;
  static constexpr int kTimes = kKV + kStages * kStageBytes;  // [kStages][kBK] time ids
  static constexpr int kInfo = kTimes + kStages * kBK * 4;    // [kStages]: k0, type
  static constexpr int kBars = kInfo + kStages * 8;           // full, empty, q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kLaunchBytes = kBytes + 1024;          // slack for the alignment
};

// The three tensor maps: Q, K, V as (D, L, B * H) bf16, boxes of 64 x 64
// (Q) and 64 x bk (K, V).
inline bool encode_fwd_maps(CUtensorMap* maps, const void* q, const void* k, const void* v,
                            int BH, int Lq, int Lk, int D, int bk) {
  const uint64_t dq[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lq),
                          static_cast<uint64_t>(BH)};
  const uint64_t dk[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Lk),
                          static_cast<uint64_t>(BH)};
  const uint64_t sq[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lq) * D * 2};
  const uint64_t sk[2] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(Lk) * D * 2};
  const uint32_t bq[3] = {64, kFwdBQ, 1};
  const uint32_t bkv[3] = {64, static_cast<uint32_t>(bk), 1};
  return encode_map(&maps[0], q, 3, dq, sq, bq) && encode_map(&maps[1], k, 3, dk, sk, bkv) &&
         encode_map(&maps[2], v, 3, dk, sk, bkv);
}

__device__ __forceinline__ uint32_t fwd_pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat16 a = __float2bfloat16_rn(lo);
  const __nv_bfloat16 b = __float2bfloat16_rn(hi);
  sum += __bfloat162float(a) + __bfloat162float(b);
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// The producer warp: the q tiles of heads bh0 .. bh0 + HS - 1, then the walk.
template <int D, int kBK, int kStages, int HS, bool kCausal>
__device__ __forceinline__ void fwd_producer(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                             const CUtensorMap* map_v, unsigned char* smem,
                                             const int* tq, const int* tk, int Lq, int Lk,
                                             int q0, int bh0, int lane) {
  using S = FwdSmem<D, kBK, kStages, HS>;
  constexpr int kPer = kBK / 32;  // keys per lane
  static_assert(kPer == 2 || kPer == 4, "64 or 128 keys per tile");
  int* s_times = reinterpret_cast<int*>(smem + S::kTimes);
  int* s_info = reinterpret_cast<int*>(smem + S::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // the q-tile's qmin and largest valid time
  int qmin = kInvalidTime, qmax = -1;
#pragma unroll
  for (int r = lane; r < kFwdBQ; r += 32) {
    const int t = q0 + r < Lq ? tq[q0 + r] : kInvalidTime;
    qmin = min(qmin, t);
    if (t != kInvalidTime) qmax = max(qmax, t);
  }
  qmin = warp_min(qmin);
  qmax = warp_max(qmax);
  if (lane == 0) {
    mbar_arrive_expect_tx(qbar, HS * S::kQBytes);
#pragma unroll
    for (int g = 0; g < HS; ++g) {
      for (int hf = 0; hf < S::kHalves; ++hf)
        tma_load_3d(smem + g * S::kQBytes + hf * kFwdBQ * 128, map_q, qbar, hf * 64, q0, bh0 + g);
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  const int nk = (Lk + kBK - 1) / kBK;
  for (int kt = 0; kt <= nk; ++kt) {
    const int k0 = kt * kBK;
    int t[kPer], type = kSkip;
    if (kt < nk) {
      int kmin = kInvalidTime, kmax = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int key = k0 + lane * kPer + i;
        t[i] = key < Lk ? tk[key] : kInvalidTime;
        kmin = min(kmin, t[i]);
        kmax = max(kmax, t[i]);
      }
      type = tile_type<kCausal>(qmin, qmax, warp_min(kmin), warp_max(kmax));
      if (type == kSkip) continue;
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (kt < nk) {
      int* dst = s_times + stage * kBK + lane * kPer;
      if constexpr (kPer == 4) {
        *reinterpret_cast<int4*>(dst) = make_int4(t[0], t[1], t[2], t[3]);
      } else {
        *reinterpret_cast<int2*>(dst) = make_int2(t[0], t[1]);
      }
    }
    if (lane == 0) {
      s_info[stage * 2 + 0] = kt < nk ? k0 : -1;
      s_info[stage * 2 + 1] = type;
    }
    if (lane == 0 && kt < nk) {
      unsigned char* ks = smem + S::kKV + stage * S::kStageBytes;
      mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
#pragma unroll
      for (int g = 0; g < HS; ++g) {
        unsigned char* hk = ks + g * S::kHeadBytes;
        for (int hf = 0; hf < S::kHalves; ++hf) {
          tma_load_3d(hk + hf * kBK * 128, map_k, &full[stage], hf * 64, k0, bh0 + g);
          tma_load_3d(hk + S::kTileBytes + hf * kBK * 128, map_v, &full[stage], hf * 64, k0,
                      bh0 + g);
        }
      }
    } else {
      mbar_arrive(&full[stage]);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// One consumer warpgroup (thread tid of 128): head bh's rows q0 .. q0 + 63,
// its q tile at qs, its slice of stage s at kv + s * FwdSmem::kStageBytes.
template <int D, int kBK, int kStages, int HS, bool kBounded, bool kCausal>
__device__ __forceinline__ void fwd_consumer(unsigned char* smem, const unsigned char* qs,
                                             const unsigned char* kv, const int* tq,
                                             const float* __restrict__ mb,
                                             __nv_bfloat16* __restrict__ o,
                                             float* __restrict__ lse, int bh, int Lq, int q0,
                                             float scale_log2, int tid) {
  using S = FwdSmem<D, kBK, kStages, HS>;
  const int* s_times = reinterpret_cast<const int*>(smem + S::kTimes);
  const int* s_info = reinterpret_cast<const int*>(smem + S::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int lane = tid & 31;
  const int warp = tid / 32;
  const int g = lane >> 2;  // row within the warp's 8-row group
  const int qd = lane & 3;  // column pair within the quad
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const int tq0 = r0 < Lq ? tq[r0] : kInvalidTime;
  const int tq1 = r1 < Lq ? tq[r1] : kInvalidTime;

  float m0 = kFwdInitM, m1 = kFwdInitM;  // softmax shift, log2 domain
  if (kBounded) {
    m0 = r0 < Lq ? mb[static_cast<size_t>(bh) * Lq + r0] : 0.f;
    m1 = r1 < Lq ? mb[static_cast<size_t>(bh) * Lq + r1] : 0.f;
  }
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators
  float acc[D / 2];          // O: 64 rows x D
  float s[kBK / 2];          // S, then P in fp32: 64 rows x kBK keys
  uint32_t p[kBK / 16][4];   // P in bf16: one A fragment per 16 keys
  float a0 = 1.f, a1 = 1.f;  // the classic form's rescale of O and l
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);

  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  // S = Q K^T of the tile in stage st
  auto issue_qk = [&](int st) {
    const unsigned char* ks = kv + st * S::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = desc_sw128(qs + (kk / 4) * kFwdBQ * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(ks + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024);
      if constexpr (kBK == 128) {
        wgmma_m64n128k16_ss(s, da, db, kk > 0);
      } else {
        wgmma_m64n64k16_ss(s, da, db, kk > 0);
      }
    }
    wgmma_commit();
  };
  // O += P V of the tile in stage st
  auto issue_pv = [&](int st) {
    const unsigned char* vs = kv + st * S::kStageBytes + S::kTileBytes;
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
  // S of the tile in stage st to exp2(s - shift) in fp32; on MASKED tiles
  // masked scores become -inf, whose exp2 is exactly 0 against any finite
  // shift. The classic form moves its shift and sets a0, a1.
  auto softmax = [&](int st, bool masked) {
    if (masked) {
      const int* ts = s_times + st * kBK;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int2 tkc = *reinterpret_cast<const int2*>(ts + j * 8 + qd * 2);
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
  };
  // with no P V in flight: the classic form rescales O and l; P rounded to
  // bf16, S's accumulator columns 16 kk .. 16 kk + 15 being the A fragment
  // of k-step kk
  auto to_p = [&]() {
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
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      p[kk][0] = fwd_pack_bf16(s[8 * kk + 0], s[8 * kk + 1], l0);
      p[kk][1] = fwd_pack_bf16(s[8 * kk + 2], s[8 * kk + 3], l1);
      p[kk][2] = fwd_pack_bf16(s[8 * kk + 4], s[8 * kk + 5], l0);
      p[kk][3] = fwd_pack_bf16(s[8 * kk + 6], s[8 * kk + 7], l1);
    }
  };

  int stage = 0;
  uint32_t phase = 0;
  // the stage of the next tile, or -1 at the end of the walk
  auto next = [&]() {
    mbar_wait(&full[stage], phase);
    if (s_info[stage * 2 + 0] < 0) return -1;
    const int cur = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    return cur;
  };

  int pv = next();  // the stage whose V the P in registers multiplies
  if (pv >= 0) {
    wgmma_fence();
    issue_qk(pv);
    wgmma_wait<0>();
    reg_fence(s);
    softmax(pv, s_info[pv * 2 + 1] == kMasked);
    to_p();
    while (true) {
      const int cur = next();
      if (cur < 0) break;
      const bool masked = s_info[cur * 2 + 1] == kMasked;
      // S = Q K^T, then the pending tile's P V behind it
      wgmma_fence();
      issue_qk(cur);
      issue_pv(pv);
      wgmma_wait<1>();
      reg_fence(s);
      softmax(cur, masked);
      // the pending P V is done: its stage goes back, P may be rewritten
      wgmma_wait<0>();
      reg_fence(acc);
      release(pv);
      to_p();
      pv = cur;
    }
    wgmma_fence();
    issue_pv(pv);
    wgmma_wait<0>();
    reg_fence(acc);
    release(pv);
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
    if (qd == 0) {
      lse[static_cast<size_t>(bh) * Lq + r0] = l0 > 0.f ? m0 * kFwdLn2 + logf(l0) : kFwdEmptyLse;
    }
  }
  if (r1 < Lq) {
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Lq + r1) * D + qd * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    if (qd == 0) {
      lse[static_cast<size_t>(bh) * Lq + r1] = l1 > 0.f ? m1 * kFwdLn2 + logf(l1) : kFwdEmptyLse;
    }
  }
}

// The whole block, called by a __global__ kernel of 128 (HS + 1) threads
// whose launch bounds leave (HS + 1) * kLaunchRegs registers per thread for
// the block; setmaxnreg then moves them to kProducerRegs on the producer and
// kConsumerRegs on each consumer.
template <int D, int kBK, int kStages, int HS, int kProducerRegs, int kConsumerRegs,
          bool kBounded, bool kCausal>
__device__ __forceinline__ void fwd_block(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                          const CUtensorMap* map_v, const int* time_q,
                                          const int* time_kv, const float* mb,
                                          __nv_bfloat16* o, float* lse, int H, int Lq, int Lk,
                                          float scale_log2) {
  static_assert(kStages >= 2, "a consumer holds one stage while it waits for the next");
  static_assert(kProducerRegs % 8 == 0 && kConsumerRegs % 8 == 0, "setmaxnreg counts");
  using S = FwdSmem<D, kBK, kStages, HS>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // the latest q-tiles (the most visible keys under causal) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdBQ;
  const int b = blockIdx.z;
  const int bh0 = b * H + blockIdx.y * HS;
  const int* tq = time_q + static_cast<size_t>(b) * Lq;
  const int* tk = time_kv + static_cast<size_t>(b) * Lk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);       // the producer warp's lanes
      mbar_init(&empty[i], 4 * HS);  // one lane per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * HS) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= 128 * HS + 32) return;  // one warp loads
    fwd_producer<D, kBK, kStages, HS, kCausal>(map_q, map_k, map_v, smem, tq, tk, Lq, Lk, q0,
                                               bh0, threadIdx.x & 31);
  } else {
    regs_alloc<kConsumerRegs>();
    const int g = threadIdx.x / 128;
    fwd_consumer<D, kBK, kStages, HS, kBounded, kCausal>(
        smem, smem + g * S::kQBytes, smem + S::kKV + g * S::kHeadBytes, tq, mb, o, lse, bh0 + g,
        Lq, q0, scale_log2, threadIdx.x & 127);
  }
}

}  // namespace pf
