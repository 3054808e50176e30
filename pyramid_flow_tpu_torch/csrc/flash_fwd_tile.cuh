// The heads-per-block forward's (flash_fwd_hn.cu) work on one 64-row q-tile
// of one head, on mma.sync.
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
//
// One group of 4 warps (kThreads threads) does one head's q-tile: q fragments
// in registers, each 64-key K/V tile loaded synchronously into the group's
// own shared buffers, bf16 mma.sync.m16n8k16 with fp32 accumulation. Every
// group of a block walks the same k-tiles of the same batch row, so the time
// ids of a k-tile are loaded once per block (by the block's first 64
// threads) and the skip decision is taken once for all its heads: a k-tile
// is skipped when no valid query (t_q != INVALID) of the q-tile can see any
// of its keys. The barriers are block-wide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pf {

constexpr int kInvalidTime = 1 << 30;
constexpr int kBQ = 64;        // query rows per group: 4 warps x 16 rows
constexpr int kBK = 64;        // keys per k-tile
constexpr int kThreads = 128;  // threads per group
constexpr float kEmptyLse = 3e38f;
constexpr float kLn2 = 0.6931471805599453f;
// Initial running max of the classic form (as INIT_M_VALUE on the TPU): far
// below any score, yet finite, so exp2(m_old - m_new) never sees inf - inf.
constexpr float kInitM = -0.35f * 3.402823466e38f;

static_assert(kBQ == kBK, "the q tile is staged through the K buffer");

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values in one 32-bit register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Rows [row0, row0 + kBK) of a row-major [L, D] bf16 matrix into shared
// memory with row stride D + 8 (the pad keeps fragment loads free of bank
// conflicts). Rows at or past L are zero. `tid` is the thread's index in its
// group.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int L, int tid) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  constexpr int kPerRow = D / kVec;
  constexpr int kStride = D + 8;
  for (int i = tid; i < kBK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

// Shared memory of one group: its K and V tiles (the q tile is staged
// through K).
template <int D>
constexpr int group_smem_bytes() {
  return 2 * kBK * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

// One head's q-tile [q0, q0 + kBQ). qh, kh, vh, oh: the head's [L, D] rows;
// tq, tk: the batch row's time ids; mbh, lseh: the head's [Lq] row bounds
// (read only when kBounded) and lse. Ks, Vs: the group's tiles; s_tk
// (kBK ints) and s_qmax: shared by the block. tid: the thread's index in its
// group; ctid: its index in the block.
template <int D, bool kBounded, bool kCausal>
__device__ __forceinline__ void fwd_tile(
    const __nv_bfloat16* __restrict__ qh, const __nv_bfloat16* __restrict__ kh,
    const __nv_bfloat16* __restrict__ vh, const int* __restrict__ tq,
    const int* __restrict__ tk_ids, const float* __restrict__ mbh,
    __nv_bfloat16* __restrict__ oh, float* __restrict__ lseh, int Lq, int Lk,
    int q0, float scale_log2, __nv_bfloat16* Ks, __nv_bfloat16* Vs, int* s_tk,
    int* s_qmax, int tid, int ctid) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;  // k-steps of q.k
  constexpr int kSt = kBK / 8;    // 8-key column tiles of S
  constexpr int kPt = kBK / 16;   // 16-key k-steps of p.v
  constexpr int kOt = D / 8;      // 8-wide column tiles of O

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 8-row group
  const int t4 = lane & 3;  // column pair within the quad

  // Stage the q tile through Ks, keep its mma fragments in registers, and
  // find the largest valid query time of the tile (-1 if there is none).
  if (ctid == 0) *s_qmax = -1;
  load_tile<D>(Ks, qh, q0, Lq, tid);
  __syncthreads();
  if (ctid < kBQ && q0 + ctid < Lq) {
    const int t = tq[q0 + ctid];
    if (t != kInvalidTime) atomicMax(s_qmax, t);
  }
  const int wr = warp * 16;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = s * 16 + t4 * 2;
    qf[s][0] = *reinterpret_cast<const uint32_t*>(&Ks[(wr + g) * kStride + c]);
    qf[s][1] = *reinterpret_cast<const uint32_t*>(&Ks[(wr + g + 8) * kStride + c]);
    qf[s][2] = *reinterpret_cast<const uint32_t*>(&Ks[(wr + g) * kStride + c + 8]);
    qf[s][3] = *reinterpret_cast<const uint32_t*>(&Ks[(wr + g + 8) * kStride + c + 8]);
  }

  // This thread's two rows: r0 (fragment elements 0, 1) and r1 (2, 3).
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  const int tq0 = r0 < Lq ? tq[r0] : kInvalidTime;
  const int tq1 = r1 < Lq ? tq[r1] : kInvalidTime;
  float m0 = kInitM, m1 = kInitM;  // softmax shift, log2 domain
  if (kBounded) {
    m0 = r0 < Lq ? mbh[r0] : 0.f;
    m1 = r1 < Lq ? mbh[r1] : 0.f;
  }
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators
  float acc[kOt][4];
#pragma unroll
  for (int n = 0; n < kOt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  __syncthreads();  // the q staging is consumed and s_qmax is final
  const int qmax = *s_qmax;

  const int nk = (Lk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    int tk = kInvalidTime;
    if (ctid < kBK) {
      if (k0 + ctid < Lk) tk = tk_ids[k0 + ctid];
      s_tk[ctid] = tk;
    }
    // Skip a k-tile that no valid query of this q-tile can see.
    const bool unseen =
        ctid >= kBK || (kCausal ? tk > qmax : (tk == kInvalidTime || qmax < 0));
    if (__syncthreads_and(unseen)) continue;

    load_tile<D>(Ks, kh, k0, Lk, tid);
    load_tile<D>(Vs, vh, k0, Lk, tid);
    __syncthreads();

    // S = q . k^T for the warp's 16 rows x 64 keys
    float sc[kSt][4];
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(n * 8 + g) * kStride + t4 * 2];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + s * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + s * 16 + 8);
        mma_16816(sc[n], qf[s], b0, b1);
      }
    }

    // scale to the log2 domain and mask; masked scores become -inf, whose
    // exp2 is exactly 0 against any finite shift
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tkc = s_tk[n * 8 + t4 * 2 + (j & 1)];
        const int tqr = j < 2 ? tq0 : tq1;
        const bool vis = kCausal ? tkc <= tqr : tkc != kInvalidTime;
        sc[n][j] = vis ? sc[n][j] * scale_log2 : -INFINITY;
      }
    }

    if (!kBounded) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kSt; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0);
      const float a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < kOt; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
    }

    // p = exp2(s - shift), rounded to bf16 as the p.v operand; the S
    // accumulator layout of two adjacent 8-key tiles is the A fragment layout
    // of one 16-key k-step.
    uint32_t pf[kPt][4];
#pragma unroll
    for (int n = 0; n < kSt; ++n) {
      const __nv_bfloat16 p0 = __float2bfloat16_rn(exp2f(sc[n][0] - m0));
      const __nv_bfloat16 p1 = __float2bfloat16_rn(exp2f(sc[n][1] - m0));
      const __nv_bfloat16 p2 = __float2bfloat16_rn(exp2f(sc[n][2] - m1));
      const __nv_bfloat16 p3 = __float2bfloat16_rn(exp2f(sc[n][3] - m1));
      l0 += __bfloat162float(p0) + __bfloat162float(p1);
      l1 += __bfloat162float(p2) + __bfloat162float(p3);
      pf[n >> 1][(n & 1) * 2 + 0] = pack2(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack2(p2, p3);
    }

    // O += p . v; the B fragment wants two consecutive keys of one value
    // column per register, so it is gathered from the row-major V tile.
    const unsigned short* vs = reinterpret_cast<const unsigned short*>(Vs);
#pragma unroll
    for (int kk = 0; kk < kPt; ++kk) {
      const int key = kk * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < kOt; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = pack2(vs[key * kStride + col], vs[(key + 1) * kStride + col]);
        const uint32_t b1 = pack2(vs[(key + 8) * kStride + col], vs[(key + 9) * kStride + col]);
        mma_16816(acc[n], pf[kk], b0, b1);
      }
    }
    __syncthreads();  // Ks, Vs and s_tk are rewritten by the next tile
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (r0 < Lq) {
    __nv_bfloat16* orow = oh + static_cast<size_t>(r0) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < kOt; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (t4 == 0) lseh[r0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kEmptyLse;
  }
  if (r1 < Lq) {
    __nv_bfloat16* orow = oh + static_cast<size_t>(r1) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < kOt; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
    }
    if (t4 == 0) lseh[r1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kEmptyLse;
  }
}

}  // namespace pf
