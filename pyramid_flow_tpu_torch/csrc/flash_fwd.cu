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
//   bounded:  shift_i = mb_i, a per-row upper bound of s(i, .) that the caller
//             computes (|q_i| * max_j |k_j| * sm_scale * log2(e) + 1)
//   classic:  shift_i = running max of the visible s(i, .)
//   p(i, j)       = visible ? exp2(s(i, j) - shift_i) : 0, rounded to bf16
//   l_i           = sum_j p(i, j) in fp32
//   o_i           = sum_j p(i, j) v_j / l_i          (bf16 operands, fp32 sum)
//   lse_i         = shift_i * ln 2 + ln l_i          (natural log)
//   A row with l_i = 0 (no visible key) writes o_i = 0 and lse_i = 3e38.
//
// Differences from the TPU kernels, none of which changes the result beyond
// rounding:
//   * The TPU kernel scales q by sm_scale * log2(e) in bf16 before q.k; this
//     kernel scales the fp32 scores instead.
//   * The TPU kernel gets l from a ones column appended to v; here l is summed
//     directly from the bf16-rounded p, which is the same sum.
//   * The TPU wrapper pads L to block multiples; this kernel masks the ragged
//     edge itself (rows past L load as zeros, keys past L count as INVALID).
//   * The TPU per-tile type table becomes block skipping: a k-tile is skipped
//     when no valid query (t_q != INVALID) of the q-tile can see any of its
//     keys. Every other tile is masked element by element.
//
// What bounds it on an H100: at head dim 64 the two products do 4 * 64 = 256
// flops per score, and each 64-key K/V tile a block loads (16 KiB) serves 64
// query rows, 64 flops per byte; every q-tile of a head reads the same tiles,
// so they mostly come from L2. The limit is the tensor cores plus the
// per-score exp2/mask work of the CUDA cores, not device memory. This first
// version keeps the design simple: one block
// of 4 warps per (b, h, 64-row q-tile), q fragments held in registers,
// synchronous 16-byte loads of each 64-key K/V tile into shared memory, bf16
// mma.sync.m16n8k16 with fp32 accumulation, and a loop over k-tiles in place
// of the TPU's sequential grid axis. It runs well below the tensor cores'
// peak (PERF.md has the measured rate): while a K/V tile loads, the tensor
// cores wait, and mma.sync cannot reach wgmma's rate. Faster variants (wgmma,
// TMA, a pipelined K/V ring, warp specialisation, unmasked fast tiles) build
// on the same contract.
//
// Entry point: pf_flash_fwd (plain C interface, bound with ctypes). It
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalidTime = 1 << 30;
constexpr int kBQ = 64;        // query rows per block: 4 warps x 16 rows
constexpr int kBK = 64;        // keys per k-tile
constexpr int kThreads = 128;
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
// conflicts). Rows at or past L are zero.
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

template <int D, bool kBounded, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ time_q,
                 const int* __restrict__ time_kv,
                 const float* __restrict__ mb,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 int H, int Lq, int Lk, float scale_log2) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;  // k-steps of q.k
  constexpr int kSt = kBK / 8;    // 8-key column tiles of S
  constexpr int kPt = kBK / 16;   // 16-key k-steps of p.v
  constexpr int kOt = D / 8;      // 8-wide column tiles of O

  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * kStride];
  __shared__ int s_tk[kBK];
  __shared__ int s_qmax;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 8-row group
  const int t4 = lane & 3;  // column pair within the quad
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int q0 = blockIdx.x * kBQ;

  const __nv_bfloat16* qb = q + bh * Lq * D;
  const __nv_bfloat16* kb = k + bh * Lk * D;
  const __nv_bfloat16* vb = v + bh * Lk * D;
  const int* tqb = time_q + static_cast<size_t>(b) * Lq;
  const int* tkb = time_kv + static_cast<size_t>(b) * Lk;

  // Stage the q tile through Ks, keep its mma fragments in registers, and
  // find the largest valid query time of the tile (-1 if there is none).
  if (tid == 0) s_qmax = -1;
  load_tile<D>(Ks, qb, q0, Lq, tid);
  __syncthreads();
  if (tid < kBQ && q0 + tid < Lq) {
    const int t = tqb[q0 + tid];
    if (t != kInvalidTime) atomicMax(&s_qmax, t);
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
  const int tq0 = r0 < Lq ? tqb[r0] : kInvalidTime;
  const int tq1 = r1 < Lq ? tqb[r1] : kInvalidTime;
  float m0 = kInitM, m1 = kInitM;  // softmax shift, log2 domain
  if (kBounded) {
    m0 = r0 < Lq ? mb[bh * Lq + r0] : 0.f;
    m1 = r1 < Lq ? mb[bh * Lq + r1] : 0.f;
  }
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the denominators
  float acc[kOt][4];
#pragma unroll
  for (int n = 0; n < kOt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  __syncthreads();  // the q staging is consumed and s_qmax is final
  const int qmax = s_qmax;

  const int nk = (Lk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    int tk = kInvalidTime;
    if (tid < kBK) {
      if (k0 + tid < Lk) tk = tkb[k0 + tid];
      s_tk[tid] = tk;
    }
    // Skip a k-tile that no valid query of this q-tile can see.
    const bool unseen =
        tid >= kBK || (kCausal ? tk > qmax : (tk == kInvalidTime || qmax < 0));
    if (__syncthreads_and(unseen)) continue;

    load_tile<D>(Ks, kb, k0, Lk, tid);
    load_tile<D>(Vs, vb, k0, Lk, tid);
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
    __nv_bfloat16* orow = o + (bh * Lq + r0) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < kOt; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (t4 == 0) lse[bh * Lq + r0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kEmptyLse;
  }
  if (r1 < Lq) {
    __nv_bfloat16* orow = o + (bh * Lq + r1) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < kOt; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
    }
    if (t4 == 0) lse[bh * Lq + r1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kEmptyLse;
  }
}

template <int D, bool kBounded, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* time_q,
           const void* time_kv, const void* mb, void* o, void* lse, int B,
           int H, int Lq, int Lk, float scale_log2, cudaStream_t stream) {
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D, kBounded, kCausal><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(time_q),
      static_cast<const int*>(time_kv), static_cast<const float*>(mb),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Lq, Lk,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(bool bounded, bool causal, const void* q, const void* k,
             const void* v, const void* time_q, const void* time_kv,
             const void* mb, void* o, void* lse, int B, int H, int Lq, int Lk,
             float scale_log2, cudaStream_t stream) {
  if (bounded) {
    return causal ? launch<D, true, true>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream)
                  : launch<D, true, false>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream);
  }
  return causal ? launch<D, false, true>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream)
                : launch<D, false, false>(q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, stream);
}

}  // namespace

// q, k, v, o: [B, H, L, D] bf16, contiguous. time_q [B, Lq], time_kv [B, Lk]
// int32. mb [B, H, Lq] fp32 (read only when bounded). lse [B, H, Lq] fp32.
// scale_log2 = sm_scale * log2(e). Returns a cudaError_t value (0 = success).
extern "C" int pf_flash_fwd(const void* q, const void* k, const void* v,
                            const void* time_q, const void* time_kv,
                            const void* mb, void* o, void* lse, int B, int H,
                            int Lq, int Lk, int D, float scale_log2,
                            int causal, int bounded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return dispatch<64>(bounded != 0, causal != 0, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
  }
  if (D == 128) {
    return dispatch<128>(bounded != 0, causal != 0, q, k, v, time_q, time_kv, mb, o, lse, B, H, Lq, Lk, scale_log2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
