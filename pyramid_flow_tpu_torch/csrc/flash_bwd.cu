// Flash-attention backward with time-id masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_bwd_dkv_kernel` (K3) and `_bwd_dq_kernel`
// (K4) of pyramid_flow_tpu/ops/flash_attention.py. One backward serves both
// forward forms (bounded and classic softmax): it consumes the natural-log
// lse the forward saved, which is the same number for both.
//
// What it computes, per (batch b, head h), with the forward's o and lse and
// the caller's delta_i = sum_d o_id * do_id (fp32):
//   visible(i, j) = causal ? t_k[j] <= t_q[i] : t_k[j] != INVALID    (INVALID = 2^30)
//   p(i, j)       = visible ? exp(q_i . k_j * sm_scale - lse_i) : 0  (fp32)
//   dv_j          = sum_i p(i, j) do_i                     (p rounded to bf16)
//   ds(i, j)      = p(i, j) * (do_i . v_j - delta_i) * sm_scale
//   dk_j          = sum_i ds(i, j) q_i                     (ds rounded to bf16)
//   dq_i          = sum_j ds(i, j) k_j
// with bf16 operands and fp32 sums, as the TPU kernels do. Under causal a
// padded query row (t_q = INVALID) sees every key, as on the TPU; the caller's
// contract is that such rows carry a zero upstream gradient (do = 0, so
// delta = 0), which makes their every term zero. A row with no visible key has
// lse = 3e38, so its p underflows to exactly 0.
//
// Two kernels and no atomics, as on the TPU, so the result is deterministic:
//   * pf_flash_bwd_dkv: one block of 4 warps per (b, h, 64-key tile). K and V
//     stay in shared memory; the block loops over 64-row q-tiles (loading Q,
//     dO, lse, delta and the query times of each), computes S^T = K Q^T with
//     the keys as rows, so P^T and dS^T come out of the accumulators already
//     in the A-operand layout of dV += P^T dO and dK += dS^T Q. Each warp owns
//     16 keys; dK and dV stay in fp32 registers and are written once.
//   * pf_flash_bwd_dq: one block of 4 warps per (b, h, 64-row q-tile). Q and
//     dO stay in shared memory; the block loops over 64-key tiles and
//     accumulates dQ += dS K in fp32 registers.
//
// Differences from the TPU kernels, none of which changes the result beyond
// rounding:
//   * exp is taken as exp2 of scores scaled by sm_scale * log2(e) against
//     lse * log2(e);
//   * the TPU wrapper pads L to block multiples; these kernels mask the ragged
//     edge themselves (rows past Lq load as zeros with lse = +inf, so p = 0;
//     keys past Lk count as INVALID and are never written);
//   * the TPU's per-tile type table becomes block skipping, the forward's rule
//     seen from either side: a (q-tile, k-tile) pair is skipped when no valid
//     query of the q-tile (t_q != INVALID) can see any key of the k-tile.
//     Skipped pairs only hold terms of padded query rows, which are zero by
//     the contract above. Every other pair is masked element by element.
//
// What bounds it on an H100: per (q-tile, k-tile) pair the dkv kernel does
// four 64 x 64 x D products (S, dP, dV, dK) and the dq kernel three (S, dP,
// dQ), 2 * 64 * 64 * D flops each, on tiles that mostly come from L2, so the
// tensor cores and the per-element exp2/mask work are the limit, not device
// memory. This first version is simple, like the forward: synchronous 16-byte
// loads into padded shared-memory tiles (row stride D + 8 halves keeps the
// fragment loads free of bank conflicts), bf16 mma.sync.m16n8k16 with fp32
// accumulation, operands whose layout does not match the B fragment gathered
// two halves at a time. Fragments are reloaded from shared memory for every
// product, so at D = 128 the registers hold only the two 16 x 128 fp32
// accumulators and two 16 x 64 score tiles (192 floats a thread in dkv).
// Faster variants (wgmma, TMA, a pipelined ring, one fused pass with atomic
// dQ) keep the same contract.
//
// Entry points: pf_flash_bwd_dkv and pf_flash_bwd_dq (plain C interface,
// bound with ctypes). Each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalidTime = 1 << 30;
constexpr int kTile = 64;       // q rows or keys per tile: 4 warps x 16 rows
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 16-bit values in one 32-bit register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__bfloat16_as_ushort(__float2bfloat16_rn(lo)),
               __bfloat16_as_ushort(__float2bfloat16_rn(hi)));
}

// Rows [row0, row0 + kTile) of a row-major [L, D] bf16 matrix into shared
// memory with row stride D + 8. Rows at or past L are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int L, int tid) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  constexpr int kPerRow = D / kVec;
  constexpr int kStride = D + 8;
  for (int i = tid; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

// c[16 x 64] = A[rows a_row0 .. a_row0 + 15, 0 .. D) . B[rows 0 .. 63, 0 .. D)^T,
// both row-major tiles in shared memory. Column tile n of c holds B rows
// n*8 .. n*8+7; the thread holds rows g (c[n][0..1]) and g + 8 (c[n][2..3]),
// columns n*8 + 2*t4 + {0, 1}.
template <int D>
__device__ __forceinline__ void gemm_abt(float (&c)[8][4],
                                         const __nv_bfloat16* a_tile, int a_row0,
                                         const __nv_bfloat16* b_tile, int g,
                                         int t4) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const int col = s * 16 + t4 * 2;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(&a_tile[(a_row0 + g) * kStride + col]);
    a[1] = *reinterpret_cast<const uint32_t*>(&a_tile[(a_row0 + g + 8) * kStride + col]);
    a[2] = *reinterpret_cast<const uint32_t*>(&a_tile[(a_row0 + g) * kStride + col + 8]);
    a[3] = *reinterpret_cast<const uint32_t*>(&a_tile[(a_row0 + g + 8) * kStride + col + 8]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* brow = &b_tile[(n * 8 + g) * kStride + col];
      mma_16816(c[n], a, *reinterpret_cast<const uint32_t*>(brow),
                *reinterpret_cast<const uint32_t*>(brow + 8));
    }
  }
}

// The fp32 accumulator of a [16 x 64] product as bf16 A fragments of four
// 16-deep k-steps: two adjacent 8-column tiles make one k-step.
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    f[n >> 1][(n & 1) * 2 + 0] = pack2f(c[n][0], c[n][1]);
    f[n >> 1][(n & 1) * 2 + 1] = pack2f(c[n][2], c[n][3]);
  }
}

// acc[16 x D] += P[16 x 64] . B[rows 0 .. 63, 0 .. D), P as A fragments and B
// a row-major tile in shared memory. The B fragment wants two consecutive
// rows of one column per register, so it is gathered two halves at a time.
template <int D>
__device__ __forceinline__ void gemm_pb(float (&acc)[D / 8][4], const uint32_t (&f)[4][4],
                                        const __nv_bfloat16* b_tile, int g, int t4) {
  constexpr int kStride = D + 8;
  const unsigned short* bs = reinterpret_cast<const unsigned short*>(b_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int row = kk * 16 + t4 * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + g;
      const uint32_t b0 = pack2(bs[row * kStride + col], bs[(row + 1) * kStride + col]);
      const uint32_t b1 = pack2(bs[(row + 8) * kStride + col], bs[(row + 9) * kStride + col]);
      mma_16816(acc[n], f[kk], b0, b1);
    }
  }
}

// Rows r0 (acc[.][0..1]) and r0 + 8 (acc[.][2..3]) of a [16 x D] fp32
// accumulator to a row-major [L, D] bf16 matrix; rows at or past L are not
// written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 8][4],
                                           int r0, int L, int t4) {
  if (r0 < L) {
    __nv_bfloat16* row = out + static_cast<size_t>(r0) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    }
  }
  if (r0 + 8 < L) {
    __nv_bfloat16* row = out + static_cast<size_t>(r0 + 8) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  // four [kTile, D + 8] bf16 tiles and three kTile-long rows of 4 bytes
  return 4 * kTile * (D + 8) * 2 + 3 * kTile * 4;
}

// K3: dK and dV of one 64-key tile.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const int* __restrict__ time_q,
                     const int* __restrict__ time_kv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int H, int Lq, int Lk, float sm_scale, float scale_log2) {
  constexpr int kStride = D + 8;
  constexpr int kOt = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * kStride;
  __nv_bfloat16* Qs = Vs + kTile * kStride;
  __nv_bfloat16* dOs = Qs + kTile * kStride;
  float* s_lse = reinterpret_cast<float*>(dOs + kTile * kStride);  // lse * log2(e)
  float* s_delta = s_lse + kTile;
  int* s_tq = reinterpret_cast<int*>(s_delta + kTile);
  __shared__ int s_kmin;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int k0 = blockIdx.x * kTile;

  const __nv_bfloat16* qb = q + bh * Lq * D;
  const __nv_bfloat16* kb = k + bh * Lk * D;
  const __nv_bfloat16* vb = v + bh * Lk * D;
  const __nv_bfloat16* dob = dout + bh * Lq * D;
  const int* tqb = time_q + static_cast<size_t>(b) * Lq;
  const int* tkb = time_kv + static_cast<size_t>(b) * Lk;
  const float* lseb = lse + bh * Lq;
  const float* deltab = delta + bh * Lq;

  if (tid == 0) s_kmin = kInvalidTime;
  load_tile<D>(Ks, kb, k0, Lk, tid);
  load_tile<D>(Vs, vb, k0, Lk, tid);
  __syncthreads();
  if (tid < kTile) {
    atomicMin(&s_kmin, k0 + tid < Lk ? tkb[k0 + tid] : kInvalidTime);
  }
  // this thread's two keys: rows g and g + 8 of the warp's 16
  const int wr = warp * 16;
  const int kr0 = k0 + wr + g;
  const int tk0 = kr0 < Lk ? tkb[kr0] : kInvalidTime;
  const int tk1 = kr0 + 8 < Lk ? tkb[kr0 + 8] : kInvalidTime;
  float dk_acc[kOt][4], dv_acc[kOt][4];
#pragma unroll
  for (int n = 0; n < kOt; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  __syncthreads();  // s_kmin is final
  const int kmin = s_kmin;

  const int nq = (Lq + kTile - 1) / kTile;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    int tq = kInvalidTime;
    if (tid < kTile) {
      const bool in = q0 + tid < Lq;
      if (in) tq = tqb[q0 + tid];
      s_tq[tid] = tq;
      s_lse[tid] = in ? lseb[q0 + tid] * kLog2e : INFINITY;
      s_delta[tid] = in ? deltab[q0 + tid] : 0.f;
    }
    // Skip a q-tile none of whose valid queries sees a key of this tile.
    const bool unseen = tid >= kTile || tq == kInvalidTime ||
                        (kCausal ? tq < kmin : kmin == kInvalidTime);
    if (__syncthreads_and(unseen)) continue;

    load_tile<D>(Qs, qb, q0, Lq, tid);
    load_tile<D>(dOs, dob, q0, Lq, tid);
    __syncthreads();

    // P^T: the warp's 16 keys x the tile's 64 queries
    float pt[8][4];
    gemm_abt<D>(pt, Ks, wr, Qs, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = n * 8 + t4 * 2 + (j & 1);
        const int tkr = j < 2 ? tk0 : tk1;
        const bool vis = kCausal ? tkr <= s_tq[qc] : tkr != kInvalidTime;
        pt[n][j] = vis ? exp2f(pt[n][j] * scale_log2 - s_lse[qc]) : 0.f;
      }
    }
    // dS^T = P^T * (V dO^T - delta) * sm_scale
    float dst[8][4];
    gemm_abt<D>(dst, Vs, wr, dOs, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = n * 8 + t4 * 2 + (j & 1);
        dst[n][j] = pt[n][j] * (dst[n][j] - s_delta[qc]) * sm_scale;
      }
    }
    uint32_t f[4][4];
    to_a_frags(f, pt);
    gemm_pb<D>(dv_acc, f, dOs, g, t4);  // dV += P^T dO
    to_a_frags(f, dst);
    gemm_pb<D>(dk_acc, f, Qs, g, t4);   // dK += dS^T Q
    __syncthreads();  // Qs, dOs and the row arrays are rewritten next
  }

  store_rows<D>(dk + bh * Lk * D, dk_acc, kr0, Lk, t4);
  store_rows<D>(dv + bh * Lk * D, dv_acc, kr0, Lk, t4);
}

// K4: dQ of one 64-row q-tile.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const int* __restrict__ time_q,
                    const int* __restrict__ time_kv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq,
                    int H, int Lq, int Lk, float sm_scale, float scale_log2) {
  constexpr int kStride = D + 8;
  constexpr int kOt = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kTile * kStride;
  __nv_bfloat16* Ks = dOs + kTile * kStride;
  __nv_bfloat16* Vs = Ks + kTile * kStride;
  int* s_tk = reinterpret_cast<int*>(Vs + kTile * kStride);
  __shared__ int s_qmax;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int q0 = blockIdx.x * kTile;

  const __nv_bfloat16* qb = q + bh * Lq * D;
  const __nv_bfloat16* kb = k + bh * Lk * D;
  const __nv_bfloat16* vb = v + bh * Lk * D;
  const __nv_bfloat16* dob = dout + bh * Lq * D;
  const int* tqb = time_q + static_cast<size_t>(b) * Lq;
  const int* tkb = time_kv + static_cast<size_t>(b) * Lk;

  // Q and dO stay staged; find the largest valid query time of the tile (-1
  // if there is none).
  if (tid == 0) s_qmax = -1;
  load_tile<D>(Qs, qb, q0, Lq, tid);
  load_tile<D>(dOs, dob, q0, Lq, tid);
  __syncthreads();
  if (tid < kTile && q0 + tid < Lq) {
    const int t = tqb[q0 + tid];
    if (t != kInvalidTime) atomicMax(&s_qmax, t);
  }
  // this thread's two rows: r0 (elements 0, 1) and r0 + 8 (2, 3)
  const int wr = warp * 16;
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  const int tq0 = r0 < Lq ? tqb[r0] : kInvalidTime;
  const int tq1 = r1 < Lq ? tqb[r1] : kInvalidTime;
  const float lse0 = r0 < Lq ? lse[bh * Lq + r0] * kLog2e : INFINITY;
  const float lse1 = r1 < Lq ? lse[bh * Lq + r1] * kLog2e : INFINITY;
  const float dl0 = r0 < Lq ? delta[bh * Lq + r0] : 0.f;
  const float dl1 = r1 < Lq ? delta[bh * Lq + r1] : 0.f;
  float dq_acc[kOt][4];
#pragma unroll
  for (int n = 0; n < kOt; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  __syncthreads();  // s_qmax is final
  const int qmax = s_qmax;

  const int nk = (Lk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    int tk = kInvalidTime;
    if (tid < kTile) {
      if (k0 + tid < Lk) tk = tkb[k0 + tid];
      s_tk[tid] = tk;
    }
    // Skip a k-tile that no valid query of this q-tile can see.
    const bool unseen =
        tid >= kTile || (kCausal ? tk > qmax : (tk == kInvalidTime || qmax < 0));
    if (__syncthreads_and(unseen)) continue;

    load_tile<D>(Ks, kb, k0, Lk, tid);
    load_tile<D>(Vs, vb, k0, Lk, tid);
    __syncthreads();

    // P: the warp's 16 queries x the tile's 64 keys
    float p[8][4];
    gemm_abt<D>(p, Qs, wr, Ks, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tkc = s_tk[n * 8 + t4 * 2 + (j & 1)];
        const int tqr = j < 2 ? tq0 : tq1;
        const bool vis = kCausal ? tkc <= tqr : tkc != kInvalidTime;
        p[n][j] = vis ? exp2f(p[n][j] * scale_log2 - (j < 2 ? lse0 : lse1)) : 0.f;
      }
    }
    // dS = P * (dO V^T - delta) * sm_scale
    float ds[8][4];
    gemm_abt<D>(ds, dOs, wr, Vs, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ds[n][j] = p[n][j] * (ds[n][j] - (j < 2 ? dl0 : dl1)) * sm_scale;
      }
    }
    uint32_t f[4][4];
    to_a_frags(f, ds);
    gemm_pb<D>(dq_acc, f, Ks, g, t4);  // dQ += dS K
    __syncthreads();  // Ks, Vs and s_tk are rewritten by the next tile
  }

  store_rows<D>(dq + bh * Lq * D, dq_acc, r0, Lq, t4);
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const int *time_q, *time_kv;
  const float *lse, *delta;
  int B, H, Lq, Lk;
  float sm_scale;
};

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* time_q, const void* time_kv, const void* lse,
               const void* delta, int B, int H, int Lq, int Lk, float sm_scale) {
  return Args{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
              static_cast<const int*>(time_q), static_cast<const int*>(time_kv),
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              B, H, Lq, Lk, sm_scale};
}

template <int D, bool kCausal>
int launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lk + kTile - 1) / kTile, a.H, a.B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      a.q, a.k, a.v, a.dout, a.time_q, a.time_kv, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.H,
      a.Lq, a.Lk, a.sm_scale, a.sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + kTile - 1) / kTile, a.H, a.B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      a.q, a.k, a.v, a.dout, a.time_q, a.time_kv, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.H, a.Lq, a.Lk, a.sm_scale,
      a.sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout: [B, H, L, D] bf16, contiguous. time_q [B, Lq], time_kv
// [B, Lk] int32. lse, delta [B, H, Lq] fp32 (natural-log lse of the forward;
// delta = rowsum(o * dout)). dk, dv [B, H, Lk, D] bf16. Returns a cudaError_t
// value (0 = success).
extern "C" int pf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* time_q,
                                const void* time_kv, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int Lq, int Lk, int D, float sm_scale,
                                int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, time_q, time_kv, lse, delta, B, H,
                           Lq, Lk, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return causal ? launch_dkv<64, true>(a, dk, dv, s) : launch_dkv<64, false>(a, dk, dv, s);
  if (D == 128) return causal ? launch_dkv<128, true>(a, dk, dv, s) : launch_dkv<128, false>(a, dk, dv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As pf_flash_bwd_dkv; dq [B, H, Lq, D] bf16.
extern "C" int pf_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* time_q,
                               const void* time_kv, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Lq, int Lk, int D, float sm_scale,
                               int causal, void* stream) {
  const Args a = make_args(q, k, v, dout, time_q, time_kv, lse, delta, B, H,
                           Lq, Lk, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return causal ? launch_dq<64, true>(a, dq, s) : launch_dq<64, false>(a, dq, s);
  if (D == 128) return causal ? launch_dq<128, true>(a, dq, s) : launch_dq<128, false>(a, dq, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
