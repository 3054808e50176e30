// A DiT block's gated residual update and the LayerNorm after it, in one
// pass, for Hopper (sm_90a; nothing in it needs more than sm_80).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the same chain (x + g * y,
// LayerNorm, the adaLN modulation, the cast) into one loop. On the card
// PyTorch ran it as five to seven full-tensor kernels per call: the fp32
// upcast, the LayerNorm, the cast back, a multiply and an add for the
// modulation, and a multiply and an add for the gated residual, each
// reading and writing the whole tensor.
//
// What it computes, per row (token) of width D of a stream X [B, L, D]
// (bf16: miniFLUX and SD3; fp32: Wan), in fp32:
//   residual (when Y is given): X' = X + G[b] * Y, or X + Y without a gate;
//              Y [B, L, D] bf16, G [B, 1, D] in X's dtype; X' is rounded to
//              X's dtype and written to OX (a fresh tensor);
//   norm (when OH is given): n = (X' - mean) * rsqrt(var + eps), mean and
//              var over the row, exact two-pass; then
//              modulation: OH = bf16(n * (1 + scale[b]) + shift[b]), scale
//                          and shift [B, 1, D] in X's dtype;
//              affine:     OH = bf16(n * w + c), w and c a LayerNorm's own
//                          bf16 weight and bias [D].
// The norm reads X' as it was rounded and stored, so OH is a function of
// what the next residual reads. X + G * Y rounds as PyTorch's separate
// fp32 kernels do (a product, then a sum; no FMA contraction), so OX equals
// the plain version (ops/residual_norm.py: residual_norm_reference) bit for
// bit; OH differs from it by the order of the row's sums and rsqrtf's last
// bit.
//
// Design: blocks of 128 threads (4 warps). A row of D / 8 vectors of 8
// features (a 16-byte bf16 load, or two fp32 ones) is held in registers by
// one warp when D <= 2048 (four rows a block; no shared memory and no
// barrier: the sums are butterfly shuffles), or by the whole block when D
// <= 8192 (one row a block; each warp's partial sum through shared memory,
// one barrier per sum, two per row). A thread holds VPT vectors, strided by
// the row's thread count so each warp-wide load covers 512 contiguous bytes
// of bf16; VPT is a template parameter (the row's vectors over its threads,
// rounded up), so the loads are unrolled and in flight together. The
// modulation vectors are read by every row of their batch row, from L1/L2.
//
// What bounds it on an H100: bytes. Per element it reads X (2 or 4 bytes)
// and Y (2) and writes X' and OH (2 or 4, and 2). miniFLUX's dual-block
// latent stream at 2 x 3072 rows x 1536 moves 8 bytes an element, 75.5 MB,
// 22.5 us at 3.35 TB/s; Wan's fp32 stream at 2 x 2944 x 5120 moves 12, 362
// MB, 108 us.
//
// Entry point: pf_residual_norm (plain C interface, bound with ctypes). It
// returns a cudaError_t value after the launch (0 = success). It launches on
// the given stream, synchronises nothing and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 8;         // features per vector: one 16-byte bf16 load
constexpr int kThreads = 128;   // threads per block
constexpr int kMaxVpt = 8;      // vectors per thread
constexpr int kWideWarps = 4;   // warps per row past one warp's reach
constexpr int kMinBlocks = 4;   // blocks per SM: at most 128 registers a thread

struct Params {
  const void* x;         // [B, L, D] in TX, rows contiguous
  long long x_batch;     // X's batch stride, in elements
  const __nv_bfloat16* y;  // [B, L, D] contiguous, or null
  const void* gate;      // [B, 1, D] in TX, or null
  const void* scale;     // modulation: [B, 1, D] in TX; affine: [D] bf16
  const void* shift;
  long long gate_batch, scale_batch, shift_batch;  // in elements
  int affine;
  void* out_x;           // [B, L, D] contiguous in TX, or null
  __nv_bfloat16* out_h;  // [B, L, D] contiguous, or null
  float eps;
  int rows_per_batch;    // L
  int width;             // D
  long long rows;        // B * L
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// the value an element of TX reads back as once stored
template <typename TX>
__device__ __forceinline__ float stored(float v);
template <>
__device__ __forceinline__ float stored<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float stored<float>(float v) {
  return v;
}

// the sum over the row's WARPS warps, the same in every thread of the row
template <int WARPS>
__device__ __forceinline__ float row_sum(float s, float* partial, int warp_in_row, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (WARPS == 1) return s;
  if (lane == 0) partial[warp_in_row] = s;
  __syncthreads();
  s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += partial[w];
  return s;
}

template <typename TX, int WARPS, int VPT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) residual_norm_kernel(const Params p) {
  constexpr int kRows = kThreads / 32 / WARPS;  // rows per block
  static_assert(WARPS == 1 || kRows == 1, "a row of several warps fills its block");
  __shared__ float partial[2][kRows][WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / WARPS;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + slot;
  // only a row of one warp can be past the end (a wide row fills its
  // block), so no thread that skips would have met a barrier
  if (row >= p.rows) return;
  const int b = static_cast<int>(row / p.rows_per_batch);
  const long long l = row - static_cast<long long>(b) * p.rows_per_batch;
  const int D = p.width;
  const int nv = D / kVec;
  const int t = (warp % WARPS) * 32 + lane;  // this thread's place in the row

  const TX* x = static_cast<const TX*>(p.x) + b * p.x_batch + l * D;
  float v[VPT][kVec];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = t + k * 32 * WARPS;
    if (j < nv) {
      load8(x + j * kVec, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[k][e] = 0.f;
    }
  }
  if (p.y != nullptr) {
    const __nv_bfloat16* y = p.y + row * D;
    const TX* g = p.gate == nullptr ? nullptr : static_cast<const TX*>(p.gate) + b * p.gate_batch;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * 32 * WARPS;
      if (j >= nv) continue;
      float yy[kVec];
      load8(y + j * kVec, yy);
      if (g != nullptr) {
        float gg[kVec];
        load8(g + j * kVec, gg);
#pragma unroll
        for (int e = 0; e < kVec; ++e) yy[e] = __fmul_rn(gg[e], yy[e]);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[k][e] = stored<TX>(__fadd_rn(v[k][e], yy[e]));
    }
    if (p.out_x != nullptr) {
      TX* ox = static_cast<TX*>(p.out_x) + row * D;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int j = t + k * 32 * WARPS;
        if (j < nv) store8(ox + j * kVec, v[k]);
      }
    }
  }
  if (p.out_h == nullptr) return;

  const int warp_in_row = warp % WARPS;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) s += v[k][e];  // past the row: zeros
  }
  const float mean = row_sum<WARPS>(s, partial[0][slot], warp_in_row, lane) / static_cast<float>(D);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (t + k * 32 * WARPS >= nv) continue;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = v[k][e] - mean;
      q += d * d;
    }
  }
  const float var = row_sum<WARPS>(q, partial[1][slot], warp_in_row, lane) / static_cast<float>(D);
  const float rstd = rsqrtf(var + p.eps);

  __nv_bfloat16* oh = p.out_h + row * D;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = t + k * 32 * WARPS;
    if (j >= nv) continue;
    float mul[kVec], add[kVec];
    if (p.affine) {
      load8(static_cast<const __nv_bfloat16*>(p.scale) + j * kVec, mul);
      load8(static_cast<const __nv_bfloat16*>(p.shift) + j * kVec, add);
    } else {
      load8(static_cast<const TX*>(p.scale) + b * p.scale_batch + j * kVec, mul);
      load8(static_cast<const TX*>(p.shift) + b * p.shift_batch + j * kVec, add);
#pragma unroll
      for (int e = 0; e < kVec; ++e) mul[e] = 1.f + mul[e];
    }
    float h[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) h[e] = (v[k][e] - mean) * rstd * mul[e] + add[e];
    store8(oh + j * kVec, h);
  }
}

template <typename TX, int WARPS, int VPT>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kRows = kThreads / 32 / WARPS;
  const long long blocks = (p.rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  residual_norm_kernel<TX, WARPS, VPT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, int WARPS>
int launch_vpt(const Params& p, int vpt, cudaStream_t stream) {
  switch (vpt) {
    case 1: return launch<TX, WARPS, 1>(p, stream);
    case 2: return launch<TX, WARPS, 2>(p, stream);
    case 3: return launch<TX, WARPS, 3>(p, stream);
    case 4: return launch<TX, WARPS, 4>(p, stream);
    case 5: return launch<TX, WARPS, 5>(p, stream);
    case 6: return launch<TX, WARPS, 6>(p, stream);
    case 7: return launch<TX, WARPS, 7>(p, stream);
    case kMaxVpt: return launch<TX, WARPS, kMaxVpt>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TX>
int launch_row(const Params& p, cudaStream_t stream) {
  const int nv = p.width / kVec;
  if (nv <= 32 * kMaxVpt) return launch_vpt<TX, 1>(p, (nv + 31) / 32, stream);
  return launch_vpt<TX, kWideWarps>(p, (nv + 32 * kWideWarps - 1) / (32 * kWideWarps), stream);
}

}  // namespace

// x_fp32: the stream X (and G, and a modulation's scale and shift) is fp32,
// else bf16. y, gate, out_x: null for no residual (gate also null for an
// ungated one; out_x null only without y). scale, shift, out_h: null for no
// norm; affine: scale and shift are a LayerNorm's bf16 weight and bias.
// Strides are in elements. The caller (ops/residual_norm.py:
// check_operands) validates shapes, dtypes, alignment and contiguity; this
// only refuses what the kernel cannot index.
extern "C" int pf_residual_norm(const void* x, long long x_batch, int x_fp32, const void* y,
                                const void* gate, long long gate_batch, const void* scale,
                                long long scale_batch, const void* shift, long long shift_batch,
                                int affine, void* out_x, void* out_h, float eps, int B, int L, int D,
                                void* stream) {
  if (B < 0 || L < 0 || D < kVec || D % kVec != 0 || D > kVec * 32 * kWideWarps * kMaxVpt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // no rows (a sequence-parallel rank's empty text shard): nothing to do;
  // the empty outputs' pointers may be null
  if (static_cast<long long>(B) * L == 0) return static_cast<int>(cudaSuccess);
  if ((y == nullptr && (gate != nullptr || out_x != nullptr)) ||
      (out_h != nullptr && (scale == nullptr || shift == nullptr)) ||
      (out_x == nullptr && out_h == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.x = x;
  p.x_batch = x_batch;
  p.y = static_cast<const __nv_bfloat16*>(y);
  p.gate = gate;
  p.scale = scale;
  p.shift = shift;
  p.gate_batch = gate_batch;
  p.scale_batch = scale_batch;
  p.shift_batch = shift_batch;
  p.affine = affine;
  p.out_x = out_x;
  p.out_h = static_cast<__nv_bfloat16*>(out_h);
  p.eps = eps;
  p.rows_per_batch = L;
  p.width = D;
  p.rows = static_cast<long long>(B) * L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_fp32 ? launch_row<float>(p, s) : launch_row<__nv_bfloat16>(p, s);
}
