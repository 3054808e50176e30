// The DiTs' q, k and v from their projections to the attention's layout,
// in one pass, for Hopper (sm_90a; nothing in it needs more than sm_80).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the same chain (RMS norm,
// the text/latent concatenation, RoPE) into the projections' epilogues. On
// the card PyTorch ran it as about fifteen elementwise and reduction kernels
// per tensor, in fp32, with a bf16 rounding between the norm and the
// rotation, a torch.cat of the text and latent heads and a copy to make each
// tensor contiguous.
//
// What it computes, for up to three slots (q, k, v of one attention site),
// each with one or two sources S_i [B, L_i, W] (W = H * Dh, text first) in
// bf16 and an output O [B, H, L_0 + L_1, Dh] in bf16. For the token l of
// the joint sequence, taken from source i at its own token l_i:
//   norm slot: y = x * rsqrt(mean_G(x^2) + eps_i) * g_i, in fp32, where the
//              group G is one head (the gain has Dh entries: miniFLUX, SD3)
//              or the whole token (W entries: Wan);
//   rope slot: y's interleaved pairs of each head rotated by cos/sin[b, l]
//              ([B, L_0 + L_1, Dh / 2] fp32), in fp32;
//   copy slot: y = x (v);
//   O[b, h, l, :] = bf16(y[h * Dh : (h + 1) * Dh]), rounded once.
// The products round as PyTorch's separate fp32 kernels do (no FMA
// contraction), so the only difference from the plain version
// (ops/qk_norm_rope.py: qk_norm_rope_reference) is the order of the sum of
// squares and rsqrtf's last bit.
//
// Design: one block per (slot, batch row, token), blocks of the three slots
// in one grid (a prefix over the slots' token counts picks the slot). A
// thread holds 8 consecutive features: one 16-byte load, one 16-byte store,
// four rotation pairs whose cos/sin are two 16-byte loads; W / 8 threads,
// rounded up to whole warps, cover the token. The norm group picks the
// reduction:
//   * a head (Dh / 8 <= 32 threads, a power of two: 8 at Dh = 64, 16 at
//     Dh = 128): butterfly shuffles within the head's lanes, no shared
//     memory and no barrier;
//   * the whole token (Wan: 640 threads at W = 5120): shuffles within each
//     warp, then each warp's partial through shared memory, summed by every
//     thread in the same order.
// The output is written head-major, so each head's Dh features land as one
// contiguous 128- or 256-byte row.
//
// What bounds it on an H100: bytes. It reads each bf16 source once and writes
// each output once (4 bytes per element of q, k or v) and reads the fp32
// cos/sin rows (4 * Dh bytes a token; each head of the token reads them
// again, from L1 or L2). miniFLUX's dual site at L = 3200, B = 2 moves
// 3 * 2 * 3200 * 1536 * 4 bytes = 118 MB, 35 us at 3.35 TB/s.
//
// Entry point: pf_qk_norm_rope (plain C interface, bound with ctypes). It
// returns a cudaError_t value after the launch (0 = success). It launches on
// the given stream, synchronises nothing and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 3;
constexpr int kVec = 8;  // features per thread: one 16-byte load
constexpr int kMaxThreads = 1024;

struct Slot {
  const __nv_bfloat16* src[2];   // [B, len[i], width]
  const __nv_bfloat16* gain[2];  // [group], or null in a copy slot
  __nv_bfloat16* dst;            // [B, H, len[0] + len[1], head_dim]
  float eps[2];
  int len[2];
  int group;  // head_dim, width, or 0: a plain copy
  int rope;
  long long first_block;  // this slot's first block in the grid
};

struct Params {
  Slot slot[kSlots];
  int nslots;
  int width;
  int head_dim;
  const float* cos;  // [B, rope_len, head_dim / 2], batch stride cs_batch
  const float* sin;
  long long cs_batch;
};

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__global__ void qk_norm_rope_kernel(const Params p) {
  __shared__ float partial[kMaxThreads / 32];
  const long long block = blockIdx.x;
  int s = 0;
#pragma unroll
  for (int i = 1; i < kSlots; ++i) {
    if (i < p.nslots && block >= p.slot[i].first_block) s = i;
  }
  const Slot& sl = p.slot[s];
  const int joint = sl.len[0] + sl.len[1];
  const long long n = block - sl.first_block;
  const int b = static_cast<int>(n / joint);
  const int l = static_cast<int>(n % joint);
  const int i = l < sl.len[0] ? 0 : 1;
  const int li = i == 0 ? l : l - sl.len[0];

  const int e = threadIdx.x * kVec;  // this thread's first feature
  const bool active = e < p.width;
  float x[kVec];
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (active) {
    raw = *reinterpret_cast<const uint4*>(
        sl.src[i] + (static_cast<long long>(b) * sl.len[i] + li) * p.width + e);
  }
  const int h = e / p.head_dim;
  const int d = e - h * p.head_dim;
  __nv_bfloat16* out = sl.dst + ((static_cast<long long>(b) * (p.width / p.head_dim) + h) *
                                     joint + l) * p.head_dim + d;
  if (sl.group == 0) {  // v: a copy into the joint layout
    if (active) *reinterpret_cast<uint4*>(out) = raw;
    return;
  }
  unpack(raw, x);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) ss += x[k] * x[k];
  if (sl.group == p.head_dim) {  // one head: its Dh / 8 lanes
    for (int off = p.head_dim / (2 * kVec); off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
  } else {  // the whole token: every warp, then the block
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const int warps = blockDim.x / 32;
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < warps; ++w) ss += partial[w];
  }
  if (!active) return;
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(sl.group)), sl.eps[i]));
  float g[kVec];
  unpack(*reinterpret_cast<const uint4*>(sl.gain[i] + (sl.group == p.head_dim ? d : e)), g);
#pragma unroll
  for (int k = 0; k < kVec; ++k) x[k] = __fmul_rn(__fmul_rn(x[k], r), g[k]);
  if (sl.rope) {
    const long long at = b * p.cs_batch + static_cast<long long>(l) * (p.head_dim / 2) + d / 2;
    const float4 c = *reinterpret_cast<const float4*>(p.cos + at);
    const float4 sn = *reinterpret_cast<const float4*>(p.sin + at);
    const float cc[4] = {c.x, c.y, c.z, c.w};
    const float ss4[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      const float xe = x[2 * k], xo = x[2 * k + 1];
      x[2 * k] = __fsub_rn(__fmul_rn(cc[k], xe), __fmul_rn(ss4[k], xo));
      x[2 * k + 1] = __fadd_rn(__fmul_rn(ss4[k], xe), __fmul_rn(cc[k], xo));
    }
  }
  *reinterpret_cast<uint4*>(out) = pack(x);
}

}  // namespace

// srcs, gains: 2 per slot (source 1 null when a slot has one source; gains
// null in a copy slot); dsts: 1 per slot; lens, eps: 2 per slot; groups,
// ropes: 1 per slot. cos/sin may be null when no slot rotates. The caller
// (ops/qk_norm_rope.py: check_slots) validates shapes, dtypes, alignment and
// contiguity; this only refuses a geometry the kernel cannot index.
extern "C" int pf_qk_norm_rope(const void* const* srcs, const void* const* gains,
                               void* const* dsts, const int* lens, const float* eps,
                               const int* groups, const int* ropes, int nslots, int B,
                               int width, int head_dim, const void* cos, const void* sin,
                               long long cs_batch, void* stream) {
  const int lanes = head_dim / kVec;  // threads of one head
  if (nslots < 1 || nslots > kSlots || head_dim < kVec || head_dim % kVec != 0 || width % head_dim != 0 ||
      width / kVec > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.nslots = nslots;
  p.width = width;
  p.head_dim = head_dim;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.cs_batch = cs_batch;
  long long blocks = 0;
  for (int s = 0; s < nslots; ++s) {
    Slot& sl = p.slot[s];
    sl.group = groups[s];
    sl.rope = ropes[s];
    sl.dst = static_cast<__nv_bfloat16*>(dsts[s]);
    // a head's lanes must sit in one warp, aligned: a power of two up to 32
    if ((sl.group != 0 && sl.group != head_dim && sl.group != width) ||
        (sl.group == head_dim && (lanes > 32 || (lanes & (lanes - 1)) != 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < 2; ++i) {
      sl.len[i] = lens[2 * s + i];
      sl.src[i] = static_cast<const __nv_bfloat16*>(srcs[2 * s + i]);
      sl.gain[i] = static_cast<const __nv_bfloat16*>(gains[2 * s + i]);
      sl.eps[i] = eps[2 * s + i];
    }
    sl.first_block = blocks;
    blocks += static_cast<long long>(B) * (sl.len[0] + sl.len[1]);
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // a slot past the last covers no block
  for (int s = nslots; s < kSlots; ++s) p.slot[s].first_block = blocks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const int threads = (width / kVec + 31) / 32 * 32;
  qk_norm_rope_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
