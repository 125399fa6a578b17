// One-token GQA flash-decode over an S-deep KV cache for Hopper (sm_90a),
// f32 accumulation on CUDA cores, f32 or bf16 inputs.
//
//   out[b, h, :] = softmax_{s < lengths[b]}(softcap(q[b, h] . k[b, s, h/G] /
//                  sqrt(D))) . v[b, s, h/G]
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel).  Semantics are the reference's
// (src/repro/kernels/ref.py: decode_attention_ref): keys at or past
// lengths[b] are masked (a sequence with lengths[b] <= 0 sees no key and,
// as in the reference's softmax over -1e30 scores, averages all S values),
// optional softcap, p rounded to v's dtype before P.V, output
// acc / max(l, 1e-30) in q's dtype.
//
// Design.  Decode is bound by the bytes of the cache it streams; the only
// reuse is GQA: the G query heads of one kv head share every K/V row.  One
// block owns one (b, kv head): it stages the G query rows once, then walks
// the valid prefix of the cache, BK = 32 keys at a time, through shared
// memory (K rows padded to D + 1 words), computes the G x BK scores, updates
// the G online-softmax rows (one warp per row, one key per lane) and the
// G x D accumulator in shared memory.  The cache is read in place as
// (B, S, KV, D) through its strides -- the TPU wrapper's moveaxis / pad
// would copy the whole cache on every step and layer -- and only the first
// lengths[b] rows of it are read, so the work follows the data.
//
// Bound on an H100 SXM: at the serving path's decode (b <= 8, 40 q heads,
// 8 kv heads, D = 128, lengths 129..143, bf16) the valid prefix is at most
// 4.7 MB per layer: ~1.4 us of HBM time, below the launch latency, so a
// launch is latency-bound.  With b x KV = 8 .. 64 blocks the card is mostly
// idle; split-K (flash-decoding across blocks) is the way to fill it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>

namespace {

constexpr int BK = 32;  // keys per staged tile (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PS = BK + 1;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) *
         (static_cast<size_t>(G) * D      // q rows
          + BK * (D + 1) + BK * D         // K, V tiles
          + static_cast<size_t>(G) * PS   // P tile
          + static_cast<size_t>(G) * D    // accumulator
          + 3 * static_cast<size_t>(G));  // m, l, corr
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ out, int S, int KV, int G, long long qsb,
              long long qsh, long long ksb, long long kss, long long ksh,
              long long vsb, long long vss, long long vsh, int has_cap,
              float softcap, float scale) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                // [G][D]
  float* ks = qs + G * D;          // [BK][DP]
  float* vs = ks + BK * DP;        // [BK][D]
  float* ps = vs + BK * D;         // [G][PS]
  float* acc = ps + G * PS;        // [G][D]
  float* row_m = acc + G * D;      // [G]
  float* row_l = row_m + G;
  float* row_c = row_l + G;

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = lengths[b];
  const bool none = len <= 0;  // no visible key: all S take part, masked
  const int n_keys = none ? S : min(len, S);

  const T* kb = kc + b * ksb + kvh * ksh;
  const T* vb = vc + b * vsb + kvh * vsh;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    const int d = e - g * D;
    qs[e] = to_f32(q[b * qsb + (kvh * G + g) * qsh + d]);
    acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    row_m[g] = MASKED;
    row_l[g] = 0.0f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D;
      const int d = e - c * D;
      const int key = k0 + c;
      const bool ok = key < n_keys;
      ks[c * DP + d] = ok ? to_f32(kb[key * kss + d]) : 0.0f;
      vs[c * D + d] = ok ? to_f32(vb[key * vss + d]) : 0.0f;
    }
    __syncthreads();

    for (int e = tid; e < G * BK; e += THREADS) {
      const int g = e / BK;
      const int c = e - g * BK;
      float x;
      if (k0 + c >= n_keys) {
        x = -CUDART_INF_F;  // not read: p = 0
      } else {
        float s = 0.0f;
        const float* qg = qs + g * D;
        const float* kr = ks + c * DP;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
        x = s * scale;
        if (has_cap) x = softcap * tanhf(x / softcap);
        if (none) x = MASKED;
      }
      ps[g * PS + c] = x;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      const float x = ps[g * PS + lane];
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = row_m[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[g * PS + lane] = to_f32(from_f32<T>(p));  // p in v's dtype for P.V
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[g] = row_l[g] * corr + sum;
        row_m[g] = m_new;
        row_c[g] = corr;
      }
    }
    __syncthreads();

    const int c_end = min(BK, n_keys - k0);
    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D;
      const int d = e - g * D;
      float a = acc[e] * row_c[g];
      const float* pg = ps + g * PS;
      for (int c = 0; c < c_end; ++c) a = fmaf(pg[c], vs[c * D + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  T* ob = out + (static_cast<long long>(b) * KV + kvh) * G * D;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    ob[e] = from_f32<T>(acc[e] / fmaxf(row_l[g], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int S, int H, int KV, const long long* st,
           int has_cap, float softcap, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = smem_bytes<D>(G);
  static size_t configured = 48 * 1024;  // the default dynamic limit
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_kernel<T, D><<<B * KV, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, KV, G,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], has_cap,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* lengths, void* out, int B, int S, int H, int KV,
               const long long* st, int has_cap, float softcap,
               cudaStream_t s) {
  switch (D) {
#define CASE(DD)                                                        \
  case DD:                                                              \
    return launch<T, DD>(q, k, v, lengths, out, B, S, H, KV, st, has_cap, \
                         softcap, s);
    CASE(8) CASE(16) CASE(32) CASE(64) CASE(128) CASE(256)
#undef CASE
    default:
      return -1;
  }
}

}  // namespace

// q: (B, H, D) with strides (qsb, qsh); k / v caches: (B, S, KV, D) with
// strides in elements for the batch, sequence and head axes (the last axis
// contiguous); lengths: (B,) int32; out: (B, H, D) contiguous; dtype 0 =
// float32, 1 = bfloat16.  Returns 0 on success, -1 for an unsupported head
// size or dtype, else cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, int B, int S, int H, int KV, int D, long long qsb,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int has_cap, float softcap, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const long long st[8] = {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, lengths, out, B, S, H, KV, st,
                             has_cap, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, out, B, S, H, KV,
                                     st, has_cap, softcap, s);
  return -1;
}
