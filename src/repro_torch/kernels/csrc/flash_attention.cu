// Blockwise causal / full GQA attention forward for Hopper (sm_90a), f32
// accumulation on CUDA cores, f32 or bf16 inputs.
//
//   out[b, q, h, :] = softmax_k(mask(softcap(q . k / sqrt(D)))) . v
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel).  Semantics are the reference's
// (src/repro/kernels/ref.py: attention_ref): bottom-right causal alignment
// k <= q + (Sk - Sq), masked scores set to -1e30 (so a row with no visible
// key averages all Sk values, as the reference's softmax does), optional
// softcap * tanh(s / softcap), p rounded to v's dtype before P.V, output
// acc / max(l, 1e-30) in q's dtype.  q head h reads kv head h / G.
//
// Design.  The TPU kernel walks a (B*H, Sq/bq, Sk/bk) grid whose last axis
// is sequential and carries m, l and acc in VMEM scratch.  Blocks do not
// run in order here, so the sequential axis becomes a loop inside the
// block: one block owns BQ = 64 query rows of one (b, h) and streams the
// K/V tiles of kv head h / G through shared memory, BK = 64 keys at a time,
// keeping the online-softmax m and l in shared memory and the output
// accumulator in registers (f32).  256 threads form a 16 x 16 grid: for
// S = Q K^T a thread computes a 4 x 4 micro-tile (rows ty + 16 i, keys
// tx + 16 j), for P.V a 4 x ceil(D/16) tile of the output.  Rows of the
// staged Q and K tiles are padded to D + 1 words, so a warp's column reads
// hit distinct banks.  Keys past the causal limit of the whole q tile are
// not loaded; keys past Sk do not exist (p = 0), so nothing is padded and
// the result does not depend on any block size.  Inputs are read through
// their strides (last dim contiguous); the output is written (B, Sq, H, D).
//
// Bound on an H100 SXM: at the serving path's prefill (b x 128 tokens,
// 40 q heads, 8 kv heads, D = 128, bf16) one launch is ~0.17 GFLOP of
// causal work per batch row over ~3.1 MB per batch row (q, k, v read
// once, out written once): a few microseconds at either roof, so a
// launch is latency-bound.  This first version is right and simple: no
// tensor cores (mma.sync / wgmma), no TMA, no pipelining of the tile loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int RI = BQ / 16;  // query rows per thread
constexpr int RJ = BK / 16;  // keys per thread in S = Q K^T
constexpr int PS = BK + 1;   // padded row stride of the P tile
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
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                 int H, int G, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, int causal, int has_cap,
                 float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = (D + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP]
  float* ks = qs + BQ * DP;     // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][D]
  float* ps = vs + BK * D;      // [BQ][PS]
  float* row_m = ps + BQ * PS;  // [BQ]
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / G;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int off = Sk - Sq;  // bottom-right causal alignment

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const int qr = q0 + r;
    qs[r * DP + d] = qr < Sq ? to_f32(qb[qr * qss + d]) : 0.0f;
  }
  if (tid < BQ) {
    row_m[tid] = MASKED;
    row_l[tid] = 0.0f;
  }

  // Keys any row of this tile can see.  If some row sees none (causal with
  // Sq > Sk), every key takes part with the masked score, as in the
  // reference, so no tile is skipped.
  int k_end = Sk;
  if (causal && q0 + off >= 0) {
    k_end = min(Sk, min(q0 + BQ, Sq) - 1 + off + 1);
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D;
      const int d = e - c * D;
      const int key = k0 + c;
      const bool ok = key < Sk;
      ks[c * DP + d] = ok ? to_f32(kb[key * kss + d]) : 0.0f;
      vs[c * D + d] = ok ? to_f32(vb[key * vss + d]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T, scaled, capped and masked, into the P tile
    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int c = tx + 16 * j;
        const int key = k0 + c;
        float x;
        if (key >= Sk) {
          x = -CUDART_INF_F;  // no such key: p = 0
        } else {
          x = s[i][j] * scale;
          if (has_cap) x = softcap * tanhf(x / softcap);
          if (causal && key > qpos + off) x = MASKED;
        }
        ps[r * PS + c] = x;
      }
    }
    __syncthreads();

    // online softmax: 4 consecutive threads per row
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float mx = -CUDART_INF_F;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, ps[r * PS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(ps[r * PS + c] - m_new);
        sum += p;
        ps[r * PS + c] = to_f32(from_f32<T>(p));  // p in v's dtype for P.V
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    const int c_end = min(BK, Sk - k0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float corr = row_c[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < c_end; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? vs[c * D + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float inv_l = 1.0f / fmaxf(row_l[r], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[d] = from_f32<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, const long long* qst,
           const long long* kst, const long long* vst, int causal,
           int has_cap, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, H / KV,
      qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
      causal, has_cap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Sk, int H, int KV, const long long* qst,
               const long long* kst, const long long* vst, int causal,
               int has_cap, float softcap, cudaStream_t s) {
  switch (D) {
#define CASE(DD)                                                         \
  case DD:                                                               \
    return launch<T, DD>(q, k, v, out, B, Sq, Sk, H, KV, qst, kst, vst,  \
                         causal, has_cap, softcap, s);
    CASE(8) CASE(16) CASE(32) CASE(64) CASE(128) CASE(256)
#undef CASE
    default:
      return -1;
  }
}

}  // namespace

// q: (B, Sq, H, D), k / v: (B, Sk, KV, D), strides in elements for the
// batch, sequence and head axes (the last axis contiguous); out: (B, Sq, H,
// D) contiguous; dtype 0 = float32, 1 = bfloat16.  Returns 0 on success,
// -1 for an unsupported head size, else cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, int has_cap, float softcap, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  const long long qst[3] = {qsb, qss, qsh};
  const long long kst[3] = {ksb, kss, ksh};
  const long long vst[3] = {vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, B, Sq, Sk, H, KV, qst, kst, vst,
                             causal, has_cap, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, KV, qst,
                                     kst, vst, causal, has_cap, softcap, s);
  return -1;
}
