// Blockwise GQA attention backward for Hopper (sm_90a): dQ, dK and dV of
// the forward kernel's function (flash_attention.cu),
//
//   x = q . k / sqrt(D);  c = softcap * tanh(x / softcap) (or x);
//   s = c, or -1e30 where masked (bottom-right causal k > q + Sk - Sq);
//   P = softmax_k(s);  out = P . v.
//
// Replaces no TPU kernel: the JAX package trains through the jnp
// flash_attention (src/repro/models/layers.py:112) under jax.grad, and its
// Pallas kernel has no backward.  This is the gradient of the port's own
// hand forward kernel, so training runs through that kernel.
//
// FlashAttention-2's backward, on the CUDA cores, in f32 (bf16 inputs are
// widened to f32 in shared memory; f32 never runs as TF32):
//   1. bwd_dot: Dv[b, h, q] = rowsum(dO * O), one warp a row, a fixed
//      shuffle butterfly;
//   2. bwd_dkdv: one block per (b, kv head, key tile) holds its K and V
//      tiles, walks the G query heads of its group and, per head, the
//      query tiles that can see the tile; per query tile it recomputes
//      P = exp(s - lse) from Q, K and the forward's saved log-sum-exp,
//      dP = dO V^T and dS = P (dP - Dv) (times 1 - tanh^2(x / softcap)
//      under the cap), and accumulates dV += P^T dO and dK += dS^T Q in
//      registers;
//   3. bwd_dq: one block per (b, head, query tile) holds Q and dO and walks
//      the key tiles it can see, dQ += dS K.
// No atomics: every sum is taken in one fixed order, so the gradient is
// the same bit for bit from run to run.
//
// Masking follows the forward: a masked score is the constant -1e30, so it
// passes no gradient to q or k; a key past Sk has p = 0; a row that sees
// no key at all (causal with q + Sk - Sq < 0) averages every key with
// p = 1 / Sk, as the reference's softmax over all -1e30 does -- it gives
// dV its share and dQ nothing.
//
// Tiles: T query rows by T keys, T = 64 for D <= 64 and 32 above, so the
// four f32 operand tiles (Q, dO, K, V, rows padded by one float so column
// reads spread over the banks) and the P / dS tiles fit in shared memory:
// 100 KB at D = 64, 75 KB at D = 128, 140 KB at D = 256.  256 threads as a
// 16 x 16 grid; a thread owns (T / 16) x (T / 16) score pairs and (T / 16)
// x ceil(D / 16) accumulator entries.
//
// Bound on an H100 SXM: at the training path's shape (b 8, S 256, 8 / 4
// heads of 64, causal, f32) a call is ~2.5x the forward's flops, ~1.3
// GFLOP over ~25 MB (q, k, v, out, dO and lse read once, dq, dk, dv
// written once): operations at the CUDA cores' 67 TFLOP/s (~20 us).
// This simple design is bound by shared-memory reads (two loads an FMA in
// the dot loops); wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int tile_of(int D) { return D <= 64 ? 64 : 32; }

template <int D>
constexpr size_t smem_bytes() {
  constexpr int T = tile_of(D);
  return sizeof(float) * (4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T);
}

struct Geo {
  int Sq, Sk, H, G;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int causal, has_cap;
  float softcap, scale;
};

// rows row0 .. row0 + T - 1 of a (rows, D) matrix with row stride rs into
// a (T, D + 1) f32 tile; rows at or past n_rows are zero
template <int D, int T, typename E>
__device__ __forceinline__ void load_tile(float* dst, const E* src, long long rs,
                                          int row0, int n_rows) {
  for (int e = threadIdx.x; e < T * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < n_rows ? to_f(src[row * rs + d]) : 0.0f;
  }
}

// P and dS of the pairs a thread owns: rows ty + 16 i of the query tile
// (at q0), keys tx + 16 j of the key tile (at k0).  qs / ds (dO) are the
// query side, ks / vs the key side; lse_s / dv_s the rows' log-sum-exp and
// rowsum(dO * O).  dS is the gradient with respect to x (before the
// 1 / sqrt(D) scale, which the callers apply once at the end).
template <int D, int T>
__device__ __forceinline__ void pairs(const float* qs, const float* dos,
                                      const float* ks, const float* vs,
                                      const float* lse_s, const float* dv_s,
                                      int q0, int k0, const Geo& g, float inv_sk,
                                      float (&p)[T / 16][T / 16],
                                      float (&ds)[T / 16][T / 16]) {
  constexpr int R = T / 16;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
      ov[i] = dos[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
  const int off = g.Sk - g.Sq;  // bottom-right causal alignment
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    const bool blind = g.causal && qpos + off < 0;  // the row sees no key
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int key = k0 + tx + 16 * j;
      float pij = 0.0f, dsij = 0.0f;
      if (qpos < g.Sq && key < g.Sk) {
        if (blind) {
          pij = inv_sk;
        } else if (!(g.causal && key > qpos + off)) {
          const float x = s[i][j] * g.scale;
          float c = x, dcap = 1.0f;
          if (g.has_cap) {
            const float th = tanhf(x / g.softcap);
            c = g.softcap * th;
            dcap = 1.0f - th * th;
          }
          pij = expf(c - lse_s[r]);
          dsij = pij * (dp[i][j] - dv_s[r]) * dcap;
        }
      }
      p[i][j] = pij;
      ds[i][j] = dsij;
    }
  }
}

// Dv = rowsum(dO * O): one warp a (b, q, h) row; O is (B, Sq, H, D)
// contiguous, dO read through its strides; Dv is (B, H, Sq)
template <typename E>
__global__ void __launch_bounds__(THREADS)
bwd_dot(const E* __restrict__ dout, const E* __restrict__ out, float* __restrict__ dvec,
        int B, int Sq, int H, int D, long long dsb, long long dss, long long dsh) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(B) * Sq * H) return;
  const int h = static_cast<int>(row % H);
  const long long bq = row / H;
  const int q = static_cast<int>(bq % Sq);
  const int b = static_cast<int>(bq / Sq);
  const E* o = out + row * D;
  const E* go = dout + b * dsb + q * dss + h * dsh;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(go[d]), to_f(o[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) dvec[(static_cast<long long>(b) * H + h) * Sq + q] = acc;
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
         const E* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ dvec, E* __restrict__ dk, E* __restrict__ dv,
         Geo g, int KV) {
  constexpr int T = tile_of(D);
  constexpr int R = T / 16;
  constexpr int DJ = (D + 15) / 16;
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + T * DP;
  float* qs = vs + T * DP;
  float* dos = qs + T * DP;
  float* ps = dos + T * DP;    // [T query rows][T + 1]
  float* dss = ps + T * (T + 1);
  float* lse_s = dss + T * (T + 1);
  float* dv_s = lse_s + T;

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int k0 = blockIdx.y * T;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int off = g.Sk - g.Sq;
  const float inv_sk = 1.0f / static_cast<float>(g.Sk);

  load_tile<D, T>(ks, k + b * g.ksb + kvh * g.ksh + k0 * g.kss, g.kss, 0, g.Sk - k0);
  load_tile<D, T>(vs, v + b * g.vsb + kvh * g.vsh + k0 * g.vss, g.vss, 0, g.Sk - k0);

  float adk[R][DJ], adv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.0f;

  const int nq = (g.Sq + T - 1) / T;
  for (int gi = 0; gi < g.G; ++gi) {
    const int h = kvh * g.G + gi;
    const E* qb = q + b * g.qsb + h * g.qsh;
    const E* ob = dout + b * g.dsb + h * g.dsh;
    const float* lb = lse + (static_cast<long long>(b) * g.H + h) * g.Sq;
    const float* db = dvec + (static_cast<long long>(b) * g.H + h) * g.Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * T;
      const int q_last = min(q0 + T, g.Sq) - 1;
      // a query tile takes part if one of its rows sees a key of this tile,
      // or one of them sees no key at all (p = 1 / Sk for every key)
      if (g.causal && q_last + off < k0 && q0 + off >= 0) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, T>(qs, qb, g.qss, q0, g.Sq);
      load_tile<D, T>(dos, ob, g.dss, q0, g.Sq);
      if (threadIdx.x < T) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < g.Sq ? lb[row] : 0.0f;
        dv_s[threadIdx.x] = row < g.Sq ? db[row] : 0.0f;
      }
      __syncthreads();
      float p[R][R], ds[R][R];
      pairs<D, T>(qs, dos, ks, vs, lse_s, dv_s, q0, k0, g, inv_sk, p, ds);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          ps[(ty + 16 * i) * (T + 1) + tx + 16 * j] = p[i][j];
          dss[(ty + 16 * i) * (T + 1) + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV[c] += sum_r P[r, c] dO[r];  dK[c] += sum_r dS[r, c] Q[r]
      const int r_end = q_last - q0 + 1;
      for (int r = 0; r < r_end; ++r) {
        float pv[R], sv[R], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = ps[r * (T + 1) + ty + 16 * i];
          sv[i] = dss[r * (T + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          ov[j] = d < D ? dos[r * DP + d] : 0.0f;
          qv[j] = d < D ? qs[r * DP + d] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            adv[i][j] = fmaf(pv[i], ov[j], adv[i][j]);
            adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= g.Sk) continue;
    const long long base = ((static_cast<long long>(b) * g.Sk + key) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[base + d] = from_f<E>(adk[i][j] * g.scale);
        dv[base + d] = from_f<E>(adv[i][j]);
      }
    }
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
       const E* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ dvec, E* __restrict__ dq, Geo g, int KV) {
  constexpr int T = tile_of(D);
  constexpr int R = T / 16;
  constexpr int DJ = (D + 15) / 16;
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + T * DP;
  float* qs = vs + T * DP;
  float* dos = qs + T * DP;
  float* dss = dos + T * DP;  // [T query rows][T + 1]
  float* lse_s = dss + 2 * T * (T + 1);
  float* dv_s = lse_s + T;

  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x - b * g.H;
  const int kvh = h / g.G;
  const int q0 = blockIdx.y * T;
  const int q_last = min(q0 + T, g.Sq) - 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int off = g.Sk - g.Sq;
  const float inv_sk = 1.0f / static_cast<float>(g.Sk);

  load_tile<D, T>(qs, q + b * g.qsb + h * g.qsh, g.qss, q0, g.Sq);
  load_tile<D, T>(dos, dout + b * g.dsb + h * g.dsh, g.dss, q0, g.Sq);
  if (threadIdx.x < T) {
    const int row = q0 + threadIdx.x;
    const long long at = (static_cast<long long>(b) * g.H + h) * g.Sq + row;
    lse_s[threadIdx.x] = row < g.Sq ? lse[at] : 0.0f;
    dv_s[threadIdx.x] = row < g.Sq ? dvec[at] : 0.0f;
  }

  float adq[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adq[i][j] = 0.0f;

  // keys a row of this tile sees with a gradient (none past q_last + off)
  const int k_end = g.causal ? min(g.Sk, q_last + off + 1) : g.Sk;
  const E* kb = k + b * g.ksb + kvh * g.ksh;
  const E* vb = v + b * g.vsb + kvh * g.vsh;
  for (int k0 = 0; k0 < k_end; k0 += T) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, T>(ks, kb, g.kss, k0, g.Sk);
    load_tile<D, T>(vs, vb, g.vss, k0, g.Sk);
    __syncthreads();
    float p[R][R], ds[R][R];
    pairs<D, T>(qs, dos, ks, vs, lse_s, dv_s, q0, k0, g, inv_sk, p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) dss[(ty + 16 * i) * (T + 1) + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[r] += sum_c dS[r, c] K[c]
    const int c_end = min(T, g.Sk - k0);
    for (int c = 0; c < c_end; ++c) {
      float sv[R], kv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dss[(ty + 16 * i) * (T + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        kv[j] = d < D ? ks[c * DP + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) adq[i][j] = fmaf(sv[i], kv[j], adq[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= g.Sq) continue;
    const long long base = ((static_cast<long long>(b) * g.Sq + qpos) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[base + d] = from_f<E>(adq[i][j] * g.scale);
    }
  }
}

struct Ptrs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* dvec;
  void *dq, *dk, *dv;
};

template <typename E, int D>
int launch_typed(const Ptrs& p, int B, int KV, const Geo& g, cudaStream_t stream) {
  constexpr int T = tile_of(D);
  constexpr size_t smem = smem_bytes<D>();
  // the shared-memory attribute is set once per instance
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(bwd_dkdv<E, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dq<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  const E* dout = static_cast<const E*>(p.dout);
  const long long rows = static_cast<long long>(B) * g.Sq * g.H;
  const unsigned dot_blocks = static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  bwd_dot<E><<<dot_blocks, THREADS, 0, stream>>>(
      dout, static_cast<const E*>(p.out), p.dvec, B, g.Sq, g.H, D, g.dsb, g.dss, g.dsh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<E, D><<<dim3(B * KV, (g.Sk + T - 1) / T), THREADS, smem, stream>>>(
      q, k, v, dout, p.lse, p.dvec, static_cast<E*>(p.dk), static_cast<E*>(p.dv), g, KV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<E, D><<<dim3(B * g.H, (g.Sq + T - 1) / T), THREADS, smem, stream>>>(
      q, k, v, dout, p.lse, p.dvec, static_cast<E*>(p.dq), g, KV);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int dtype, const Ptrs& p, int B, int KV, const Geo& g, cudaStream_t s) {
  return dtype == 1 ? launch_typed<__nv_bfloat16, D>(p, B, KV, g, s)
                    : launch_typed<float, D>(p, B, KV, g, s);
}

}  // namespace

// q: (B, Sq, H, D), k / v: (B, Sk, KV, D), dout: (B, Sq, H, D), read through
// their batch / sequence / head strides (in elements; the last axis
// contiguous); out: the forward's output (B, Sq, H, D) contiguous; lse:
// (B, H, Sq) f32 from the forward; dvec: (B, H, Sq) f32 scratch; dq / dk /
// dv: contiguous outputs in the inputs' dtype (0 = float32, 1 = bfloat16).
// Launches bwd_dot, bwd_dkdv and bwd_dq, in that order, on `stream`.
// Returns 0 on success, -1 for an unsupported head size or dtype, else the
// first failed launch's cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const float* lse, float* dvec, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
    int H, int KV, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long dsb, long long dss, long long dsh, int causal, int has_cap, float softcap,
    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || KV <= 0 || H % KV) return -1;
  const Ptrs p{q, k, v, out, dout, lse, dvec, dq, dk, dv};
  const Geo g{Sq, Sk, H, H / KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
              dsb, dss, dsh, causal, has_cap, softcap,
              1.0f / sqrtf(static_cast<float>(D))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_d<8>(dtype, p, B, KV, g, s);
    case 16: return launch_d<16>(dtype, p, B, KV, g, s);
    case 32: return launch_d<32>(dtype, p, B, KV, g, s);
    case 64: return launch_d<64>(dtype, p, B, KV, g, s);
    case 128: return launch_d<128>(dtype, p, B, KV, g, s);
    case 256: return launch_d<256>(dtype, p, B, KV, g, s);
    default: return -1;
  }
}
