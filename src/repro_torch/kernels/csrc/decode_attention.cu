// One-token GQA flash-decode over an S-deep KV cache for Hopper (sm_90a),
// f32 accumulation on CUDA cores, f32 or bf16 inputs, split-K over the
// cache, optionally under a sliding window or a chunked-local mask.
//
//   out[b, h, :] = softmax_{lo_b <= s < lengths[b]}(softcap(q[b, h] .
//                  k[b, s, h/G] / sqrt(D))) . v[b, s, h/G]
//
// The query sits at position lengths[b] - 1, so lo_b is 0 with no mask,
// lengths[b] - window under a window (window > 0) and
// floor((lengths[b] - 1) / chunk) * chunk under a chunk (chunk > 0): the
// reference's masks (src/repro/models/layers.py:177-182).  Those are
// exactly the keys that survive the mask, so the kernel reads [lo_b,
// lengths[b]) and masks nothing: a 4096 window over an 8k cache reads
// 4096 rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel).  Semantics are the reference's
// (src/repro/kernels/ref.py: decode_attention_ref): keys at or past
// lengths[b] are masked (a sequence with lengths[b] <= 0 sees no key and,
// as in the reference's softmax over -1e30 scores, averages all S values),
// optional softcap, p rounded to v's dtype before P.V, output
// acc / max(l, 1e-30) in q's dtype.  The cache is read in place as
// (B, S, KV, D) through its strides -- the TPU wrapper's moveaxis / pad
// would copy the whole cache on every step and layer -- and only the first
// lengths[b] rows of it are read.
//
// Bound on an H100 SXM (3.35 TB/s): at the serving path's decode (b = 8,
// 40 q heads, 8 kv heads, D = 128, lengths 129..143, bf16) the valid
// prefixes are 4.6 MB: 1.4 us of HBM time; at b = 1, 0.55 MB (0.16 us).
// With M = G = 5 query rows a kv head, tensor cores buy nothing: the kernel
// is bound by bytes and, at these sizes, by latency.  The first port's
// design -- one block per (b, kv head), 8..64 blocks on 132 SMs, 32-key
// tiles through shared memory with four barriers each, scalar loads, one
// thread's 128-long fmaf chain per score -- took 0.0408 ms at b = 8 and
// 0.0387 ms at b = 1 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the card
// mostly idle.  This design takes 0.0124 ms at b = 8 and 0.0098 ms at
// b = 1 on the same card and limit (1.01x and 0.96x SDPA timed in the same
// run), most of it the latency of its two dependent launches.
//
// Design (flash-decoding).  decode_attn_split splits the key axis across
// blocks: grid (B * KV * head chunks, n_split); block (., i) takes keys
// [lo_b + i * W / n_split, lo_b + (i + 1) * W / n_split), stopped at
// lengths[b], where W = min(S, window, chunk) is the most keys a query can
// see (S for a sequence that sees none).  The wrapper plans n_split from
// W, B * KV and the SM count alone (kernels/decode_attention.py:
// _split_plan), never from lengths, which live on the card.  Inside a
// block of 128 threads, D / 8 threads share one key row, each loading 16
// bytes of bf16 (32 of f32) of it, so 128 / (D / 8) key groups run side by
// side; the GT query rows of the head chunk (all G = 5 at the path shape)
// live in registers.  A group takes U keys a step (their K and V loads all
// in flight at once; at the path shape 8 groups x 6 keys cover a split in
// one step), forms the GT scores with shuffle reductions over its D / 8
// lanes and keeps its own online-softmax state (m, l, acc[GT][8]); there is
// no barrier in the key loop.  Groups merge once, at the end of the chunk,
// through shared memory.  A block whose share of the span is empty (a
// short sequence) writes an empty partial (m = -inf, l = 0).  With n_split == 1 the
// block writes the output; otherwise it writes its partial (m, l, acc[D])
// in f32 to the wrapper's scratch, and decode_attn_combine, launched next
// from the same C entry point on the same stream as a programmatic
// dependent launch (its blocks start while the splits run and wait at
// griddepcontrol.wait for their results), rescales each split by
// exp(m_i - m) -- skipping empty ones, so it never forms exp(-inf - -inf)
// -- and writes acc / max(l, 1e-30).  A sequence with lengths[b] <= 0 has
// every split non-empty with m = -1e30, so the combine still averages all
// S.  Every row of q and of the caches is read in 16-byte pieces, so base
// pointers and strides must be 16-byte aligned (the wrapper checks and
// raises; it never copies).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SPLITS = 16;  // the combine holds a row's splits in registers
constexpr float MASKED = -1e30f;  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// 8 consecutive elements of one row: one 16-byte load of bf16, two of f32
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      const float2 f = __bfloat1622float2(h);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  }
};

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// partials: ml[n_split][B H][2] (m, l), then acc[n_split][B H][D]
template <typename T, int GT>
__global__ void __launch_bounds__(THREADS)
decode_attn_split(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int* __restrict__ lengths,
                  T* __restrict__ out, float* __restrict__ part, int B, int S,
                  int H, int KV, int G, int D, int n_split, long long qsb,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, int window,
                  int chunk, int has_cap, float softcap, float scale) {
  // the combine's blocks may start now; they wait for this grid's results
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // keys a group takes per step: all their loads are in flight together
  constexpr int U = (GT <= 5 ? 6 : 2) / (sizeof(T) == 4 ? 2 : 1);
  __shared__ float red[THREADS * 8 * GT];  // [group][g][D] accumulators
  __shared__ float grp_m[THREADS * GT];    // [group][g]; then the weights
  __shared__ float grp_l[THREADS * GT];
  __shared__ float blk_m[GT], blk_l[GT];

  const int tpk = D >> 3;  // threads per key row
  const int n_grp = THREADS / tpk;
  const int grp = threadIdx.x / tpk;
  const int sub = threadIdx.x - grp * tpk;  // this thread's 8 columns
  const int n_gc = (G + GT - 1) / GT;
  const int gc = blockIdx.x % n_gc;
  const int bk = blockIdx.x / n_gc;
  const int b = bk / KV;
  const int kvh = bk - b * KV;
  const int g0 = gc * GT;
  const int n_g = min(GT, G - g0);
  const int h0 = kvh * G + g0;  // first q head of this block
  const int split = blockIdx.y;
  const long long BH = static_cast<long long>(B) * H;

  // this sequence's keys [lo, n_keys) and the planned span W (see header)
  const int len = lengths[b];
  int lo = 0, W = S;
  if (window > 0) {
    lo = max(lo, len - window);
    W = min(W, window);
  }
  if (chunk > 0) {
    if (len > 0) lo = max(lo, (len - 1) / chunk * chunk);
    W = min(W, chunk);
  }
  // no visible key: all S take part, masked
  const bool none = len <= 0 || lo >= min(len, S);
  if (none) lo = 0, W = S;
  const int n_keys = none ? S : min(len, S);
  const int c0 =
      lo + static_cast<int>(static_cast<long long>(split) * W / n_split);
  const int c1 =
      lo + static_cast<int>(static_cast<long long>(split + 1) * W / n_split);
  const int c_end = min(c1, n_keys);
  float* part_ml = part;
  float* part_acc = part + n_split * BH * 2;

  if (c0 >= c_end) {  // an empty partial (never split 0: W >= n_split)
    if (static_cast<int>(threadIdx.x) < n_g) {
      float* ml = part_ml + (split * BH + b * H + h0 + threadIdx.x) * 2;
      ml[0] = -CUDART_INF_F;
      ml[1] = 0.0f;
    }
    return;
  }

  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < n_g) {
      Chunk<T> c;
      c.load(q + b * qsb + (h0 + g) * qsh + sub * 8);
      c.get(qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.0f;
    }
  }
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
  }

  const T* kb = kc + b * ksb + kvh * ksh + sub * 8;
  const T* vb = vc + b * vsb + kvh * vsh + sub * 8;
  // the loop bound is the block's, so every lane reaches the shuffles
  for (int base = c0; base < c_end; base += U * n_grp) {
    Chunk<T> kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + grp + u * n_grp;
      if (key < c_end) {
        kr[u].load(kb + key * kss);
        vr[u].load(vb + key * vss);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
    float sc[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      kr[u].get(kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float a = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qr[g][e], kf[e], a);
        sc[u][g] = a;
      }
    }
    for (int o = tpk >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool valid = base + grp + u * n_grp < c_end;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float x = sc[u][g] * scale;
        if (has_cap) x = softcap * tanhf(x / softcap);
        if (none) x = MASKED;
        sc[u][g] = valid ? x : -CUDART_INF_F;  // p = 0 for a missing key
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -CUDART_INF_F) continue;  // this group had no key this step
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f((m[g] - m_new) * LOG2E);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      vr[u].get(vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = sc[u][g] == -CUDART_INF_F  // a missing key
                            ? 0.0f
                            : exp2f((sc[u][g] - m[g]) * LOG2E);
        l[g] += p;
        const float pv = round_to(p, vc);  // p in v's dtype for P.V
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
      }
    }
  }

  // merge the groups: weights exp(m_group - m_block), once per chunk
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (sub == 0) {
      grp_m[grp * GT + g] = m[g];
      grp_l[grp * GT + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      red[(grp * GT + g) * D + sub * 8 + e] = acc[g][e];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < GT) {
    const int g = threadIdx.x;
    float mb = -CUDART_INF_F;
    for (int i = 0; i < n_grp; ++i) mb = fmaxf(mb, grp_m[i * GT + g]);
    float lb = 0.0f;
    for (int i = 0; i < n_grp; ++i) {
      const float mi = grp_m[i * GT + g];
      const float w = mi == -CUDART_INF_F ? 0.0f : exp2f((mi - mb) * LOG2E);
      grp_m[i * GT + g] = w;
      lb += w * grp_l[i * GT + g];
    }
    blk_m[g] = mb;
    blk_l[g] = lb;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_g * D; e += THREADS) {
    const int g = e / D;
    const int d = e - g * D;
    float a = 0.0f;
    for (int i = 0; i < n_grp; ++i)
      a = fmaf(red[(i * GT + g) * D + d], grp_m[i * GT + g], a);
    const long long row = static_cast<long long>(b) * H + h0 + g;
    if (n_split == 1) {
      store(out + row * D + d, a / fmaxf(blk_l[g], 1e-30f));
    } else {
      const long long pr = split * BH + row;
      part_acc[pr * D + d] = a;
      if (d == 0) {
        part_ml[pr * 2] = blk_m[g];
        part_ml[pr * 2 + 1] = blk_l[g];
      }
    }
  }
}

// out[row, d] = sum_i w_i acc_i[row, d] / max(sum_i w_i l_i[row], 1e-30),
// w_i = exp(m_i - max_j m_j) over the non-empty splits
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_combine(const float* __restrict__ part, T* __restrict__ out,
                    int BH, int D, int n_split) {
  // wait until the split grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long idx =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(BH) * D) return;
  const long long row = idx / D;
  const int d = static_cast<int>(idx - row * D);
  const float* ml = part;
  const float* acc = part + static_cast<long long>(n_split) * BH * 2;
  // every split's loads in flight at once
  float mi[MAX_SPLITS], li[MAX_SPLITS], ai[MAX_SPLITS];
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) {
    mi[i] = -CUDART_INF_F;
    li[i] = ai[i] = 0.0f;
    if (i < n_split) {
      const long long pr = static_cast<long long>(i) * BH + row;
      mi[i] = ml[pr * 2];
      li[i] = ml[pr * 2 + 1];
      if (mi[i] != -CUDART_INF_F) ai[i] = acc[pr * D + d];  // empty: unwritten
    }
  }
  float mb = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) mb = fmaxf(mb, mi[i]);
  float lb = 0.0f, a = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) {
    if (mi[i] == -CUDART_INF_F) continue;  // an empty split
    const float w = exp2f((mi[i] - mb) * LOG2E);
    lb = fmaf(w, li[i], lb);
    a = fmaf(w, ai[i], a);
  }
  store(out + idx, a / fmaxf(lb, 1e-30f));
}

template <typename T, int GT>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part, int B, int S, int H, int KV, int D,
           int n_split, const long long* st, int window, int chunk,
           int has_cap, float softcap, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(B * KV * ((G + GT - 1) / GT), n_split);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_attn_split<T, GT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part, B, S, H,
      KV, G, D, n_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], window, chunk, has_cap, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);

  const long long n = static_cast<long long>(B) * H * D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + THREADS - 1) / THREADS));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attn_combine<T>,
                           static_cast<const float*>(part),
                           static_cast<T*>(out), B * H, D, n_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_g(const void* q, const void* k, const void* v, const int* lengths,
               void* out, float* part, int B, int S, int H, int KV, int D,
               int n_split, const long long* st, int window, int chunk,
               int has_cap, float softcap, cudaStream_t s) {
  const int G = H / KV;
#define ARGS q, k, v, lengths, out, part, B, S, H, KV, D, n_split, st, window, \
             chunk, has_cap, softcap, s
  if (G <= 1) return launch<T, 1>(ARGS);
  if (G <= 2) return launch<T, 2>(ARGS);
  if (G <= 4) return launch<T, 4>(ARGS);
  if (G == 5) return launch<T, 5>(ARGS);
  return launch<T, 8>(ARGS);  // chunks of 8 q heads
#undef ARGS
}

}  // namespace

// q: (B, H, D) with strides (qsb, qsh); k / v caches: (B, S, KV, D) with
// strides in elements for the batch, sequence and head axes (the last axis
// contiguous; base pointers and strides 16-byte aligned); lengths: (B,)
// int32; out: (B, H, D) contiguous; part: n_split * B * H * (D + 2) floats
// of scratch (unused when n_split == 1); window / chunk: the masks' widths,
// 0 for none; dtype 0 = float32, 1 = bfloat16.
// Returns 0 on success, -1 for an unsupported head size (a power of two,
// 8 .. 256), dtype, mask width or split count (1 .. min(S, 16)), else the
// launches' CUDA error.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, void* part, int B, int S, int H, int KV, int D, int n_split,
    long long qsb, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int window, int chunk,
    int has_cap, float softcap, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  // D / 8 threads share a key row: a power of two, at most one warp
  if (D < 8 || D > 256 || (D & (D - 1)) || n_split < 1 || n_split > S ||
      n_split > MAX_SPLITS || window < 0 || chunk < 0)
    return -1;
  const long long st[8] = {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_g<float>(q, k, v, lengths, out, p, B, S, H, KV, D,
                             n_split, st, window, chunk, has_cap, softcap, s);
  if (dtype == 1)
    return dispatch_g<__nv_bfloat16>(q, k, v, lengths, out, p, B, S, H, KV, D,
                                     n_split, st, window, chunk, has_cap,
                                     softcap, s);
  return -1;
}
