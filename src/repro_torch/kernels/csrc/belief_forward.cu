// MMPP phase-belief forward filter (one block per trace).
//
// Counterpart of the lax.scan in belief_forward_jax,
// src/repro/serving/arrivals.py:431-467 (a scan, not a Pallas kernel): the
// exact posterior over the hidden phase, folded over one trace's arrival
// times from a shared start state (b_init, t_init):
//
//   gap  = max(t - last, 0);  E = Re(V diag(exp(d gap)) V^-1)
//   p    = b E, clipped at 0 (non-finite -> 0);  s = sum p
//   p, s = b0, sum b0                      if !(finite(s) && s > TINY)
//   b'   = (p / s) * rates;  s2 = sum b'
//   b', s2 = b0 * rates, sum(b0 * rates)   if !(finite(s2) && s2 > TINY)
//   b    = b' / s2
//
// Slots whose time is +inf or NaN keep the carry (b, last) and repeat the
// previous row.  Output: beliefs (S, N, K), and the final (b, t) per trace.
//
// Design: two warps a block.  The step matrices E depend on the gaps only,
// so warp 1 computes a chunk of 32 of them ahead -- one slot a lane: the
// last valid time before its slot (a max-scan of valid indices across the
// warp, carried from chunk to chunk), the gap, K complex exponentials and
// the K x K real part of V diag(ex) V^-1 -- into shared memory, while lane
// 0 of warp 0 folds the previous chunk through the guarded recurrence.  The
// fold is the serial chain; the exponentials and the K^3 products stay off
// it.  Two buffers of 32 step matrices (K <= 8: 32 KB) and one barrier a
// chunk.
//
// Numerics: the plain version's (kernels/belief_forward.py) operation for
// operation -- each product-sum is the fused multiply-add chain acc = x0 *
// y0, acc = fma(xk, yk, acc), every other sum runs in order k = 0..K-1
// (numpy's pairwise tree at K = 8), everything else rounded on its own
// (__d*_rn, and the file is built with -fmad=false).  exp / sin / cos are
// CUDA's (within an ulp of the host's), so the rows agree with the plain
// version to ~1e-16, not bit for bit.
//
// Bound: bytes S * N * (8 + 8K) over the memory rate -- far below the
// serial chain, N steps of one fold (a K-term product, two guarded
// renormalisations with K divides each), which is what a trace's time is.
// Traces run in parallel, one block each.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kChunk = 32;
constexpr double kTiny = 1e-300;
constexpr unsigned kFull = 0xffffffffu;

// consts layout: d_re[K] d_im[K] v_re[KK] v_im[KK] vi_re[KK] vi_im[KK]
//                rates[K] b0[K] b_init[K] t_init
struct Consts {
  const double *d_re, *d_im, *v_re, *v_im, *vi_re, *vi_im, *rates, *b0, *b_init;
  double t_init;
};

__device__ __forceinline__ Consts unpack(const double* c, int K) {
  Consts o;
  o.d_re = c;
  o.d_im = o.d_re + K;
  o.v_re = o.d_im + K;
  o.v_im = o.v_re + K * K;
  o.vi_re = o.v_im + K * K;
  o.vi_im = o.vi_re + K * K;
  o.rates = o.vi_im + K * K;
  o.b0 = o.rates + K;
  o.b_init = o.b0 + K;
  o.t_init = o.b_init[K];
  return o;
}

// sum in order k = 0..K-1; numpy's pairwise tree at exactly 8 terms
template <int K>
__device__ __forceinline__ double seq_sum(const double* v) {
  if (K == 8) {
    const double a = __dadd_rn(__dadd_rn(v[0], v[1]), __dadd_rn(v[2], v[3]));
    const double b = __dadd_rn(__dadd_rn(v[4], v[5]), __dadd_rn(v[6], v[7]));
    return __dadd_rn(a, b);
  }
  double acc = v[0];
  for (int k = 1; k < K; ++k) acc = __dadd_rn(acc, v[k]);
  return acc;
}

// Warp 1: the step matrices of slots [i0, i0 + 32) into e (32 x K x K) and
// their validity into ok; `carry` is the last valid time before i0.
template <int K>
__device__ void produce(const double* times, long long N, long long i0,
                        const Consts& c, double* e, unsigned char* ok,
                        double& carry) {
  const int l = threadIdx.x & 31;
  const long long i = i0 + l;
  const double t = i < N ? times[i] : NAN;
  const bool valid = isfinite(t);
  // last valid slot at or before this lane (inclusive max-scan), then the
  // one strictly before it
  int incl = valid ? l : -1;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (l >= off && o > incl) incl = o;
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (l == 0) excl = -1;
  const double t_prev = __shfl_sync(kFull, t, excl < 0 ? 0 : excl);
  const double last = excl >= 0 ? t_prev : carry;
  const int top = __shfl_sync(kFull, incl, 31);
  const double t_top = __shfl_sync(kFull, t, top < 0 ? 0 : top);
  carry = top >= 0 ? t_top : carry;
  ok[l] = valid ? 1 : 0;
  if (!valid) return;
  const double gap = fmax(__dsub_rn(t, last), 0.0);
  double ex_re[K], ex_im[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const double er = exp(__dmul_rn(c.d_re[m], gap));
    const double th = __dmul_rn(c.d_im[m], gap);
    ex_re[m] = __dmul_rn(er, cos(th));
    ex_im[m] = __dmul_rn(er, sin(th));
  }
  double* el = e + l * K * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double vre[K], vim[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const double a = c.v_re[k * K + m], b = c.v_im[k * K + m];
      vre[m] = __dsub_rn(__dmul_rn(a, ex_re[m]), __dmul_rn(b, ex_im[m]));
      vim[m] = __dadd_rn(__dmul_rn(a, ex_im[m]), __dmul_rn(b, ex_re[m]));
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      double acc = __dmul_rn(vre[0], c.vi_re[j]);
      acc = __fma_rn(-vim[0], c.vi_im[j], acc);
#pragma unroll
      for (int m = 1; m < K; ++m) {
        acc = __fma_rn(vre[m], c.vi_re[m * K + j], acc);
        acc = __fma_rn(-vim[m], c.vi_im[m * K + j], acc);
      }
      el[k * K + j] = acc;
    }
  }
}

// Lane 0 of warp 0: fold slots [i0, i0 + n) through the recurrence.
template <int K>
__device__ void fold(const double* times, double* out, long long i0, int n,
                     const Consts& c, const double* e, const unsigned char* ok,
                     double (&b)[K], double& last, double b0_sum,
                     const double (&b0r)[K], double b0r_sum) {
  const double* rates = c.rates;
  for (int l = 0; l < n; ++l) {
    const long long i = i0 + l;
    if (ok[l]) {
      const double* el = e + l * K * K;
      double p[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        double acc = __dmul_rn(b[0], el[j]);
#pragma unroll
        for (int k = 1; k < K; ++k) acc = __fma_rn(b[k], el[k * K + j], acc);
        p[j] = isfinite(acc) ? fmax(acc, 0.0) : 0.0;
      }
      double s = seq_sum<K>(p);
      if (!(isfinite(s) && s > kTiny)) {  // degenerate propagation
#pragma unroll
        for (int j = 0; j < K; ++j) p[j] = c.b0[j];
        s = b0_sum;
      }
      double bn[K];
#pragma unroll
      for (int j = 0; j < K; ++j) bn[j] = __dmul_rn(__ddiv_rn(p[j], s), rates[j]);
      double s2 = seq_sum<K>(bn);
      if (!(isfinite(s2) && s2 > kTiny)) {
#pragma unroll
        for (int j = 0; j < K; ++j) bn[j] = b0r[j];
        s2 = b0r_sum;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) b[j] = __ddiv_rn(bn[j], s2);
      last = times[i];
    }
    double* o = out + i * K;
#pragma unroll
    for (int j = 0; j < K; ++j) o[j] = b[j];
  }
}

template <int K>
__global__ void __launch_bounds__(64) belief_forward_kernel(
    const double* __restrict__ times_all, const double* __restrict__ consts,
    double* __restrict__ beliefs, double* __restrict__ b_final,
    double* __restrict__ t_final, long long N) {
  __shared__ double e[2][kChunk * K * K];
  __shared__ unsigned char ok[2][kChunk];
  const long long s = blockIdx.x;
  const double* times = times_all + s * N;
  double* out = beliefs + s * N * K;
  const Consts c = unpack(consts, K);
  const long long n_chunks = (N + kChunk - 1) / kChunk;
  double carry = c.t_init;  // warp 1's: the last valid time seen so far
  // lane 0 of warp 0's fold state
  double b[K], b0r[K];
  double last = c.t_init, b0_sum = 0.0, b0r_sum = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      b[j] = c.b_init[j];
      b0r[j] = __dmul_rn(c.b0[j], c.rates[j]);
    }
    b0_sum = seq_sum<K>(c.b0);
    b0r_sum = seq_sum<K>(b0r);
  }
  for (long long ch = 0; ch <= n_chunks; ++ch) {
    if (threadIdx.x >= 32 && ch < n_chunks) {
      produce<K>(times, N, ch * kChunk, c, e[ch & 1], ok[ch & 1], carry);
    } else if (threadIdx.x == 0 && ch > 0) {
      const long long i0 = (ch - 1) * kChunk;
      const int n = static_cast<int>(N - i0 < kChunk ? N - i0 : kChunk);
      fold<K>(times, out, i0, n, c, e[(ch - 1) & 1], ok[(ch - 1) & 1], b, last,
              b0_sum, b0r, b0r_sum);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < K; ++j) b_final[s * K + j] = b[j];
    t_final[s] = last;
  }
}

template <int K>
int launch(const double* times, const double* consts, double* beliefs, double* b_final,
           double* t_final, long long S, long long N, cudaStream_t st) {
  belief_forward_kernel<K><<<static_cast<unsigned>(S), 64, 0, st>>>(
      times, consts, beliefs, b_final, t_final, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one block of two warps per trace on `stream`: times (S, N),
// consts as above, beliefs (S, N, K), b_final (S, K), t_final (S,).
// Returns a CUDA error code (0: none).
extern "C" int belief_forward_launch(const double* times, const double* consts,
                                     double* beliefs, double* b_final, double* t_final,
                                     long long S, long long N, long long K,
                                     void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(times, consts, beliefs, b_final, t_final, S, N, st);
    case 2: return launch<2>(times, consts, beliefs, b_final, t_final, S, N, st);
    case 3: return launch<3>(times, consts, beliefs, b_final, t_final, S, N, st);
    case 4: return launch<4>(times, consts, beliefs, b_final, t_final, S, N, st);
    case 5: return launch<5>(times, consts, beliefs, b_final, t_final, S, N, st);
    case 6: return launch<6>(times, consts, beliefs, b_final, t_final, S, N, st);
    case 7: return launch<7>(times, consts, beliefs, b_final, t_final, S, N, st);
    case 8: return launch<8>(times, consts, beliefs, b_final, t_final, S, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
