// The belief filter's step, shared by belief_forward.cu (its kernels) and
// chain_floor.cu (the fold's chain alone): the filter's constants, the
// step matrix of a gap and the guarded fold of one arrival.
//
// Numerics: the plain version's (kernels/belief_forward.py) operation for
// operation -- each product-sum is the fused multiply-add chain acc = x0 *
// y0, acc = fma(xk, yk, acc), every other sum runs in order k = 0..K-1
// (numpy's pairwise tree at K = 8), everything else rounded on its own
// (__d*_rn; the including files are built with -fmad=false).  exp / sin /
// cos are CUDA's (within an ulp of the host's).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace belief {

constexpr int kMaxK = 8;
constexpr double kTiny = 1e-300;  // the reference's _BELIEF_TINY

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
#pragma unroll
  for (int k = 1; k < K; ++k) acc = __dadd_rn(acc, v[k]);
  return acc;
}

// Re(V diag(exp(d gap)) V^-1), row-major K x K
template <int K>
__device__ __forceinline__ void step_matrix(double gap, const Consts& c, double* el) {
  double ex_re[K], ex_im[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const double er = exp(__dmul_rn(c.d_re[m], gap));
    const double th = __dmul_rn(c.d_im[m], gap);
    ex_re[m] = __dmul_rn(er, cos(th));
    ex_im[m] = __dmul_rn(er, sin(th));
  }
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

// The fold's constants in registers: rates, the stationary start b0 and
// the two fallbacks' sums.
template <int K>
struct FoldConsts {
  double rates[K], b0[K], b0r[K];
  double b0_sum, b0r_sum;

  __device__ __forceinline__ explicit FoldConsts(const Consts& c) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      rates[j] = c.rates[j];
      b0[j] = c.b0[j];
      b0r[j] = __dmul_rn(b0[j], rates[j]);
    }
    b0_sum = seq_sum<K>(b0);
    b0r_sum = seq_sum<K>(b0r);
  }
};

// One arrival folded into b through its step matrix el:
//   p = b E, clipped at 0 (non-finite -> 0);  s = sum p
//   p, s = b0, sum b0                      if !(finite(s) && s > TINY)
//   b'   = (p / s) * rates;  s2 = sum b'
//   b', s2 = b0 * rates, sum(b0 * rates)   if !(finite(s2) && s2 > TINY)
//   b    = b' / s2
template <int K>
__device__ __forceinline__ void fold_step(double (&b)[K], const double* el,
                                          const FoldConsts<K>& f) {
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
    for (int j = 0; j < K; ++j) p[j] = f.b0[j];
    s = f.b0_sum;
  }
  double bn[K];
#pragma unroll
  for (int j = 0; j < K; ++j) bn[j] = __dmul_rn(__ddiv_rn(p[j], s), f.rates[j]);
  double s2 = seq_sum<K>(bn);
  if (!(isfinite(s2) && s2 > kTiny)) {
#pragma unroll
    for (int j = 0; j < K; ++j) bn[j] = f.b0r[j];
    s2 = f.b0r_sum;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) b[j] = __ddiv_rn(bn[j], s2);
}

}  // namespace belief
