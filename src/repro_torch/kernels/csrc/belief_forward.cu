// MMPP phase-belief forward filter, time-parallel over each trace.
//
// Counterpart of the lax.scan in belief_forward_jax,
// src/repro/serving/arrivals.py:431-467 (a scan, not a Pallas kernel): the
// exact posterior over the hidden phase, folded over one trace's arrival
// times from a shared start state (b_init, t_init), one arrival at a time
// through the guarded step of belief_fold.cuh.  Slots whose time is +inf or
// NaN keep the carry (b, last) and repeat the previous row.  Output:
// beliefs (S, N, K), and the final (b, t) per trace.
//
// Bound: bytes S * N * (8 + 8K) over the memory rate.  A serial fold is a
// dependent chain of N steps (a K-term product, two guarded
// renormalisations of K divides each), ~230 cycles a step on this card:
// one block walking a trace ran at 16.0-16.3 ms for 6 x 49 152 slots (K =
// 2) with 126 of 132 SMs idle; these three passes take 0.09 ms there at C =
// 64 (H100 80GB HBM3, 700 W).  Away from its guards, a step is a product
// with a nonnegative matrix and a rescale, b' ~ b E diag(rates), and such
// products associate.  So each trace is cut into chunks of C slots (C from
// the wrapper, the same for every call, so chunk c always covers slots
// [cC, cC + C)):
//
//   A (a warp a chunk, a lane a slot): the last valid time before the slot
//     (a warp max-scan, carried across the chunk's 32-slot blocks; the
//     chunk's first carry by a ballot search backwards, made only once a
//     valid slot turns up, so the padded tail of a trace costs nothing),
//     its step matrix E (today's producer code) into device memory, M = E
//     diag(rates) clipped at 0 (the identity for a padded slot), and a
//     safety flag.  It is false where E has an entry below zero or not
//     finite, a rate is negative, or a guard could fire for some
//     normalised start: min_k sum_j E_kj <= kSafe, or min_k sum_j E_kj r_j
//     <= kSafe * max(1, max_k sum_j E_kj) (kSafe = 1e50 * TINY; with E >=
//     0, s >= min_k sum_j E_kj and s2 >= min rr / max row sum).  E =
//     exp((R - Lambda) gap) is nonnegative, but its rounding leaves
//     entries near zero at ~1e-17 either side.  The fold clips b E, the
//     product clips E; with a negative entry the two part by that noise,
//     and a chain that rotates mass into phases now at 1e-10 (a long
//     cycle) multiplies it: a K = 8 cycle parted by 2e-10 within 128
//     slots.  With E >= 0 both clips are no-ops, every term is
//     nonnegative, and componentwise relative rounding cannot grow.  (The
//     two-phase filters of the paths show no negative entry but at a gap
//     of exactly 0 -- a repeated time -- where E = I leaves +-4e-21 off the
//     diagonal: such a chunk is folded exactly, a cost in time only.)  Then
//     the chunk's product P_c = M_0 ... M_{C-1} by a warp tree over each
//     32-slot block
//     and in order over the blocks, every product scaled by a power of two
//     (exact) so its largest entry is in [1, 2); and the chunk's last valid
//     time.
//   B (a warp a trace): start_{c+1} = start_c P_c, scaled by a power of
//     two, a window of 32 chunks at a time: a warp scan of the window's
//     products gives every start of the window from the window's first;
//     the products stream through shared memory by cp.async a window
//     ahead.  A chunk with an unsafe slot, or whose propagated start is not
//     finite or has no entry above kLive, is folded exactly instead (from
//     start_belief(start_c), as pass C folds it, by lane 0 while the warp
//     stages the chunk's step matrices into shared memory a block ahead)
//     and counted; the window goes on a chunk at a time from there.  The warp also finds the
//     trace's last valid time (t_final) among the chunks' last valid times.
//   C (a warp 32 chunks, a lane a chunk): the exact guarded fold of the
//     chunk from start_belief(start_c) (b_init itself for c = 0): the
//     plain version's arithmetic, step for step.  The step matrices and
//     the validity words stream into shared memory by cp.async a block of
//     J steps ahead; the rows go through shared memory and leave as
//     coalesced stores.  The last chunk of a trace writes b_final.
//
// Chunk c's rows depend only on slots [0, (c + 1) C): rows[:, :n] of a call
// on N slots equal, bit for bit, those of a call on the first n slots,
// and every call gives the same bits (no atomics, fixed trees).  Against
// the serial fold (belief_forward_ref) the rows agree to rounding: the
// chunk starts come from products, the folds inside a chunk are the plain
// version's own.
//
// Numerics: belief_fold.cuh's; the products and pass B are not the plain
// version's operations (only its tolerance, atol 1e-12, binds them).
#include "belief_fold.cuh"

namespace {

using belief::Consts;
using belief::FoldConsts;
using belief::fold_step;
using belief::seq_sum;
using belief::step_matrix;
using belief::unpack;

constexpr double kSafe = 1e-250;   // a margin of 1e50 over the guards' TINY
constexpr double kLive = 0x1p-900;  // a propagated start below this is folded
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsA = 4;  // pass A: chunks a block
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int pow2_floor(int x) {
  return x >= 32 ? 32 : x >= 16 ? 16 : x >= 8 ? 8 : x >= 4 ? 4 : 2;
}

// Pass C's staging: a lane's step matrix at stride LS doubles (odd, so the
// 32 lanes' 8-byte reads fall in distinct banks), J steps a staged block (J
// divides 32, so a block reads one validity word), the rows at stride RS.
template <int K>
struct Tile {
  static constexpr int KK = K * K;
  static constexpr int LS = (KK % 2) ? KK : KK + 1;
  static constexpr int J = pow2_floor(96 / LS);
  static constexpr int RS = J * K + 1;
  static constexpr int kSmem = 8 * (2 * J * 32 * LS + 32 * RS) + 4 * 2 * 32 + 16 * 32;
};

// Pass B's exact fold of a chunk: its step matrices stream into shared
// memory by cp.async JB steps a block (JB divides 32, so a block reads one
// validity word), a block ahead of lane 0's fold.
template <int K>
struct Stage {
  static constexpr int JB = pow2_floor(512 / (K * K));
};

struct Layout {
  long long nC, G, Gp, W;
};

__host__ __device__ inline Layout layout(long long S, long long N, long long C) {
  Layout o;
  o.nC = N > 0 ? (N + C - 1) / C : 0;
  o.G = S * o.nC;
  o.Gp = (o.G + 31) / 32 * 32;
  o.W = (C + 31) / 32;
  return o;
}

struct Args {
  const double* times;
  const double* consts;
  double* beliefs;
  double* b_final;
  double* t_final;
  double* et;      // (C, Gp, K*K) step matrices, slot-major
  double* prod;    // (G, K*K) chunk products
  double* starts;  // (G, K) chunk starts, scaled by a power of two
  double* tlast;   // (G,) each chunk's last valid time, NaN if none
  unsigned* masks;  // (G, W) validity words
  int* flags;      // (G,) 1: the chunk holds an unsafe slot
  int* unsafe;     // (S,) chunks folded exactly in pass B
  long long S, N, C;
  Layout o;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^-e for the exponent e of mx, so that mx times it lies in [1, 2); 1 for
// zero, subnormal, inf or NaN.  A product by it is exact.
__device__ __forceinline__ double pow2_scale(double mx) {
  const long long eb = (__double_as_longlong(mx) >> 52) & 0x7ff;
  if (eb == 0 || eb >= 2046) return 1.0;
  return __longlong_as_double((2046 - eb) << 52);
}

// o = a b (K x K, row-major), scaled by a power of two; o may not alias.
template <int K>
__device__ __forceinline__ void matmul_scaled(const double* a, const double* b, double* o) {
  double mx = 0.0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      double acc = __dmul_rn(a[i * K], b[j]);
#pragma unroll
      for (int m = 1; m < K; ++m) acc = __fma_rn(a[i * K + m], b[m * K + j], acc);
      o[i * K + j] = acc;
      mx = fmax(mx, fabs(acc));
    }
  }
  const double sc = pow2_scale(mx);
#pragma unroll
  for (int q = 0; q < K * K; ++q) o[q] = __dmul_rn(o[q], sc);
}

// The belief a chunk's fold starts from: b_init for the first chunk, else
// the propagated start normalised.
template <int K>
__device__ __forceinline__ void start_belief(double (&b)[K], const double* v, bool first,
                                             const Consts& c) {
  if (first) {
#pragma unroll
    for (int j = 0; j < K; ++j) b[j] = c.b_init[j];
    return;
  }
  double x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = v[j];
  const double s = seq_sum<K>(x);
#pragma unroll
  for (int j = 0; j < K; ++j) b[j] = __ddiv_rn(x[j], s);
}

// Pass A: one warp a chunk.
template <int K>
__global__ void __launch_bounds__(32 * kWarpsA) products_kernel(const Args g) {
  constexpr int KK = K * K;
  const int l = threadIdx.x & 31;
  const long long gi = static_cast<long long>(blockIdx.x) * kWarpsA + (threadIdx.x >> 5);
  if (gi >= g.o.G) return;
  const long long s = gi / g.o.nC, c = gi % g.o.nC, i0 = c * g.C;
  const int n = static_cast<int>(g.N - i0 < g.C ? g.N - i0 : g.C);
  const double* times = g.times + s * g.N;
  const Consts cs = unpack(g.consts, K);
  double r[K];
  bool rates_ok = true;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    r[j] = cs.rates[j];
    rates_ok = rates_ok && isfinite(r[j]) && r[j] >= 0.0;
  }
  // the last valid time before the chunk's first valid slot: searched
  // backwards once that slot turns up
  double carry = cs.t_init;
  bool have_carry = false;
  double P[KK], M[KK], R[KK], O[KK];
#pragma unroll
  for (int q = 0; q < KK; ++q) P[q] = (q % (K + 1) == 0) ? 1.0 : 0.0;
  bool unsafe = false;
  for (int k = 0; k * 32 < n; ++k) {
    const int j = k * 32 + l;
    const double t = j < n ? times[i0 + j] : NAN;
    const bool valid = isfinite(t);
    const unsigned vm = __ballot_sync(kFull, valid);
    if (l == 0) g.masks[gi * g.o.W + k] = vm;
    if (vm == 0) continue;  // the identity: nothing to multiply
    if (!have_carry) {
      have_carry = true;
      for (long long hi = i0 + k * 32; hi > 0;) {
        const long long lo = hi > 32 ? hi - 32 : 0;
        const long long i = lo + l;
        const double tb = i < hi ? times[i] : NAN;
        const unsigned m = __ballot_sync(kFull, isfinite(tb));
        if (m) {
          carry = __shfl_sync(kFull, tb, 31 - __clz(m));
          break;
        }
        hi = lo;
      }
    }
    // the last valid lane at or before this one (inclusive max-scan), then
    // the one strictly before it
    int incl = valid ? l : -1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (l >= off && o > incl) incl = o;
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (l == 0) excl = -1;
    const double t_prev = __shfl_sync(kFull, t, excl < 0 ? 0 : excl);
    const double last = excl >= 0 ? t_prev : carry;
    carry = __shfl_sync(kFull, t, 31 - __clz(vm));
    bool safe = true;
    if (valid) {
      step_matrix<K>(fmax(__dsub_rn(t, last), 0.0), cs, M);
      double* dst = g.et + (static_cast<long long>(j) * g.o.Gp + gi) * KK;
#pragma unroll
      for (int q = 0; q < KK; ++q) dst[q] = M[q];
      bool fin_pos = rates_ok;
      double mn_rs = INFINITY, mn_rr = INFINITY, mx_rs = 0.0;
#pragma unroll
      for (int a = 0; a < K; ++a) {
        double rs = 0.0, rr = 0.0;
#pragma unroll
        for (int b = 0; b < K; ++b) {
          const double x = M[a * K + b];
          fin_pos = fin_pos && isfinite(x) && x >= 0.0;
          rs = __dadd_rn(rs, x);
          const double xr = __dmul_rn(x, r[b]);
          rr = __dadd_rn(rr, xr);
          M[a * K + b] = fmax(xr, 0.0);
        }
        mn_rs = fmin(mn_rs, rs);
        mn_rr = fmin(mn_rr, rr);
        mx_rs = fmax(mx_rs, rs);
      }
      safe = fin_pos && mn_rs > kSafe && mn_rr > __dmul_rn(kSafe, fmax(1.0, mx_rs));
    } else {
#pragma unroll
      for (int q = 0; q < KK; ++q) M[q] = (q % (K + 1) == 0) ? 1.0 : 0.0;
    }
    unsafe = unsafe || __any_sync(kFull, !safe);
    // the block's product M_0 ... M_31 in lane 0, by a tree: at level d the
    // lanes at multiples of 2d take their right neighbour's product
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int q = 0; q < KK; ++q) R[q] = __shfl_down_sync(kFull, M[q], d);
      matmul_scaled<K>(M, R, O);
#pragma unroll
      for (int q = 0; q < KK; ++q) M[q] = O[q];
    }
    matmul_scaled<K>(P, M, O);
#pragma unroll
    for (int q = 0; q < KK; ++q) P[q] = O[q];
  }
  if (l == 0) {
#pragma unroll
    for (int q = 0; q < KK; ++q) g.prod[gi * KK + q] = P[q];
    g.flags[gi] = unsafe ? 1 : 0;
    g.tlast[gi] = have_carry ? carry : NAN;
  }
}

// Pass B: one warp a trace, a window of 32 chunk products at a time.
// Lane q scans P_{c0} ... P_{c0+q} (a Hillis-Steele scan, each product
// scaled by a power of two) and whether any of them is flagged; the starts
// of the window's chunks are then v P_{c0} ... P_{c0+q} in parallel, up to
// the first chunk that is flagged or whose start is not live.  From there
// lane 0 walks the rest of the window a chunk at a time: v P_c, or the exact
// fold of chunk c (counted).  Which way a chunk's start is made depends
// only on the chunks before it, so a call on a prefix makes the same.
template <int K>
__device__ __forceinline__ bool propagate(const double (&v)[K], const double* P, double (&nv)[K]) {
  double mx = 0.0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    double acc = __dmul_rn(v[0], P[j]);
#pragma unroll
    for (int m = 1; m < K; ++m) acc = __fma_rn(v[m], P[m * K + j], acc);
    nv[j] = acc;
    mx = fmax(mx, acc);
  }
  return isfinite(seq_sum<K>(nv)) && mx > kLive;
}

template <int K>
__device__ __forceinline__ void scale_pow2(double (&v)[K]) {
  double mx = 0.0;
#pragma unroll
  for (int j = 0; j < K; ++j) mx = fmax(mx, v[j]);
  const double sc = pow2_scale(mx);
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = __dmul_rn(v[j], sc);
}

// The exact fold of chunk gi (C slots) from b, lane 0 folding while the
// warp stages the next block of step matrices; every lane returns lane 0's b.
template <int K>
__device__ void fold_chunk_staged(double (&b)[K], const Args& g, long long gi,
                                  double* eb, unsigned* mw, const FoldConsts<K>& f) {
  constexpr int KK = K * K, JB = Stage<K>::JB;
  const int l = threadIdx.x;
  const int n = static_cast<int>(g.C);
  auto issue = [&](int j0, int buf) {
    const int cnt = n - j0 < JB ? n - j0 : JB;
    for (int e = l; e < cnt * KK; e += 32)
      cp_async8(eb + buf * JB * KK + e,
                g.et + (static_cast<long long>(j0 + e / KK) * g.o.Gp + gi) * KK + e % KK);
    if (l == 0) cp_async4(mw + buf, g.masks + gi * g.o.W + (j0 >> 5));
    cp_commit();
  };
  issue(0, 0);
  for (int j0 = 0, it = 0; j0 < n; j0 += JB, ++it) {
    const int buf = it & 1;
    if (j0 + JB < n) {
      issue(j0 + JB, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    if (l == 0) {
      const unsigned m = mw[buf];
      const int cnt = n - j0 < JB ? n - j0 : JB;
      for (int jj = 0; jj < cnt; ++jj)
        if ((m >> ((j0 + jj) & 31)) & 1u) fold_step<K>(b, eb + (buf * JB + jj) * KK, f);
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < K; ++j) b[j] = __shfl_sync(kFull, b[j], 0);
}

template <int K>
__global__ void __launch_bounds__(32) starts_kernel(const Args g) {
  constexpr int KK = K * K;
  __shared__ double pb[2][32 * KK];
  __shared__ int fb[2][32];
  __shared__ double sv[32 * K];  // the window's starts, written out together
  __shared__ double eb[2 * Stage<K>::JB * KK];  // an exact fold's staged steps
  __shared__ unsigned mw[2];
  const int l = threadIdx.x;
  const long long s = blockIdx.x, nC = g.o.nC, g0 = s * nC;
  const Consts cs = unpack(g.consts, K);
  const long long nP = nC > 0 ? nC - 1 : 0;  // products needed: every chunk but the last
  const long long nW = (nP + 31) / 32;
  auto issue = [&](long long w) {
    const long long c0 = w * 32;
    const int cnt = static_cast<int>(nP - c0 < 32 ? nP - c0 : 32);
    const double* src = g.prod + (g0 + c0) * KK;
    for (int e = l; e < cnt * KK; e += 32) cp_async8(&pb[w & 1][e], src + e);
    if (l < cnt) cp_async4(&fb[w & 1][l], g.flags + g0 + c0 + l);
    cp_commit();
  };
  double v[K];  // the start of the window's first chunk, the same in every lane
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = cs.b_init[j];
  if (l == 0 && nC > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) g.starts[g0 * K + j] = v[j];
  }
  int n_unsafe = 0;
  if (nW > 0) issue(0);
  for (long long w = 0; w < nW; ++w) {
    if (w + 1 < nW) {
      issue(w + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    const long long c0 = w * 32;
    const int cnt = static_cast<int>(nP - c0 < 32 ? nP - c0 : 32);
    const double* pw = pb[w & 1];
    double A[KK], R[KK], O[KK];
    bool bad = true;
    if (l < cnt) {
#pragma unroll
      for (int q = 0; q < KK; ++q) A[q] = pw[l * KK + q];
      bad = fb[w & 1][l] != 0;
    } else {
#pragma unroll
      for (int q = 0; q < KK; ++q) A[q] = (q % (K + 1) == 0) ? 1.0 : 0.0;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int q = 0; q < KK; ++q) R[q] = __shfl_up_sync(kFull, A[q], d);
      const bool rb = __shfl_up_sync(kFull, bad ? 1 : 0, d) != 0;
      matmul_scaled<K>(R, A, O);
      if (l >= d) {
#pragma unroll
        for (int q = 0; q < KK; ++q) A[q] = O[q];
        bad = bad || rb;
      }
    }
    double nv[K];
    const bool ok = !bad && propagate<K>(v, A, nv);
    const unsigned fails = __ballot_sync(kFull, !ok);  // lanes >= cnt are bad
    const int F = fails ? __ffs(fails) - 1 : 32;       // <= cnt
    if (l < F) {
      scale_pow2<K>(nv);
#pragma unroll
      for (int j = 0; j < K; ++j) sv[l * K + j] = nv[j];
    }
    if (F > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = __shfl_sync(kFull, nv[j], F - 1);
    }
    // the rest of the window a chunk at a time, every lane holding the same v
    for (int q = F; q < cnt; ++q) {
      const long long cc = c0 + q;
      double nx[K];
      if (fb[w & 1][q] != 0 || !propagate<K>(v, pw + q * KK, nx)) {
        // the exact fold over the chunk, as pass C folds it
        ++n_unsafe;
        const FoldConsts<K> f(cs);
        start_belief<K>(nx, v, cc == 0, cs);
        fold_chunk_staged<K>(nx, g, g0 + cc, eb, mw, f);
      }
      scale_pow2<K>(nx);
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = nx[j];
      if (l == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) sv[q * K + j] = nx[j];
      }
    }
    __syncwarp();
    for (int e = l; e < cnt * K; e += 32) g.starts[(g0 + c0 + 1) * K + e] = sv[e];
    __syncwarp();
  }
  // t_final: the last chunk that holds a valid slot, else t_init
  unsigned last = 0;
  for (long long q = l; q < nC; q += 32)
    if (isfinite(g.tlast[g0 + q])) last = static_cast<unsigned>(q + 1);
  last = __reduce_max_sync(kFull, last);
  if (l == 0) {
    g.unsafe[s] = n_unsafe;
    g.t_final[s] = last > 0 ? g.tlast[g0 + last - 1] : cs.t_init;
    if (nC == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) g.b_final[s * K + j] = cs.b_init[j];
    }
  }
}

// Pass C: one warp 32 chunks; each lane folds its chunk.
template <int K>
__global__ void __launch_bounds__(32) fold_kernel(const Args g) {
  using T = Tile<K>;
  constexpr int KK = K * K, LS = T::LS, J = T::J, RS = T::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  double* eb = reinterpret_cast<double*>(smem);  // [2][J][32][LS]
  double* rows = eb + 2 * J * 32 * LS;           // [32][RS]
  unsigned* mb = reinterpret_cast<unsigned*>(rows + 32 * RS);  // [2][32]
  long long* obase = reinterpret_cast<long long*>(mb + 2 * 32);  // [32] row offsets
  int* ocount = reinterpret_cast<int*>(obase + 32);              // [32] chunk lengths
  const int l = threadIdx.x;
  const long long gb = static_cast<long long>(blockIdx.x) * 32, gi = gb + l;
  const bool active = gi < g.o.G;
  long long s = 0, c = 0;
  int n = 0;
  if (active) {
    s = gi / g.o.nC;
    c = gi % g.o.nC;
    n = static_cast<int>(g.N - c * g.C < g.C ? g.N - c * g.C : g.C);
  }
  obase[l] = (s * g.N + c * g.C) * K;
  ocount[l] = n;
  const int nmax = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(n)));
  const Consts cs = unpack(g.consts, K);
  const FoldConsts<K> f(cs);
  double b[K] = {};
  if (active) start_belief<K>(b, g.starts + gi * K, c == 0, cs);
  auto issue = [&](int j0, int buf) {
    const int cnt = nmax - j0 < J ? nmax - j0 : J;
    for (int jj = 0; jj < cnt; ++jj) {
      const double* src = g.et + (static_cast<long long>(j0 + jj) * g.o.Gp + gb) * KK;
      double* dst = eb + (buf * J + jj) * 32 * LS;
#pragma unroll
      for (int q = 0; q < KK; ++q) {
        const int e = l + 32 * q;
        cp_async8(dst + (e / KK) * LS + e % KK, src + e);
      }
    }
    if (active) cp_async4(mb + buf * 32 + l, g.masks + gi * g.o.W + (j0 >> 5));
    cp_commit();
  };
  if (nmax > 0) issue(0, 0);
  __syncwarp();
  double* rw = rows + l * RS;
  for (int j0 = 0, it = 0; j0 < nmax; j0 += J, ++it) {
    const int buf = it & 1;
    if (j0 + J < nmax) {
      issue(j0 + J, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    const unsigned mw = active ? mb[buf * 32 + l] : 0u;
    const double* e0 = eb + (buf * J * 32 + l) * LS;
#pragma unroll 4
    for (int jj = 0; jj < J; ++jj) {
      const int j = j0 + jj;
      if (j < n && ((mw >> (j & 31)) & 1u)) fold_step<K>(b, e0 + jj * 32 * LS, f);
#pragma unroll
      for (int q = 0; q < K; ++q) rw[jj * K + q] = b[q];
    }
    __syncwarp();
    // the block's rows of the 32 chunks, each chunk's run contiguous in beliefs
#pragma unroll 2
    for (int e = l; e < 32 * J * K; e += 32) {
      const int m = e / (J * K), off = e % (J * K);
      const int cnt = (ocount[m] - j0) * K;
      if (off < cnt) g.beliefs[obase[m] + static_cast<long long>(j0) * K + off] = rows[m * RS + off];
    }
    __syncwarp();
  }
  if (active && c == g.o.nC - 1) {
#pragma unroll
    for (int q = 0; q < K; ++q) g.b_final[s * K + q] = b[q];
  }
}

template <int K>
int launch(const Args& a, cudaStream_t st) {
  const Layout& o = a.o;
  if (o.G > 0) {
    products_kernel<K><<<static_cast<unsigned>((o.G + kWarpsA - 1) / kWarpsA), 32 * kWarpsA,
                         0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  starts_kernel<K><<<static_cast<unsigned>(a.S), 32, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || o.G == 0) return static_cast<int>(e);
  // the shared-memory attribute belongs to the function on a device: set once
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(fold_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<K>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  fold_kernel<K><<<static_cast<unsigned>(o.Gp / 32), 32, Tile<K>::kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch a call needs: out[0] doubles (step matrices, products, starts,
// the chunks' last valid times),
// out[1] 32-bit words (validity words, flags, the unsafe counts).
extern "C" void belief_forward_scratch(long long S, long long N, long long K, long long C,
                                       long long* out) {
  const Layout o = layout(S, N, C);
  out[0] = C * o.Gp * K * K + o.G * K * K + o.G * K + o.G;
  out[1] = o.G * o.W + o.G + S;
}

// Launches the three passes on `stream`: times (S, N), consts as in
// belief_fold.cuh, beliefs (S, N, K), b_final (S, K), t_final (S,), chunk C
// >= 1, scratch as belief_forward_scratch sizes it (the unsafe counts, (S,)
// int32, are its last S words).  Returns a CUDA error code (0: none).
extern "C" int belief_forward_launch(const double* times, const double* consts,
                                     double* beliefs, double* b_final, double* t_final,
                                     long long S, long long N, long long K, long long C,
                                     double* dscratch, int* iscratch, void* stream) {
  if (S <= 0) return 0;
  if (C < 1 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.times = times;
  a.consts = consts;
  a.beliefs = beliefs;
  a.b_final = b_final;
  a.t_final = t_final;
  a.S = S;
  a.N = N;
  a.C = C;
  a.o = layout(S, N, C);
  a.et = dscratch;
  a.prod = a.et + C * a.o.Gp * K * K;
  a.starts = a.prod + a.o.G * K * K;
  a.tlast = a.starts + a.o.G * K;
  a.masks = reinterpret_cast<unsigned*>(iscratch);
  a.flags = iscratch + a.o.G * a.o.W;
  a.unsafe = a.flags + a.o.G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    case 4: return launch<4>(a, st);
    case 5: return launch<5>(a, st);
    case 6: return launch<6>(a, st);
    case 7: return launch<7>(a, st);
    case 8: return launch<8>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
