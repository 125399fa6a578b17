// Chain floors of the walking kernels: each walk's dependent chain alone,
// with every operand already in registers or shared memory, no staging, no
// accounting, no records and no global traffic inside the loop.  Not a
// port of any kernel and not on any path: chip_smoke.py launches it beside
// fleet_scan.cu, sim_scan.cu, belief_forward.cu and mmpp_sample.cu to say
// how far each is from the least time its serial walk can take on this
// card.
//
//   fleet: per step, the fault-boundary scan over M replicas in registers,
//          the admission test and a JSQ route (scores over M), the first
//          pending replica's table lookup (or the belief blend), the
//          service time means[a] * draw * mult, and the clock advance (the
//          earliest completion against the next arrival); run for a
//          given number of steps a lane.  Arrival times come from a
//          window of the lane's own trace in shared memory, replayed with
//          an offset (one add a wrap), so the steps look like the path's.
//   sim:   per epoch, pol[min(s, P - 1)] (cut to 0 above s), the service
//          time means[a] (times a unit factor when the family has one),
//          the run of offset sums and compares against T (at most k_max
//          kept), and the state update (queue length, clock, integral,
//          energy); run for E epochs.  Gaps come from a window of the
//          lane's own stream in shared memory, read cyclically.
//   belief: the serial fold of belief_fold.cuh (a K-term product, the two
//          guarded sums, 2K divides) for a given number of arrivals a
//          trace, step matrices from a window of the trace's own in shared
//          memory, read cyclically.  A one-lane walk of a trace is bounded
//          by it; the time-parallel belief kernel is not.
//   mmpp:  the competing-clocks step (a select by phase, the add, the
//          compare, the selects of t and nsw, the phase flip) for n steps a
//          lane, the staged candidates (E_g / lam0, E_g / lam1, E_d * dw0,
//          E_d * dw1) from a window of the lane's own in shared memory.
//
// Built with the walking kernels' flags (-fmad=false), so each add and
// product is the same instruction as in the walk.  A floor's own counts
// (arrivals consumed, requests admitted, switches) are returned so a caller
// can set them beside the path's.
#include <cuda_runtime.h>
#include <math.h>

#include "belief_fold.cuh"

namespace {

constexpr int kRegM = 8;
constexpr int kWin = 1024;  // window entries (a power of two)

struct FleetFloor {
  const double* win;        // (lanes, kWin) arrival times from the lane's trace
  const long long* tab;     // (M, K, L) one table stack
  const double* bel;        // (lanes, kWin, K) belief rows; mix only
  const double* means;      // (b_max + 1,)
  const double* zeta;       // (b_max + 1,)
  const long long* steps;   // (lanes,) steps to walk
  double* out;              // (lanes, 3): t, energy, admitted
  long long M, K, L, b_max;
  double draw, mult;
  int mix;
};

// MAXM: the smallest of 1, 2, 4, 8 that holds M, as the fleet kernel's
// register walk is compiled.
template <int MAXM>
__global__ void __launch_bounds__(32) fleet_floor_kernel(const FleetFloor g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lane = blockIdx.x;
  int M = static_cast<int>(g.M);
  __builtin_assume(M > MAXM / 2 && M <= MAXM);
  int K = static_cast<int>(g.K), L = static_cast<int>(g.L);
  const int KL = K * L, nm = static_cast<int>(g.b_max + 1);
  double* win = reinterpret_cast<double*>(smem);
  double* means = win + kWin;
  double* zeta = means + nm;
  double* bel = zeta + nm;
  long long* tab = reinterpret_cast<long long*>(bel + (g.mix ? kWin * K : 0));
  for (int i = threadIdx.x; i < kWin; i += 32) win[i] = g.win[lane * kWin + i];
  for (int i = threadIdx.x; i < nm; i += 32) {
    means[i] = g.means[i];
    zeta[i] = g.zeta[i];
  }
  if (g.mix)
    for (int i = threadIdx.x; i < kWin * K; i += 32) bel[i] = g.bel[lane * kWin * K + i];
  for (int i = threadIdx.x; i < M * KL; i += 32) tab[i] = g.tab[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  double busy[MAXM], nb[MAXM];
  int qlen[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    busy[m] = INFINITY;
    nb[m] = win[kWin - 1] * INFINITY;  // +inf, not known to the compiler
    qlen[m] = 0;
  }
  double nb_min = nb[0];
  const double span = win[kWin - 1] - win[0] + (win[kWin - 1] - win[0]) / (kWin - 1);
  double draw = g.draw, mult = g.mult;
  int b_max = static_cast<int>(g.b_max), n_steps = static_cast<int>(g.steps[lane]);
  const int mix = g.mix;
  asm volatile("" : "+r"(M), "+r"(K), "+r"(L), "+r"(b_max), "+r"(n_steps), "+d"(draw),
               "+d"(mult));
  unsigned needs = 0;
  double t = 0.0, energy = 0.0, base = 0.0, nxt = win[0];
  int n_adm = 0;
  for (int step = 0; step < n_steps; ++step) {
    if (nb_min <= t) {  // (0) a fault boundary (none falls due: nb is +inf)
      int mb = 0;
#pragma unroll
      for (int m = MAXM - 1; m >= 0; --m)
        if (m < M && nb[m] <= t) mb = m;
#pragma unroll
      for (int m = 0; m < MAXM; ++m)
        if (m == mb) nb[m] = INFINITY;
      continue;
    }
    if (nxt <= t) {  // (1) route to the shortest queue
      int mr = 0, best = 0x7fffffff;
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < M) {
          const int v = 2 * qlen[m] + (isinf(busy[m]) ? 0 : 1);
          if (v < best) {
            best = v;
            mr = m;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m == mr) {
          ++qlen[m];
          if (isinf(busy[m])) needs |= 1u << m;
        }
      }
      ++n_adm;
      const int j = n_adm & (kWin - 1);
      if (j == 0) base = base + span;
      nxt = base + win[j];
      continue;
    }
    if (needs) {  // (2) the first pending replica decides
      const int m = __ffs(needs) - 1;
      int q = qlen[0];
#pragma unroll
      for (int i = 1; i < MAXM; ++i) q = i == m ? qlen[i] : q;
      const int col = q < L - 1 ? q : L - 1;
      long long a;
      if (mix) {
        const double* b = bel + (n_adm > 0 ? ((n_adm - 1) & (kWin - 1)) * K : 0);
        double acc = b[0] * static_cast<double>(tab[m * KL + col]);
        for (int k = 1; k < K; ++k)
          acc = acc + b[k] * static_cast<double>(tab[m * KL + k * L + col]);
        a = static_cast<long long>(rint(acc));
      } else {
        a = tab[m * KL + col];
      }
      const int cap = q < b_max ? q : b_max;
      a = a < 0 ? 0 : (a > cap ? cap : a);
      needs &= ~(1u << m);
      if (a > 0) {
        const int ai = static_cast<int>(a);
        const double t_done = t + means[ai] * draw * mult;
#pragma unroll
        for (int i = 0; i < MAXM; ++i) {
          if (i == m) {
            qlen[i] -= ai;
            busy[i] = t_done;
          }
        }
        energy += zeta[ai];
      }
      continue;
    }
    int mc = 0;  // (3) advance the clock
    double tc = INFINITY;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M && busy[m] < tc) {
        tc = busy[m];
        mc = m;
      }
    }
    if (nxt <= tc) {
      t = nxt;
    } else {
      t = tc;
#pragma unroll
      for (int m = 0; m < MAXM; ++m)
        if (m == mc) busy[m] = INFINITY;
      needs |= 1u << mc;
    }
  }
  g.out[lane * 3 + 0] = t;
  g.out[lane * 3 + 1] = energy;
  g.out[lane * 3 + 2] = static_cast<double>(n_adm);
}

struct SimFloor {
  const double* gaps;   // (kWin,) the lane's first gaps arr[i] / lam
  const double* units;  // (kWin,) service factors of the first epochs (fam != 0)
  const long long* pol;
  const double* means;
  const double* en;
  double* out;  // t, qint, energy, consumed
  long long P, n_means, E, k_max;
  int fam;
};

__global__ void __launch_bounds__(32) sim_floor_kernel(const SimFloor g) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* gaps = reinterpret_cast<double*>(smem);
  double* units = gaps + kWin;
  double* means = units + kWin;
  double* en = means + g.n_means;
  int* pol = reinterpret_cast<int*>(en + g.n_means);
  for (int i = threadIdx.x; i < kWin; i += 32) {
    gaps[i] = g.gaps[i];
    units[i] = g.units[i];
  }
  for (long long i = threadIdx.x; i < g.n_means; i += 32) {
    means[i] = g.means[i];
    en[i] = g.en[i];
  }
  for (long long i = threadIdx.x; i < g.P; i += 32) pol[i] = static_cast<int>(g.pol[i]);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int P1 = static_cast<int>(g.P - 1), E = static_cast<int>(g.E);
  int kmax = static_cast<int>(g.k_max < (1LL << 30) ? g.k_max : (1LL << 30));
  int unit = g.fam != 0;
  asm volatile("" : "+r"(P1), "+r"(E), "+r"(kmax), "+r"(unit));
  int s = 0, cur = 0;
  double t = 0.0, qint = 0.0, energy = 0.0, gnext = gaps[0];
  for (int ep = 0; ep < E; ++ep) {
    int a = pol[s < P1 ? s : P1];
    if (a > s) a = 0;
    if (a == 0) {
      const double dt = gnext;
      ++cur;
      gnext = gaps[cur & (kWin - 1)];
      const double t_next = t + dt;
      qint = qint + static_cast<double>(s) * dt;
      s += 1;
      t = t_next;
      continue;
    }
    const double T = unit ? means[a] * units[ep & (kWin - 1)] : means[a];
    const double t_next = t + T;
    double c = 0.0, contrib = 0.0;
    int n = 0;
    for (;;) {
      c = c + gnext;
      ++cur;
      gnext = gaps[cur & (kWin - 1)];
      if (!(c < T) || n == kmax) break;
      contrib = contrib + (T - c);
      ++n;
    }
    qint = qint + (static_cast<double>(s) * T + contrib);
    energy = energy + en[a];
    s = s - a + n;
    t = t_next;
  }
  g.out[0] = t;
  g.out[1] = qint;
  g.out[2] = energy;
  g.out[3] = static_cast<double>(cur);
}

constexpr int kBelWin = 256;  // step matrices in the belief floor's window

// One lane (thread 0 of a block) a trace: steps[lane] folds from b_init.
template <int K>
__global__ void __launch_bounds__(32) belief_floor_kernel(const double* win,
                                                          const double* consts,
                                                          const long long* steps, double* out) {
  constexpr int KK = K * K;
  __shared__ double e[kBelWin * KK];
  const long long lane = blockIdx.x;
  for (int i = threadIdx.x; i < kBelWin * KK; i += 32) e[i] = win[lane * kBelWin * KK + i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const belief::Consts cs = belief::unpack(consts, K);
  const belief::FoldConsts<K> f(cs);
  double b[K];
#pragma unroll
  for (int j = 0; j < K; ++j) b[j] = cs.b_init[j];
  int n = static_cast<int>(steps[lane]);
  asm volatile("" : "+r"(n));
  for (int i = 0; i < n; ++i) belief::fold_step<K>(b, e + (i & (kBelWin - 1)) * KK, f);
#pragma unroll
  for (int j = 0; j < K; ++j) out[lane * K + j] = b[j];
}

// One lane (thread 0 of a block) a walk: win (lanes, kWin, 4) holds each
// step's (E_g / lam0, E_g / lam1, E_d * dw0, E_d * dw1); nsw0 (lanes,) the
// first switch.  out (lanes, 3): t, nsw, switches.
__global__ void __launch_bounds__(32) mmpp_floor_kernel(const double* win, const double* nsw0,
                                                        long long n, double* out) {
  __shared__ __align__(16) double w[kWin * 4];
  const long long lane = blockIdx.x;
  for (int i = threadIdx.x; i < kWin * 4; i += 32) w[i] = win[lane * kWin * 4 + i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double2* sg = reinterpret_cast<const double2*>(w);
  int steps = static_cast<int>(n);
  asm volatile("" : "+r"(steps));
  double t = 0.0, nsw = nsw0[lane];
  int phase = 0, switches = 0;
  double2 gg = sg[0], dd = sg[1];
  for (int i = 0; i < steps; ++i) {
    const int k = (i + 1) & (kWin - 1);
    const double2 ngg = sg[2 * k], ndd = sg[2 * k + 1];
    const double gap = phase ? gg.y : gg.x;
    const double dstep = phase ? dd.x : dd.y;
    const double cand = t + gap;
    const double nn = nsw + dstep;
    const bool sw = cand >= nsw;
    t = sw ? nsw : cand;
    nsw = sw ? nn : nsw;
    phase ^= sw ? 1 : 0;
    switches += sw ? 1 : 0;
    gg = ngg;
    dd = ndd;
  }
  out[lane * 3 + 0] = t;
  out[lane * 3 + 1] = nsw;
  out[lane * 3 + 2] = static_cast<double>(switches);
}

template <int MAXM>
int launch_floor(const FleetFloor& g, long long lanes, long long bytes, cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fleet_floor_kernel<MAXM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fleet_floor_kernel<MAXM><<<static_cast<unsigned>(lanes), 32, bytes, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of the fleet floor's block, and its launch (one block of
// one warp a lane; M <= 8).  Return a CUDA error code (0: none).
extern "C" long long fleet_floor_smem_bytes(long long M, long long K, long long L,
                                            long long b_max, int mix) {
  return 8 * (kWin + 2 * (b_max + 1) + (mix ? kWin * K : 0) + M * K * L);
}

extern "C" int fleet_floor_launch(const double* win, const long long* tab, const double* bel,
                                  const double* means, const double* zeta,
                                  const long long* steps, double* out, long long lanes,
                                  long long M, long long K, long long L, long long b_max,
                                  double draw, double mult, int mix, void* stream) {
  if (M < 1 || M > kRegM) return static_cast<int>(cudaErrorInvalidValue);
  FleetFloor g{win, tab, bel, means, zeta, steps, out, M, K, L, b_max, draw, mult, mix};
  const long long bytes = fleet_floor_smem_bytes(M, K, L, b_max, mix);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1) return launch_floor<1>(g, lanes, bytes, st);
  if (M == 2) return launch_floor<2>(g, lanes, bytes, st);
  if (M <= 4) return launch_floor<4>(g, lanes, bytes, st);
  return launch_floor<kRegM>(g, lanes, bytes, st);
}

// Entries of each floor's window (arrival times; gaps and factors).
extern "C" long long chain_floor_window() { return kWin; }

extern "C" int sim_floor_launch(const double* gaps, const double* units, const long long* pol,
                                long long P, const double* means, const double* en,
                                long long n_means, long long E, long long k_max, int fam,
                                double* out, void* stream) {
  SimFloor g{gaps, units, pol, means, en, out, P, n_means, E, k_max, fam};
  const long long bytes = 8 * (2 * kWin + 2 * n_means) + 4 * P;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sim_floor_kernel<<<1, 32, bytes, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Step matrices in the belief floor's window.
extern "C" long long belief_floor_window() { return kBelWin; }

// The belief fold's chain: one block a trace, win (lanes, kBelWin, K * K),
// consts as belief_fold.cuh lays them out, out (lanes, K).
extern "C" int belief_floor_launch(const double* win, const double* consts,
                                   const long long* steps, long long lanes, long long K,
                                   double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(lanes);
  switch (K) {
    case 1: belief_floor_kernel<1><<<blocks, 32, 0, st>>>(win, consts, steps, out); break;
    case 2: belief_floor_kernel<2><<<blocks, 32, 0, st>>>(win, consts, steps, out); break;
    case 3: belief_floor_kernel<3><<<blocks, 32, 0, st>>>(win, consts, steps, out); break;
    case 4: belief_floor_kernel<4><<<blocks, 32, 0, st>>>(win, consts, steps, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The MMPP walk's chain: one block a lane, n steps each.
extern "C" int mmpp_floor_launch(const double* win, const double* nsw0, long long lanes,
                                 long long n, double* out, void* stream) {
  mmpp_floor_kernel<<<static_cast<unsigned>(lanes), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      win, nsw0, n, out);
  return static_cast<int>(cudaGetLastError());
}
