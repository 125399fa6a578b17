// Event kernel of the compiled serving backend (one block per lane).
//
// Counterpart of _scan_core in src/repro/serving/compiled.py, which is a
// jax.lax.scan and not a Pallas kernel.  PyTorch has no scan, so the event
// loop of one simulation lane runs in one thread: admit every arrival due
// by the clock, read the action table[phase of the last admitted arrival,
// min(q, L - 1)], apply the clip / wait / terminate / capped-drain rules,
// draw the service time means[a] * draws[min(n_batches, n_draws - 1)],
// advance the clock.
//
// One __global__, three template flags (eight instances):
//   QMAN      the managed-queue lane: an explicit admitted-slot queue per
//             lane, door refusals past buffer_cap queued requests (counted
//             against the running queue, which still holds expired
//             requests not yet swept), then -- with shed set -- the sweep
//             of the expired queue prefix (deadline <= t) before every
//             decision.  A sweep is not an epoch.
//   ADAPTIVE  the AdaptiveController in the loop: every taken arrival, in
//             time order, folds into the EWMA gap estimate and may switch
//             the live bank entry (relative margin, minimum dwell).
//   MIX       the belief-mixture action rule (BeliefPhaseScheduler(mode=
//             "mix")): the action is rint(sum_k beliefs[last, k] *
//             table[k, min(q, L - 1)]) with beliefs the phase posterior
//             row of the last admitted arrival (the managed-queue index
//             where that lane is used), summed in order k = 0..K-1 with
//             each product and sum rounded on its own; rint rounds half
//             to even, as np.round.  Then the same clip / wait / terminate
//             rules.
// Lanes: block -> (trace s = lane / n_pol, table p = lane % n_pol); the
// adaptive lane runs over the whole bank (n_pol = 1).
//
// Two warps a block, specialised.  Lane 0 of warp 0 (the producer) walks
// the events: its chain of dependent loads and branches is the lane's
// time.  Every serve it takes goes into a ring in shared memory
// (completion time, first queue index, batch size).  Warp 1 (the
// consumer) accounts the served requests from the ring, off the
// producer's chain: each of its 32 lanes takes one request of a batch --
// latency, SLO miss, histogram bin (a log2 guess checked against the
// edges, staged in shared memory; a miss bisects) and the shared-memory
// histogram row -- and lane 0 adds the latencies and energies in service
// order, so the sums are the Python loop's bit for bit.  With record the
// producer also writes each epoch's action, the consumer each served
// request's arrival slot and completion time, in service order.
//
// Numerics: every f64 operation that decides anything is rounded on its
// own (__dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn / __dsqrt_rn, and
// the file is built with -fmad=false), exactly as numpy, Python floats
// and the reference scan round them; a fused multiply-add would move an
// admission `arrival <= t` or a hysteresis comparison by one ulp and
// break decision-for-decision equality.
//
// Bound: a lane is a dependent chain -- each event needs the clock of the
// previous one -- so it runs at the latency of one thread's loads and
// branches, far from the card's memory or compute roofs.  Each lane gets
// a block of its own; many lanes fill the card.
#include <cuda_runtime.h>
#include <math.h>

// The launch parameters (ctypes mirrors them field for field).  At global
// scope: the exported launch function takes a pointer to one.
struct ScanParams {
  const long long* tables;  // (n_tables, K, L) action tables
  const double* arrivals;   // (S, size) sorted, +inf padded
  const double* deadlines;  // (S, size)
  const long long* phases;  // (S, size) row of each arrival
  const double* draws;      // (S, n_draws) unit service draws
  const double* means;      // (b_max + 1,)
  const double* zeta;       // (b_max + 1,), zeta[0] = 0
  const double* edges;      // (n_edges,) histogram bin edges
  const double* ad_f;       // adaptive lane only
  const long long* ad_i;    // adaptive lane only
  long long* agg_i;         // (n_lanes, N_AGG_I)
  double* agg_f;            // (n_lanes, N_AGG_F)
  long long* hist;          // (n_lanes, n_edges + 1)
  int* queue;               // (n_lanes, size) admitted slots; managed queue only
  int* rec_a;               // (n_lanes, rec_cap) action per epoch, or null
  int* rec_slot;            // (n_lanes, size) served slots in service order, or null
  double* rec_done;         // (n_lanes, size) their completion times, or null
  const double* beliefs;    // (S, size, K) phase posterior rows; mix lane only
  long long n_lanes, n_pol, n_tables, K, L, size, n_draws, n_edges;
  long long max_eps, rec_cap, b_max, buffer_cap;
  double t0, horizon;
  int drain, shed, check_deadlines, qman, adaptive, mix;
};

namespace {

// columns of agg_i (int64) and agg_f (f64) per lane
enum {
  I_SERVED, I_ADMITTED, I_BATCHES, I_EPOCHS, I_TERMINATED, I_SLO_MISS,
  I_SHED, I_EXPIRED, I_HEAD, I_TAIL, I_SEL, I_SWITCHES, I_HAVE_GAP_BAR,
  I_HAVE_LAST, N_AGG_I
};
enum { F_T_FINAL, F_ENERGY, F_LAT_SUM, F_GAP_BAR, F_LAST, F_LAST_SWITCH, N_AGG_F };
// ad_f: controller constants and initial state, then lam_keys[P], aux_sq[P];
// ad_i: initial state
enum {
  A_INV_SCALE, A_EWMA, A_MARGIN, A_MIN_DWELL, A_MIN_GAP, A_INIT_EST,
  A_GAP_BAR0, A_LAST0, A_LAST_SWITCH0, N_AD_F
};
enum { J_SEL0, J_SWITCHES0, J_HAVE_GAP_BAR0, J_HAVE_LAST0, N_AD_I };

constexpr int kRing = 64;     // serves in flight between producer and consumer
constexpr int kPublish = 16;  // serves per published count (a fence each)
constexpr unsigned kFull = 0xffffffffu;

// The block's shared memory: the ring, the edges, the histogram row, and
// the ring's counters (each written by one side only).
struct Ring {
  double* t_done;
  long long* first;  // queue index (managed queue) or service index of the batch
  int* a;
  double* edges;
  int* hist;
  volatile long long* produced;
  volatile long long* consumed;
  volatile int* finished;
};

__host__ __device__ constexpr long long smem_bytes(long long n_edges) {
  return kRing * (8 + 8 + 4) + 8 * n_edges + 4 * (n_edges + 1);
}

// searchsorted(edges, lat, side="right"): the number of edges <= lat.  The
// log2 guess is the bin itself for geometric edges (up to f32 rounding);
// it is checked against the edges around it, and a miss bisects.
__device__ __forceinline__ long long bin_of(double lat, const double* edges,
                                            long long n, float lo, float scale) {
  const float f = (__log2f(static_cast<float>(lat)) - lo) * scale + 1.0f;
  long long g = f >= static_cast<float>(n) ? n : (f > 0.0f ? static_cast<long long>(f) : 0);
  const bool lo_ok = g == 0 || edges[g - 1] <= lat;
  const bool hi_ok = g == n || lat < edges[g];
  if (lo_ok && hi_ok) return g;
  long long a = 0, b = n;
  while (a < b) {
    const long long m = (a + b) >> 1;
    if (edges[m] <= lat) a = m + 1; else b = m;
  }
  return a;
}

// Warp 1: account every served request of the lane, in service order.
template <bool QMAN>
__device__ void consume(const ScanParams& p, const Ring& r, long long lane,
                        const double* arr, const double* dl, const int* queue) {
  const int me = threadIdx.x & 31;
  const long long n = p.n_edges;
  // the log2 guess of a bin, (log2(lat) - lo) * scale + 1: exact up to
  // rounding for geometric edges; other edges only bisect more often
  const double e0 = r.edges[0], e1 = r.edges[n - 1];
  const bool geometric = n > 1 && 0.0 < e0 && e0 < e1 && e1 < INFINITY;
  const float lo = geometric ? static_cast<float>(log2(e0)) : 0.0f;
  const float scale = geometric ? static_cast<float>((n - 1) / log2(e1 / e0)) : 0.0f;
  int* rec_slot = p.rec_slot ? p.rec_slot + lane * p.size : nullptr;
  double* rec_done = p.rec_done ? p.rec_done + lane * p.size : nullptr;
  double lat_sum = 0.0, energy = 0.0;
  long long miss = 0, got = 0, srv = 0;
  for (;;) {
    // finished is read before produced: once it is set, produced is final
    int fin = *r.finished;
    __threadfence_block();
    const long long avail = *r.produced;
    fin = __shfl_sync(kFull, fin, 0);
    const long long upto = __shfl_sync(kFull, avail, 0);
    if (got == upto) {
      if (fin) break;
      __nanosleep(100);  // leave the SM's load pipes to the producer
      continue;
    }
    __threadfence_block();  // the ring entries up to `upto` are visible
    for (; got < upto; ++got) {
      const int k = static_cast<int>(got % kRing);
      const double t_done = r.t_done[k];
      const long long first = r.first[k];
      const int a = r.a[k];
      if (me == 0) energy = __dadd_rn(energy, p.zeta[a]);
      for (int base = 0; base < a; base += 32) {
        const int i = base + me;
        double lat = 0.0;
        if (i < a) {
          const long long slot = QMAN ? queue[first + i] : first + i;
          lat = __dsub_rn(t_done, arr[slot]);
          if (p.check_deadlines && t_done > dl[slot]) ++miss;
          atomicAdd(r.hist + bin_of(lat, r.edges, n, lo, scale), 1);
          if (rec_slot) {
            rec_slot[srv + i] = static_cast<int>(slot);
            rec_done[srv + i] = t_done;
          }
        }
        const int m = a - base < 32 ? a - base : 32;
        for (int j = 0; j < m; ++j) {  // the Python loop's order
          const double v = __shfl_sync(kFull, lat, j);
          if (me == 0) lat_sum = __dadd_rn(lat_sum, v);
        }
      }
      srv += a;
    }
    if (me == 0) *r.consumed = got;
  }
  for (int off = 16; off > 0; off >>= 1) miss += __shfl_down_sync(kFull, miss, off);
  __syncwarp();
  long long* hist = p.hist + lane * (n + 1);
  for (long long i = me; i <= n; i += 32) hist[i] = r.hist[i];
  if (me == 0) {
    p.agg_i[lane * N_AGG_I + I_SLO_MISS] = miss;
    p.agg_f[lane * N_AGG_F + F_ENERGY] = energy;
    p.agg_f[lane * N_AGG_F + F_LAT_SUM] = lat_sum;
  }
}

// Lane 0 of warp 0: the event loop of the lane.
template <bool QMAN, bool ADAPTIVE, bool MIX>
__device__ void produce(const ScanParams& p, const Ring& r, long long lane,
                        const double* arr, const double* __restrict__ dl,
                        int* queue) {
  const long long s = lane / p.n_pol;
  long long size = p.size;
  const long long* ph = p.phases + s * size;
  const double* draws = p.draws + s * p.n_draws;
  const long long KL = p.K * p.L;
  long long L = p.L, b_max = p.b_max, max_eps = p.max_eps;
  double horizon = p.horizon;
  const long long* tab = p.tables + (ADAPTIVE ? 0 : (lane % p.n_pol) * KL);
  int* rec_a = p.rec_a ? p.rec_a + lane * p.rec_cap : nullptr;
  const double* means = p.means;
  const long long K = p.K;
  const double* bel = MIX ? p.beliefs + s * size * K : nullptr;
  // keep the loop's invariants in registers (the compiler would reload them
  // from the constant bank inside the event loop, on its critical path)
  asm volatile("" : "+l"(arr), "+l"(ph), "+l"(draws), "+l"(tab), "+l"(means));
  if (MIX) asm volatile("" : "+l"(bel));
  asm volatile("" : "+l"(size), "+l"(L), "+l"(b_max), "+l"(max_eps), "+d"(horizon));

  // the controller: constants, then the state the lane starts from
  double inv_scale = 0, ewma = 0, margin = 0, min_dwell = 0, min_gap = 0, init_est = 0;
  double gap_bar = 0, last = 0, last_sw = 0;
  bool have_gb = false, have_last = false;
  long long sel = 0, n_sw = 0;
  const double* lam_keys = nullptr;
  const double* aux_sq = nullptr;
  if (ADAPTIVE) {
    inv_scale = p.ad_f[A_INV_SCALE];
    ewma = p.ad_f[A_EWMA];
    margin = p.ad_f[A_MARGIN];
    min_dwell = p.ad_f[A_MIN_DWELL];
    min_gap = p.ad_f[A_MIN_GAP];
    init_est = p.ad_f[A_INIT_EST];
    gap_bar = p.ad_f[A_GAP_BAR0];
    last = p.ad_f[A_LAST0];
    last_sw = p.ad_f[A_LAST_SWITCH0];
    lam_keys = p.ad_f + N_AD_F;
    aux_sq = lam_keys + p.n_tables;
    sel = p.ad_i[J_SEL0];
    n_sw = p.ad_i[J_SWITCHES0];
    have_gb = p.ad_i[J_HAVE_GAP_BAR0] != 0;
    have_last = p.ad_i[J_HAVE_LAST0] != 0;
    tab = p.tables + sel * KL;
  }
  // scaled distance of bank entry i to the estimate: the reference lane's
  // sqrt(((lam_i - est) * inv_scale)^2 + aux_sq_i), op for op
  auto dist = [&](long long i, double est) -> double {
    const double x = __dmul_rn(__dsub_rn(lam_keys[i], est), inv_scale);
    return __dsqrt_rn(__dadd_rn(__dmul_rn(x, x), aux_sq[i]));
  };
  // one observed arrival: EWMA fold, then the hysteresis-guarded retune
  auto observe = [&](double t_j) {
    if (have_last) {
      const double gap = fmax(__dsub_rn(t_j, last), min_gap);
      gap_bar = have_gb ? __dadd_rn(__dmul_rn(__dsub_rn(1.0, ewma), gap_bar),
                                    __dmul_rn(ewma, gap))
                        : gap;
      have_gb = true;
    }
    last = t_j;
    have_last = true;
    const double est = have_gb ? __ddiv_rn(1.0, fmax(gap_bar, min_gap)) : init_est;
    if (!(__dsub_rn(t_j, last_sw) >= min_dwell) || !isfinite(est)) return;
    long long cand = 0;
    double d_cand = dist(0, est);
    for (long long i = 1; i < p.n_tables; ++i) {
      const double d = dist(i, est);
      if (d < d_cand) {  // strict: the first minimum, as argmin
        cand = i;
        d_cand = d;
      }
    }
    if (cand != sel && d_cand < __dmul_rn(__dsub_rn(1.0, margin), dist(sel, est))) {
      sel = cand;
      last_sw = t_j;
      ++n_sw;
      tab = p.tables + sel * KL;
    }
  };
  // arrivals at or past the horizon are never admitted
  auto due_time = [&](long long i) -> double {
    if (i >= size) return INFINITY;
    const double x = arr[i];
    return x < horizon ? x : INFINITY;
  };

  const long long n_draws = p.n_draws;
  double t = p.t0;
  long long n_srv = 0, n_adm = 0, n_bat = 0, n_eps = 0, consumed = 0;
  long long n_shed = 0, n_exp = 0, head = 0, tail = 0, last_adm = -1;
  bool done = false;
  while (!done && n_eps < max_eps) {
    // admit every arrival due by t, in time order; x ends as the first
    // arrival not yet due (+inf past the trace)
    double x;
    for (;; ++n_adm) {
      x = due_time(n_adm);
      if (!(n_adm < size && x <= t)) break;
      if (QMAN) {
        if (tail - head >= p.buffer_cap) {  // refused at the door, never observed
          ++n_shed;
          continue;
        }
        queue[tail++] = static_cast<int>(n_adm);
        last_adm = n_adm;
      }
      if (ADAPTIVE) observe(x);
    }
    if (QMAN && p.shed) {  // drop the expired prefix of the queue
      while (head < tail && dl[queue[head]] <= t) {
        ++head;
        ++n_exp;
      }
    }
    const long long q = QMAN ? tail - head : n_adm - n_srv;
    const long long li = QMAN ? (last_adm > 0 ? last_adm : 0) : (n_adm > 0 ? n_adm - 1 : 0);
    const long long col = q < L - 1 ? q : L - 1;
    long long a;
    if (MIX) {  // posterior-weighted blend of the phase rows, rounded
      const double* b = bel + li * K;
      double acc = __dmul_rn(b[0], static_cast<double>(tab[col]));
      for (long long k = 1; k < K; ++k)
        acc = __dadd_rn(acc, __dmul_rn(b[k], static_cast<double>(tab[k * L + col])));
      a = static_cast<long long>(rint(acc));
    } else {
      a = tab[ph[li] * L + col];
    }
    const long long cap = q < b_max ? q : b_max;
    a = a < 0 ? 0 : (a > cap ? cap : a);
    const bool live = isfinite(x);
    const bool wait = a == 0 && live;
    const bool term = a == 0 && !live && (q == 0 || !p.drain);
    if (a == 0 && !live && !term) a = cap;  // b_max-capped tail drain
    const bool serve = !wait && !term;
    if (!serve) a = 0;
    if (rec_a) rec_a[n_eps] = static_cast<int>(a);
    ++n_eps;
    // the service time is read before the branch, as the loads it needs
    // (draws[n_bat], means[a]) are known by now
    const double draw = draws[n_bat < n_draws - 1 ? n_bat : n_draws - 1];
    const double t_done = __dadd_rn(t, __dmul_rn(means[a], draw));
    if (wait) {
      t = x;
    } else if (serve) {
      // hand the batch to the consumer; the count is published every
      // kPublish serves (one fence each), with room for the next kPublish
      const int k = static_cast<int>(n_bat % kRing);
      r.t_done[k] = t_done;
      r.first[k] = QMAN ? head : n_srv;
      r.a[k] = static_cast<int>(a);
      if (QMAN) head += a;
      n_srv += a;
      ++n_bat;
      t = t_done;
      if (n_bat % kPublish == 0) {
        __threadfence_block();  // the entries (and the queue slots) before the count
        *r.produced = n_bat;
        while (n_bat + kPublish - consumed > kRing) consumed = *r.consumed;
      }
    }
    done = term;
  }
  __threadfence_block();
  *r.produced = n_bat;
  __threadfence_block();
  *r.finished = 1;
  long long* oi = p.agg_i + lane * N_AGG_I;
  oi[I_SERVED] = n_srv;
  oi[I_ADMITTED] = n_adm;
  oi[I_BATCHES] = n_bat;
  oi[I_EPOCHS] = n_eps;
  oi[I_TERMINATED] = done ? 1 : 0;
  oi[I_SHED] = n_shed;
  oi[I_EXPIRED] = n_exp;
  oi[I_HEAD] = head;
  oi[I_TAIL] = tail;
  oi[I_SEL] = sel;
  oi[I_SWITCHES] = n_sw;
  oi[I_HAVE_GAP_BAR] = have_gb ? 1 : 0;
  oi[I_HAVE_LAST] = have_last ? 1 : 0;
  double* of = p.agg_f + lane * N_AGG_F;
  of[F_T_FINAL] = t;
  of[F_GAP_BAR] = gap_bar;
  of[F_LAST] = last;
  of[F_LAST_SWITCH] = last_sw;
}

template <bool QMAN, bool ADAPTIVE, bool MIX>
__global__ void __launch_bounds__(64) serve_scan_kernel(const ScanParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long produced, consumed;
  __shared__ int finished;
  const long long lane = blockIdx.x;
  const long long n = p.n_edges;
  Ring r;
  r.t_done = reinterpret_cast<double*>(smem);
  r.edges = r.t_done + kRing;
  r.first = reinterpret_cast<long long*>(r.edges + n);
  r.a = reinterpret_cast<int*>(r.first + kRing);
  r.hist = r.a + kRing;
  r.produced = &produced;
  r.consumed = &consumed;
  r.finished = &finished;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) r.edges[i] = p.edges[i];
  for (long long i = threadIdx.x; i <= n; i += blockDim.x) r.hist[i] = 0;
  if (threadIdx.x == 0) {
    produced = 0;
    consumed = 0;
    finished = 0;
  }
  __syncthreads();
  const long long s = lane / p.n_pol;
  const double* arr = p.arrivals + s * p.size;
  const double* dl = p.deadlines + s * p.size;
  int* queue = QMAN ? p.queue + lane * p.size : nullptr;
  if (threadIdx.x >= 32) {
    consume<QMAN>(p, r, lane, arr, dl, queue);
  } else if (threadIdx.x == 0) {
    produce<QMAN, ADAPTIVE, MIX>(p, r, lane, arr, dl, queue);
  }
}

template <bool QMAN, bool ADAPTIVE, bool MIX>
int launch(const ScanParams& p, cudaStream_t st) {
  const long long bytes = smem_bytes(p.n_edges);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        serve_scan_kernel<QMAN, ADAPTIVE, MIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  serve_scan_kernel<QMAN, ADAPTIVE, MIX>
      <<<static_cast<unsigned>(p.n_lanes), 64, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size of ScanParams, so the caller's copy of the layout can be checked.
extern "C" long long serve_scan_params_bytes() {
  return static_cast<long long>(sizeof(ScanParams));
}

// Dynamic shared memory a block needs for n_edges histogram edges.
extern "C" long long serve_scan_smem_bytes(long long n_edges) {
  return smem_bytes(n_edges);
}

template <bool MIX>
int launch_mix(const ScanParams& p, cudaStream_t st) {
  if (p.qman && p.adaptive) return launch<true, true, MIX>(p, st);
  if (p.qman) return launch<true, false, MIX>(p, st);
  if (p.adaptive) return launch<false, true, MIX>(p, st);
  return launch<false, false, MIX>(p, st);
}

// Launches one block of two warps per lane, the instance chosen by
// params->qman / ->adaptive / ->mix.  Returns a CUDA error code (0: none).
extern "C" int serve_scan_launch(const ScanParams* params, void* stream) {
  const ScanParams p = *params;
  if (p.n_lanes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.mix ? launch_mix<true>(p, st) : launch_mix<false>(p, st);
}
