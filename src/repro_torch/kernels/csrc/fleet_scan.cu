// Fleet event kernel: M routed replicas, one simulation lane a block.
//
// Counterpart of _fleet_scan_core in src/repro/serving/fleet.py, which is a
// jax.lax.scan (fleet.py:551) followed by a vectorised per-request
// reconstruction (:558-648), and not a Pallas kernel.  PyTorch has no scan,
// so the event loop of one lane runs in one thread, one event a step, in
// the reference's step priority:
//   (0) a due fault boundary replays, the lowest replica index first;
//   (1) else one due arrival is routed (rr / jsq / pow2 / batch_aware, DOWN
//       replicas masked) and queued, or shed by a full waiting room;
//   (2) else the lowest-index replica with a pending decision decides;
//   (3) else the clock advances: arrival, completion, fault boundary, in
//       that order on ties, or the lane stops.
// Every argmin / argmax takes the lowest index, as jnp does, and a phase
// outside the stack reads its nearest row, as jnp's clamped gathers do.
//
// Accounting happens inside the walk (the reference rebuilds it after the
// scan): each replica keeps a FIFO of the arrival slots routed to it, in
// global scratch (n_lanes x M x size int32); substream positions [0, c0)
// are the carried queue q0.  A serve resolves positions [n_srv + n_drop,
// ... + a) at serve start -- latency, SLO miss, histogram bin (in shared
// memory), the record rows -- and a crash leaves its positions in place,
// so a requeue to the front costs nothing; a batch that runs out of
// retries marks the same positions dropped.  Energy and the latency sum
// add in step order.
//
// Replica state (busy clock, next boundary, queue and the counters) lives
// in the block's shared memory, up to M = 64 replicas; the wrapper refuses
// more.  Template flags: MIX (the belief-mixture action rule,
// rint(sum_k beliefs[last, k] * table[m, k, min(q, L - 1)]), summed in
// order k = 0..K-1; before the first admission the row bel0 stands in) and
// RECORD (per-epoch decisions and per-request rows).
//
// Numerics: built with -fmad=false, so every f64 operation is rounded on
// its own as in numpy and the reference scan: svc = means[a] * draw *
// mult in that order, t_done = t + svc, crash energy zeta[a] * (ds - t) /
// svc.  A contracted multiply-add would move a clock by an ulp and break
// decision-for-decision equality.
//
// Bound: a lane is a dependent chain of steps, each needing the state the
// last one left; it runs at the latency of one thread's shared-memory
// loads and branches, far from the card's memory or compute roofs.
#include <cuda_runtime.h>
#include <math.h>

struct FleetParams {
  const long long* tables;  // (P, M, K, L) action tables
  const long long* thr;     // (P, M, K, L) threshold gaps
  const long long* rids;    // (R,) router ids
  const double* arrivals;   // (S, size) sorted, +inf padded
  const double* deadlines;  // (S, size)
  const long long* phases;  // (S, size)
  const double* router_u;   // (S, size, 2) pow2 uniforms
  const double* draws;      // (S, n_draws) unit service draws
  const double* means;      // (b_max + 1,)
  const double* zeta;       // (b_max + 1,), zeta[0] = 0
  const double* edges;      // (n_edges,)
  const double* fb;         // (M, nfb) fault boundaries, +inf padded
  const double* fmult;      // (M, n_mult) per-attempt service multipliers
  const double* q0_times;   // (M, q0w) carried queues, +inf padded
  const double* q0_dl;      // (M, q0w)
  const double* busy0;      // (M,)
  const long long* state0;  // (5, M): nbat, needs, fcur, rty, infl
  const double* beliefs;    // (S, size, K); mix only
  const double* bel0;       // (S, K); mix only
  long long* agg_i;         // (n_lanes, N_AGG_I)
  double* agg_f;            // (n_lanes, N_AGG_F)
  long long* rep_i;         // (n_lanes, N_REP, M)
  double* busy;             // (n_lanes, M)
  long long* hist;          // (n_lanes, n_edges + 1)
  int* fifo;                // (n_lanes, M, size) scratch
  int* rec_a;               // (n_lanes, rec_cap); record only
  int* rec_m;               // (n_lanes, rec_cap)
  double* arr_lat;          // (n_lanes, size), zeroed by the caller
  signed char* arr_state;   // (n_lanes, size), zeroed
  int* arr_server;          // (n_lanes, size), filled with M
  int* arr_pos;             // (n_lanes, size), zeroed
  double* q0_lat;           // (n_lanes, M, q0w), zeroed
  signed char* q0_state;    // (n_lanes, M, q0w), zeroed
  long long n_lanes, P, R, M, K, L, size, n_draws, n_edges, nfb, n_mult, q0w;
  long long max_eps, step_cap, rec_cap, b_max, buf_cap, max_retries, rr0, ph0;
  double t0, horizon, t_last;
  int drain, more_coming, mix, record;
};

namespace {

enum { I_ADMITTED, I_RR, I_PH, I_EPOCHS, I_STEPS, I_DONE, I_BATCHES, I_ATTEMPTS,
       I_MISS, N_AGG_I };
enum { F_T, F_ENERGY, F_LAT_SUM, N_AGG_F };
enum { R_QLEN, R_ROUTE, R_SRV, R_NBAT, R_NEEDS, R_FCUR, R_RTY, R_INFL, R_NDROP,
       R_NSHED, N_REP };
enum { S_NBAT, S_NEEDS, S_FCUR, S_RTY, S_INFL };
constexpr int kServed = 1, kDropped = 2, kShed = 4;
constexpr int kScoreQcap = (1 << 14) - 1;
constexpr int kGapShift = 1 << 15;
constexpr int kDownPenalty = 1 << 30;
constexpr int kCounters = 10;  // per-replica int64 arrays in shared memory

__host__ __device__ constexpr long long smem_bytes(long long n_edges, long long M) {
  return 8 * n_edges + 8 * 2 * M + 8 * kCounters * M + 4 * (n_edges + 1) + 4 * M;
}

// Per-replica state of the lane, in shared memory.
struct Rep {
  double* busy;
  double* nb;  // next unreplayed fault boundary (+inf past the end)
  long long *qlen, *route, *srv, *nbat, *fcur, *rty, *infl, *ndrop, *nshed, *c0;
  int* needs;
};

// searchsorted(edges, lat, side="right"): the number of edges <= lat.
__device__ __forceinline__ long long bin_of(double lat, const double* edges, long long n) {
  long long a = 0, b = n;
  while (a < b) {
    const long long m = (a + b) >> 1;
    if (edges[m] <= lat) a = m + 1; else b = m;
  }
  return a;
}

template <bool MIX, bool RECORD>
__device__ void walk(const FleetParams& p, long long lane, const double* edges, int* hist,
                     const Rep& r) {
  const long long M = p.M, K = p.K, L = p.L, size = p.size;
  const long long s = lane / (p.P * p.R), pp = (lane / p.R) % p.P, rix = lane % p.R;
  const long long KL = K * L;
  const long long* tab = p.tables + pp * M * KL;
  const long long* thr = p.thr + pp * M * KL;
  const long long rid = p.rids[rix];
  const double* arr = p.arrivals + s * size;
  const double* dl = p.deadlines + s * size;
  const long long* ph = p.phases + s * size;
  const double* ru = p.router_u + s * size * 2;
  const double* draws = p.draws + s * p.n_draws;
  const double* bel = MIX ? p.beliefs + s * size * K : nullptr;
  const double* bel0 = MIX ? p.bel0 + s * K : nullptr;
  int* fifo = p.fifo + lane * M * size;
  const long long q0w = p.q0w;
  int* rec_a = RECORD ? p.rec_a + lane * p.rec_cap : nullptr;
  int* rec_m = RECORD ? p.rec_m + lane * p.rec_cap : nullptr;
  double* arr_lat = RECORD ? p.arr_lat + lane * size : nullptr;
  signed char* arr_state = RECORD ? p.arr_state + lane * size : nullptr;
  int* arr_server = RECORD ? p.arr_server + lane * size : nullptr;
  int* arr_pos = RECORD ? p.arr_pos + lane * size : nullptr;
  double* q0_lat = RECORD ? p.q0_lat + lane * M * q0w : nullptr;
  signed char* q0_state = RECORD ? p.q0_state + lane * M * q0w : nullptr;
  const double horizon = p.horizon, t_last = p.t_last;
  const bool drain = p.drain != 0, more = p.more_coming != 0;
  const long long nfb = p.nfb, n_mult = p.n_mult, n_draws = p.n_draws, n_edges = p.n_edges;

  long long nbat0_sum = 0;
  for (long long m = 0; m < M; ++m) {
    long long c0 = 0;
    while (c0 < q0w && isfinite(p.q0_times[m * q0w + c0])) ++c0;
    const long long fcur = p.state0[S_FCUR * M + m], infl = p.state0[S_INFL * M + m];
    const double b = p.busy0[m];
    r.c0[m] = c0;
    r.busy[m] = b;
    r.fcur[m] = fcur;
    r.infl[m] = infl;
    r.qlen[m] = c0 - infl;
    r.route[m] = c0;
    r.srv[m] = 0;
    r.nbat[m] = p.state0[S_NBAT * M + m];
    nbat0_sum += r.nbat[m];
    r.rty[m] = p.state0[S_RTY * M + m];
    r.ndrop[m] = 0;
    r.nshed[m] = 0;
    r.needs[m] = p.state0[S_NEEDS * M + m] != 0 && isinf(b) && infl == 0 && (fcur & 1) == 0;
    r.nb[m] = fcur < nfb ? p.fb[m * nfb + fcur] : INFINITY;
  }

  double t = p.t0, energy = 0.0, lat_sum = 0.0;
  long long n_adm = 0, rr = p.rr0, phc = p.ph0, neps = 0, nuse = 0, n_bat = 0, miss = 0;
  bool done = false;

  // resolve substream position pos of replica m: served at t_done, or dropped
  auto resolve = [&](long long m, long long pos, bool served, double t_done) {
    double lat = 0.0;
    if (pos < r.c0[m]) {
      if (RECORD) q0_state[m * q0w + pos] |= served ? kServed : kDropped;
      if (!served) return;
      lat = t_done - p.q0_times[m * q0w + pos];
      if (RECORD) q0_lat[m * q0w + pos] = lat;
      if (t_done > p.q0_dl[m * q0w + pos]) ++miss;
    } else {
      const long long i = fifo[m * size + (pos - r.c0[m])];
      if (RECORD) arr_state[i] |= served ? kServed : kDropped;
      if (!served) return;
      lat = t_done - arr[i];
      if (RECORD) arr_lat[i] = lat;
      if (t_done > dl[i]) ++miss;
    }
    lat_sum += lat;
    ++hist[bin_of(lat, edges, n_edges)];
  };

  while (!done && neps < p.max_eps && nuse < p.step_cap) {
    const long long ia = n_adm < size - 1 ? n_adm : size - 1;
    const double x = arr[ia];
    const double nxt = x < horizon ? x : INFINITY;
    const bool dead = isinf(nxt) && !more;
    if (dead && drain) {  // wake idle UP replicas for the b_max-capped drain
      for (long long m = 0; m < M; ++m)
        if (isinf(r.busy[m]) && r.qlen[m] > 0 && (r.fcur[m] & 1) == 0 && r.infl[m] == 0)
          r.needs[m] = 1;
    }
    ++nuse;

    // ---- (0) fault boundary: the lowest-index due one --------------------
    long long mb = -1;
    for (long long m = 0; m < M; ++m)
      if (r.nb[m] <= t) { mb = m; break; }
    if (mb >= 0) {
      const long long m = mb;
      const bool start = (r.fcur[m] & 1) == 0;
      if (start && r.infl[m] > 0) {
        if (r.rty[m] + 1 > p.max_retries) {  // out of retries: the batch drops
          const long long base = r.srv[m] + r.ndrop[m];
          for (long long k = 0; k < r.infl[m]; ++k) resolve(m, base + k, false, 0.0);
          r.ndrop[m] += r.infl[m];
          r.rty[m] = 0;
        } else {  // requeue to the front, positions kept
          r.qlen[m] += r.infl[m];
          r.rty[m] += 1;
        }
        r.infl[m] = 0;
      }
      if (start) {
        r.needs[m] = 0;  // a down-start silences a pending decision
      } else if (r.qlen[m] > 0 && isinf(r.busy[m]) && r.infl[m] == 0) {
        r.needs[m] = 1;  // the repair re-arms queued work
      }
      const long long f = ++r.fcur[m];
      r.nb[m] = f < nfb ? p.fb[m * nfb + f] : INFINITY;
      continue;
    }

    // ---- (1) admission: route one due arrival ----------------------------
    if (nxt <= t) {
      long long mr = 0;
      if (rid == 0) {  // round robin: the first UP replica from its slot
        mr = rr % M;
        for (long long k = 0; k < M; ++k) {
          const long long c = (rr + k) % M;
          if ((r.fcur[c] & 1) == 0) { mr = c; break; }
        }
      } else {
        auto score = [&](long long m) -> int {
          const long long qe = r.qlen[m] + r.infl[m];
          const int bf = (!isinf(r.busy[m]) || r.infl[m] > 0) ? 1 : 0;
          const int pen = (r.fcur[m] & 1) ? kDownPenalty : 0;
          const int base = 2 * static_cast<int>(qe < kScoreQcap ? qe : kScoreQcap) + bf;
          if (rid != 3) return base + pen;
          // batch-aware: the gap to the next admission threshold at the
          // arriving request's phase, a busy replica's gap plus its backlog
          const long long col = qe < 0 ? 0 : (qe < L - 1 ? qe : L - 1);
          const long long pa = ph[ia] < 0 ? 0 : (ph[ia] < K - 1 ? ph[ia] : K - 1);
          int g = static_cast<int>(thr[m * KL + pa * L + col]);
          g += bf * static_cast<int>(qe < kScoreQcap ? qe : kScoreQcap);
          g = g < kScoreQcap ? g : kScoreQcap;
          return g * kGapShift + base + pen;
        };
        if (rid == 2) {  // power of two choices; a tie goes to the first
          const long long M1 = M - 1;
          long long c1 = static_cast<long long>(ru[2 * ia] * static_cast<double>(M));
          long long c2 = static_cast<long long>(ru[2 * ia + 1] * static_cast<double>(M));
          c1 = c1 < M1 ? c1 : M1;
          c2 = c2 < M1 ? c2 : M1;
          mr = score(c1) <= score(c2) ? c1 : c2;
        } else {  // jsq / batch-aware: the lowest score, lowest index
          int best = score(0);
          for (long long m = 1; m < M; ++m) {
            const int v = score(m);
            if (v < best) { best = v; mr = m; }
          }
        }
      }
      if (RECORD) arr_server[ia] = static_cast<int>(mr);
      if (r.qlen[mr] + r.infl[mr] >= p.buf_cap) {  // the waiting room is full
        ++r.nshed[mr];
        if (RECORD) arr_state[ia] |= kShed;
      } else {
        const long long pos = r.route[mr];
        fifo[mr * size + (pos - r.c0[mr])] = static_cast<int>(ia);
        if (RECORD) arr_pos[ia] = static_cast<int>(pos);
        ++r.qlen[mr];
        ++r.route[mr];
        if (isinf(r.busy[mr]) && (r.fcur[mr] & 1) == 0 && r.infl[mr] == 0) r.needs[mr] = 1;
      }
      phc = ph[ia];
      ++rr;
      ++n_adm;
      continue;
    }

    // ---- (2) decision epoch on the first pending replica -----------------
    long long md = -1;
    for (long long m = 0; m < M; ++m)
      if (r.needs[m]) { md = m; break; }
    if (md >= 0) {
      const long long m = md, q = r.qlen[m];
      const long long col = q < L - 1 ? q : L - 1;
      const long long* row = tab + m * KL;
      long long a;
      if (MIX) {  // posterior-weighted blend of the phase rows, rounded
        const double* b = n_adm > 0 ? bel + (n_adm - 1 < size - 1 ? n_adm - 1 : size - 1) * K
                                    : bel0;
        double acc = b[0] * static_cast<double>(row[col]);
        for (long long k = 1; k < K; ++k) acc = acc + b[k] * static_cast<double>(row[k * L + col]);
        a = static_cast<long long>(rint(acc));
      } else {
        a = row[(phc < 0 ? 0 : (phc < K - 1 ? phc : K - 1)) * L + col];
      }
      const long long cap = q < p.b_max ? q : p.b_max;
      a = a < 0 ? 0 : (a > cap ? cap : a);
      if (a == 0 && dead && q > 0 && drain) a = cap;  // the capped tail drain
      if (RECORD) {
        rec_a[neps] = static_cast<int>(a);
        rec_m[neps] = static_cast<int>(m);
      }
      ++neps;
      r.needs[m] = 0;
      if (a > 0) {
        const long long nb_m = r.nbat[m];
        const double svc = p.means[a] * draws[nb_m < n_draws - 1 ? nb_m : n_draws - 1]
                           * p.fmult[m * n_mult + (nb_m < n_mult - 1 ? nb_m : n_mult - 1)];
        const double t_done = t + svc;
        const double ds = r.nb[m];  // the replica is UP: its next down-start
        r.qlen[m] -= a;
        if (ds < t_done) {  // the batch crashes; prorated energy
          r.infl[m] += a;
          energy += p.zeta[a] * (ds - t) / svc;
        } else {
          const long long base = r.srv[m] + r.ndrop[m];
          for (long long k = 0; k < a; ++k) resolve(m, base + k, true, t_done);
          r.busy[m] = t_done;
          r.srv[m] += a;
          r.rty[m] = 0;
          energy += p.zeta[a];
          ++n_bat;
        }
        r.nbat[m] = nb_m + 1;
      }
      continue;
    }

    // ---- (3) advance: arrival, completion, or fault boundary -------------
    // streaming deferral: with more chunks to come, completions and
    // boundaries at or after the chunk's last arrival wait for the next
    const bool fin = isfinite(nxt);
    long long mc = 0;
    double tc = INFINITY, tb = INFINITY;
    for (long long m = 0; m < M; ++m) {
      const double b = r.busy[m];
      const double be = (fin || dead || b < t_last) ? b : INFINITY;
      if (be < tc) { tc = be; mc = m; }
      const double nbm = r.nb[m];
      if ((r.qlen[m] > 0 || r.infl[m] > 0) && (fin || dead || nbm < t_last) && nbm < tb)
        tb = nbm;
    }
    if (fin && nxt <= tc && nxt <= tb) {
      t = nxt;
    } else if (isfinite(tc) && tc <= tb) {
      t = tc;
      r.busy[mc] = INFINITY;
      r.needs[mc] = 1;
    } else if (isfinite(tb)) {
      t = tb;  // the boundary itself replays next step
    } else {
      done = true;  // drained, or every remaining event deferred
    }
  }

  long long nbat_sum = 0;
  long long* oi = p.agg_i + lane * N_AGG_I;
  long long* rep = p.rep_i + lane * N_REP * M;
  for (long long m = 0; m < M; ++m) {
    nbat_sum += r.nbat[m];
    rep[R_QLEN * M + m] = r.qlen[m];
    rep[R_ROUTE * M + m] = r.route[m];
    rep[R_SRV * M + m] = r.srv[m];
    rep[R_NBAT * M + m] = r.nbat[m];
    rep[R_NEEDS * M + m] = r.needs[m];
    rep[R_FCUR * M + m] = r.fcur[m];
    rep[R_RTY * M + m] = r.rty[m];
    rep[R_INFL * M + m] = r.infl[m];
    rep[R_NDROP * M + m] = r.ndrop[m];
    rep[R_NSHED * M + m] = r.nshed[m];
    p.busy[lane * M + m] = r.busy[m];
  }
  oi[I_ADMITTED] = n_adm;
  oi[I_RR] = rr;
  oi[I_PH] = phc;
  oi[I_EPOCHS] = neps;
  oi[I_STEPS] = nuse;
  oi[I_DONE] = done ? 1 : 0;
  oi[I_BATCHES] = n_bat;
  oi[I_ATTEMPTS] = nbat_sum - nbat0_sum;
  oi[I_MISS] = miss;
  double* of = p.agg_f + lane * N_AGG_F;
  of[F_T] = t;
  of[F_ENERGY] = energy;
  of[F_LAT_SUM] = lat_sum;
}

template <bool MIX, bool RECORD>
__global__ void __launch_bounds__(32) fleet_scan_kernel(const FleetParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lane = blockIdx.x;
  const long long n = p.n_edges, M = p.M;
  double* edges = reinterpret_cast<double*>(smem);
  Rep r;
  r.busy = edges + n;
  r.nb = r.busy + M;
  long long* c = reinterpret_cast<long long*>(r.nb + M);
  r.qlen = c;
  r.route = c + M;
  r.srv = c + 2 * M;
  r.nbat = c + 3 * M;
  r.fcur = c + 4 * M;
  r.rty = c + 5 * M;
  r.infl = c + 6 * M;
  r.ndrop = c + 7 * M;
  r.nshed = c + 8 * M;
  r.c0 = c + 9 * M;
  int* hist = reinterpret_cast<int*>(c + kCounters * M);
  r.needs = hist + n + 1;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) edges[i] = p.edges[i];
  for (long long i = threadIdx.x; i <= n; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) walk<MIX, RECORD>(p, lane, edges, hist, r);
  __syncthreads();
  long long* out = p.hist + lane * (n + 1);
  for (long long i = threadIdx.x; i <= n; i += blockDim.x) out[i] = hist[i];
}

template <bool MIX, bool RECORD>
int launch(const FleetParams& p, cudaStream_t st) {
  const long long bytes = smem_bytes(p.n_edges, p.M);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fleet_scan_kernel<MIX, RECORD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fleet_scan_kernel<MIX, RECORD><<<static_cast<unsigned>(p.n_lanes), 32, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size of FleetParams, so the caller's copy of the layout can be checked.
extern "C" long long fleet_scan_params_bytes() {
  return static_cast<long long>(sizeof(FleetParams));
}

// Dynamic shared memory a block needs for n_edges edges and M replicas.
extern "C" long long fleet_scan_smem_bytes(long long n_edges, long long M) {
  return smem_bytes(n_edges, M);
}

// Launches one block of one warp per lane (thread 0 walks; the warp stages
// the edges and the histogram row).  Returns a CUDA error code (0: none).
extern "C" int fleet_scan_launch(const FleetParams* params, void* stream) {
  const FleetParams p = *params;
  if (p.n_lanes <= 0) return 0;
  if (p.M < 1 || p.M > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.mix) return p.record ? launch<true, true>(p, st) : launch<true, false>(p, st);
  return p.record ? launch<false, true>(p, st) : launch<false, false>(p, st);
}
