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
// Bound: a lane is a dependent chain of steps, each needing the clock and
// the replica state the last one left, so a lane runs at the latency of
// one thread's step, far from the card's memory (the byte bound of the
// chip_smoke row is 4-5 orders below it) or compute roofs.  The design
// keeps only that chain on the walking thread (chain_floor.cu measures
// the chain alone):
//
//   * Three warps a block.  Lane 0 of warp 0 walks.  Warp 1 (the consumer)
//     accounts every served or dropped request.  Warp 2 (the stager)
//     copies the lane's due times (arrivals before the horizon), phases,
//     pow2 uniforms and, for MIX, belief rows into shared memory in
//     double-buffered chunks of kChunk arrivals ahead of the walker, which
//     publishes the oldest arrival it still reads at each chunk crossing.
//     The action and threshold tables of the lane's stack, the service
//     means and the energies are copied into shared memory at block start
//     (the tables where they fit).
//   * Replica state: for M <= kRegM (every path's M: 1, 3, 4, 8) the
//     fields that every step scans -- busy clock, next fault boundary,
//     queue length, in-flight count -- live in registers: the walk is
//     compiled for MAXM = 1, 2, 4 and 8 (the smallest that holds M; the
//     compiler is told M > MAXM / 2) with its loops unrolled and predicated
//     on m < M, so no register array is indexed at run time (a replica
//     picked at run time is read through a select chain and written
//     through predicated moves).  The pending-decision and DOWN flags are
//     bit masks (the first pending replica is one find-first-set), and the
//     earliest next fault boundary is kept beside them, so a step tests
//     one clock for a due boundary.  The fields touched only at a replica
//     picked at run time (routed, served, dropped, shed, attempts,
//     retries, fault cursor, carried-queue length) are int32 in shared
//     memory.  M from 9 to 64 keeps every field in shared memory (the same
//     code, not unrolled).  Counts on the chain are int32 and the loop's
//     scalar invariants are pinned in registers: a single thread pays the
//     latency of every dependent instruction (about ten cycles each on
//     this card), so the step's instruction count is its time.
//   * Round robin carries rr mod M as a wrapped counter beside rr, and
//     picks the first UP replica at or after it from the UP mask: no
//     64-bit division on the chain.
//   * Accounting on the consumer warp.  The walker pushes each serve or
//     drop as a record (replica, first substream position, count,
//     completion time, served or dropped) into a ring in shared memory and
//     publishes the count every kPublish records; it blocks while the ring
//     is full, so nothing is dropped.  The consumer resolves each record's
//     positions, one request a lane: the arrival slot (from the replica's
//     FIFO of routed slots, in shared memory where M x size x 4 bytes fit,
//     else in global scratch), the latency, the SLO miss, the histogram
//     bin (a log2 guess checked against the staged edges, a bisection on a
//     miss) and the shared histogram by atomics, and the record rows.  Its
//     lane 0 adds the latencies in push order, so lat_sum is bitwise the
//     plain walk's.  The energy stays on the walker, one add a decision,
//     in step order.  A request's state bits are written by one side only:
//     shed by the walker, served or dropped by the consumer.
//   * The service draw and fault multiplier of a decision are read through
//     L1 from the replica's attempt count (a cursor per replica, not one
//     stream); their loads are issued before the table lookup, beside it on
//     the chain rather than after it.
//
// Template flags: MAXM (1, 2, 4, kRegM: registers; kMaxM: shared memory; 20
// instances in all), MIX (the
// belief-mixture action rule, rint(sum_k beliefs[last, k] * table[m, k,
// min(q, L - 1)]), summed in order k = 0..K-1; before the first admission
// the row bel0 stands in) and RECORD (per-epoch decisions and per-request
// rows).
//
// Numerics: built with -fmad=false, so every f64 operation is rounded on
// its own as in numpy and the reference scan: svc = means[a] * draw *
// mult in that order, t_done = t + svc, crash energy zeta[a] * (ds - t) /
// svc.  A contracted multiply-add would move a clock by an ulp and break
// decision-for-decision equality; the kernel equals its plain walk
// (kernels/fleet_scan.py) in every output.
#include <cuda_runtime.h>
#include <climits>
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
  int* fifo;                // (n_lanes, M, size) scratch, unless in shared memory
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
  int stage_tables, fifo_smem;  // the wrapper's shared-memory plan
};

namespace {

enum { I_ADMITTED, I_RR, I_PH, I_EPOCHS, I_STEPS, I_DONE, I_BATCHES, I_ATTEMPTS,
       I_MISS, N_AGG_I };
enum { F_T, F_ENERGY, F_LAT_SUM, N_AGG_F };
enum { R_QLEN, R_ROUTE, R_SRV, R_NBAT, R_NEEDS, R_FCUR, R_RTY, R_INFL, R_NDROP,
       R_NSHED, N_REP };
enum { S_NBAT, S_NEEDS, S_FCUR, S_RTY, S_INFL };
// int32 per-replica arrays in shared memory (the cold fields)
enum { C_ROUTE, C_SRV, C_NBAT, C_RTY, C_NDROP, C_NSHED, C_C0, C_FCUR, N_COLD };
constexpr int kServed = 1, kDropped = 2, kShed = 4;
constexpr int kScoreQcap = (1 << 14) - 1;
constexpr int kGapShift = 1 << 15;
constexpr int kDownPenalty = 1 << 30;
constexpr int kRegM = 8;       // replicas kept in registers (the unrolled walk)
constexpr int kMaxM = 64;      // the wrapper's MAX_REPLICAS
constexpr int kChunk = 256;    // staged arrivals a chunk; two buffers
constexpr int kRing = 64;      // records in flight between walker and consumer
constexpr int kPublish = 16;   // records a published count (a fence each)
constexpr int kThreads = 96;   // walker warp, consumer warp, stager warp
constexpr unsigned kFull = 0xffffffffu;

// Byte offsets of the block's shared memory, every region 16-byte aligned
// (kernels/fleet_scan.py's smem_bytes mirrors the total).
struct Layout {
  long long edges, means, zeta, rec_t, st_arr, st_ph, st_ru, st_bel, busy, nb, tab, thr,
      rec_m, rec_first, rec_cnt, cold, qlen, infl, hist, fifo, total;
};

__host__ __device__ inline long long up16(long long b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(long long n_edges, long long M, long long K,
                                         long long L, long long size, long long n_means,
                                         int mix, int stage_tables, int fifo_smem) {
  Layout o{};
  long long at = 64;  // the ring and staging counters
  o.edges = at; at += up16(8 * n_edges);
  o.means = at; at += up16(8 * n_means);
  o.zeta = at; at += up16(8 * n_means);
  o.rec_t = at; at += up16(8 * kRing);
  o.st_arr = at; at += up16(8 * 2 * kChunk);
  o.st_ph = at; at += up16(8 * 2 * kChunk);
  o.st_ru = at; at += up16(16 * 2 * kChunk);
  o.st_bel = at; at += mix ? up16(8 * 2 * kChunk * K) : 0;
  o.busy = at; at += up16(8 * M);
  o.nb = at; at += up16(8 * M);
  o.tab = at; at += stage_tables ? up16(8 * M * K * L) : 0;
  o.thr = at; at += stage_tables ? up16(8 * M * K * L) : 0;
  o.rec_m = at; at += up16(4 * kRing);
  o.rec_first = at; at += up16(4 * kRing);
  o.rec_cnt = at; at += up16(4 * kRing);
  o.cold = at; at += up16(4 * N_COLD * M);
  o.qlen = at; at += up16(4 * M);
  o.infl = at; at += up16(4 * M);
  o.hist = at; at += up16(4 * (n_edges + 1));
  o.fifo = at; at += fifo_smem ? up16(4 * M * size) : 0;
  o.total = at;
  return o;
}

__host__ __device__ inline Layout layout_of(const FleetParams& p) {
  return layout(p.n_edges, p.M, p.K, p.L, p.size, p.b_max + 1, p.mix, p.stage_tables,
                p.fifo_smem);
}

// The block's shared memory, bound to the layout.
struct Shared {
  volatile long long* produced;  // records published by the walker
  volatile long long* consumed;  // records accounted by the consumer
  volatile long long* staged;    // arrivals staged by the stager
  volatile long long* lo;        // the oldest arrival the walker still reads
  volatile int* finished;        // the walker is done (produced is final)
  double *edges, *means, *zeta, *rec_t, *st_arr, *st_ru, *st_bel, *busy, *nb;
  long long* st_ph;
  const long long *tab, *thr;  // the lane's stack: shared memory or global
  int *rec_m, *rec_first, *rec_cnt, *cold, *qlen, *infl, *hist, *fifo;
};

__device__ inline Shared bind(unsigned char* base, const Layout& o, const FleetParams& p,
                              long long lane) {
  Shared sm;
  long long* ctl = reinterpret_cast<long long*>(base);
  sm.produced = ctl;
  sm.consumed = ctl + 1;
  sm.staged = ctl + 2;
  sm.lo = ctl + 3;
  sm.finished = reinterpret_cast<int*>(ctl + 4);
  sm.edges = reinterpret_cast<double*>(base + o.edges);
  sm.means = reinterpret_cast<double*>(base + o.means);
  sm.zeta = reinterpret_cast<double*>(base + o.zeta);
  sm.rec_t = reinterpret_cast<double*>(base + o.rec_t);
  sm.st_arr = reinterpret_cast<double*>(base + o.st_arr);
  sm.st_ph = reinterpret_cast<long long*>(base + o.st_ph);
  sm.st_ru = reinterpret_cast<double*>(base + o.st_ru);
  sm.st_bel = reinterpret_cast<double*>(base + o.st_bel);
  sm.busy = reinterpret_cast<double*>(base + o.busy);
  sm.nb = reinterpret_cast<double*>(base + o.nb);
  const long long pp = (lane / p.R) % p.P, stack = p.M * p.K * p.L;
  sm.tab = p.stage_tables ? reinterpret_cast<long long*>(base + o.tab) : p.tables + pp * stack;
  sm.thr = p.stage_tables ? reinterpret_cast<long long*>(base + o.thr) : p.thr + pp * stack;
  sm.rec_m = reinterpret_cast<int*>(base + o.rec_m);
  sm.rec_first = reinterpret_cast<int*>(base + o.rec_first);
  sm.rec_cnt = reinterpret_cast<int*>(base + o.rec_cnt);
  sm.cold = reinterpret_cast<int*>(base + o.cold);
  sm.qlen = reinterpret_cast<int*>(base + o.qlen);
  sm.infl = reinterpret_cast<int*>(base + o.infl);
  sm.hist = reinterpret_cast<int*>(base + o.hist);
  sm.fifo = p.fifo_smem ? reinterpret_cast<int*>(base + o.fifo) : p.fifo + lane * p.M * p.size;
  return sm;
}

// Per-replica array: registers (REG, indexed only by unrolled loop
// counters; a runtime index reads a select chain and writes predicated
// moves) or shared memory.
template <class T, int N, bool REG>
struct Arr;

template <class T, int N>
struct Arr<T, N, true> {
  T v[N];
  __device__ __forceinline__ void bind(T*) {}
  __device__ __forceinline__ T& at(int i) { return v[i]; }
  __device__ __forceinline__ T get(int m) const {
    T r = v[0];
#pragma unroll
    for (int i = 1; i < N; ++i) r = i == m ? v[i] : r;
    return r;
  }
  __device__ __forceinline__ void set(int m, T x) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i == m) v[i] = x;
  }
};

template <class T, int N>
struct Arr<T, N, false> {
  T* v;
  __device__ __forceinline__ void bind(T* p) { v = p; }
  __device__ __forceinline__ T& at(int i) { return v[i]; }
  __device__ __forceinline__ T get(int m) const { return v[m]; }
  __device__ __forceinline__ void set(int m, T x) { v[m] = x; }
};

// f(m) for every replica m < M: unrolled to MAXM = kRegM (m a constant in
// each copy), a plain loop otherwise.
template <int MAXM, class F>
__device__ __forceinline__ void each(int M, F f) {
  if constexpr (MAXM <= kRegM) {
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
      if (m < M) f(m);
  } else {
#pragma unroll 1
    for (int m = 0; m < M; ++m) f(m);
  }
}

// The lowest m < M with pred(m), or -1 (branch-free when unrolled).
template <int MAXM, class F>
__device__ __forceinline__ int first(int M, F pred) {
  if constexpr (MAXM <= kRegM) {
    int r = -1;
#pragma unroll
    for (int m = MAXM - 1; m >= 0; --m)
      if (m < M && pred(m)) r = m;
    return r;
  } else {
#pragma unroll 1
    for (int m = 0; m < M; ++m)
      if (pred(m)) return m;
    return -1;
  }
}

__device__ __forceinline__ unsigned long long bit(int m) { return 1ull << m; }

// searchsorted(edges, lat, side="right"): the number of edges <= lat.  The
// log2 guess is the bin itself for geometric edges (up to f32 rounding);
// it is checked against the edges around it, and a miss bisects.
__device__ __forceinline__ long long bin_of(double lat, const double* edges, long long n,
                                            float lo, float scale) {
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

// Lane 0 of warp 0: the event loop of the lane.  MAXM is the register
// walk's bound (1, 2, 4 or 8, the smallest that holds M; the compiler is
// told M > MAXM / 2, so only the top copy of an unrolled loop tests
// m < M) or kMaxM for the shared-memory walk.  Counts on the chain are
// int32 (the wrapper bounds positions and step_cap below 2^31) and the
// loop's scalar invariants are pinned in registers.
template <int MAXM, bool MIX, bool RECORD>
__device__ void walk(const FleetParams& p, const Shared& sm, long long lane) {
  constexpr bool REG = MAXM <= kRegM;
  int M = static_cast<int>(p.M);
  if constexpr (REG) __builtin_assume(M > MAXM / 2 && M <= MAXM);
  int K = static_cast<int>(p.K), L = static_cast<int>(p.L), size = static_cast<int>(p.size);
  const int KL = K * L;
  const long long s = lane / (p.P * p.R), rix = lane % p.R;
  const long long rid = p.rids[rix];
  const long long* tab = sm.tab;
  const long long* thr = sm.thr;
  const double* draws = p.draws + s * p.n_draws;
  const double* fmult = p.fmult;
  const double* bel0 = MIX ? p.bel0 + s * K : nullptr;
  int* fifo = sm.fifo;
  int* rec_a = RECORD ? p.rec_a + lane * p.rec_cap : nullptr;
  int* rec_m = RECORD ? p.rec_m + lane * p.rec_cap : nullptr;
  signed char* arr_state = RECORD ? p.arr_state + lane * size : nullptr;
  int* arr_server = RECORD ? p.arr_server + lane * size : nullptr;
  int* arr_pos = RECORD ? p.arr_pos + lane * size : nullptr;
  double t_last = p.t_last;
  const bool drain = p.drain != 0, more = p.more_coming != 0;
  const int nfb = static_cast<int>(p.nfb), q0w = static_cast<int>(p.q0w);
  int n_mult = static_cast<int>(p.n_mult), n_draws = static_cast<int>(p.n_draws);
  // step_cap < 2^31 (the wrapper's check) and epochs <= steps
  int step_cap = static_cast<int>(p.step_cap);
  int max_eps = static_cast<int>(p.max_eps < p.step_cap ? p.max_eps : p.step_cap);
  int b_max = static_cast<int>(p.b_max < INT_MAX ? p.b_max : INT_MAX);
  long long buf_cap = p.buf_cap;
  const long long max_retries = p.max_retries;
  asm volatile("" : "+r"(M), "+r"(K), "+r"(L), "+r"(size), "+r"(step_cap), "+r"(max_eps),
               "+r"(b_max), "+r"(n_mult), "+r"(n_draws));
  asm volatile("" : "+l"(buf_cap), "+d"(t_last));  // scalars only (see sim_scan.cu)
  int* route = sm.cold + C_ROUTE * M;
  int* srv = sm.cold + C_SRV * M;
  int* nbat = sm.cold + C_NBAT * M;
  int* rty = sm.cold + C_RTY * M;
  int* ndrop = sm.cold + C_NDROP * M;
  int* nshed = sm.cold + C_NSHED * M;
  int* c0 = sm.cold + C_C0 * M;
  int* fcur = sm.cold + C_FCUR * M;

  Arr<double, MAXM, REG> busy, nb;
  Arr<int, MAXM, REG> qlen, infl;
  busy.bind(sm.busy);
  nb.bind(sm.nb);
  qlen.bind(sm.qlen);
  infl.bind(sm.infl);
  unsigned long long needs = 0, down = 0;
  long long nbat0_sum = 0;
  each<MAXM>(M, [&](int m) {
    int c = 0;
    while (c < q0w && isfinite(p.q0_times[m * q0w + c])) ++c;
    const int f = static_cast<int>(p.state0[S_FCUR * M + m]);
    const int in = static_cast<int>(p.state0[S_INFL * M + m]);
    const double b = p.busy0[m];
    c0[m] = c;
    busy.at(m) = b;
    fcur[m] = f;
    infl.at(m) = in;
    qlen.at(m) = c - in;
    route[m] = c;
    srv[m] = 0;
    nbat[m] = static_cast<int>(p.state0[S_NBAT * M + m]);
    nbat0_sum += nbat[m];
    rty[m] = static_cast<int>(p.state0[S_RTY * M + m]);
    ndrop[m] = 0;
    nshed[m] = 0;
    if (p.state0[S_NEEDS * M + m] != 0 && isinf(b) && in == 0 && (f & 1) == 0) needs |= bit(m);
    if (f & 1) down |= bit(m);
    nb.at(m) = f < nfb ? p.fb[m * nfb + f] : INFINITY;
  });
  const unsigned long long all = M == 64 ? ~0ull : bit(M) - 1;
  // the earliest next boundary of any replica: a step replays a boundary
  // only once it is due, and boundaries move only when one replays
  auto nb_least = [&]() {
    double lo = INFINITY;
    each<MAXM>(M, [&](int m) { lo = fmin(lo, nb.at(m)); });
    return lo;
  };
  double nb_min = nb_least();

  // staged arrivals: index j is readable once the stager has published
  // past it; the walker publishes the oldest index it reads (n_adm - 1,
  // the belief row of the last admission) at each chunk crossing
  int ready = 0;
  auto need = [&](int j) {
    if (j >= ready) {
      long long r;
      do { r = *sm.staged; } while (r <= j);
      ready = static_cast<int>(r);
      __threadfence_block();
    }
  };
  constexpr int kWin = 2 * kChunk - 1;

  double t = p.t0, energy = 0.0;
  int n_adm = 0, neps = 0, nuse = 0, n_bat = 0;
  long long rr = p.rr0, phc = p.ph0;
  int phk = static_cast<int>(phc < 0 ? 0 : (phc < K - 1 ? phc : K - 1));
  int rrm = static_cast<int>(((p.rr0 % M) + M) % M);
  int n_rec = 0, consumed = 0;
  bool done = false;

  // one serve (served) or drop record into the consumer's ring
  auto push = [&](int m, int first_pos, int cnt, double t_done, bool served) {
    const int k = n_rec % kRing;
    sm.rec_t[k] = t_done;
    sm.rec_m[k] = m;
    sm.rec_first[k] = first_pos;
    sm.rec_cnt[k] = served ? cnt : -cnt;
    ++n_rec;
    if (n_rec % kPublish == 0) {
      __threadfence_block();  // the entries (and the FIFO slots) before the count
      *sm.produced = n_rec;
      while (n_rec + kPublish - consumed > kRing) consumed = static_cast<int>(*sm.consumed);
    }
  };

  need(0);
  double nxt = sm.st_arr[0];  // the due time of slot min(n_adm, size - 1)
  while (!done && neps < max_eps && nuse < step_cap) {
    const int ia = n_adm < size - 1 ? n_adm : size - 1;
    const bool dead = isinf(nxt) && !more;
    if (dead && drain) {  // wake idle UP replicas for the b_max-capped drain
      each<MAXM>(M, [&](int m) {
        if (isinf(busy.at(m)) && qlen.at(m) > 0 && !((down >> m) & 1) && infl.at(m) == 0)
          needs |= bit(m);
      });
    }
    ++nuse;

    // ---- (0) fault boundary: the lowest-index due one --------------------
    if (nb_min <= t) {
      const int m = first<MAXM>(M, [&](int i) { return nb.at(i) <= t; });
      const int f0 = fcur[m];
      const bool start = (f0 & 1) == 0;
      int in = infl.get(m);
      if (start && in > 0) {
        if (rty[m] + 1 > max_retries) {  // out of retries: the batch drops
          push(m, srv[m] + ndrop[m], in, 0.0, false);
          ndrop[m] += in;
          rty[m] = 0;
        } else {  // requeue to the front, positions kept
          qlen.set(m, qlen.get(m) + in);
          rty[m] += 1;
        }
        infl.set(m, 0);
        in = 0;
      }
      if (start) {
        needs &= ~bit(m);  // a down-start silences a pending decision
      } else if (qlen.get(m) > 0 && isinf(busy.get(m)) && in == 0) {
        needs |= bit(m);  // the repair re-arms queued work
      }
      const int f = f0 + 1;
      fcur[m] = f;
      down ^= bit(m);
      nb.set(m, f < nfb ? p.fb[m * nfb + f] : INFINITY);
      nb_min = nb_least();
      continue;
    }

    // ---- (1) admission: route one due arrival ----------------------------
    if (nxt <= t) {
      const int w = ia & kWin;
      const long long ph_i = sm.st_ph[w];
      int mr = rrm;
      if (rid == 0) {  // round robin: the first UP replica from its slot
        const unsigned long long up = ~down & all;
        const unsigned long long hi = up >> rrm;
        if (hi) mr = rrm + __ffsll(static_cast<long long>(hi)) - 1;
        else if (up) mr = __ffsll(static_cast<long long>(up)) - 1;
      } else {
        const int pa = static_cast<int>(ph_i < 0 ? 0 : (ph_i < K - 1 ? ph_i : K - 1));
        // score from the replica's state; batch-aware adds the gap to the
        // next admission threshold at the arriving request's phase, a
        // busy replica's gap plus its backlog
        auto score = [&](int m, int q, int in, double b) -> int {
          const int qe = q + in;
          const int bf = (!isinf(b) || in > 0) ? 1 : 0;
          const int pen = ((down >> m) & 1) ? kDownPenalty : 0;
          const int qc = qe < kScoreQcap ? qe : kScoreQcap;
          const int base = 2 * qc + bf;
          if (rid != 3) return base + pen;
          const int col = qe < 0 ? 0 : (qe < L - 1 ? qe : L - 1);
          int g = static_cast<int>(thr[m * KL + pa * L + col]);
          g += bf * qc;
          g = g < kScoreQcap ? g : kScoreQcap;
          return g * kGapShift + base + pen;
        };
        if (rid == 2) {  // power of two choices; a tie goes to the first
          const int M1 = M - 1;
          long long c1 = static_cast<long long>(sm.st_ru[2 * w] * static_cast<double>(M));
          long long c2 = static_cast<long long>(sm.st_ru[2 * w + 1] * static_cast<double>(M));
          const int a1 = static_cast<int>(c1 < M1 ? c1 : M1);
          const int a2 = static_cast<int>(c2 < M1 ? c2 : M1);
          mr = score(a1, qlen.get(a1), infl.get(a1), busy.get(a1))
                   <= score(a2, qlen.get(a2), infl.get(a2), busy.get(a2)) ? a1 : a2;
        } else {  // jsq / batch-aware: the lowest score, lowest index
          int best = 0x7fffffff;
          mr = 0;
          auto lowest = [&](int m) {
            const int v = score(m, qlen.at(m), infl.at(m), busy.at(m));
            if (v < best) {
              best = v;
              mr = m;
            }
          };
          // two copies, rid known in each: no router test inside the scan
          if (rid == 3) each<MAXM>(M, lowest);
          else each<MAXM>(M, lowest);
        }
      }
      if (RECORD) arr_server[ia] = mr;
      const int qm = qlen.get(mr), im = infl.get(mr);
      if (static_cast<long long>(qm) + im >= buf_cap) {  // the waiting room is full
        ++nshed[mr];
        if (RECORD) arr_state[ia] |= kShed;
      } else {
        const int pos = route[mr];
        fifo[static_cast<long long>(mr) * size + (pos - c0[mr])] = ia;
        if (RECORD) arr_pos[ia] = pos;
        qlen.set(mr, qm + 1);
        route[mr] = pos + 1;
        if (isinf(busy.get(mr)) && !((down >> mr) & 1) && im == 0) needs |= bit(mr);
      }
      phc = ph_i;
      phk = static_cast<int>(phc < 0 ? 0 : (phc < K - 1 ? phc : K - 1));
      ++rr;
      if (++rrm == M) rrm = 0;
      ++n_adm;
      if (((n_adm - 1) & (kChunk - 1)) == 0) {  // the walker left a chunk
        __threadfence_block();
        *sm.lo = n_adm - 1 < size - 1 ? n_adm - 1 : size - 1;
      }
      const int nx = n_adm < size - 1 ? n_adm : size - 1;
      need(nx);
      nxt = sm.st_arr[nx & kWin];
      continue;
    }

    // ---- (2) decision epoch on the first pending replica -----------------
    if (needs) {
      const int m = __ffsll(static_cast<long long>(needs)) - 1;
      const int q = qlen.get(m);
      const int nb_m = nbat[m];
      // the service-time loads need only the attempt count: issue them first
      const double draw = draws[nb_m < n_draws - 1 ? nb_m : n_draws - 1];
      const double mult = fmult[m * n_mult + (nb_m < n_mult - 1 ? nb_m : n_mult - 1)];
      const int col = q < L - 1 ? q : L - 1;
      const long long* row = tab + m * KL;
      long long a;
      if (MIX) {  // posterior-weighted blend of the phase rows, rounded
        const double* b = n_adm > 0
            ? sm.st_bel + ((n_adm - 1 < size - 1 ? n_adm - 1 : size - 1) & kWin) * K
            : bel0;
        double acc = b[0] * static_cast<double>(row[col]);
        for (int k = 1; k < K; ++k) acc = acc + b[k] * static_cast<double>(row[k * L + col]);
        a = static_cast<long long>(rint(acc));
      } else {
        a = row[phk * L + col];
      }
      const int cap = q < b_max ? q : b_max;
      a = a < 0 ? 0 : (a > cap ? cap : a);
      if (a == 0 && dead && q > 0 && drain) a = cap;  // the capped tail drain
      if (RECORD) {
        rec_a[neps] = static_cast<int>(a);
        rec_m[neps] = m;
      }
      ++neps;
      needs &= ~bit(m);
      if (a > 0) {
        const int ai = static_cast<int>(a);
        const double svc = sm.means[ai] * draw * mult;
        const double t_done = t + svc;
        const double ds = nb.get(m);  // the replica is UP: its next down-start
        qlen.set(m, q - ai);
        if (ds < t_done) {  // the batch crashes; prorated energy
          infl.set(m, infl.get(m) + ai);
          energy += sm.zeta[ai] * (ds - t) / svc;
        } else {
          push(m, srv[m] + ndrop[m], ai, t_done, true);
          busy.set(m, t_done);
          srv[m] += ai;
          rty[m] = 0;
          energy += sm.zeta[ai];
          ++n_bat;
        }
        nbat[m] = nb_m + 1;
      }
      continue;
    }

    // ---- (3) advance: arrival, completion, or fault boundary -------------
    // streaming deferral: with more chunks to come, completions and
    // boundaries at or after the chunk's last arrival wait for the next
    const bool fin = isfinite(nxt);
    int mc = 0;
    double tc = INFINITY, tb = INFINITY;
    each<MAXM>(M, [&](int m) {
      const double b = busy.at(m);
      const double be = (fin || dead || b < t_last) ? b : INFINITY;
      if (be < tc) {
        tc = be;
        mc = m;
      }
      const double nbm = nb.at(m);
      if ((qlen.at(m) > 0 || infl.at(m) > 0) && (fin || dead || nbm < t_last) && nbm < tb)
        tb = nbm;
    });
    if (fin && nxt <= tc && nxt <= tb) {
      t = nxt;
    } else if (isfinite(tc) && tc <= tb) {
      t = tc;
      busy.set(mc, INFINITY);
      needs |= bit(mc);
    } else if (isfinite(tb)) {
      t = tb;  // the boundary itself replays next step
    } else {
      done = true;  // drained, or every remaining event deferred
    }
  }
  __threadfence_block();
  *sm.produced = n_rec;
  __threadfence_block();
  *sm.finished = 1;

  long long nbat_sum = 0;
  long long* oi = p.agg_i + lane * N_AGG_I;
  long long* rep = p.rep_i + lane * N_REP * M;
  each<MAXM>(M, [&](int m) {
    nbat_sum += nbat[m];
    rep[R_QLEN * M + m] = qlen.at(m);
    rep[R_ROUTE * M + m] = route[m];
    rep[R_SRV * M + m] = srv[m];
    rep[R_NBAT * M + m] = nbat[m];
    rep[R_NEEDS * M + m] = (needs >> m) & 1;
    rep[R_FCUR * M + m] = fcur[m];
    rep[R_RTY * M + m] = rty[m];
    rep[R_INFL * M + m] = infl.at(m);
    rep[R_NDROP * M + m] = ndrop[m];
    rep[R_NSHED * M + m] = nshed[m];
    p.busy[lane * M + m] = busy.at(m);
  });
  oi[I_ADMITTED] = n_adm;
  oi[I_RR] = rr;
  oi[I_PH] = phc;
  oi[I_EPOCHS] = neps;
  oi[I_STEPS] = nuse;
  oi[I_DONE] = done ? 1 : 0;
  oi[I_BATCHES] = n_bat;
  oi[I_ATTEMPTS] = nbat_sum - nbat0_sum;
  double* of = p.agg_f + lane * N_AGG_F;
  of[F_T] = t;
  of[F_ENERGY] = energy;
}

// Warp 1: resolve every record's positions, one request a lane, in push
// order; lane 0 adds the latencies in that order.
template <bool RECORD>
__device__ void consume(const FleetParams& p, const Shared& sm, long long lane) {
  const int me = threadIdx.x & 31;
  const long long size = p.size, q0w = p.q0w, n = p.n_edges;
  const int M = static_cast<int>(p.M);
  const long long s = lane / (p.P * p.R);
  const double* arr = p.arrivals + s * size;
  const double* dl = p.deadlines + s * size;
  const int* c0 = sm.cold + C_C0 * M;
  const int* fifo = sm.fifo;
  double* arr_lat = RECORD ? p.arr_lat + lane * size : nullptr;
  signed char* arr_state = RECORD ? p.arr_state + lane * size : nullptr;
  double* q0_lat = RECORD ? p.q0_lat + lane * M * q0w : nullptr;
  signed char* q0_state = RECORD ? p.q0_state + lane * M * q0w : nullptr;
  // the log2 guess of a bin, (log2(lat) - lo) * scale + 1: exact up to
  // rounding for geometric edges; other edges only bisect more often
  const double e0 = sm.edges[0], e1 = sm.edges[n - 1];
  const bool geometric = n > 1 && 0.0 < e0 && e0 < e1 && e1 < INFINITY;
  const float lo = geometric ? static_cast<float>(log2(e0)) : 0.0f;
  const float scale = geometric ? static_cast<float>((n - 1) / log2(e1 / e0)) : 0.0f;
  double lat_sum = 0.0;
  long long miss = 0, got = 0;
  for (;;) {
    // finished is read before produced: once it is set, produced is final
    int fin = *sm.finished;
    __threadfence_block();
    const long long avail = *sm.produced;
    fin = __shfl_sync(kFull, fin, 0);
    const long long upto = __shfl_sync(kFull, avail, 0);
    if (got == upto) {
      if (fin) break;
      __nanosleep(100);  // leave the SM's load pipes to the walker
      continue;
    }
    __threadfence_block();  // the ring entries up to `upto` are visible
    while (got < upto) {
      const int nrec = static_cast<int>(upto - got < 32 ? upto - got : 32);
      // lane k holds record got + k; an inclusive scan of the counts
      const int kk = static_cast<int>((got + me) % kRing);
      const int mine = me < nrec ? abs(sm.rec_cnt[kk]) : 0;
      int off = mine;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, off, d);
        if (me >= d) off += v;
      }
      const int total = __shfl_sync(kFull, off, 31);
      for (int base = 0; base < total; base += 32) {
        const int item = base + me;
        int j = 0;  // the record of item: the records that end at or before it
        for (int k = 0; k < nrec; ++k) j += __shfl_sync(kFull, off, k) <= item ? 1 : 0;
        const int ex = __shfl_sync(kFull, off, j > 0 ? j - 1 : 0);
        double lat = 0.0;
        int served = 0;
        if (item < total) {
          const int r = static_cast<int>((got + j) % kRing);
          const int m = sm.rec_m[r];
          const int cnt = sm.rec_cnt[r];
          const double t_done = sm.rec_t[r];
          const int pos = sm.rec_first[r] + item - (j > 0 ? ex : 0);
          served = cnt > 0;
          const int state = served ? kServed : kDropped;
          if (pos < c0[m]) {
            if (RECORD) q0_state[m * q0w + pos] |= state;
            if (served) {
              lat = t_done - p.q0_times[m * q0w + pos];
              if (RECORD) q0_lat[m * q0w + pos] = lat;
              if (t_done > p.q0_dl[m * q0w + pos]) ++miss;
            }
          } else {
            const int i = fifo[m * size + (pos - c0[m])];
            if (RECORD) arr_state[i] |= state;
            if (served) {
              lat = t_done - arr[i];
              if (RECORD) arr_lat[i] = lat;
              if (t_done > dl[i]) ++miss;
            }
          }
          if (served) atomicAdd(sm.hist + bin_of(lat, sm.edges, n, lo, scale), 1);
        }
        const int cnt_here = total - base < 32 ? total - base : 32;
        for (int i = 0; i < cnt_here; ++i) {  // the plain walk's order
          const double v = __shfl_sync(kFull, lat, i);
          const int ok = __shfl_sync(kFull, served, i);
          if (me == 0 && ok) lat_sum = lat_sum + v;
        }
      }
      got += nrec;
    }
    if (me == 0) *sm.consumed = got;
  }
  for (int off = 16; off > 0; off >>= 1) miss += __shfl_down_sync(kFull, miss, off);
  if (me == 0) {
    p.agg_i[lane * N_AGG_I + I_MISS] = miss;
    p.agg_f[lane * N_AGG_F + F_LAT_SUM] = lat_sum;
  }
}

// Warp 2: stage the lane's per-arrival inputs ahead of the walker, chunk c
// into buffer c & 1 once the walker has left chunk c - 2.
template <bool MIX>
__device__ void stage(const FleetParams& p, const Shared& sm, long long lane) {
  const int me = threadIdx.x & 31;
  const long long size = p.size, K = p.K;
  const long long s = lane / (p.P * p.R);
  const double* arr = p.arrivals + s * size;
  const long long* ph = p.phases + s * size;
  const double* ru = p.router_u + s * size * 2;
  const double* bel = MIX ? p.beliefs + s * size * K : nullptr;
  const bool want_ru = p.rids[lane % p.R] == 2;
  const double horizon = p.horizon;
  for (long long c = 0; c * kChunk < size; ++c) {
    if (c >= 2) {
      bool stop = false;
      for (;;) {
        long long lo = 0;
        int fin = 0;
        if (me == 0) {
          fin = *sm.finished;
          lo = *sm.lo;
        }
        lo = __shfl_sync(kFull, lo, 0);
        fin = __shfl_sync(kFull, fin, 0);
        if (lo >= (c - 1) * kChunk) break;
        if (fin) {
          stop = true;
          break;
        }
        __nanosleep(200);
      }
      if (stop) break;
      __threadfence_block();  // the walker's reads of chunk c - 2 came first
    }
    const long long base = c * kChunk;
    const int cnt = static_cast<int>(size - base < kChunk ? size - base : kChunk);
    const int b = static_cast<int>((c & 1) * kChunk);
    for (int i = me; i < cnt; i += 32) {
      const double x = arr[base + i];
      sm.st_arr[b + i] = x < horizon ? x : INFINITY;
      sm.st_ph[b + i] = ph[base + i];
      if (want_ru) {
        sm.st_ru[2 * (b + i)] = ru[2 * (base + i)];
        sm.st_ru[2 * (b + i) + 1] = ru[2 * (base + i) + 1];
      }
      if (MIX)
        for (long long k = 0; k < K; ++k) sm.st_bel[(b + i) * K + k] = bel[(base + i) * K + k];
    }
    __syncwarp();
    if (me == 0) {
      __threadfence_block();
      *sm.staged = base + cnt;
    }
  }
}

template <int MAXM, bool MIX, bool RECORD>
__global__ void __launch_bounds__(kThreads, 1) fleet_scan_kernel(const FleetParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lane = blockIdx.x;
  const Layout o = layout_of(p);
  const Shared sm = bind(smem, o, p, lane);
  const long long n = p.n_edges, nm = p.b_max + 1;
  for (long long i = threadIdx.x; i < n; i += kThreads) sm.edges[i] = p.edges[i];
  for (long long i = threadIdx.x; i <= n; i += kThreads) sm.hist[i] = 0;
  for (long long i = threadIdx.x; i < nm; i += kThreads) {
    sm.means[i] = p.means[i];
    sm.zeta[i] = p.zeta[i];
  }
  if (p.stage_tables) {
    const long long stack = p.M * p.K * p.L, pp = (lane / p.R) % p.P;
    long long* tab = reinterpret_cast<long long*>(smem + o.tab);
    long long* thr = reinterpret_cast<long long*>(smem + o.thr);
    for (long long i = threadIdx.x; i < stack; i += kThreads) {
      tab[i] = p.tables[pp * stack + i];
      thr[i] = p.thr[pp * stack + i];
    }
  }
  if (threadIdx.x == 0) {
    *sm.produced = 0;
    *sm.consumed = 0;
    *sm.staged = 0;
    *sm.lo = 0;
    *sm.finished = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == 1) {
    consume<RECORD>(p, sm, lane);
  } else if (warp == 2) {
    stage<MIX>(p, sm, lane);
  } else if (threadIdx.x == 0) {
    walk<MAXM, MIX, RECORD>(p, sm, lane);
  }
  __syncthreads();
  long long* out = p.hist + lane * (n + 1);
  for (long long i = threadIdx.x; i <= n; i += kThreads) out[i] = sm.hist[i];
}

template <int MAXM, bool MIX, bool RECORD>
int launch(const FleetParams& p, cudaStream_t st) {
  const long long bytes = layout_of(p).total;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fleet_scan_kernel<MAXM, MIX, RECORD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fleet_scan_kernel<MAXM, MIX, RECORD>
      <<<static_cast<unsigned>(p.n_lanes), kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MAXM>
int launch_flags(const FleetParams& p, cudaStream_t st) {
  if (p.mix) return p.record ? launch<MAXM, true, true>(p, st) : launch<MAXM, true, false>(p, st);
  return p.record ? launch<MAXM, false, true>(p, st) : launch<MAXM, false, false>(p, st);
}

}  // namespace

// The size of FleetParams, so the caller's copy of the layout can be checked.
extern "C" long long fleet_scan_params_bytes() {
  return static_cast<long long>(sizeof(FleetParams));
}

// Dynamic shared memory a block needs: the wrapper's plan (stage_tables,
// fifo_smem) laid out as the kernel lays it out.
extern "C" long long fleet_scan_smem_bytes(long long n_edges, long long M, long long K,
                                           long long L, long long size, long long n_means,
                                           int mix, int stage_tables, int fifo_smem) {
  return layout(n_edges, M, K, L, size, n_means, mix, stage_tables, fifo_smem).total;
}

// Launches one block of three warps per lane (lane 0 of warp 0 walks, warp
// 1 accounts, warp 2 stages).  Returns a CUDA error code (0: none).
extern "C" int fleet_scan_launch(const FleetParams* params, void* stream) {
  const FleetParams p = *params;
  if (p.n_lanes <= 0) return 0;
  if (p.M < 1 || p.M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.M == 1) return launch_flags<1>(p, st);
  if (p.M == 2) return launch_flags<2>(p, st);
  if (p.M <= 4) return launch_flags<4>(p, st);
  if (p.M <= kRegM) return launch_flags<kRegM>(p, st);
  return launch_flags<kMaxM>(p, st);
}
