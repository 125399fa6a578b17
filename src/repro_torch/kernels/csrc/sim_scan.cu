// The independent queue simulator: one block a lane walks the decision
// epochs of the batch-service queue under a policy table.
//
// Counterpart of the lax.scan in simulate(), src/repro/core/simulate.py:
// 169-232 (a scan, not a Pallas kernel).  Per epoch, with s requests in the
// system at time t:
//
//   a = pol[min(s, P - 1)], cut to 0 when a > s
//   a == 0: wait for one arrival: dt = E / lam; it joins the FIFO at t + dt
//   a >  0: serve the a oldest: T = service(a); the responses are
//           t + T - (their arrival times); arrivals land during the
//           service at offsets c_1 < c_2 < ... (exponential gaps at rate
//           lam summed until they pass T); a run that would give more
//           than k_max is clipped to k_max arrivals at (c_j / tau) * T,
//           tau the (k_max + 1)-th arrival's offset, and counted
//   the exact queue-length integral: s * dt waiting, s * T + sum (T - c_j)
//   serving; energy en[a] a serve.
//
// The clip keeps the reference's law (k_max arrivals at sort(u) * T, u
// uniform): given that the (k + 1)-th arrival of a Poisson process falls
// at tau < T, the first k arrival times over tau are k sorted uniforms on
// [0, 1], whatever tau.  So the rescale needs no extra draws.
//
// Arrivals are drawn *during* service, as the reference draws a Poisson
// count; a run of exponential gaps summed past T gives the count and the
// sorted offsets at once (the same law: the Poisson process restarts at
// every epoch), from one flat stream of unit exponentials read through a
// cursor.  The request FIFO is a ring of kBuf = 2^15 arrival times per
// lane in global memory (256 KB: over a block's shared memory), read
// before this epoch's arrivals are written, as the reference reads its
// carried buffer (src/repro/core/simulate.py:45-46).  Service times take their unit draws from a per-epoch
// (E, W) array: det none, expo one exponential, erlang k (their sum),
// hyperexpo a uniform (the component) and an exponential, atoms a
// uniform.  A lane whose arrival stream runs out stops and reports the
// epoch (the wrapper raises; nothing wraps).
//
// Bound: bytes (the draws read, the actions and responses written) over
// the memory rate are 4-5 orders below the walk's time; the walk is a
// dependent chain -- each epoch needs the queue length and clock the last
// one left, each arrival of a run the offset sum before it -- so the
// design keeps only that chain on the walking thread (chain_floor.cu
// measures it alone):
//
//   * One block of three warps a lane.  Lane 0 of warp 0 walks; its
//     counts are int32 and its scalar invariants pinned in registers.
//   * The policy, means, energies, means / k and the mixture tables are
//     copied into shared memory at block start.
//   * Warp 1 (the stager) computes every gap arr[i] / lam with
//     __ddiv_rn -- the same IEEE quotient the walk divided -- into a
//     double-buffered shared window of kGapChunk gaps ahead of the cursor,
//     and each epoch's service factors (the erlang sum, the mixture
//     component's scale, the exponential) into a window of kEpChunk
//     epochs.  The walker publishes its cursor and epoch at each chunk
//     crossing; a chunk is overwritten only once the walker has left it,
//     and the walker waits on the published count before reading past it.
//     The division and the component walk leave the chain; the sums stay
//     bitwise.  The clip (rare) sums the kept gaps again from global
//     memory, in order.
//   * The walker touches no global memory inside its loop: on this card a
//     single thread pays for every instruction on its path (a global store
//     cost about 40 cycles, a shared one about 10).  It writes each wait
//     epoch's arrival time and each kept offset c of a run into an arrival
//     buffer in shared memory (kCap = 4096 positions; the wrapper refuses
//     k_max above it, as a run lives there until answered) and pushes each
//     serve as a record (t, T, a, the run's first position and length, the
//     clip's tau) into a ring in shared memory.
//   * Warp 2 (the responder) takes the records in the walker's order, so
//     the global ring holds exactly what the reference's carried buffer
//     held at each serve: it writes the wait epochs' arrival times to the
//     ring; answers each response from the latest arrival written to its
//     entry before the serve's run (resp = t + T - arrival; from the buffer
//     while the walker has not reused the slot, else from the ring -- a
//     queue longer than 2^15 reads an entry a later arrival overwrote, as
//     the reference does); then turns the run's offsets into arrival times
//     (t + c, or t + (c / tau) * T after a clip, the plain walk's
//     operations in its order) in the buffer and the ring, and writes
//     acts.  It publishes how far the buffer is free; the walker waits for
//     room before a run that could overrun it.
//
// Numerics: built with -fmad=false, so every product and sum rounds on its
// own, in the order of the plain walk (kernels/sim_scan.py), which the
// kernel equals in every output.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr long long kBuf = 1LL << 15;
constexpr long long kMask = kBuf - 1;
constexpr int kGapChunk = 1024;  // staged gaps a chunk; two buffers
constexpr int kEpChunk = 512;    // staged epochs' service factors a chunk; two buffers
constexpr int kCap = 4096;       // arrival buffer: the newest arrivals' offsets or times
constexpr int kRing = 64;        // serve records in flight to the responder
constexpr int kPublish = 16;     // records a published count (a fence each)
constexpr int kThreads = 96;     // walker warp, stager warp, responder warp
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const long long* pol;
  long long P;
  const double* means;
  const double* en;
  int fam;
  long long erlang_k;
  const double* cum;
  const double* scales;
  long long C;
  const double* svc;
  long long W;
  const double* arr;
  long long A;
  double lam;
  long long k_max;
  long long E;
  long long L;
  long long R;
  double* ring;
  int* acts;
  double* resp;
  double* fout;
  long long* iout;
};

struct Layout {
  long long gaps, units, abuf, rec_t, rec_T, rec_tau, means, en, mk, cum, scales, rec_a,
      rec_tail, rec_n, rec_ep, pol, total;
};

__host__ __device__ inline long long up16(long long b) { return (b + 15) / 16 * 16; }

// Byte offsets of a block's shared memory (kernels/sim_scan.py's
// smem_bytes mirrors the total): counters, then every region 16-byte aligned.
__host__ __device__ inline Layout layout(long long P, long long n_means, long long C) {
  Layout o{};
  long long at = 64;
  o.gaps = at; at += up16(8 * 2 * kGapChunk);
  o.units = at; at += up16(16 * 2 * kEpChunk);
  o.abuf = at; at += up16(8 * kCap);
  o.rec_t = at; at += up16(8 * kRing);
  o.rec_T = at; at += up16(8 * kRing);
  o.rec_tau = at; at += up16(8 * kRing);
  o.means = at; at += up16(8 * n_means);
  o.en = at; at += up16(8 * n_means);
  o.mk = at; at += up16(8 * n_means);
  o.cum = at; at += up16(8 * C);
  o.scales = at; at += up16(8 * C);
  o.rec_a = at; at += up16(4 * kRing);
  o.rec_tail = at; at += up16(4 * kRing);
  o.rec_n = at; at += up16(4 * kRing);
  o.rec_ep = at; at += up16(4 * kRing);
  o.pol = at; at += up16(4 * P);
  o.total = at;
  return o;
}

struct Shared {
  // produced: (records << 32) | the walker's tail
  volatile long long *produced, *consumed, *gstaged, *ustaged, *cur_lo, *ep_lo, *freed;
  volatile int* finished;
  double *gaps, *units, *abuf, *rec_t, *rec_T, *rec_tau, *means, *en, *mk, *cum, *scales;
  int *rec_a, *rec_tail, *rec_n, *rec_ep, *pol;
};

__device__ inline Shared bind(unsigned char* base, const Layout& o) {
  Shared sm;
  long long* ctl = reinterpret_cast<long long*>(base);
  sm.produced = ctl;
  sm.consumed = ctl + 1;
  sm.gstaged = ctl + 2;
  sm.ustaged = ctl + 3;
  sm.cur_lo = ctl + 4;
  sm.ep_lo = ctl + 5;
  sm.freed = ctl + 6;
  sm.finished = reinterpret_cast<int*>(ctl + 7);
  sm.gaps = reinterpret_cast<double*>(base + o.gaps);
  sm.units = reinterpret_cast<double*>(base + o.units);
  sm.abuf = reinterpret_cast<double*>(base + o.abuf);
  sm.rec_t = reinterpret_cast<double*>(base + o.rec_t);
  sm.rec_T = reinterpret_cast<double*>(base + o.rec_T);
  sm.rec_tau = reinterpret_cast<double*>(base + o.rec_tau);
  sm.means = reinterpret_cast<double*>(base + o.means);
  sm.en = reinterpret_cast<double*>(base + o.en);
  sm.mk = reinterpret_cast<double*>(base + o.mk);
  sm.cum = reinterpret_cast<double*>(base + o.cum);
  sm.scales = reinterpret_cast<double*>(base + o.scales);
  sm.rec_a = reinterpret_cast<int*>(base + o.rec_a);
  sm.rec_tail = reinterpret_cast<int*>(base + o.rec_tail);
  sm.rec_n = reinterpret_cast<int*>(base + o.rec_n);
  sm.rec_ep = reinterpret_cast<int*>(base + o.rec_ep);
  sm.pol = reinterpret_cast<int*>(base + o.pol);
  return sm;
}

__device__ __forceinline__ long long component(double u, const double* cum, long long C) {
  long long j = 0;
  while (j < C - 1 && !(u < cum[j])) ++j;
  return j;
}

// Lane 0 of warp 0: the epochs of the lane.  Counts are int32 (the
// wrapper bounds A, E and P below 2^30); the loop's scalar invariants are
// pinned in registers; the next gap is read one arrival ahead, so its
// shared-memory latency overlaps the current arrival's compare.  The walker
// touches no global memory inside the loop: each wait epoch's arrival time
// and each kept offset c of a run go to the arrival buffer (position q at
// abuf[q mod kCap]), each serve to a record.
__device__ void walk(const Args& g, const Shared& sm, long long lane) {
  const double* ar = g.arr + lane * g.A;
  int A = static_cast<int>(g.A), E = static_cast<int>(g.E), P1 = static_cast<int>(g.P - 1);
  // n (kept arrivals of a run) never reaches A, so a larger k_max never binds
  int kmax = static_cast<int>(g.k_max < g.A ? g.k_max : g.A);
  int fam = g.fam;
  double lam = g.lam;
  // scalars only: a pointer through asm loses its address space (generic
  // loads and stores in place of LDS / STS)
  asm volatile("" : "+r"(A), "+r"(E), "+r"(P1), "+r"(kmax), "+r"(fam), "+d"(lam));
  const double* gaps = sm.gaps;
  double* abuf = sm.abuf;
  constexpr int kWin = 2 * kGapChunk - 1;
  int s = 0, tail = 0, cur = 0, served = 0, exhausted = -1;
  long long clipped = 0;
  double t = 0.0, qint = 0.0, energy = 0.0;
  int n_rec = 0, seen = 0, uready = 0;
  int room = kCap;  // positions below it are free in the arrival buffer
  int lim = 0;      // the cursor that needs the slow path: a chunk's end, or A

  // the records and the tail (every position below it is final or covered
  // by a pushed record) to the responder, as one word: a count read with
  // a newer tail would let it flush offsets of runs it has not finalised
  auto publish = [&]() {
    __threadfence_block();  // the records and buffer entries before the word
    *sm.produced = (static_cast<long long>(n_rec) << 32) | static_cast<unsigned>(tail);
  };
  // the cursor reached lim: false when the stream is spent, else wait for
  // the next chunk (publishing the cursor, which frees the stager to
  // overwrite the chunk before the one just left)
  auto refill = [&]() -> bool {
    if (cur >= A) return false;
    publish();  // the responder must not wait on a walker that waits
    __threadfence_block();
    *sm.cur_lo = cur;
    long long ready;
    do { ready = *sm.gstaged; } while (ready <= cur);
    __threadfence_block();
    const int end = (cur / kGapChunk + 1) * kGapChunk;
    lim = end < A ? end : A;
    return true;
  };
  // room in the arrival buffer up to position q (the responder frees it)
  auto wait_room = [&](int q) {
    publish();
    do { room = static_cast<int>(*sm.freed) + kCap; } while (q >= room);
    __threadfence_block();
  };
  auto push = [&](int a, int tail_r, int n, bool clip, double tau, double T, int ep) {
    const int k = n_rec % kRing;
    sm.rec_t[k] = t;
    sm.rec_T[k] = T;
    sm.rec_tau[k] = tau;
    sm.rec_a[k] = a;
    sm.rec_tail[k] = tail_r;
    sm.rec_n[k] = n | (clip ? 1 << 30 : 0);
    sm.rec_ep[k] = ep;
    ++n_rec;
    if (n_rec % kPublish == 0) {
      publish();
      while (n_rec + kPublish - seen > kRing) seen = static_cast<int>(*sm.consumed);
    }
  };

  double gnext = 0.0;  // gaps[cur] once cur < lim
  for (int ep = 0; ep < E; ++ep) {
    int a = sm.pol[s < P1 ? s : P1];
    if (a > s) a = 0;
    if (a == 0) {
      if (cur == lim) {
        if (!refill()) { exhausted = ep; break; }
        gnext = gaps[cur & kWin];
      }
      const double dt = gnext;
      ++cur;
      gnext = gaps[cur & kWin];  // ahead: read again after a refill
      const double t_next = t + dt;
      if (tail >= room) wait_room(tail);
      abuf[tail & (kCap - 1)] = t_next;
      ++tail;
      qint = qint + static_cast<double>(s) * dt;
      s += 1;
      t = t_next;
      continue;
    }
    const double m = sm.means[a];
    double T = m;
    if (fam != 0) {
      if (ep >= uready) {  // publish the epoch, wait for its chunk of factors
        __threadfence_block();
        *sm.ep_lo = ep;
        long long ready;
        do { ready = *sm.ustaged; } while (ready <= ep);
        uready = static_cast<int>(ready);
        __threadfence_block();
      }
      const int w = ep & (2 * kEpChunk - 1);
      const double u1 = sm.units[2 * w];
      switch (fam) {
        case 2: T = sm.mk[a] * u1; break;
        case 3: T = (m * u1) * sm.units[2 * w + 1]; break;
        default: T = m * u1; break;
      }
    }
    const double t_next = t + T;
    if (tail + kmax > room) wait_room(tail + kmax - 1);
    const int first = cur;
    double c = 0.0, contrib = 0.0, tau = 0.0;
    int n = 0;
    bool out = false, clip = false;
    for (;;) {
      if (cur == lim) {
        if (!refill()) { out = true; break; }
        gnext = gaps[cur & kWin];
      }
      c = c + gnext;
      ++cur;
      gnext = gaps[cur & kWin];
      if (!(c < T)) break;
      if (n == kmax) {  // clipped at tau = c: the kept k_max move to
        ++clipped;      // (c_j / tau) * T, the c_j summed again in order
        clip = true;
        tau = c;
        double cj = 0.0;
        contrib = 0.0;
        for (int j = 0; j < n; ++j) {
          cj = cj + __ddiv_rn(ar[first + j], lam);
          const double off = (cj / tau) * T;
          contrib = contrib + (T - off);
        }
        break;
      }
      abuf[(tail + n) & (kCap - 1)] = c;
      contrib = contrib + (T - c);
      ++n;
    }
    // the responses are read before this epoch's arrivals land, as in the
    // plain walk; a lane out of draws still answers its last serve
    push(a, tail, n, clip, tau, T, out ? -1 : ep);
    served += a;
    if (out) { exhausted = ep; break; }
    tail += n;
    qint = qint + (static_cast<double>(s) * T + contrib);
    energy = energy + sm.en[a];
    s = s - a + n;
    t = t_next;
  }
  publish();
  __threadfence_block();
  *sm.finished = 1;
  g.fout[lane * 3 + 0] = t;
  g.fout[lane * 3 + 1] = qint;
  g.fout[lane * 3 + 2] = energy;
  g.iout[lane * 4 + 0] = served;
  g.iout[lane * 4 + 1] = clipped;
  g.iout[lane * 4 + 2] = cur;
  g.iout[lane * 4 + 3] = exhausted;
}

// Warp 1: the gaps and the epochs' service factors, a chunk ahead.
__device__ void stage(const Args& g, const Shared& sm, long long lane) {
  const int me = threadIdx.x & 31;
  const double* ar = g.arr + lane * g.A;
  const double* sd0 = g.svc + lane * g.E * g.W;
  const long long A = g.A, E = g.E, W = g.W;
  const double lam = g.lam;
  const long long n_gc = (A + kGapChunk - 1) / kGapChunk;
  const long long n_uc = g.fam != 0 ? (E + kEpChunk - 1) / kEpChunk : 0;
  long long gc = 0, uc = 0;
  while (gc < n_gc || uc < n_uc) {
    long long clo = 0, elo = 0;
    int fin = 0;
    if (me == 0) {
      fin = *sm.finished;
      clo = *sm.cur_lo;
      elo = *sm.ep_lo;
    }
    fin = __shfl_sync(kFull, fin, 0);
    clo = __shfl_sync(kFull, clo, 0);
    elo = __shfl_sync(kFull, elo, 0);
    bool did = false;
    if (gc < n_gc && (gc < 2 || clo >= (gc - 1) * kGapChunk)) {
      __threadfence_block();  // the walker's reads of chunk gc - 2 came first
      const long long base = gc * kGapChunk;
      const int cnt = static_cast<int>(A - base < kGapChunk ? A - base : kGapChunk);
      const int b = static_cast<int>((gc & 1) * kGapChunk);
      for (int i = me; i < cnt; i += 32) sm.gaps[b + i] = __ddiv_rn(ar[base + i], lam);
      __syncwarp();
      if (me == 0) {
        __threadfence_block();
        *sm.gstaged = base + cnt;
      }
      ++gc;
      did = true;
    }
    if (uc < n_uc && (uc < 2 || elo >= (uc - 1) * kEpChunk)) {
      __threadfence_block();
      const long long base = uc * kEpChunk;
      const int cnt = static_cast<int>(E - base < kEpChunk ? E - base : kEpChunk);
      const int b = static_cast<int>((uc & 1) * kEpChunk);
      for (int i = me; i < cnt; i += 32) {
        const double* sd = sd0 + (base + i) * W;
        double u1 = 0.0, u2 = 0.0;
        switch (g.fam) {
          case 1: u1 = sd[0]; break;
          case 2: {
            double gam = sd[0];
            for (long long j = 1; j < g.erlang_k; ++j) gam = gam + sd[j];
            u1 = gam;
            break;
          }
          case 3:
            u1 = sm.scales[component(sd[0], sm.cum, g.C)];
            u2 = sd[1];
            break;
          default: u1 = sm.scales[component(sd[0], sm.cum, g.C)]; break;
        }
        sm.units[2 * (b + i)] = u1;
        sm.units[2 * (b + i) + 1] = u2;
      }
      __syncwarp();
      if (me == 0) {
        __threadfence_block();
        *sm.ustaged = base + cnt;
      }
      ++uc;
      did = true;
    }
    if (!did) {
      if (fin) break;
      __nanosleep(200);
    }
  }
}

// Warp 2: the ring and the responses, record by record in the walker's
// order.  Per serve record: the wait epochs' arrival times before it go to
// the global ring; each response reads the latest arrival written to its
// ring entry before this serve's run (from the arrival buffer while the
// walker has not reused that slot, else from the global ring) and writes
// resp[r] = t + T - arrival; then the run's offsets become arrival times
// (t + c, or t + (c / tau) * T after a clip: the plain walk's operations)
// in the buffer and the ring.  Positions below `freed` are in the ring; the
// walker writes the buffer only below freed + kCap.
__device__ void respond(const Args& g, const Shared& sm, long long lane) {
  const int me = threadIdx.x & 31;
  double* ring = g.ring + lane * kBuf;
  double* resp = g.resp + lane * g.R;
  int* acts = g.acts + lane * g.E;
  double* abuf = sm.abuf;
  int got = 0, done = 0, freed = 0, served = 0;
  // positions [from, to) of the buffer into the ring
  auto flush = [&](int from, int to) {
    for (int q = from + me; q < to; q += 32) ring[q & kMask] = abuf[q & (kCap - 1)];
  };
  for (;;) {
    int fin = *sm.finished;
    __threadfence_block();
    const long long word = __shfl_sync(kFull, *sm.produced, 0);
    fin = __shfl_sync(kFull, fin, 0);
    const int upto = static_cast<int>(word >> 32);
    const int wt = static_cast<int>(word & 0xffffffffLL);
    __threadfence_block();  // the records and buffer entries up to `upto`
    if (got == upto && done >= wt) {
      if (fin) break;
      __nanosleep(100);
      continue;
    }
    for (; got < upto; ++got) {
      const int k = got % kRing;
      const double t = sm.rec_t[k], T = sm.rec_T[k], tau = sm.rec_tau[k];
      const int a = sm.rec_a[k], tail = sm.rec_tail[k], nf = sm.rec_n[k], ep = sm.rec_ep[k];
      const int n = nf & ((1 << 30) - 1);
      const bool clip = (nf >> 30) != 0;
      const double t_next = t + T;
      flush(done, tail);
      __syncwarp();
      for (int j = me; j < a; j += 32) {
        const int q = served + j;  // the ring position a response reads
        const int p = q + static_cast<int>(kBuf) * ((tail - 1 - q) >> 15);  // its latest write
        const double v = p >= freed ? abuf[p & (kCap - 1)] : ring[p & kMask];
        resp[q] = t_next - v;
      }
      if (me == 0 && ep >= 0) acts[ep] = a;
      for (int j = me; j < n; j += 32) {
        const int q = tail + j;
        const double c = abuf[q & (kCap - 1)];
        const double v = clip ? t + (c / tau) * T : t + c;
        abuf[q & (kCap - 1)] = v;
        ring[q & kMask] = v;
      }
      __syncwarp();
      served += a;
      done = tail + n;
    }
    if (wt > done) {  // the wait epochs after the last record
      flush(done, wt);
      done = wt;
    }
    __syncwarp();
    if (me == 0) {
      __threadfence_block();
      *sm.consumed = got;
      *sm.freed = done;
    }
    freed = done;
  }
}

__global__ void __launch_bounds__(kThreads, 1) sim_scan_kernel(const Args g, long long n_means) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lane = blockIdx.x;
  const Layout o = layout(g.P, n_means, g.C);
  const Shared sm = bind(smem, o);
  for (long long i = threadIdx.x; i < g.P; i += kThreads) sm.pol[i] = static_cast<int>(g.pol[i]);
  for (long long i = threadIdx.x; i < n_means; i += kThreads) {
    sm.means[i] = g.means[i];
    sm.en[i] = g.en[i];
    sm.mk[i] = g.means[i] / static_cast<double>(g.erlang_k);
  }
  for (long long i = threadIdx.x; i < g.C; i += kThreads) {
    sm.cum[i] = g.cum[i];
    sm.scales[i] = g.scales[i];
  }
  if (threadIdx.x == 0) {
    *sm.produced = 0;
    *sm.consumed = 0;
    *sm.gstaged = 0;
    *sm.ustaged = 0;
    *sm.cur_lo = 0;
    *sm.ep_lo = 0;
    *sm.freed = 0;
    *sm.finished = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == 1) {
    stage(g, sm, lane);
  } else if (warp == 2) {
    respond(g, sm, lane);
  } else if (threadIdx.x == 0) {
    walk(g, sm, lane);
  }
}

}  // namespace

// Dynamic shared memory a block needs (kernels/sim_scan.py mirrors it).
extern "C" long long sim_scan_smem_bytes(long long P, long long n_means, long long C) {
  return layout(P, n_means, C).total;
}

// Launches one block of three warps per lane (lane 0 of warp 0 walks, warp
// 1 stages, warp 2 writes the responses).  Returns a CUDA error code.
extern "C" int sim_scan_launch(const long long* pol, long long P, const double* means,
                               long long n_means, const double* en, int fam,
                               long long erlang_k, const double* cum, const double* scales,
                               long long C, const double* svc, long long W, const double* arr,
                               long long A, double lam, long long k_max, long long E,
                               long long L, long long R, double* ring, int* acts,
                               double* resp, double* fout, long long* iout, void* stream) {
  if (L <= 0) return 0;
  Args g{pol, P, means, en, fam, erlang_k, cum, scales, C, svc, W, arr, A, lam,
         k_max, E, L, R, ring, acts, resp, fout, iout};
  const long long bytes = layout(P, n_means, C).total;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sim_scan_kernel<<<static_cast<unsigned>(L), kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(g, n_means);
  return static_cast<int>(cudaGetLastError());
}
