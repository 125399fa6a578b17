// Event kernel of the compiled serving backend (one thread per lane).
//
// Counterpart of the plain lane of _scan_core in src/repro/serving/
// compiled.py, which is a jax.lax.scan and not a Pallas kernel.  PyTorch
// has no scan, so the whole event loop of one simulation lane runs in one
// thread: admit every arrival due by the clock, read the action
// table[phase of the last admitted arrival, min(q, L - 1)], apply the
// clip / wait / terminate / capped-drain rules, draw the service time
// means[a] * draws[min(n_batches, n_draws - 1)], advance the clock.  Each
// decision epoch writes one record (a, t_done); the per-request latencies,
// SLO misses, histogram and energy are rebuilt from the records with
// batch tensor ops afterwards, as the reference does after its scan.
//
// Numerics: t + means[a] * draw is rounded product-first with __dmul_rn /
// __dadd_rn (and the file is built with -fmad=false), exactly as numpy
// and the reference scan round it; a fused multiply-add would move an
// admission `arrival <= t` by one ulp and break decision-for-decision
// equality.
//
// Bound: the work is a dependent chain -- each event needs the clock of
// the previous one -- so one lane runs at the latency of one thread's
// loads and branches, far from the card's memory or compute roofs (a few
// bytes per event).  Throughput comes from many lanes (seeds x policies),
// which the grid runner of a later slice launches.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void serve_scan_kernel(
    const long long* __restrict__ table, int L,
    const double* __restrict__ arrivals,
    const long long* __restrict__ phases, long long size,
    const double* __restrict__ draws, long long n_draws,
    const double* __restrict__ means, double t0, double horizon,
    long long max_eps, int drain, long long b_max, int n_lanes,
    int* __restrict__ rec_a, double* __restrict__ rec_t, long long rec_cap,
    long long* __restrict__ agg_i, double* __restrict__ agg_t) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  arrivals += lane * size;
  phases += lane * size;
  draws += lane * n_draws;
  rec_a += lane * rec_cap;
  rec_t += lane * rec_cap;

  double t = t0;
  long long n_srv = 0, n_adm = 0, n_bat = 0, n_eps = 0;
  bool done = false;
  // arrivals at or past the horizon are never admitted
  auto due_time = [&](long long i) -> double {
    if (i >= size) return INFINITY;
    const double x = arrivals[i];
    return x < horizon ? x : INFINITY;
  };
  while (!done && n_eps < max_eps) {
    while (due_time(n_adm) <= t) ++n_adm;  // admit every arrival due by t
    const long long q = n_adm - n_srv;
    const long long last = n_adm > 0 ? n_adm - 1 : 0;
    long long a = table[phases[last] * L + (q < L - 1 ? q : L - 1)];
    const long long cap = q < b_max ? q : b_max;
    a = a < 0 ? 0 : (a > cap ? cap : a);
    const double nxt = due_time(n_adm);
    const bool live = isfinite(nxt);
    const bool wait = a == 0 && live;
    const bool term = a == 0 && !live && (q == 0 || !drain);
    if (a == 0 && !live && !term) a = cap;  // b_max-capped tail drain
    const bool serve = !wait && !term;
    if (!serve) a = 0;
    const double draw = draws[n_bat < n_draws - 1 ? n_bat : n_draws - 1];
    const double t_done = __dadd_rn(t, __dmul_rn(means[a], draw));
    rec_a[n_eps] = static_cast<int>(a);
    rec_t[n_eps] = t_done;
    ++n_eps;
    if (wait) {
      t = nxt;
    } else if (serve) {
      t = t_done;
      n_srv += a;
      ++n_bat;
    }
    done = term;
  }
  long long* out = agg_i + 5 * lane;
  out[0] = n_srv;
  out[1] = n_adm;
  out[2] = n_bat;
  out[3] = n_eps;
  out[4] = done ? 1 : 0;
  agg_t[lane] = t;
}

}  // namespace

// table: (K, L) int64 phase-indexed action table, shared by all lanes;
// arrivals (f64, sorted, +inf padded) and phases (int64): (n_lanes, size);
// draws: (n_lanes, n_draws) f64 unit service draws; means: (b_max + 1,)
// f64.  Outputs: rec_a (int32) / rec_t (f64): (n_lanes, rec_cap) with
// rec_cap >= max_eps, one record per decision epoch; agg_i: (n_lanes, 5)
// int64 = (n_served, n_admitted, n_batches, n_epochs, terminated);
// agg_t: (n_lanes,) f64 final clock.  Returns cudaGetLastError().
extern "C" int serve_scan_launch(
    const long long* table, int L, const double* arrivals,
    const long long* phases, long long size, const double* draws,
    long long n_draws, const double* means, double t0, double horizon,
    long long max_eps, int drain, long long b_max, int n_lanes, int* rec_a,
    double* rec_t, long long rec_cap, long long* agg_i, double* agg_t,
    void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = n_lanes < 128 ? n_lanes : 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  serve_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, L, arrivals, phases, size, draws, n_draws, means, t0, horizon,
      max_eps, drain, b_max, n_lanes, rec_a, rec_t, rec_cap, agg_i, agg_t);
  return static_cast<int>(cudaGetLastError());
}
