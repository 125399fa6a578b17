// The independent queue simulator: one thread a lane walks the decision
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
// lane in global memory (256 KB: over a block's shared memory; it stays in
// L2), read before this epoch's arrivals are written, as the reference
// reads its carried buffer.  Service times take their unit draws from a
// per-epoch (E, W) array: det none, expo one exponential, erlang k (their
// sum), hyperexpo a uniform (the component) and an exponential, atoms a
// uniform.  A lane whose arrival stream runs out stops and reports the
// epoch (the wrapper raises; nothing wraps).
//
// Numerics: built with -fmad=false, so every product and sum rounds on its
// own, in the order of the plain walk (kernels/sim_scan.py), which the
// kernel equals in every output.
//
// Bound: bytes (the draws read, the actions and responses written) over
// the memory rate; the real bound is the serial chain, a dependent walk of
// roughly (1 + arrivals) steps an epoch.
#include <cuda_runtime.h>

namespace {

constexpr long long kBuf = 1LL << 15;
constexpr long long kMask = kBuf - 1;

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

__device__ __forceinline__ long long component(double u, const double* cum, long long C) {
  long long j = 0;
  while (j < C - 1 && !(u < cum[j])) ++j;
  return j;
}

__global__ void sim_scan_kernel(Args g) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= g.L) return;
  const double* __restrict__ sd0 = g.svc + lane * g.E * g.W;
  const double* __restrict__ ar = g.arr + lane * g.A;
  double* __restrict__ ring = g.ring + lane * kBuf;
  int* __restrict__ acts = g.acts + lane * g.E;
  double* __restrict__ resp = g.resp + lane * g.R;
  long long s = 0, head = 0, tail = 0, cur = 0, served = 0, clipped = 0;
  long long exhausted = -1;
  double t = 0.0, qint = 0.0, energy = 0.0;
  for (long long ep = 0; ep < g.E; ++ep) {
    long long a = g.pol[s < g.P - 1 ? s : g.P - 1];
    if (a > s) a = 0;
    if (a == 0) {
      if (cur >= g.A) { exhausted = ep; break; }
      const double dt = ar[cur++] / g.lam;
      const double t_next = t + dt;
      ring[tail] = t_next;
      tail = (tail + 1) & kMask;
      qint = qint + static_cast<double>(s) * dt;
      s += 1;
      t = t_next;
      acts[ep] = 0;
      continue;
    }
    const double* sd = sd0 + ep * g.W;
    const double m = g.means[a];
    double T;
    switch (g.fam) {
      case 0: T = m; break;
      case 1: T = m * sd[0]; break;
      case 2: {
        double gam = sd[0];
        for (long long j = 1; j < g.erlang_k; ++j) gam = gam + sd[j];
        T = (m / static_cast<double>(g.erlang_k)) * gam;
        break;
      }
      case 3: T = (m * g.scales[component(sd[0], g.cum, g.C)]) * sd[1]; break;
      default: T = m * g.scales[component(sd[0], g.cum, g.C)]; break;
    }
    const double t_next = t + T;
    for (long long j = 0; j < a; ++j) resp[served + j] = t_next - ring[(head + j) & kMask];
    served += a;
    head = (head + a) & kMask;
    const long long first = cur;
    double c = 0.0, contrib = 0.0;
    long long n = 0;
    bool out = false;
    for (;;) {
      if (cur >= g.A) { out = true; break; }
      c = c + ar[cur++] / g.lam;
      if (!(c < T)) break;
      if (n == g.k_max) {  // clipped at tau = c: redo the kept k_max at
        ++clipped;         // (c_j / tau) * T, the c_j summed again in order
        const double tau = c;
        double cj = 0.0;
        contrib = 0.0;
        for (long long j = 0; j < n; ++j) {
          cj = cj + ar[first + j] / g.lam;
          const double off = (cj / tau) * T;
          ring[(tail + j) & kMask] = t + off;
          contrib = contrib + (T - off);
        }
        break;
      }
      ring[(tail + n) & kMask] = t + c;
      contrib = contrib + (T - c);
      ++n;
    }
    if (out) { exhausted = ep; break; }
    tail = (tail + n) & kMask;
    qint = qint + (static_cast<double>(s) * T + contrib);
    energy = energy + g.en[a];
    s = s - a + n;
    t = t_next;
    acts[ep] = static_cast<int>(a);
  }
  g.fout[lane * 3 + 0] = t;
  g.fout[lane * 3 + 1] = qint;
  g.fout[lane * 3 + 2] = energy;
  g.iout[lane * 4 + 0] = served;
  g.iout[lane * 4 + 1] = clipped;
  g.iout[lane * 4 + 2] = cur;
  g.iout[lane * 4 + 3] = exhausted;
}

}  // namespace

extern "C" int sim_scan_launch(const long long* pol, long long P, const double* means,
                               const double* en, int fam, long long erlang_k,
                               const double* cum, const double* scales, long long C,
                               const double* svc, long long W, const double* arr,
                               long long A, double lam, long long k_max, long long E,
                               long long L, long long R, double* ring, int* acts,
                               double* resp, double* fout, long long* iout,
                               void* stream) {
  if (L <= 0) return 0;
  Args g{pol, P, means, en, fam, erlang_k, cum, scales, C, svc, W, arr, A, lam,
         k_max, E, L, R, ring, acts, resp, fout, iout};
  const int threads = 32;
  const long long blocks = (L + threads - 1) / threads;
  sim_scan_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
