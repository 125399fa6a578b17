// MMPP(2) arrival sampler: the competing-clocks walk, one thread a lane.
//
// Counterpart of the lax.scan in mmpp2_times_jax,
// src/repro/serving/arrivals.py:580-599 (a scan, not a Pallas kernel).  A
// lane is one key of the reference's vmap.  Per lane, from pre-drawn unit
// exponentials draws[lane] = (E_0, E_g[0], E_d[0], E_g[1], E_d[1], ...):
//
//   t = 0, phase = 0, nsw = E_0 * dwell[0]
//   step i:  gap = E_g[i] / lam[phase]
//            switch = t + gap >= nsw
//            switch: phase ^= 1, t = nsw, nsw = nsw + E_d[i] * dwell[phase]
//            else:   t = t + gap
//            out: times[i] = t, emitted[i] = !switch, phases[i] = phase
//
// The sort that pushes non-arrivals to +inf stays a torch.sort on the
// device, as the reference sorts outside its scan.
//
// Numerics: built with -fmad=false, so t + gap and nsw + e * dwell round
// as the plain walk (kernels/mmpp_sample.py) rounds them; with IEEE
// division the kernel equals its plain walk bit for bit.
//
// Bound: bytes L * ((1 + 2n) * 8 + n * 13) over the memory rate; the real
// bound is each lane's serial chain of n dependent steps (a divide, an
// add, a compare and a select).  Lanes run in parallel, one thread each.
#include <cuda_runtime.h>

namespace {

__global__ void mmpp_sample_kernel(const double* __restrict__ draws, long long L,
                                   long long n, double lam0, double lam1, double dw0,
                                   double dw1, double* __restrict__ times,
                                   unsigned char* __restrict__ emitted,
                                   int* __restrict__ phases) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const double* d = draws + lane * (1 + 2 * n);
  double* tt = times + lane * n;
  unsigned char* em = emitted + lane * n;
  int* ph = phases + lane * n;
  double t = 0.0;
  double nsw = d[0] * dw0;
  int phase = 0;
  for (long long i = 0; i < n; ++i) {
    const double gap = d[1 + 2 * i] / (phase ? lam1 : lam0);
    const double cand = t + gap;
    const bool sw = cand >= nsw;
    if (sw) {
      phase ^= 1;
      t = nsw;
      nsw = nsw + d[2 + 2 * i] * (phase ? dw1 : dw0);
    } else {
      t = cand;
    }
    tt[i] = t;
    em[i] = sw ? 0 : 1;
    ph[i] = phase;
  }
}

}  // namespace

extern "C" int mmpp_sample_launch(const double* draws, long long L, long long n,
                                  double lam0, double lam1, double dw0, double dw1,
                                  double* times, unsigned char* emitted, int* phases,
                                  void* stream) {
  if (L <= 0 || n <= 0) return 0;
  const int threads = 64;
  const long long blocks = (L + threads - 1) / threads;
  mmpp_sample_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      draws, L, n, lam0, lam1, dw0, dw1, times, emitted, phases);
  return static_cast<int>(cudaGetLastError());
}
