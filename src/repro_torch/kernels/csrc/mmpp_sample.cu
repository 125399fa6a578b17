// MMPP(2) arrival sampler: the competing-clocks walk, one block a lane.
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
// Bound: bytes L * ((1 + 2n) * 8 + n * 13) over the memory rate; the real
// bound is each lane's serial chain of n dependent steps.  Both quotients
// E_g / lam0 and E_g / lam1, and both dwell steps E_d * dw0 and E_d * dw1,
// depend on the draws only, so the design keeps only the chain on the
// walking thread (chain_floor.cu measures it alone):
//
//   * One block of three warps a lane.
//   * Warp 1 (the stager) copies the lane's draws a chunk of kR steps ahead
//     into a shared ring by cp.async, then writes each step's four
//     candidates (the two IEEE quotients, the two products) into a
//     double-buffered shared window.  It overwrites a window only once the
//     walker has published that it left it.
//   * Lane 0 of warp 0 (the walker) reads shared memory only: a select by
//     phase, the add, the compare, the selects of t and nsw and the phase
//     flip a step (the switch's dwell step is the one of the phase it
//     leaves for, computed before the compare), the next step's candidates
//     read one step ahead.  It writes t and (phase | emitted << 8) into a
//     double-buffered shared window and publishes each chunk.
//   * Warp 2 (the writer) stores each published chunk's times, emitted and
//     phases to device memory, coalesced, and publishes it consumed.
//
// Numerics: built with -fmad=false, so t + gap and nsw + e * dwell round
// as the plain walk (kernels/mmpp_sample.py) rounds them; every quotient
// and product is the walk's own IEEE operation, done ahead; the kernel
// equals its plain walk bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 512;         // steps a chunk; two buffers of each window
constexpr int kThreads = 96;    // walker warp, stager warp, writer warp

// Shared memory: control words, then the windows (every one 16-byte aligned).
constexpr int kCtl = 64;                    // staged, cur_lo, produced (long long)
constexpr int kRaw = kCtl;                  // double [2][2 * kR]: the draws
constexpr int kStg = kRaw + 8 * 2 * 2 * kR;  // double [2][kR][4]: g0 g1 d0 d1
constexpr int kOutT = kStg + 8 * 2 * 4 * kR;  // double [2][kR]: t
constexpr int kOutP = kOutT + 8 * 2 * kR;     // int [2][kR]: phase | emitted << 8
constexpr int kSmem = kOutP + 4 * 2 * kR;

struct Args {
  const double* draws;
  long long L, n;
  double lam0, lam1, dw0, dw1;
  double* times;
  unsigned char* emitted;
  int* phases;
};

struct Ctl {
  volatile long long *staged, *cur_lo, *produced, *consumed;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ long long chunk_len(long long n, long long ch) {
  const long long rest = n - ch * kR;
  return rest < kR ? rest : kR;
}

// Lane 0 of warp 0.
__device__ void walk(const Args& g, const Ctl& ctl, unsigned char* smem, long long lane) {
  const double2* stg = reinterpret_cast<const double2*>(smem + kStg);
  double* out_t = reinterpret_cast<double*>(smem + kOutT);
  int* out_p = reinterpret_cast<int*>(smem + kOutP);
  const long long n = g.n, n_ch = (n + kR - 1) / kR;
  double t = 0.0;
  double nsw = g.draws[lane * (1 + 2 * n)] * g.dw0;
  int phase = 0;
  for (long long ch = 0; ch < n_ch; ++ch) {
    const long long base = ch * kR;
    const int cnt = static_cast<int>(chunk_len(n, ch));
    const int b = static_cast<int>(ch & 1);
    __threadfence_block();
    *ctl.cur_lo = base;  // frees the stager to refill the window left last
    while (*ctl.staged < base + cnt) {
    }
    while (*ctl.consumed < base - kR) {  // the writer has stored chunk ch - 2
    }
    __threadfence_block();
    const double2* sg = stg + 2 * b * kR;
    double* ot = out_t + b * kR;
    int* op = out_p + b * kR;
    double2 gg = sg[0], dd = sg[1];
    for (int j = 0; j < cnt; ++j) {
      // one step ahead (past the chunk's end it reads a neighbouring window,
      // never used)
      const double2 ngg = sg[2 * j + 2], ndd = sg[2 * j + 3];
      const double gap = phase ? gg.y : gg.x;
      const double dstep = phase ? dd.x : dd.y;  // the phase a switch goes to
      const double cand = t + gap;
      const double nn = nsw + dstep;
      const bool sw = cand >= nsw;
      t = sw ? nsw : cand;
      nsw = sw ? nn : nsw;
      phase ^= sw ? 1 : 0;
      ot[j] = t;
      op[j] = phase | (sw ? 0 : 256);
      gg = ngg;
      dd = ndd;
    }
    __threadfence_block();
    *ctl.produced = base + cnt;
  }
}

// Warp 1: the draws by cp.async a chunk ahead, then the four candidates.
__device__ void stage(const Args& g, const Ctl& ctl, unsigned char* smem, long long lane) {
  const int me = threadIdx.x & 31;
  double* raw = reinterpret_cast<double*>(smem + kRaw);
  double* stg = reinterpret_cast<double*>(smem + kStg);
  const long long n = g.n, n_ch = (n + kR - 1) / kR;
  const double* src = g.draws + lane * (1 + 2 * n) + 1;
  const double lam0 = g.lam0, lam1 = g.lam1, dw0 = g.dw0, dw1 = g.dw1;
  auto issue = [&](long long ch) {
    const int cnt = static_cast<int>(chunk_len(n, ch));
    double* dst = raw + (ch & 1) * 2 * kR;
    const double* s0 = src + 2 * ch * kR;
    for (int e = me; e < 2 * cnt; e += 32) cp_async8(dst + e, s0 + e);
    cp_commit();
  };
  issue(0);
  for (long long ch = 0; ch < n_ch; ++ch) {
    if (ch + 1 < n_ch) {
      issue(ch + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    const long long base = ch * kR;
    const int cnt = static_cast<int>(chunk_len(n, ch));
    // the walker left chunk ch - 2 once it published a cursor in chunk ch - 1
    long long lo = 0;
    if (me == 0) {
      do {
        lo = *ctl.cur_lo;
        if (lo < base - kR) __nanosleep(100);
      } while (lo < base - kR);
    }
    __syncwarp();
    __threadfence_block();
    const double* rw = raw + (ch & 1) * 2 * kR;
    double* st = stg + (ch & 1) * 4 * kR;
    for (int j = me; j < cnt; j += 32) {
      const double eg = rw[2 * j], ed = rw[2 * j + 1];
      st[4 * j + 0] = __ddiv_rn(eg, lam0);
      st[4 * j + 1] = __ddiv_rn(eg, lam1);
      st[4 * j + 2] = __dmul_rn(ed, dw0);
      st[4 * j + 3] = __dmul_rn(ed, dw1);
    }
    __syncwarp();
    if (me == 0) {
      __threadfence_block();
      *ctl.staged = base + cnt;
    }
  }
}

// Warp 2: each published chunk to device memory.
__device__ void store_rows(const Args& g, const Ctl& ctl, unsigned char* smem, long long lane) {
  const int me = threadIdx.x & 31;
  const double* out_t = reinterpret_cast<const double*>(smem + kOutT);
  const int* out_p = reinterpret_cast<const int*>(smem + kOutP);
  const long long n = g.n, n_ch = (n + kR - 1) / kR;
  double* tt = g.times + lane * n;
  unsigned char* em = g.emitted + lane * n;
  int* ph = g.phases + lane * n;
  for (long long ch = 0; ch < n_ch; ++ch) {
    const long long base = ch * kR;
    const int cnt = static_cast<int>(chunk_len(n, ch));
    if (me == 0) {
      while (*ctl.produced < base + cnt) __nanosleep(100);
    }
    __syncwarp();
    __threadfence_block();
    const double* ot = out_t + (ch & 1) * kR;
    const int* op = out_p + (ch & 1) * kR;
    for (int j = me; j < cnt; j += 32) {
      const int p = op[j];
      tt[base + j] = ot[j];
      em[base + j] = static_cast<unsigned char>(p >> 8);
      ph[base + j] = p & 1;
    }
    __syncwarp();
    if (me == 0) {
      __threadfence_block();
      *ctl.consumed = base + cnt;
    }
  }
}

__global__ void __launch_bounds__(kThreads) mmpp_sample_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lane = blockIdx.x;
  long long* c = reinterpret_cast<long long*>(smem);
  Ctl ctl{c, c + 1, c + 2, c + 3};
  if (threadIdx.x < 4) c[threadIdx.x] = threadIdx.x == 1 ? -kR : 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    if (threadIdx.x == 0) walk(g, ctl, smem, lane);
  } else if (warp == 1) {
    stage(g, ctl, smem, lane);
  } else {
    store_rows(g, ctl, smem, lane);
  }
}

}  // namespace

// Launches one block of three warps per lane on `stream`: draws (L, 1 + 2n),
// times (L, n), emitted (L, n), phases (L, n).  Returns a CUDA error code.
extern "C" int mmpp_sample_launch(const double* draws, long long L, long long n,
                                  double lam0, double lam1, double dw0, double dw1,
                                  double* times, unsigned char* emitted, int* phases,
                                  void* stream) {
  if (L <= 0 || n <= 0) return 0;
  // the shared-memory attribute belongs to the function on a device: set once
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(mmpp_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  Args g{draws, L, n, lam0, lam1, dw0, dw1, times, emitted, phases};
  mmpp_sample_kernel<<<static_cast<unsigned>(L), kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Steps a staged chunk (the ring's size; the card tests run lanes of kR +-1).
extern "C" long long mmpp_sample_chunk() { return kR; }
