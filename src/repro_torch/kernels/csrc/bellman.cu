// Banded RVI Bellman backup for Hopper (sm_90a), IEEE f32 on CUDA cores.
//
//   G[n, t, a] = sum_k pmfs[n, a, k] * h[n, t + k] + tails[n, t, a] * hso[n]
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bellman.py:
// bellman_banded (_kernel) and bellman_banded_batched (_kernel_batched).
// One __global__ serves both: the spec index is blockIdx.z, and the scalar
// wrapper launches it with n_specs = 1.
//
// Design.  The TPU kernel builds each (TB, KB) Hankel window of h out of
// 128 stacked dynamic slices and feeds the MXU.  Here a block owns a tile
// of TB base states x AB actions of one spec; for each KB-wide k-chunk it
// stages the contiguous slice h[t0 + c : t0 + c + TB + KB] and the (AB, KB)
// pmf chunk in shared memory, and every thread reads shifted views of the
// staged slice: lane l of a warp handles base states t0 + l + 32 r
// (r < RT), so the h reads of a warp are consecutive words (no bank
// conflicts), and each warp owns RA actions whose pmf words are shared-
// memory broadcasts.  A thread keeps RT x RA independent f32 accumulators
// in registers.  Ragged T / A / K edges are masked here, so the wrapper
// passes the arrays unpadded (h keeps its zero tail past s_max).
//
// Numerics: f32 products with f32 accumulation in k order, no TF32 and no
// tensor cores -- the solver's policy-equality checks rely on it.
//
// Bound on an H100 SXM: 2*T*A*K flops over (T+K + A*K + 2*T*A) * 4 bytes.
// At the solver's path shape T = K = 129, A = 33 that is 1.1 MFLOP over
// ~52 KB, so a launch is bound by launch latency, not by the card.  At
// T = K = 4097, A = 33 it is 1.1 GFLOP over ~1.7 MB: compute-bound, about
// 17 us at the 67 TFLOP/s f32 CUDA-core peak.  This first version aims at
// being right; wgmma with a 3xTF32 split, persistent blocks and a CUDA
// graph around the RVI loop are the ways to make it fast.
#include <cuda_runtime.h>

namespace {

constexpr int RT = 2;           // base states per thread (strided by 32)
constexpr int RA = 8;           // actions per thread
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TB = 32 * RT;     // base states per block
constexpr int AB = RA * WARPS;  // actions per block
constexpr int KB = 128;         // k-chunk staged in shared memory

__global__ void __launch_bounds__(THREADS)
bellman_banded_kernel(const float* __restrict__ h,
                      const float* __restrict__ pmfs,
                      const float* __restrict__ tails,
                      const float* __restrict__ hso,
                      float* __restrict__ out,
                      int T, int A, int K, int h_len) {
  __shared__ float hs[TB + KB];
  __shared__ float ps[AB][KB];

  const int n = blockIdx.z;
  const int t0 = blockIdx.x * TB;
  const int a_blk = blockIdx.y * AB;
  const int lane = threadIdx.x & 31;
  const int a_w = (threadIdx.x >> 5) * RA;  // this warp's first action
  const float* hn = h + static_cast<size_t>(n) * h_len;
  const float* pn = pmfs + static_cast<size_t>(n) * A * K;

  float acc[RT][RA];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < RA; ++j) acc[r][j] = 0.0f;

  for (int c0 = 0; c0 < K; c0 += KB) {
    for (int u = threadIdx.x; u < TB + KB; u += THREADS) {
      const int idx = t0 + c0 + u;
      hs[u] = idx < h_len ? hn[idx] : 0.0f;
    }
    for (int e = threadIdx.x; e < AB * KB; e += THREADS) {
      const int aa = e / KB;
      const int kk = e - aa * KB;
      const int a = a_blk + aa;
      const int k = c0 + kk;
      ps[aa][kk] = (a < A && k < K) ? pn[static_cast<size_t>(a) * K + k] : 0.0f;
    }
    __syncthreads();
    const int kmax = min(KB, K - c0);
    if (a_blk + a_w < A) {  // warp-uniform: skip warps past the last action
      for (int kk = 0; kk < kmax; ++kk) {
        float hv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) hv[r] = hs[lane + 32 * r + kk];
#pragma unroll
        for (int j = 0; j < RA; ++j) {
          const float p = ps[a_w + j][kk];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r][j] = fmaf(p, hv[r], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  const float so = hso[n];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int t = t0 + lane + 32 * r;
    if (t >= T) continue;
    const size_t row = (static_cast<size_t>(n) * T + t) * A;
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int a = a_blk + a_w + j;
      if (a < A) {
        out[row + a] = __fadd_rn(acc[r][j], __fmul_rn(tails[row + a], so));
      }
    }
  }
}

}  // namespace

// h: (n_specs, h_len), pmfs: (n_specs, A, K), tails: (n_specs, T, A),
// hso: (n_specs,), out: (n_specs, T, A); all f32, contiguous, on one card.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bellman_banded_launch(const float* h, const float* pmfs,
                                     const float* tails, const float* hso,
                                     float* out, int n_specs, int T, int A,
                                     int K, int h_len, void* stream) {
  if (n_specs <= 0 || T <= 0 || A <= 0) return 0;
  const dim3 grid((T + TB - 1) / TB, (A + AB - 1) / AB, n_specs);
  bellman_banded_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      h, pmfs, tails, hso, out, T, A, K, h_len);
  return static_cast<int>(cudaGetLastError());
}
