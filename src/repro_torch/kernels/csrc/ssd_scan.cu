// Chunked SSD (state-space duality) scan of a Mamba2 block for Hopper
// (sm_90a), IEEE f32 on the CUDA cores, f32 or bf16 inputs.
//
// Counterpart of the lax.scan over chunks in mamba2_block,
// src/repro/models/layers.py:496-523 (a scan, not a Pallas kernel).  Per
// sequence b and SSM head h, with the incoming state S0 (P x N, f32), the
// steps cut into chunks of L (the last one padded with dt = dA = 0, which
// leaves the state as it is), and per chunk cum = cumsum(dA):
//
//   y[i, p]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[j, p]
//            + exp(cum_i) sum_n C[i, n] S[p, n]
//   S[p, n] <- S[p, n] exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j x[j, p] B[j, n]
//
// y comes out in f32 before the d_skip term, (B, S, H, P) contiguous; the
// final state goes to state_out (B, H, P, N), which may be state_in itself:
// a block reads its (b, h) slice whole before it writes it.  The masked
// decay exp(cum_i - cum_j) is formed only for j <= i, so the positive
// exponent of an unmasked pair is never taken (no inf * 0).  Padded rows
// contribute exact zeros in the reference, so the kernel skips them.
//
// Bound on an H100 SXM: at the hybrid serving path's decode step (b = 8,
// one token, H = 64, P = N = 64) the kernel reads and writes 8.4 MB of f32
// state: 5 us of HBM time; the prefill (b = 8, 128 tokens, one chunk) does
// ~4 MFLOP per (b, h) -- 2.1 GFLOP, 0.03 ms at the 67 TFLOP/s f32 rate --
// and moves ~16 MB of state and inputs.  Both are far below the rest of a
// step (PERF.md), so this first design is plain: one block of 256 threads
// per (head, sequence) walks the chunks in order with the chunk's x, B, C,
// dt, cum, the L x L decay matrix and the state all in shared memory (183
// KB at L = 128, P = N = 64: one block an SM), five barriers a chunk.
// Rows of B, C and the state are padded to N + 1 floats so that a warp's
// reads of 32 rows at one n fall in 32 banks.  wgmma for the L x L and
// L x P products, TMA loads and C . B shared across heads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ xs, long long x_sb, long long x_ss,
                const T* __restrict__ bm, long long b_sb, long long b_ss,
                const T* __restrict__ cm, long long c_sb, long long c_ss,
                const float* __restrict__ dt, const float* __restrict__ da,
                const float* state_in, float* __restrict__ y, float* state_out,
                int S, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  const int NP = N + 1;  // padded row of B, C and the state
  float* xs_s = smem;               // L x P
  float* b_s = xs_s + L * P;        // L x NP
  float* c_s = b_s + L * NP;        // L x NP
  float* dt_s = c_s + L * NP;       // L
  float* cum_s = dt_s + L;          // L
  float* w_s = cum_s + L;           // L
  float* att = w_s + L;             // L x L (rows i, columns j <= i)
  float* st = att + L * L;          // P x NP

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long sh = (static_cast<long long>(b) * H + h) * P * N;

  for (int idx = tid; idx < P * N; idx += THREADS)
    st[(idx / N) * NP + idx % N] = state_in[sh + idx];

  const int n_ch = (S + L - 1) / L;
  for (int c = 0; c < n_ch; ++c) {
    const int s0 = c * L;
    const int Lc = min(L, S - s0);  // rows past Lc are the reference's padding
    __syncthreads();  // the previous chunk is done with every buffer
    for (int idx = tid; idx < Lc * P; idx += THREADS) {
      const int j = idx / P, p = idx % P;
      xs_s[idx] = to_f32(xs[b * x_sb + (s0 + j) * x_ss + static_cast<long long>(h) * P + p]);
    }
    for (int idx = tid; idx < Lc * N; idx += THREADS) {
      const int j = idx / N, n = idx % N;
      b_s[j * NP + n] = to_f32(bm[b * b_sb + (s0 + j) * b_ss + n]);
      c_s[j * NP + n] = to_f32(cm[b * c_sb + (s0 + j) * c_ss + n]);
    }
    for (int j = tid; j < Lc; j += THREADS) {
      const long long o = (static_cast<long long>(b) * S + s0 + j) * H + h;
      dt_s[j] = dt[o];
      cum_s[j] = da[o];
    }
    __syncthreads();

    // cum = inclusive prefix sum of dA: warp 0, ceil(Lc / 32) rows a lane
    if (tid < 32) {
      const int per = (Lc + 31) / 32;
      const int lo = min(tid * per, Lc), hi = min(lo + per, Lc);
      float run = 0.f;
      for (int j = lo; j < hi; ++j) {
        run += cum_s[j];
        cum_s[j] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int j = lo; j < hi; ++j) cum_s[j] += excl;
    }
    __syncthreads();

    const float tot = cum_s[Lc - 1];
    for (int j = tid; j < Lc; j += THREADS) w_s[j] = expf(tot - cum_s[j]) * dt_s[j];
    // att[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i only
    for (int idx = tid; idx < Lc * Lc; idx += THREADS) {
      const int i = idx / Lc, j = idx % Lc;
      if (j > i) continue;
      const float* ci = c_s + i * NP;
      const float* bj = b_s + j * NP;
      float dot = 0.f;
      for (int n = 0; n < N; ++n) dot = fmaf(ci[n], bj[n], dot);
      att[i * L + j] = dot * expf(cum_s[i] - cum_s[j]) * dt_s[j];
    }
    __syncthreads();

    // y[i, p]: the intra-chunk sum over j <= i plus the carried state's term
    for (int idx = tid; idx < Lc * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      const float* ai = att + i * L;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(ai[j], xs_s[j * P + p], intra);
      const float* ci = c_s + i * NP;
      const float* sp = st + p * NP;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], sp[n], inter);
      y[((static_cast<long long>(b) * S + s0 + i) * H + h) * P + p] =
          intra + inter * expf(cum_s[i]);
    }
    __syncthreads();

    // S <- S exp(cum_L) + sum_j w_j x[j, p] B[j, n]
    const float decay = expf(tot);
    for (int idx = tid; idx < P * N; idx += THREADS) {
      const int p = idx / N, n = idx % N;
      float acc = 0.f;
      for (int j = 0; j < Lc; ++j) acc = fmaf(w_s[j] * xs_s[j * P + p], b_s[j * NP + n], acc);
      float* sv = st + p * NP + n;
      *sv = fmaf(*sv, decay, acc);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += THREADS)
    state_out[sh + idx] = st[(idx / N) * NP + idx % N];
}

template <typename T>
int launch(const void* xs, long long x_sb, long long x_ss, const void* bm, long long b_sb,
           long long b_ss, const void* cm, long long c_sb, long long c_ss, const float* dt,
           const float* da, const float* state_in, float* y, float* state_out, int B,
           int S, int H, int P, int N, int L, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_scan_kernel<T><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(xs), x_sb, x_ss, static_cast<const T*>(bm), b_sb, b_ss,
      static_cast<const T*>(cm), c_sb, c_ss, dt, da, state_in, y, state_out, S, H, P, N,
      L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one block, in bytes (the wrapper checks it against the
// card's 227 KB before it launches).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int L) {
  const long long NP = N + 1;
  return 4LL * (static_cast<long long>(L) * P + 2LL * L * NP + 3LL * L +
                static_cast<long long>(L) * L + static_cast<long long>(P) * NP);
}

extern "C" int ssd_scan_launch(const void* xs, long long x_sb, long long x_ss,
                               const void* bm, long long b_sb, long long b_ss,
                               const void* cm, long long c_sb, long long c_ss,
                               const float* dt, const float* da, const float* state_in,
                               float* y, float* state_out, int B, int S, int H, int P,
                               int N, int L, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || S <= 0 || B > 65535) return -1;
  const long long smem = ssd_scan_smem_bytes(P, N, L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xs, x_sb, x_ss, bm, b_sb, b_ss, cm, c_sb, c_ss, dt, da, state_in,
                         y, state_out, B, S, H, P, N, L, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xs, x_sb, x_ss, bm, b_sb, b_ss, cm, c_sb, c_ss, dt, da,
                                 state_in, y, state_out, B, S, H, P, N, L, smem, s);
  return -1;
}
