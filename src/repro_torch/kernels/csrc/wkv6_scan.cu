// WKV6 recurrence of an RWKV6 (Finch) time-mix block for Hopper (sm_90a),
// IEEE f32 on the CUDA cores, f32 or bf16 r / k / v.
//
// Counterpart of the lax.scan of rwkv6_time_mix's `step`,
// src/repro/models/layers.py:599-627 (a scan, not a Pallas kernel; no TPU
// kernel is replaced, and PyTorch has no scan).  Per sequence b and head h,
// with a P x P f32 state S (the incoming state, or zeros) and per step t:
//
//   kv[i, j] = k_t[i] v_t[j]
//   y_t[j]   = sum_i r_t[i] (S[i, j] + u[h, i] kv[i, j])
//   S[i, j] <- w_t[i] S[i, j] + kv[i, j]
//
// r, k, v (B, S, H, P) in f32 or bf16 (upcast as they are read, as the
// reference upcasts per step), w (B, S, H, P) f32, u (H, P) f32, all
// contiguous; y (B, S, H, P) f32 before ln_x; the final state goes to
// state_out (B, H, P, P), which may be state_in itself: each thread reads
// the state entries it alone writes, and writes them after the last step.
// The reference's segmentation (_segmented_scan, with its padded steps of
// decay 1 and k = v = 0) leaves the forward unchanged; the kernel walks
// the S steps directly.  w is taken as given: nothing is recomputed from
// it, and the source builds without --use_fast_math.
//
// Bound on an H100 SXM (67 TFLOP/s f32, 3.35 TB/s): the function needs 5
// flops per state entry a step (r^T S into y; w S + k v^T), the bonus being
// rank 1 (y += v sum_i r_i u_i k_i, 5 flops a channel).  At the RWKV6-3B
// serving path's prefill (b = 8, 128 tokens, 40 heads of 64, bf16 r / k /
// v, the cache's state read and written) that is 0.85 GFLOP (0.0127 ms)
// over 47.2 MB (0.0141 ms): bound by bytes; the decode step (one token)
// reads and writes 5.2 MB of f32 state each way: 0.0031 ms of bytes.  The
// kernel does 7 flops an entry (it applies u per entry); its shared-memory
// loads, not these flops, are its likely limit (inferred, not measured).
//
// Design (the first, simple and right; the chunked form with intra-chunk
// products on wgmma is its redesign):
//
//   * one block per (sequence, head), P x G threads (G = 4): thread
//     (j, g) holds the P / G entries S[i, j] with i = ii G + g in
//     registers for the whole walk, so the state is read and written once;
//     at the path's 8 x 40 heads of 64 the 320 blocks of 256 threads fit
//     one wave (40 KB of shared memory and 80 registers a thread, no
//     spill: three blocks an SM);
//   * T = 32 steps at a time are staged in shared memory, r, k and w of a
//     step's row i packed in one float4 (one 16-byte load per state entry
//     a step; the four row groups of a warp read 64 consecutive bytes, no
//     bank conflict) and v beside them; the loads are coalesced along P
//     and a ragged last tile stages only its steps;
//   * y_t[j] is summed over a thread's rows in four accumulators (no
//     16-term dependent chain), then over the G threads of column j (they
//     are neighbouring lanes) by two xor shuffles; one lane writes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int G = 4;   // threads that share a column j (row groups)
constexpr int T = 32;  // steps staged at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename In, int P>
__global__ void __launch_bounds__(P * G)
wkv6_kernel(const In* __restrict__ r, const In* __restrict__ k, const In* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* state_in, float* __restrict__ y, float* state_out, int S,
            int H) {
  constexpr int R = P / G;  // state entries a thread holds
  constexpr int NT = P * G;
  __shared__ float4 rkw[T][P];
  __shared__ float vs[T][P];
  const int tid = threadIdx.x;
  const int j = tid / G;
  const int g = tid % G;
  const int h = static_cast<int>(blockIdx.x % H);
  const long long b = blockIdx.x / H;
  const long long sbase = static_cast<long long>(blockIdx.x) * P * P;

  float st[R];
  float uu[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int i = ii * G + g;
    st[ii] = state_in != nullptr ? state_in[sbase + i * P + j] : 0.f;
    uu[ii] = u[h * P + i];
  }
  const long long step = static_cast<long long>(H) * P;  // between two steps
  const long long base = (b * S * H + h) * P;            // (b, 0, h, 0)
  for (int s0 = 0; s0 < S; s0 += T) {
    const int n = min(T, S - s0);
    for (int idx = tid; idx < n * P; idx += NT) {
      const int t = idx / P;
      const int i = idx % P;
      const long long off = base + (s0 + t) * step + i;
      rkw[t][i] = make_float4(to_f32(r[off]), to_f32(k[off]), w[off], 0.f);
      vs[t][i] = to_f32(v[off]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const float4 q = rkw[t][ii * G + g];  // r, k, w of row i
        const float kv = q.y * vj;
        acc[ii % 4] += q.x * (st[ii] + uu[ii] * kv);
        st[ii] = q.z * st[ii] + kv;
      }
      float out = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int m = 1; m < G; m <<= 1) out += __shfl_xor_sync(0xffffffffu, out, m);
      if (g == 0) y[base + (s0 + t) * step + j] = out;
    }
    __syncthreads();  // the tile is read before the next one is staged
  }
#pragma unroll
  for (int ii = 0; ii < R; ++ii) state_out[sbase + (ii * G + g) * P + j] = st[ii];
}

template <typename In>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* state_in, float* y, float* state_out, int B, int S, int H, int P,
           cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * H);
  const In* ri = static_cast<const In*>(r);
  const In* ki = static_cast<const In*>(k);
  const In* vi = static_cast<const In*>(v);
  switch (P) {
    case 16:
      wkv6_kernel<In, 16><<<blocks, 16 * G, 0, s>>>(ri, ki, vi, w, u, state_in, y,
                                                      state_out, S, H);
      break;
    case 32:
      wkv6_kernel<In, 32><<<blocks, 32 * G, 0, s>>>(ri, ki, vi, w, u, state_in, y,
                                                      state_out, S, H);
      break;
    case 64:
      wkv6_kernel<In, 64><<<blocks, 64 * G, 0, s>>>(ri, ki, vi, w, u, state_in, y,
                                                      state_out, S, H);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v (B, S, H, P) contiguous (dtype 0 = float32, 1 = bfloat16); w (B,
// S, H, P) f32; u (H, P) f32; state_in (B, H, P, P) f32 or null (zeros);
// y (B, S, H, P) f32; state_out (B, H, P, P) f32, may be state_in.  P is
// 16, 32 or 64.  Returns cudaGetLastError() after the launch, -1 for
// arguments it does not take.
extern "C" int wkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* state_in, void* y,
                                void* state_out, int B, int S, int H, int P, int dtype,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || static_cast<long long>(B) * H > 0x7fffffffLL) return -1;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(state_in);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, k, v, wf, uf, si, yf, so, B, S, H, P, s);
  if (dtype == 1) return launch<__nv_bfloat16>(r, k, v, wf, uf, si, yf, so, B, S, H, P, s);
  return -1;
}
