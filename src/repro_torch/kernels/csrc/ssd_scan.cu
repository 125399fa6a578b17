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
// Bound on an H100 SXM (67 TFLOP/s f32, 3.35 TB/s): at the hybrid serving
// path's prefill (b = 8, 128 tokens, one chunk, H = 64, P = N = 64, bf16)
// the scan does 1.64 GFLOP (C . B once a sequence; per head the decays,
// the intra-chunk product, the carried state's term and the state update)
// over ~16 MB: 0.024 ms of operations; the decode step (one token) reads
// and writes 8.4 MB of f32 state: 0.005 ms of bytes.
//
// The first design took 0.512904 ms at that prefill and 0.014864
// ms at the decode step (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), 21x
// its bound and no faster than its plain version: one block of 256
// threads per (head, sequence) held the chunk's x, B, C, the L x L decay
// matrix and the state in 183 KB of shared memory (one block an SM, 3.9
// waves with a tail); every product was scalar from shared memory at two
// or three loads an FMA; C_i . B_j was computed again by each of the 64
// heads (a quarter of a block's FMAs); and the flattened triangle idled
// half the threads.  This design takes 0.109325 ms at the prefill and
// 0.010066 ms at the decode step (same card and limit, chip_smoke.py),
// 4.5x and 2.0x its bounds: the products are now a small share, and a
// block's phases (staging, building A, the two products) still run one
// after another behind barriers.  Its parts:
//
//   * ssd_cb, a first pass per (sequence, chunk): C B^T for the pairs
//     j <= i, once for all heads, written transposed (CBt[j][i]) beside
//     C^T (Ct[n][i]) in f32 -- 0.75 MB at the prefill, read back from L2.
//     64 x 64 pair tiles, one block each, 4 x 4 pairs a thread from float4
//     loads.  Decode (L = 1) needs one C . B a sequence and skips the pass:
//     the scan forms it in a warp (and a decode block takes two heads of
//     a sequence, so the step's blocks fit in one wave);
//   * ssd_scan_kernel, one block of 256 threads per (head, sequence), the
//     chunks in order.  Per row block of up to 64 rows it builds
//     A = [att ; exp(cum_i) C^T] -- att[i, j] = CBt[j][i] exp(cum_i -
//     cum_j) dt_j for j <= i, 0 above -- transposed in shared memory, and
//     y = A^T [x ; S^T] is one register-tiled product: 4 rows x 4 channels
//     a thread, a float4 of A and a float4 of x (or S^T) a step, 8 FMAs a
//     load, the key range cut at the tile's last row.  Then
//     S^T <- S^T exp(cum_L) + (w B)^T x, the same way (4 states x 4
//     channels a thread).  All products IEEE f32 from f32 operands: att,
//     the state and w x are never rounded;
//   * shared memory: x (L x P), the state transposed (N x P), and one
//     region that holds A (its (L + N) x 64 rows while y is formed) or w B
//     (L x N, for the state update): 97.5 KB at L = 128, P = N = 64, so two
//     blocks share an SM;
//   * every staging loop keeps several loads of a thread in flight (a
//     strided loop of single loads waits out each load's latency in turn)
//     and walks rows and columns without a division per element (in
//     unrolled loops, runtime divisions cost as much code as the products);
//     the chunked path's state moves in 16-byte vectors (a thread a channel row, eight
//     states a vector pair; scalar where N is not a multiple of 8 or a
//     pointer is not aligned); P and N are padded to multiples of 4 with
//     zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int RB_MAX = 64;  // rows of a y row block
constexpr int CB_T = 64;    // pair tile of the first pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int up4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr long long max_ll(long long a, long long b) { return a > b ? a : b; }

// Floats of one head's share of a decode block: the state [P][N], the x,
// C and B rows, dt, dA and the step's C . B term, rounded to 16 bytes.
__host__ __device__ constexpr int decode_floats(int P, int N) {
  return up4(P * N + P + 2 * N + 3);
}

// Shared memory of a scan block, in floats.  Chunks of L > 1: x [L][PP],
// S^T [NN][PP], the region of A [L + NN][64] or w B [L][NN], then dt, cum
// and w [L] each.  L = 1: two heads' decode_floats.
__host__ __device__ constexpr long long scan_floats(int P, int N, int L) {
  return L == 1 ? 2LL * decode_floats(P, N)
                : static_cast<long long>(L) * up4(P) + static_cast<long long>(up4(N)) * up4(P) +
                      max_ll(static_cast<long long>(L + up4(N)) * RB_MAX,
                             static_cast<long long>(L) * up4(N)) +
                      3LL * L;
}

// st(e, ld(e)) for e = tid, tid + NT, ... < n (NT threads), with U loads
// of a thread in flight at once (a strided loop would wait for each in
// turn)
template <int U, int NT = THREADS, typename Ld, typename St>
__device__ __forceinline__ void batched(int n, int tid, Ld ld, St st) {
  for (int e0 = tid; e0 < n; e0 += U * NT) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      v[u] = e < n ? ld(e) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e < n) st(e, v[u]);
    }
  }
}

// the same for float4 values
template <int U, typename Ld, typename St>
__device__ __forceinline__ void batched4(int n, int tid, Ld ld, St st) {
  for (int e0 = tid; e0 < n; e0 += U * THREADS) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e < n) v[u] = ld(e);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e < n) st(e, v[u]);
    }
  }
}

// (row j, column c) of e = e0, e0 + THREADS, ... in a row-major range of
// rows of w columns, stepped without a division per element
struct Walk {
  int j, c, dj, dc, w;
  __device__ __forceinline__ Walk(int e0, int width) : w(width) {
    j = e0 / w;
    c = e0 - j * w;
    dj = THREADS / w;
    dc = THREADS - dj * w;
  }
  __device__ __forceinline__ void next() {
    j += dj;
    c += dc;
    if (c >= w) {
      c -= w;
      ++j;
    }
  }
};

// st(e, ld(j, c)) over a row-major range of rows of w columns (e = j w +
// c), four loads of a thread in flight at once
template <typename Ld, typename St>
__device__ __forceinline__ void batched2d(int rows, int w, int tid, Ld ld, St st) {
  const int n = rows * w;
  Walk at(tid, w);
  for (int e0 = tid; e0 < n; e0 += 4 * THREADS) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = e0 + u * THREADS < n ? ld(at.j, at.c) : 0.0f;
      at.next();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * THREADS < n) st(e0 + u * THREADS, v[u]);
  }
}

// the 16-byte vector at p as f32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// dst[j * ds + c] = scale(j) * src[j * rs + c] in f32 for rows j < n_rows
// and columns c < width, zero for width <= c < ds: 16-byte loads where
// width and the rows allow them, else single elements; four loads of a
// thread in flight at once
template <typename T, typename Scale>
__device__ __forceinline__ void stage_f32(float* dst, int ds, const T* src, long long rs,
                                          int n_rows, int width, int tid, Scale scale) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = width % V == 0 && ds == width &&
                   ((reinterpret_cast<uintptr_t>(src) |
                     static_cast<uintptr_t>(rs * static_cast<long long>(sizeof(T)))) & 15) == 0;
  if (!vec) {
    batched2d(
        n_rows, ds, tid,
        [&](int j, int c) { return c < width ? scale(j) * to_f32(src[j * rs + c]) : 0.0f; },
        [&](int e, float v) { dst[e] = v; });
    return;
  }
  const int n = n_rows * (width / V);  // vectors
  Walk at(tid, width / V);
  for (int e0 = tid; e0 < n; e0 += 4 * THREADS) {
    float f[4][V];
    int row[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      row[u] = at.j;
      if (e0 + u * THREADS < n) unpack16(src + at.j * rs + at.c * V, f[u]);
      at.next();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS;
      if (e < n) {
        const float sc = scale(row[u]);
#pragma unroll
        for (int q = 0; q < V; q += 4)
          *reinterpret_cast<float4*>(dst + e * V + q) =
              make_float4(sc * f[u][q], sc * f[u][q + 1], sc * f[u][q + 2], sc * f[u][q + 3]);
      }
    }
  }
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4& a, const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

// First pass: CBt[b, c, j, i] = C_i . B_j for j <= i < Lc and Ct[b, c, n,
// i] = C[i, n], f32.  grid (pair tiles of the chunk, chunks, B); tile
// (ib, jb), jb <= ib, covers rows i of ib and j of jb; the diagonal tiles
// also write Ct.  4 x 4 pairs a thread: rows i = ig + 16 m, j = 4 jg + a.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cb(const T* __restrict__ bm, long long b_sb, long long b_ss, const T* __restrict__ cm,
       long long c_sb, long long c_ss, float* __restrict__ cbt, float* __restrict__ ct,
       int S, int N, int L) {
  __shared__ __align__(16) float cs[CB_T][CB_T + 4];  // C rows, 64 states at a time
  __shared__ __align__(16) float bs[CB_T][CB_T + 4];  // B rows
  int ib = 0;
  while ((ib + 1) * (ib + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ib;
  const int jb = blockIdx.x - ib * (ib + 1) / 2;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * L;
  const int Lc = min(L, S - s0);
  const int i0 = ib * CB_T, j0 = jb * CB_T;
  if (i0 >= Lc) return;
  const int tid = threadIdx.x;
  const int ig = tid & 15, jg = tid >> 4;
  const long long n_ch = gridDim.y;
  float* cb_out = cbt + (static_cast<long long>(b) * n_ch + c) * L * L;
  float* ct_out = ct + (static_cast<long long>(b) * n_ch + c) * N * L;

  float acc[4][4];  // [a: j = 4 jg + a][m: i = ig + 16 m]
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[a][m] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += CB_T) {
    __syncthreads();  // the previous states' readers are done
    batched<8>(
        CB_T * CB_T, tid,
        [&](int e) {
          const int r = e / CB_T, n = e - r * CB_T;
          return n0 + n < N && i0 + r < Lc
                     ? to_f32(cm[b * c_sb + (s0 + i0 + r) * c_ss + n0 + n]) : 0.0f;
        },
        [&](int e, float v) { cs[e / CB_T][e % CB_T] = v; });
    batched<8>(
        CB_T * CB_T, tid,
        [&](int e) {
          const int r = e / CB_T, n = e - r * CB_T;
          return n0 + n < N && j0 + r < Lc
                     ? to_f32(bm[b * b_sb + (s0 + j0 + r) * b_ss + n0 + n]) : 0.0f;
        },
        [&](int e, float v) { bs[e / CB_T][e % CB_T] = v; });
    __syncthreads();
    if (jb == ib) {  // C^T, coalesced along i
      for (int e = tid; e < CB_T * CB_T; e += THREADS) {
        const int n = e / CB_T, r = e - n * CB_T;
        if (n0 + n < N && i0 + r < Lc)
          ct_out[static_cast<long long>(n0 + n) * L + i0 + r] = cs[r][n];
      }
    }
    for (int n = 0; n < CB_T; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) cv[m] = *reinterpret_cast<const float4*>(&cs[ig + 16 * m][n]);
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = *reinterpret_cast<const float4*>(&bs[4 * jg + a][n]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[a][m] = fmaf(bv[a].x, cv[m].x, acc[a][m]);
          acc[a][m] = fmaf(bv[a].y, cv[m].y, acc[a][m]);
          acc[a][m] = fmaf(bv[a].z, cv[m].z, acc[a][m]);
          acc[a][m] = fmaf(bv[a].w, cv[m].w, acc[a][m]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + 4 * jg + a;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = i0 + ig + 16 * m;
      if (j <= i && i < Lc) cb_out[static_cast<long long>(j) * L + i] = acc[a][m];
    }
  }
}

// L = 1 (a decode step, or chunks of one step): no first pass and no
// transposition.  A block takes two heads of one sequence, 128 threads
// each, so that a decode step's (head, sequence) pairs fit in one wave.
// A head's state is copied row-major into shared memory beside the step's
// x, C and B rows, all loads in flight at once, so a block waits for one
// round trip; then each warp owns whole rows p, its lanes over n:
//   y[p]    = (C . B) exp(cum - cum) dt x[p] + sum_n (exp(cum) C[n]) S[p, n]
//   S[p, n] <- S[p, n] exp(cum) + (w B[n]) x[p],  w = exp(cum - cum) dt,
// the sum over n by a fixed shuffle butterfly.  Chunk c is step c.
template <typename T>
__device__ __forceinline__ void decode_steps(const T* __restrict__ xs, long long x_sb,
                                             long long x_ss, const T* __restrict__ bm,
                                             long long b_sb, long long b_ss,
                                             const T* __restrict__ cm, long long c_sb,
                                             long long c_ss, const float* __restrict__ dt,
                                             const float* __restrict__ da,
                                             const float* state_in, float* __restrict__ y,
                                             float* state_out, int S, int H, int P, int N,
                                             float* smem) {
  constexpr int HT = THREADS / 2;  // threads a head
  const int half = threadIdx.x / HT;
  const int tid = threadIdx.x - half * HT;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = 2 * blockIdx.x + half;
  const bool live = h < H;  // an odd H leaves the last block's second half idle
  float* sd = smem + half * decode_floats(P, N);  // the state, [P][N]
  float* xr = sd + P * N;  // x row [P], then the C row [N], the B row [N], dt, dA
  float* cr = xr + P;
  float* br = cr + N;
  float* sc = br + N;  // dt, dA, then the C . B term
  const int b = blockIdx.y;
  const long long sh = (static_cast<long long>(b) * H + (live ? h : 0)) * P * N;
  const int n4 = (P * N) % 4 == 0 &&
                         ((reinterpret_cast<uintptr_t>(state_in + sh) |
                           reinterpret_cast<uintptr_t>(state_out + sh)) & 15) == 0
                     ? P * N / 4 : 0;  // 16-byte vectors of the state, or none

  if (live) {
    for (int e0 = tid; e0 < n4; e0 += 4 * HT) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + u * HT < n4) v[u] = reinterpret_cast<const float4*>(state_in + sh)[e0 + u * HT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + u * HT < n4) reinterpret_cast<float4*>(sd)[e0 + u * HT] = v[u];
    }
    if (n4 == 0)
      batched<8, HT>(P * N, tid, [&](int e) { return state_in[sh + e]; },
                     [&](int e, float v) { sd[e] = v; });
  }
  for (int s = 0; s < S; ++s) {
    if (s > 0) __syncthreads();  // the previous step is done with the rows
    if (live)
      batched<4, HT>(
          P + 2 * N + 2, tid,
          [&](int e) {
            if (e < P) return to_f32(xs[b * x_sb + s * x_ss + static_cast<long long>(h) * P + e]);
            e -= P;
            if (e < N) return to_f32(cm[b * c_sb + s * c_ss + e]);
            e -= N;
            if (e < N) return to_f32(bm[b * b_sb + s * b_ss + e]);
            const long long o = (static_cast<long long>(b) * S + s) * H + h;
            return e == N ? dt[o] : da[o];
          },
          [&](int e, float v) { xr[e] = v; });
    __syncthreads();
    const float dts = sc[0], cum = sc[1];  // a one-step chunk: cum = tot = dA
    if (live && warp == 0) {
      float dot = 0.0f;
      for (int n = lane; n < N; n += 32) dot = fmaf(cr[n], br[n], dot);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
      if (lane == 0) sc[2] = dot * expf(cum - cum) * dts;
    }
    __syncthreads();
    const float ec = expf(cum), w = expf(cum - cum) * dts;
    if (live)
      for (int n = tid; n < N; n += HT) {
        cr[n] = ec * cr[n];
        br[n] = w * br[n];
      }
    __syncthreads();
    const float att = sc[2];
    if (live)
      for (int p = warp; p < P; p += HT / 32) {
        const float xp = xr[p];
        float acc = 0.0f;
        for (int n = lane; n < N; n += 32) {
          const float sv = sd[p * N + n];
          acc = fmaf(cr[n], sv, acc);
          sd[p * N + n] = fmaf(sv, ec, br[n] * xp);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) y[((static_cast<long long>(b) * S + s) * H + h) * P + p] = att * xp + acc;
      }
  }
  __syncthreads();
  if (!live) return;
  for (int e = tid; e < n4; e += HT)
    reinterpret_cast<float4*>(state_out + sh)[e] = reinterpret_cast<const float4*>(sd)[e];
  if (n4 == 0)
    for (int e = tid; e < P * N; e += HT) state_out[sh + e] = sd[e];
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const T* __restrict__ xs, long long x_sb, long long x_ss,
                const T* __restrict__ bm, long long b_sb, long long b_ss,
                const T* __restrict__ cm, long long c_sb, long long c_ss,
                const float* __restrict__ dt, const float* __restrict__ da,
                const float* __restrict__ cbt, const float* __restrict__ ct,
                const float* state_in, float* __restrict__ y, float* state_out,
                int S, int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  if (L == 1) {
    decode_steps<T>(xs, x_sb, x_ss, bm, b_sb, b_ss, cm, c_sb, c_ss, dt, da, state_in, y,
                    state_out, S, H, P, N, smem);
    return;
  }
  const int PP = up4(P), NN = up4(N);
  constexpr int RB = RB_MAX;
  float* x_s = smem;                   // [L][PP]
  float* st = x_s + L * PP;            // S^T: [NN][PP]
  float* un = st + NN * PP;            // A: [L + NN][RB], or w B: [L][NN]
  float* dt_s = un + max_ll(static_cast<long long>(L + NN) * RB, static_cast<long long>(L) * NN);
  float* cum_s = dt_s + L;
  float* w_s = cum_s + L;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long sh = (static_cast<long long>(b) * H + h) * P * N;
  const int P4 = PP / 4;
  const bool vec_state = N % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(state_in + sh) | reinterpret_cast<uintptr_t>(state_out + sh)) &
       15) == 0;

  // the incoming state, transposed: S^T[n][p] = S[p][n]
  if (PP != P || NN != N)
    for (int e = tid; e < NN * PP; e += THREADS) st[e] = 0.0f;
  __syncthreads();
  if (vec_state) {  // eight states n8 .. n8 + 7 of channel p a step
    const int nv = P * (N / 8);
    Walk at(tid, P);  // j: n8 / 8, c: p
    for (int e0 = tid; e0 < nv; e0 += 4 * THREADS) {
      float4 lo[4], hi[4];
      int pn[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pn[u][0] = at.c;
        pn[u][1] = 8 * at.j;
        if (e0 + u * THREADS < nv) {
          const float* src = state_in + sh + at.c * N + 8 * at.j;
          lo[u] = *reinterpret_cast<const float4*>(src);
          hi[u] = *reinterpret_cast<const float4*>(src + 4);
        }
        at.next();
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e0 + u * THREADS >= nv) break;
        const float v[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w, hi[u].x, hi[u].y, hi[u].z, hi[u].w};
#pragma unroll
        for (int m = 0; m < 8; ++m) st[(pn[u][1] + m) * PP + pn[u][0]] = v[m];
      }
    }
  } else {
    Walk at(tid, N);
    for (int e = tid; e < P * N; e += THREADS, at.next())
      st[at.c * PP + at.j] = state_in[sh + e];
  }

  const int n_ch = (S + L - 1) / L;
  for (int c = 0; c < n_ch; ++c) {
    const int s0 = c * L;
    const int Lc = min(L, S - s0);  // rows past Lc are the reference's padding
    __syncthreads();  // the previous chunk is done with every buffer
    stage_f32(x_s, PP, xs + b * x_sb + s0 * x_ss + static_cast<long long>(h) * P, x_ss, Lc, P,
              tid, [](int) { return 1.0f; });
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

    const float* cb = cbt + (static_cast<long long>(b) * n_ch + c) * L * L;
    const float* cc = ct + (static_cast<long long>(b) * n_ch + c) * N * L;
    float* a_c = un + L * RB;  // the exp(cum_i) C^T rows of A
    for (int i0 = 0; i0 < Lc; i0 += RB) {
      const int jmax = min(Lc, i0 + RB);  // keys rows i0 .. i0 + RB - 1 see
      if (i0 > 0) __syncthreads();  // the previous row block's readers are done
      // four rows i a float4 (L % 4 == 0: rows of CBt and Ct in 16-byte
      // vectors; a vector that starts below Lc ends below L), else one;
      // the width is a template constant, so the divisions are shifts
      auto build_a = [&](auto vec_t) {
        constexpr bool VEC = decltype(vec_t)::value;
        constexpr int PER = VEC ? 4 : 1;
        constexpr int W = RB / PER;  // groups of rows i in a row block
        batched4<4>(
            jmax * W, tid,
            [&](int e) {
              const int j = e / W, i = i0 + PER * (e - j * W);
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              if (i < Lc) {
                if (VEC) {
                  unpack16(cb + static_cast<long long>(j) * L + i, c);
                } else {
                  c[0] = cb[static_cast<long long>(j) * L + i];
                }
              }
              float a[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                a[q] = q < PER && i + q < Lc && j <= i + q
                           ? c[q] * expf(cum_s[i + q] - cum_s[j]) * dt_s[j] : 0.0f;
              return make_float4(a[0], a[1], a[2], a[3]);
            },
            [&](int e, float4 v) {
              if (VEC) {
                reinterpret_cast<float4*>(un)[e] = v;
              } else {
                un[e] = v.x;
              }
            });
        batched4<4>(
            NN * W, tid,
            [&](int e) {
              const int n = e / W, i = i0 + PER * (e - n * W);
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              if (i < Lc && n < N) {
                if (VEC) {
                  unpack16(cc + static_cast<long long>(n) * L + i, c);
                } else {
                  c[0] = cc[static_cast<long long>(n) * L + i];
                }
              }
              float a[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                a[q] = q < PER && i + q < Lc && n < N ? expf(cum_s[i + q]) * c[q] : 0.0f;
              return make_float4(a[0], a[1], a[2], a[3]);
            },
            [&](int e, float4 v) {
              if (VEC) {
                reinterpret_cast<float4*>(a_c)[e] = v;
              } else {
                a_c[e] = v.x;
              }
            });
      };
      if (L % 4 == 0) {
        build_a(std::true_type{});
      } else {
        build_a(std::false_type{});
      }
      __syncthreads();
      // y rows i0 + 4 rg + m, channels 4 pg + q: A^T [x ; S^T]
      for (int t = tid; t < (RB / 4) * P4; t += THREADS) {
        const int rg = t / P4, pg = t - rg * P4;
        if (i0 + 4 * rg >= Lc) continue;
        float acc[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][q] = 0.0f;
        const int jend = min(jmax, i0 + 4 * rg + 4);  // keys the tile's last row sees
#pragma unroll 4
        for (int j = 0; j < jend; ++j)
          fma4x4(acc, *reinterpret_cast<const float4*>(un + j * RB + 4 * rg),
                 *reinterpret_cast<const float4*>(x_s + j * PP + 4 * pg));
#pragma unroll 4
        for (int n = 0; n < NN; ++n)
          fma4x4(acc, *reinterpret_cast<const float4*>(a_c + n * RB + 4 * rg),
                 *reinterpret_cast<const float4*>(st + n * PP + 4 * pg));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = i0 + 4 * rg + m;
          if (i >= Lc) break;
          float* yr = y + ((static_cast<long long>(b) * S + s0 + i) * H + h) * P;
          const int p = 4 * pg;
          if (P % 4 == 0) {
            *reinterpret_cast<float4*>(yr + p) =
                make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (p + q < P) yr[p + q] = acc[m][q];
          }
        }
      }
    }
    __syncthreads();  // y is formed: the region now takes w B

    // S^T <- S^T exp(cum_L) + (w B)^T x: states 4 ng + a, channels 4 pg + q
    stage_f32(un, NN, bm + b * b_sb + s0 * b_ss, b_ss, Lc, N, tid,
              [&](int j) { return w_s[j]; });
    __syncthreads();
    const float decay = expf(tot);
    for (int t = tid; t < (NN / 4) * P4; t += THREADS) {
      const int ng = t / P4, pg = t - ng * P4;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < Lc; ++j)
        fma4x4(acc, *reinterpret_cast<const float4*>(un + j * NN + 4 * ng),
               *reinterpret_cast<const float4*>(x_s + j * PP + 4 * pg));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4* sv = reinterpret_cast<float4*>(st + (4 * ng + a) * PP + 4 * pg);
        float4 o = *sv;
        o.x = fmaf(o.x, decay, acc[a][0]);
        o.y = fmaf(o.y, decay, acc[a][1]);
        o.z = fmaf(o.z, decay, acc[a][2]);
        o.w = fmaf(o.w, decay, acc[a][3]);
        *sv = o;
      }
    }
  }
  __syncthreads();
  if (vec_state) {
    Walk at(tid, P);
    for (int e = tid; e < P * (N / 8); e += THREADS, at.next()) {
      const int p = at.c, n8 = 8 * at.j;
      float v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) v[m] = st[(n8 + m) * PP + p];
      *reinterpret_cast<float4*>(state_out + sh + p * N + n8) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(state_out + sh + p * N + n8 + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
    Walk at(tid, N);
    for (int e = tid; e < P * N; e += THREADS, at.next())
      state_out[sh + e] = st[at.c * PP + at.j];
  }
}

template <typename T>
int launch(const void* xs, long long x_sb, long long x_ss, const void* bm, long long b_sb,
           long long b_ss, const void* cm, long long c_sb, long long c_ss, const float* dt,
           const float* da, float* cbt, float* ct, const float* state_in, float* y,
           float* state_out, int B, int S, int H, int P, int N, int L, long long smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_ch = (S + L - 1) / L;
  if (L > 1) {
    const int nb = (L + CB_T - 1) / CB_T;
    ssd_cb<T><<<dim3(nb * (nb + 1) / 2, n_ch, B), THREADS, 0, stream>>>(
        static_cast<const T*>(bm), b_sb, b_ss, static_cast<const T*>(cm), c_sb, c_ss, cbt, ct,
        S, N, L);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(L == 1 ? (H + 1) / 2 : H, B);  // decode: two heads a block
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xs), x_sb, x_ss, static_cast<const T*>(bm), b_sb, b_ss,
      static_cast<const T*>(cm), c_sb, c_ss, dt, da, L > 1 ? cbt : nullptr,
      L > 1 ? ct : nullptr, state_in, y, state_out, S, H, P, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one scan block, in bytes (the wrapper checks it against
// the card's 227 KB before it launches).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int L) {
  return 4 * scan_floats(P, N, L);
}

// Floats of the first pass's scratch (CBt then Ct) for B sequences of S
// steps in chunks of L; 0 when L == 1 (no first pass).
extern "C" long long ssd_scan_scratch_floats(int B, int S, int N, int L) {
  if (L <= 1) return 0;
  const long long n_ch = (S + L - 1) / L;
  return static_cast<long long>(B) * n_ch * L * (L + N);
}

// xs (B, S, H, P), Bm / Cm (B, S, N) read through their batch and step
// strides (dtype 0 = float32, 1 = bfloat16); dt, dA (B, S, H) f32
// contiguous; state_in (B, H, P, N) f32; y (B, S, H, P) f32; state_out
// (B, H, P, N) f32, may be state_in; scratch: ssd_scan_scratch_floats f32
// (null when L == 1).  Launches ssd_cb (when L > 1), then ssd_scan_kernel.
extern "C" int ssd_scan_launch(const void* xs, long long x_sb, long long x_ss,
                               const void* bm, long long b_sb, long long b_ss,
                               const void* cm, long long c_sb, long long c_ss,
                               const float* dt, const float* da, float* scratch,
                               const float* state_in, float* y, float* state_out, int B,
                               int S, int H, int P, int N, int L, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || S <= 0 || B > 65535) return -1;
  if (L > 1 && scratch == nullptr) return -1;
  const long long smem = ssd_scan_smem_bytes(P, N, L);
  const long long n_ch = (S + L - 1) / L;
  float* cbt = scratch;
  float* ct = L > 1 ? scratch + static_cast<long long>(B) * n_ch * L * L : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xs, x_sb, x_ss, bm, b_sb, b_ss, cm, c_sb, c_ss, dt, da, cbt, ct,
                         state_in, y, state_out, B, S, H, P, N, L, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xs, x_sb, x_ss, bm, b_sb, b_ss, cm, c_sb, c_ss, dt, da, cbt,
                                 ct, state_in, y, state_out, B, S, H, P, N, L, smem, s);
  return -1;
}
