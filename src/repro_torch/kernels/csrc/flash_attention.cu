// Blockwise GQA attention forward for Hopper (sm_90a): causal or full,
// optionally under a sliding window or a chunked-local mask.
//
//   out[b, q, h, :] = softmax_k(mask(softcap(q . k / sqrt(D)))) . v
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel).  Semantics are the reference's
// (src/repro/kernels/ref.py: attention_ref; the window and chunk masks of
// src/repro/models/layers.py:177-182): query row i sits at the absolute
// position p = i + (Sk - Sq) (bottom-right alignment) and sees key k when
// k <= p (causal), p - k < window (window > 0) and floor(p / chunk) ==
// floor(k / chunk) (chunk > 0); masked scores are set to -1e30 (so a row
// with no visible key averages all Sk values, as the reference's softmax
// does), optional
// softcap * tanh(s / softcap), p rounded to v's dtype before P.V, output
// acc / max(l, 1e-30) in q's dtype.  q head h reads kv head h / G.  Inputs
// are read through their strides (last dim contiguous); the output is
// written (B, Sq, H, D).  When the caller passes an `lse` buffer (B, H, Sq)
// f32, each row's log-sum-exp m + log(l) of its scaled, capped and masked
// scores goes there too: the backward kernel (flash_attention_bwd.cu)
// recomputes P from it.  The serving path passes none and writes nothing.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 3.35 TB/s): at the
// serving path's prefill (8 x 128 tokens, 40 q heads, 8 kv heads, D = 128,
// causal, bf16) a launch is 1.35 GFLOP (1.4 us on the tensor cores) over
// ~25 MB (q, k, v read once, out written once: 7.5 us), so it is bound by
// bytes.  The first port's design -- every bf16 tile widened to f32 in
// 116 KB of shared memory (one block an SM), fmaf chains on the CUDA
// cores, element-wise loads, four barriers a key tile -- took 0.1319 ms
// there (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), bound by the CUDA
// cores' instruction rate.  This design takes 0.0151 ms on the same card
// and limit, 2.0x its byte bound and 1.05x SDPA timed in the same run.
//
// The C entry point picks one kernel by dtype:
//
// bf16: flash_fwd_wgmma, on the tensor cores.  One warpgroup (128 threads)
// owns BQ = 64 query rows of one (b, h) -- wgmma's M -- and walks the K/V
// tiles of kv head h / G, BK = 64 keys at a time:
//   * S = Q K^T is wgmma.m64n64k16 (bf16 x bf16 -> f32) with Q and K in
//     shared memory in bf16, K-major, in the 128-byte swizzled layout the
//     wgmma descriptors name (rows of 64 columns, 16-byte chunk c of row r
//     stored at chunk c ^ (r % 8); a wider head is D / 64 such blocks).
//   * The online softmax runs on the accumulator fragments in registers:
//     a row lives in the four threads of a quad, so its max and sum are two
//     shuffles each.  No P tile in shared memory, no barrier per step.
//   * P is rounded to bf16 in registers -- the reference's "p in v's dtype"
//     -- and is then the A operand of the register-A wgmma for O += P V: S's
//     accumulator fragment is, pair for pair, that operand's fragment.  V is
//     the B operand from shared memory, read MN-major (the transpose bit of
//     the descriptor), one m64n64 product per 64 output columns.
//   * Q once, then each K/V tile, arrive by 16-byte cp.async into one
//     buffer each: 49 KB of shared memory and 163 registers a thread at
//     D = 128 (ptxas), so three blocks share an SM, and one block's tile
//     loads while the others compute (the grid at the path shape is
//     B * H * ceil(Sq / 64) = 640 blocks, and each q tile walks one or two
//     key tiles).
//   * The output leaves through shared memory (the Q and K buffers, rows
//     padded by 16 bytes so the fragment writes spread over the banks) in
//     16-byte stores along each row.
//   * Key tiles past the q tile's causal limit are not loaded; the diagonal
//     tile and keys past Sk are masked per element (-1e30 causal, p = 0 for
//     keys that do not exist).  A q tile with a row that sees no key (Sq >
//     Sk, causal) walks every key.
//   * D < 64 is staged in one 64-column block: Q and K zero-filled up to
//     the next multiple of 16 (D = 8 is padded to 16), so the zeros add
//     nothing to Q K^T; the padded output columns are never written.
//     D = 256 keeps BK = 64: its accumulator is 4 x 32 registers a thread
//     (206 registers, no spill, by ptxas).
//   * Base pointers and the batch / sequence / head strides must be 16-byte
//     aligned (the wrapper checks and raises; it never copies).
//
// Masks (both kernels).  A row's visible keys are one span [lo(p), hi(p))
// (KeySpan), and lo and hi never decrease with p, so a q tile's keys are
// [lo(first row), hi(last row)): the tile walks only the key tiles that
// meet that span -- for a window, [q_lo - window + 1, q_hi]; for a chunk,
// the chunks its rows are in -- and skips the rest without loading them.
// A key tile inside every row's span ([lo(last row), hi(first row))) is
// taken whole; only the tiles at the span's edges (the diagonal, the
// window's trailing edge, a chunk boundary inside the tile, keys past Sk)
// are masked element by element against each row's own span.  If a row
// of the tile sees no key (p < 0 under causal or chunk: Sq > Sk), the tile
// walks and masks every key, as before.
//
// f32: flash_fwd_f32, the first port's kernel on the CUDA cores: the tensor
// cores would take f32 as TF32, which breaks the 2e-5 tolerance.  One block
// of 256 threads owns 64 query rows and streams 64-key tiles through shared
// memory in f32; S = Q K^T and P V are fmaf chains.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "wgmma.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// floor(a / b) for b > 0 (C++ division truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The keys [lo(p), hi(p)) a query at absolute position p sees; window and
// chunk are 0 for none.  Empty (lo >= hi) for a row that sees no key.
struct KeySpan {
  int Sk, causal, window, chunk;

  __device__ __forceinline__ int lo(int p) const {
    int l = 0;
    if (window > 0) l = max(l, p - window + 1);
    if (chunk > 0) l = max(l, floor_div(p, chunk) * chunk);
    return l;
  }
  __device__ __forceinline__ int hi(int p) const {
    long long h = Sk;
    if (causal) h = min(h, static_cast<long long>(p) + 1);
    if (chunk > 0)
      h = min(h, (static_cast<long long>(floor_div(p, chunk)) + 1) * chunk);
    return static_cast<int>(max(h, 0LL));
  }
};

// The key tiles [t_begin, t_end) a q tile with rows at positions [p0, p1]
// walks, and the keys [full_lo, full_hi) every one of its rows sees (a key
// tile inside them needs no mask).
struct TilePlan {
  int t_begin, t_end, full_lo, full_hi;

  __device__ TilePlan(const KeySpan& sp, int p0, int p1) {
    // a row that sees no key: every key takes part, masked
    if (p0 < 0 && (sp.causal || sp.chunk > 0)) {
      t_begin = 0;
      t_end = (sp.Sk + BK - 1) / BK;
      full_lo = 1;
      full_hi = 0;
    } else {
      t_begin = sp.lo(p0) / BK;
      t_end = (sp.hi(p1) + BK - 1) / BK;
      full_lo = sp.lo(p1);
      full_hi = sp.hi(p0);
    }
  }
  __device__ __forceinline__ bool full(int k0) const {
    return k0 >= full_lo && k0 + BK <= full_hi;
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

// the wgmma helpers (tiles, descriptors, products) are in wgmma.cuh

template <int D>
constexpr int wg_smem_bytes() {
  // Q, K and V tiles, plus slack to align the base to 1024 bytes
  return 3 * ((D + 63) / 64) * BLOCK_BYTES + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                int Sk, int H, int G, long long qsb, long long qss,
                long long qsh, long long ksb, long long kss, long long ksh,
                long long vsb, long long vss, long long vsh, int causal,
                int window, int chunk, int has_cap, float softcap, float scale) {
  constexpr int DB = (D + 63) / 64;     // 64-column blocks of a row
  constexpr int KS = (D + 15) / 16;     // k-steps of Q K^T
  constexpr int QK_CH = 2 * KS;         // staged chunks of a Q / K row
  constexpr int V_CH = D / 8;           // staged chunks of a V row
  constexpr int OP = DB * BLOCK_BYTES;  // bytes of one 64-row operand

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + OP;
  const uint32_t sv = sk + OP;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / G;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int off = Sk - Sq;  // bottom-right causal alignment

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

  // the key tiles this q tile walks (see the header)
  const KeySpan sp{Sk, causal, window, chunk};
  const TilePlan plan(sp, q0 + off, min(q0 + BQ, Sq) - 1 + off);

  stage_rows<D, QK_CH>(sq, qb, qss, q0, Sq, tid);
  stage_rows<D, QK_CH>(sk, kb, kss, plan.t_begin * BK, Sk, tid);
  stage_rows<D, V_CH>(sv, vb, vss, plan.t_begin * BK, Sk, tid);
  cp_commit();

  // this thread's rows of the 64-row tile (wgmma accumulator layout):
  // element 4 i + e of a fragment is row r0 + 8 (e / 2), column
  // 8 i + 2 (lane % 4) + e % 2
  const int r0 = 16 * warp + (lane >> 2);
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const int col = 2 * (lane & 3);
  // each row's visible keys, for the masked tiles
  const int row_lo[2] = {sp.lo(qpos[0] + off), sp.lo(qpos[1] + off)};
  const int row_hi[2] = {sp.hi(qpos[0] + off), sp.hi(qpos[1] + off)};

  float o[DB][32];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
  float m[2] = {MASKED, MASKED};
  float l[2] = {0.0f, 0.0f};

  for (int t = plan.t_begin; t < plan.t_end; ++t) {
    const int k0 = t * BK;
    const bool full = plan.full(k0);
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t is in, from every thread's copies

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t at = (kk >> 2) * BLOCK_BYTES + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(sq + at, LBO_K), sw128_desc(sk + at, LBO_K));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, cap, mask; online softmax on the fragments
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col + (e & 1);
        float x = s[4 * i + e] * scale;
        if (has_cap) x = softcap * tanhf(x / softcap);
        if (!full) {
          if (key >= Sk) {
            x = -CUDART_INF_F;  // no such key: p = 0
          } else if (key < row_lo[e >> 1] || key >= row_hi[e >> 1]) {
            x = MASKED;
          }
        }
        s[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      corr[rr] = exp2f((m[rr] - m_new) * LOG2E);
      m[rr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      const float p = exp2f((s[i] - m[rr]) * LOG2E);
      sum[rr] += p;
      s[i] = p;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      l[rr] = l[rr] * corr[rr] + sum[rr];
    }
    // P in v's dtype, as the A fragments of four k16 steps
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int j = 0; j < DB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= corr[(i >> 1) & 1];

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < DB; ++j)
        wgmma_rs_mn(o[j], pa[kk],
                    sw128_desc(sv + j * BLOCK_BYTES + kk * 16 * 128, LBO_MN));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < DB; ++j) fence_regs(o[j]);
    if (t + 1 < plan.t_end) {
      __syncthreads();  // every warp is done with tile t
      stage_rows<D, QK_CH>(sk, kb, kss, k0 + BK, Sk, tid);
      stage_rows<D, V_CH>(sv, vb, vss, k0 + BK, Sk, tid);
      cp_commit();
    }
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) inv[rr] = 1.0f / fmaxf(l[rr], 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // a quad holds its rows' m and l
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (qpos[rr] < Sq)
        lse[(static_cast<long long>(b) * H + h) * Sq + qpos[rr]] =
            m[rr] + logf(l[rr]);
  }
  // The output goes through shared memory (the Q and K buffers, free now),
  // rows padded by 16 bytes so the fragment writes miss each other's banks,
  // then out in 16-byte stores along each row.
  constexpr int OS = D + 8;
  __syncthreads();
  __nv_bfloat16* os =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (sq - smem_u32(smem_raw)));
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int j = 0; j < DB; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = 64 * j + 8 * i + col;
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(os + (r0 + 8 * rr) * OS + d) =
              __floats2bfloat162_rn(o[j][4 * i + 2 * rr] * inv[rr],
                                    o[j][4 * i + 2 * rr + 1] * inv[rr]);
      }
  __syncthreads();
  for (int e = tid; e < BQ * (D / 8); e += WG_THREADS) {
    const int r = e / (D / 8);
    const int c = e - r * (D / 8);
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * OS + 8 * c);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int RI = BQ / 16;  // query rows per thread
constexpr int RJ = BK / 16;  // keys per thread in S = Q K^T
constexpr int PS = BK + 1;   // padded row stride of the P tile

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int Sq, int Sk, int H, int G,
              long long qsb, long long qss,
              long long qsh, long long ksb, long long kss, long long ksh,
              long long vsb, long long vss, long long vsh, int causal,
              int window, int chunk, int has_cap, float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = (D + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP]
  float* ks = qs + BQ * DP;     // [BK][DP]
  float* vs = ks + BK * DP;     // [BK][D]
  float* ps = vs + BK * D;      // [BQ][PS]
  float* row_m = ps + BQ * PS;  // [BQ]
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / G;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int off = Sk - Sq;  // bottom-right causal alignment

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  for (int e = tid; e < BQ * D; e += F32_THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const int qr = q0 + r;
    qs[r * DP + d] = qr < Sq ? qb[qr * qss + d] : 0.0f;
  }
  if (tid < BQ) {
    row_m[tid] = MASKED;
    row_l[tid] = 0.0f;
  }

  // the key tiles this q tile walks, as in the bf16 kernel
  const KeySpan sp{Sk, causal, window, chunk};
  const TilePlan plan(sp, q0 + off, min(q0 + BQ, Sq) - 1 + off);

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = plan.t_begin * BK; k0 < plan.t_end * BK; k0 += BK) {
    const bool full = plan.full(k0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += F32_THREADS) {
      const int c = e / D;
      const int d = e - c * D;
      const int key = k0 + c;
      const bool ok = key < Sk;
      ks[c * DP + d] = ok ? kb[key * kss + d] : 0.0f;
      vs[c * D + d] = ok ? vb[key * vss + d] : 0.0f;
    }
    __syncthreads();

    // S = Q K^T, scaled, capped and masked, into the P tile
    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int p = q0 + r + off;
      const int lo = full ? 0 : sp.lo(p);
      const int hi = full ? Sk : sp.hi(p);
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int c = tx + 16 * j;
        const int key = k0 + c;
        float x;
        if (key >= Sk) {
          x = -CUDART_INF_F;  // no such key: p = 0
        } else {
          x = s[i][j] * scale;
          if (has_cap) x = softcap * tanhf(x / softcap);
          if (key < lo || key >= hi) x = MASKED;
        }
        ps[r * PS + c] = x;
      }
    }
    __syncthreads();

    // online softmax: 4 consecutive threads per row
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float mx = -CUDART_INF_F;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, ps[r * PS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(ps[r * PS + c] - m_new);
        sum += p;
        ps[r * PS + c] = p;  // f32: p is already in v's dtype
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    const int c_end = min(BK, Sk - k0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float corr = row_c[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < c_end; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? vs[c * D + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
  if (lse != nullptr && tid < BQ && q0 + tid < Sq)
    lse[(static_cast<long long>(b) * H + h) * Sq + q0 + tid] =
        row_m[tid] + logf(row_l[tid]);

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float inv_l = 1.0f / fmaxf(row_l[r], 1e-30f);
    float* o = out + ((static_cast<long long>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[d] = acc[i][j] * inv_l;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Sq, Sk, H, KV;
  const long long* st;  // qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh
  int causal, window, chunk, has_cap;
  float softcap;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
int launch_kernel(Kernel kernel, bool& configured, size_t smem, int threads,
                  const Args& a, float scale) {
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  const long long* s = a.st;
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.Sq, a.Sk, a.H,
      a.H / a.KV, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
      a.causal, a.window, a.chunk, a.has_cap, a.softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int dtype, const Args& a) {
  // the shared-memory attribute is set once per kernel
  static bool bf16_ready = false, f32_ready = false;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (dtype == 1)
    return launch_kernel<__nv_bfloat16>(flash_fwd_wgmma<D>, bf16_ready,
                                        wg_smem_bytes<D>(), WG_THREADS, a,
                                        scale);
  return launch_kernel<float>(flash_fwd_f32<D>, f32_ready, f32_smem_bytes<D>(),
                              F32_THREADS, a, scale);
}

}  // namespace

// q: (B, Sq, H, D), k / v: (B, Sk, KV, D), strides in elements for the
// batch, sequence and head axes (the last axis contiguous; for bf16 every
// base pointer and stride 16-byte aligned); out: (B, Sq, H, D) contiguous;
// window / chunk: the masks' widths, 0 for none; dtype 0 = float32
// (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel); lse: (B, H, Sq)
// f32 contiguous, or null for none.
// Returns 0 on success, -1 for an unsupported head size, dtype or mask
// width, else cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, int window, int chunk, int has_cap,
    float softcap, int dtype, float* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || window < 0 || chunk < 0) return -1;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const Args a{q, k, v, out, lse, B, Sq, Sk, H, KV, st, causal, window, chunk,
               has_cap, softcap, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 8: return launch_d<8>(dtype, a);
    case 16: return launch_d<16>(dtype, a);
    case 32: return launch_d<32>(dtype, a);
    case 64: return launch_d<64>(dtype, a);
    case 128: return launch_d<128>(dtype, a);
    case 256: return launch_d<256>(dtype, a);
    default: return -1;
  }
}
