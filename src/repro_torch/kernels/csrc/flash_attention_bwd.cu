// Blockwise GQA attention backward for Hopper (sm_90a): dQ, dK and dV of
// the forward kernel's function (flash_attention.cu),
//
//   x = q . k / sqrt(D);  c = softcap * tanh(x / softcap) (or x);
//   s = c, or -1e30 where masked;  P = softmax_k(s);  out = P . v,
//
// under the forward's masks: query row i sits at p = i + Sk - Sq (bottom-
// right), and key k is visible when k <= p (causal), p - k < window
// (window > 0) and floor(p / chunk) == floor(k / chunk) (chunk > 0).
//
// Replaces no TPU kernel: the JAX package trains through the jnp
// flash_attention (src/repro/models/layers.py:112) under jax.grad, and its
// Pallas kernel has no backward.  This is the gradient of the port's own
// hand forward kernel, so training runs through that kernel.
//
// FlashAttention-2's backward, three launches a call, no atomics:
//   1. bwd_dot: Dv[b, h, q] = rowsum(dO * O), one warp a row, a fixed
//      shuffle butterfly;
//   2. dK / dV: one block per (b, kv head, key tile) holds its K and V
//      tiles and walks the G query heads of its group and, per head, the
//      query tiles that can see the tile; per query tile it recomputes
//      P = exp(s - lse) from Q, K and the forward's saved log-sum-exp,
//      dP = dO V^T and dS = P (dP - Dv) (times 1 - tanh^2(x / softcap)
//      under the cap), and accumulates dV += P^T dO and dK += dS^T Q;
//   3. dQ: one block per (b, head, query tile) holds Q and dO and walks the
//      key tiles it can see, dQ += dS K.
// Every sum is taken in one fixed order, so the gradient is the same bit
// for bit from run to run.
//
// Masking follows the forward: a row's visible keys are one span [lo(p),
// hi(p)) (span_lo / span_hi, the forward's KeySpan), and a masked score is
// the constant -1e30, so it passes no gradient to q or k; a key past Sk
// has p = 0; a row that sees no key at all (an empty span: p < 0 under
// causal or chunk, Sq > Sk) averages every key with p = 1 / Sk, as the
// reference's softmax over all -1e30 does -- it gives dV its share and dQ
// nothing.  lo and hi never decrease with p, so a key tile's query rows
// and a query tile's keys are intervals: a dK / dV block walks only the
// query tiles with a row that sees one of its keys (QTiles; plus the
// blind rows' tiles) and a dQ block only the key tiles of its rows' spans
// (a 6144-row local layer under a 4096 window walks at most 4096 + 64
// keys a tile).  A tile step whose pairs all take part (most of a causal
// sweep, the inside of a window or a chunk) skips the tests; p =
// exp(c - lse) is one FMA and an exp2 from lse * log2(e).  The edge
// steps test each pair against its row's span (dQ, the f32 dK / dV) or
// its key's rows (SeenBy; the bf16 dK / dV, whose threads each hold two
// keys and sixteen rows), kept in shared memory.
// kernels/flash_attention_bwd.py mirrors this arithmetic in Python (spans,
// seen_by, query_tiles, key_tiles, tile_open), and the CPU tests hold it
// to the mask.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 CUDA
// cores, 3.35 TB/s): a call does 10 D flops per visible (q, k) pair and
// head (S, dP, dV, dK, dQ) and moves q, k, v, out, dO and lse once and
// dq, dk, dv once.  At the training path's shape (b 8, S 256, 8 / 4 heads
// of 64, causal, f32) that is 1.35 GFLOP: 0.020 ms of operations; at
// Qwen2.5-32B's 40 / 8 heads of 128 in bf16, 0.030 ms of bytes; at
// Zamba2's 32 / 32 x 64 in bf16, 0.020 ms of bytes.
//
// The first design took 0.194490 / 1.474691 / 0.471499 ms there
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), against 0.138286 / 0.165147
// / 0.071584 ms for SDPA's backward: f32 tiles in shared memory for both
// dtypes (bf16 widened on load, one element a thread), fmaf chains on the
// CUDA cores at one shared-memory load per two FMAs, P and dS through
// shared memory behind four barriers a tile step, and a dK / dV grid of
// 128 blocks (under one wave of 132 SMs) whose causal blocks did 2 to 8
// tile steps.  This design takes 0.134458 / 0.163488 / 0.098845 ms there
// (same card and limit, chip_smoke.py), against SDPA's 0.134189 / 0.168018
// / 0.072061 in the same run: at SDPA's time in f32 (within 2% either way
// from run to run), below it at Qwen's heads, 1.37x it at Zamba2's,
// 4.9-6.7x the bounds.  What holds it back now: in a
// warpgroup a tile step's products and its elementwise pass run one after
// the other (nothing overlaps them but the other blocks on the SM), and
// f32 computes S and dP twice (7 products a pair, the bound counts 5).
// It picks one kernel pair by dtype:
//
// bf16: bwd_dkdv_bf16 / bwd_dq_bf16, on the tensor cores (wgmma, the
// forward's building blocks in wgmma.cuh).  The 64-key (dK / dV) or
// 64-query (dQ) tile is wgmma's M, so one warpgroup owns it:
//   * S^T = K Q^T and dP^T = V dO^T (dK / dV), S = Q K^T and dP = dO V^T
//     (dQ) are m64n64k16 products with both operands in shared memory,
//     K-major, in the 128-byte swizzled layout;
//   * P and dS are formed on the accumulator fragments in registers and
//     rounded to bf16 -- as the forward rounds P before P V -- and are
//     then the register-A operands of dV += P^T dO, dK += dS^T Q and
//     dQ += dS K, whose B operand (dO, Q, K) is read MN-major from the
//     same tiles.  No P or dS tile in shared memory;
//   * accumulators, lse and Dv stay f32;
//   * the streamed tiles (Q and dO, or K and V) are double-buffered: the
//     next one arrives by 16-byte cp.async while the current one computes
//     (a misaligned operand is staged by plain loads instead);
//   * the pair formulas are compiled once for each of six cases (the
//     whole tile takes part, or an edge of a window / chunk, or of the
//     causal mask alone; softcap or not) and a tile step runs one of them
//     straight through, masks as selects.  A step's code has
//     to stay in the instruction cache: with the masked formula, the cap
//     and its division inlined into every pair, and the misaligned-row
//     staging inlined at every staging call, a kernel compiled to over
//     12k instructions and its warps spent most of a step fetching them;
//   * up to D = 128 one warpgroup owns a block (249 registers at D = 128,
//     no spill: two blocks an SM); D = 256 splits the output columns over
//     two warpgroups (256 threads), each computing the 64 x 64 score tiles
//     itself, so that its dK and dV accumulators (2 x 64 x 256 f32) fit.
//     D < 64 is staged in one 64-column block, zero-filled to the next 16
//     columns.
//   Shared memory: six 64-row operand tiles, 49 KB at D = 64, 97 KB at
//   D = 128 (two blocks an SM), 194 KB at D = 256.
//
// f32: bwd_dkdv_f32 / bwd_dq_f32, IEEE f32 on the CUDA cores (the tensor
// cores would take f32 as TF32, which breaks the 1e-4 bar and the
// policy-style exactness the port keeps).  256 threads a block, register
// micro-tiles fed by 16-byte shared-memory loads:
//   * the score products give a thread 4 keys x 2 queries of S and of dP;
//     a step reads four key rows and two query rows of each operand as
//     float4s along D, 64 FMAs for 12 loads.  Rows are padded by four
//     floats, so the eight float4 reads of a quarter-warp fall in distinct
//     banks;
//   * P^T and dS^T go through shared memory once per tile step, stored so
//     that dV += P^T dO and dK += dS^T Q read two keys' P and dS as float2s
//     and the columns as float4s (2 keys x 4 D / 64 columns of each a
//     thread, 16 FMAs for 4 loads at D = 64), and dQ += dS K a float4 of
//     four queries' dS and float4s of K (4 x 4 D / 64, 16 FMAs for 2
//     loads);
//   * the dK / dV block owns 32 keys and the dQ block 64 queries, so the
//     training path's shape gives 256 blocks of each kernel: two blocks,
//     16 warps, on each of the 132 SMs, all resident at once.  Causal
//     blocks differ in work (a key tile near the diagonal sees fewer query
//     tiles); the grids put the heaviest blocks first (the dK / dV grid's
//     first row is the first key tile, the dQ grid is walked from the last
//     query tile), so the block scheduler's longest-first order balances
//     the SMs;
//   * every tile arrives by 16-byte cp.async, all of a thread's copies in
//     flight at once (double-buffering them measured no faster: the other
//     block on the SM computes while one waits);
//   * D < 64 computes on 64 zero-padded columns.
// Both: no atomics; the gradients leave in the inputs' dtype, dq / dk / dv
// contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int DOT_THREADS = 256;
constexpr int TILE = 64;  // bf16 tiles; f32 query tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr float LOG2E = 1.4426950408889634f;

struct Geo {
  int Sq, Sk, H, G;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int causal, window, chunk, has_cap;  // window / chunk: 0 for none
  float softcap, scale, scale_log2, inv_cap;  // scale * log2(e); 1 / softcap (0: none)
};

// floor(a / b) for b > 0 (C++ division truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The keys [span_lo(p), span_hi(p)) a query at absolute position p sees
// (the forward's KeySpan); empty (hi <= lo) for a row that sees no key.
// Both never decrease with p.
__device__ __forceinline__ int span_lo(int p, const Geo& g) {
  long long l = 0;
  if (g.window > 0) l = max(l, static_cast<long long>(p) - g.window + 1);
  if (g.chunk > 0) l = max(l, static_cast<long long>(floor_div(p, g.chunk)) * g.chunk);
  return static_cast<int>(min(l, static_cast<long long>(g.Sk)));
}
__device__ __forceinline__ int span_hi(int p, const Geo& g) {
  long long h = g.Sk;
  if (g.causal) h = min(h, static_cast<long long>(p) + 1);
  if (g.chunk > 0) h = min(h, (floor_div(p, g.chunk) + 1LL) * g.chunk);
  return static_cast<int>(max(h, 0LL));
}

// p and dS of one (query, key) pair from its score s = q . k, dp = dO . v,
// its row's lse2 = lse * log2(e) and Dv: p = exp(c - lse) as one FMA and
// an exp2, dS = p (dp - Dv) (times 1 - tanh^2(x / softcap) under the cap,
// CAP); dS is the gradient with respect to x, before the 1 / sqrt(D)
// scale, which the callers apply at the end.  Unless the whole tile takes
// part (OPEN), p and dS are then selected, without branches: zero past
// Sq / Sk (inside) and where the key is masked (seen), 1 / Sk (and no
// gradient) for a row that sees no key (blind), as the caller's row_vis
// (or SeenBy) found them.  The two flags are template arguments so that a
// tile step runs one short straight-line variant.
template <bool OPEN, bool CAP>
__device__ __forceinline__ void pair(float s, float dp, bool inside, bool seen, bool blind,
                                     float lse2, float dvq, const Geo& g, float inv_sk,
                                     float& p, float& ds) {
  float po, dso;
  if (CAP) {
    const float th = tanhf(s * g.scale * g.inv_cap);
    po = exp2f(fmaf(g.softcap * th, LOG2E, -lse2));
    dso = po * (dp - dvq) * (1.0f - th * th);
  } else {
    po = exp2f(fmaf(s, g.scale_log2, -lse2));
    dso = po * (dp - dvq);
  }
  if (OPEN) {
    p = po;
    ds = dso;
    return;
  }
  p = inside ? (blind ? inv_sk : (seen ? po : 0.0f)) : 0.0f;
  ds = inside && seen ? dso : 0.0f;
}

// whether a pair takes part (seen) and whether its row, at position pos,
// sees no key (blind): under a window or a chunk (LOCAL) from the row's
// span [lo, hi), read only then; else from the causal edge alone
struct Vis {
  bool seen, blind;
};
template <bool LOCAL>
__device__ __forceinline__ Vis row_vis(int key, int pos, const int& lo, const int& hi,
                                       const Geo& g) {
  if constexpr (LOCAL) {
    return {key >= lo && key < hi, hi <= lo};
  } else {
    return {!g.causal || key <= pos, g.causal && pos < 0};
  }
}

// runs f(open, local, cap) with the flags as std::bool_constant, so that
// the elementwise pass of a tile step is compiled once for each of the six:
// a whole tile (open; its masks are moot), or an edge step under a window
// or a chunk (local) or under the causal edge alone, each with and without
// the softcap.  Keeping the causal-only edge apart keeps the unmasked
// kernels within 3% of their time before the masks (tools/attn_bwd_ab.py;
// one masked formula for every edge step cost 4% at D = 128)
template <typename F>
__device__ __forceinline__ void dispatch_pairs(bool open, bool local, bool cap, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (cap) {
    if (open) f(T{}, N{}, T{});
    else if (local) f(N{}, T{}, T{});
    else f(N{}, N{}, T{});
  } else if (open) {
    f(T{}, N{}, N{});
  } else if (local) {
    f(N{}, T{}, N{});
  } else {
    f(N{}, N{}, N{});
  }
}

// whether every pair of query rows [q0, q0 + nr) and keys [k0, k0 + nk)
// takes part: all inside Sq x Sk and every key in every row's span -- in
// [span_lo(last row), span_hi(first row)), as the spans never shrink from
// the front or the back as p grows (a blind row's empty span fails it)
__device__ __forceinline__ bool tile_open(int q0, int nr, int k0, int nk, const Geo& g) {
  const int off = g.Sk - g.Sq;
  return q0 + nr <= g.Sq && k0 + nk <= g.Sk && k0 >= span_lo(q0 + nr - 1 + off, g) &&
         k0 + nk <= span_hi(q0 + off, g);
}

// The positions [first, last] of the rows that see key k (span_lo(p) <= k <
// span_hi(p): one interval, as both never decrease): p >= k (causal), p >=
// k's chunk start; p <= k + window - 1, p < the end of k's chunk.  A row
// that sees no key is never among them.  Clamped to +-2^30.
struct SeenBy {
  int first, last;
  __device__ __forceinline__ SeenBy(int k, const Geo& g) {
    long long lo = -(1LL << 30), hi = 1LL << 30;
    if (g.causal) lo = k;
    if (g.chunk > 0) {
      const long long c0 = static_cast<long long>(floor_div(k, g.chunk)) * g.chunk;
      lo = max(lo, c0);
      hi = c0 + g.chunk - 1;
    }
    if (g.window > 0) hi = min(hi, static_cast<long long>(k) + g.window - 1);
    first = static_cast<int>(lo);
    last = static_cast<int>(min(hi, 1LL << 30));
  }
};

// The query tiles (of TILE rows) that take part for the keys [k0, k0 + nk):
// those with a row that sees one of them -- the rows from the first that
// sees k0 to the last that sees the last key (SeenBy) -- [lo, hi), and,
// under causal or chunk with Sq > Sk, those with a row that sees no key
// at all (p < 0: p = 1 / Sk for every key), [0, nblind).  at(v) is the
// v-th of the n tiles, in order.  flash_attention_bwd.query_tiles is its
// Python mirror.
struct QTiles {
  int nblind, lo, n;
  __device__ __forceinline__ QTiles(int k0, int nk, const Geo& g) {
    const int nq = (g.Sq + TILE - 1) / TILE;
    const int off = g.Sk - g.Sq;
    nblind = (g.causal || g.chunk > 0) && off < 0 ? min(nq, (-off + TILE - 1) / TILE) : 0;
    // rows from the first that sees key k0 to the last that sees the last key
    const int r_lo = max(SeenBy(k0, g).first - off, 0);
    const int r_hi = min(SeenBy(min(k0 + nk, g.Sk) - 1, g).last - off, g.Sq - 1);
    lo = r_lo <= r_hi ? r_lo / TILE : 0;
    const int hi = r_lo <= r_hi ? r_hi / TILE + 1 : 0;
    lo = max(lo, nblind);
    n = nblind + max(hi - lo, 0);
  }
  __device__ __forceinline__ int at(int v) const { return v < nblind ? v : lo + v - nblind; }
};

// The key tiles (of KT keys) a query tile's rows [q0, q_last] walk for dQ:
// those of the spans of its rows that see a key, [span_lo(first such row),
// span_hi(last row)); a blind row (p < 0 under causal or chunk) takes no
// gradient and adds no key.  flash_attention_bwd.key_tiles is its Python
// mirror.
template <int KT>
struct KTiles {
  int begin, end;
  __device__ __forceinline__ KTiles(int q0, int q_last, const Geo& g) {
    const int off = g.Sk - g.Sq;
    const int k_lo = span_lo(max(q0 + off, 0), g), k_hi = span_hi(q_last + off, g);
    begin = k_lo / KT;
    end = k_hi > k_lo ? (k_hi + KT - 1) / KT : begin;
  }
};

// Dv = rowsum(dO * O): one warp a (b, q, h) row; O is (B, Sq, H, D)
// contiguous, dO read through its strides; Dv is (B, H, Sq)
template <typename E>
__global__ void __launch_bounds__(DOT_THREADS)
bwd_dot(const E* __restrict__ dout, const E* __restrict__ out, float* __restrict__ dvec,
        int B, int Sq, int H, int D, long long dsb, long long dss, long long dsh) {
  const long long row = static_cast<long long>(blockIdx.x) * (DOT_THREADS / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(B) * Sq * H) return;
  const int h = static_cast<int>(row % H);
  const long long bq = row / H;
  const int q = static_cast<int>(bq % Sq);
  const int b = static_cast<int>(bq / Sq);
  const E* o = out + row * D;
  const E* go = dout + b * dsb + q * dss + h * dsh;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(go[d]), to_f(o[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) dvec[(static_cast<long long>(b) * H + h) * Sq + q] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

// consumer warpgroups of a block: the output columns are split over two
// at D = 256
__host__ __device__ constexpr int bf_groups(int D) { return D > 128 ? 2 : 1; }

template <int D>
constexpr int bf_smem_bytes() {
  // six 64-row operand tiles, the double-buffered rows' lse and Dv and the
  // keys' rows (dQ: the rows' spans), and slack to align the tiles to 1024
  // bytes
  return 6 * ((D + 63) / 64) * BLOCK_BYTES + 6 * TILE * 4 + 1024;
}

// rows row0 .. row0 + 63 gathered by two-byte loads and stored as whole
// 16-byte chunks, for rows that are not 16-byte aligned: out of line, as
// it runs rarely and would otherwise be inlined at every staging call
template <int D, int NCH, int NT>
__device__ __noinline__ void stage_bf16_gather(uint32_t dst, const __nv_bfloat16* src,
                                               long long rs, int row0, int n_rows, int tid) {
  for (int e = tid; e < 64 * NCH; e += NT) {
    const int r = e / NCH;
    const int c = e - r * NCH;
    const int row = row0 + r;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < n_rows && c < D / 8) {
      const uint16_t* gp = reinterpret_cast<const uint16_t*>(src + row * rs + c * 8);
      for (int i = 0; i < 4; ++i)
        w[i] = static_cast<uint32_t>(gp[2 * i]) | (static_cast<uint32_t>(gp[2 * i + 1]) << 16);
    }
    const uint32_t at = dst + (c >> 3) * BLOCK_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(w[0]),
                 "r"(w[1]), "r"(w[2]), "r"(w[3]));
  }
}

// 16-byte global -> shared copies of rows row0 .. row0 + 63 (stage_rows),
// or, where the rows are not 16-byte aligned, stage_bf16_gather
template <int D, int NCH, int NT>
__device__ __forceinline__ void stage_bf16(uint32_t dst, const __nv_bfloat16* src,
                                           long long rs, int row0, int n_rows, int tid) {
  if (((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(rs * 2)) & 15) == 0) {
    stage_rows<D, NCH, NT>(dst, src, rs, row0, n_rows, tid);
  } else {
    stage_bf16_gather<D, NCH, NT>(dst, src, rs, row0, n_rows, tid);
  }
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A fragments (four k16 steps of 16 columns) of a 64 x 64 accumulator,
// rounded to bf16: element 4 i + e sits at row r0 + 8 (e / 2), column
// 8 i + 2 (lane % 4) + e % 2.  The empty asm pins every fragment before
// the caller's wgmma fence: left alone, the compiler sinks the packing
// between the products that read it, and ptxas then has to fence each
// product again.
__device__ __forceinline__ void to_a_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// two 64 x 64 score products of one warpgroup, both operands K-major in
// shared memory: s = A1 B1^T, dp = A2 B2^T over the D (padded to 16) columns
template <int KS>
__device__ __forceinline__ void score_pair(float (&s)[32], float (&dp)[32], uint32_t a1,
                                           uint32_t b1, uint32_t a2, uint32_t b2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  fence_regs(s);  // the zeros are written before the fence
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t at = (kk >> 2) * BLOCK_BYTES + (kk & 3) * 32;
    wgmma_ss(s, sw128_desc(a1 + at, LBO_K), sw128_desc(b1 + at, LBO_K));
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t at = (kk >> 2) * BLOCK_BYTES + (kk & 3) * 32;
    wgmma_ss(dp, sw128_desc(a2 + at, LBO_K), sw128_desc(b2 + at, LBO_K));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

template <int D>
__global__ void __launch_bounds__(128 * bf_groups(D), D <= 64 ? 3 : 1)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Geo g,
              int KV) {
  constexpr int NW = bf_groups(D);
  constexpr int NT = 128 * NW;
  constexpr int DB = (D + 63) / 64;  // 64-column blocks of a row
  constexpr int DBW = DB / NW;       // of them, a warpgroup's output columns
  constexpr int KS = (D + 15) / 16;  // k16 steps over D
  constexpr int CH = 2 * KS;         // staged 16-byte chunks of a row
  constexpr int OP = DB * BLOCK_BYTES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + 6 * OP);
  int* seen_s = reinterpret_cast<int*>(rows_s + 256);
  const uint32_t sk = base;
  const uint32_t sv = base + OP;
  // buffer u: Q at base + (2 + 2 u) OP, dO right after it; lse and Dv of
  // its rows at rows_s[u * 128], rows_s[u * 128 + 64]; the positions of
  // the first and last rows that see key k0 + j at seen_s[j], seen_s[64 + j]

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int k0 = blockIdx.y * TILE;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const float inv_sk = 1.0f / static_cast<float>(g.Sk);
  const bool masked = g.window > 0 || g.chunk > 0;  // edge steps test spans

  stage_bf16<D, CH, NT>(sk, k + b * g.ksb + kvh * g.ksh, g.kss, k0, g.Sk, tid);
  stage_bf16<D, CH, NT>(sv, v + b * g.vsb + kvh * g.vsh, g.vss, k0, g.Sk, tid);
  if (tid < TILE) {
    const SeenBy sb(k0 + tid, g);
    seen_s[tid] = sb.first;
    seen_s[64 + tid] = sb.last;
  }

  // the (head, query tile) items that take part, heads outermost
  const QTiles tiles(k0, TILE, g);
  const int n_items = g.G * tiles.n;
  auto stage = [&](int u, int it) {
    const int gi = it / tiles.n;
    const int h = kvh * g.G + gi;
    const int q0 = tiles.at(it - gi * tiles.n) * TILE;
    const uint32_t sq = base + (2 + 2 * u) * OP;
    stage_bf16<D, CH, NT>(sq, q + b * g.qsb + h * g.qsh, g.qss, q0, g.Sq, tid);
    stage_bf16<D, CH, NT>(sq + OP, dout + b * g.dsb + h * g.dsh, g.dss, q0, g.Sq, tid);
    if (tid < TILE) {
      const int row = q0 + tid;
      const long long at = (static_cast<long long>(b) * g.H + h) * g.Sq + row;
      rows_s[u * 128 + tid] = row < g.Sq ? lse[at] * LOG2E : 0.0f;
      rows_s[u * 128 + 64 + tid] = row < g.Sq ? dvec[at] : 0.0f;
    }
  };
  if (n_items > 0) stage(0, 0);
  cp_commit();

  float adk[DBW][32], adv[DBW][32];
#pragma unroll
  for (int j = 0; j < DBW; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[j][i] = adv[j][i] = 0.0f;
    fence_regs(adk[j]);
    fence_regs(adv[j]);
  }

  const int key_r0 = k0 + 16 * warp + (lane >> 2);  // this thread's keys: +0, +8
  const int col = 2 * (lane & 3);
  const bool can_blind = g.causal || g.chunk > 0;  // a row at p < 0 sees no key
  for (int it = 0; it < n_items; ++it) {
    const int u = it & 1;
    if (it + 1 < n_items) stage(u ^ 1, it + 1);
    cp_commit();
    cp_wait_one();  // every group but the one just issued has landed
    fence_async_smem();
    __syncthreads();

    const uint32_t sq = base + (2 + 2 * u) * OP;
    const uint32_t sdo = sq + OP;
    const float* lse_s = rows_s + u * 128;  // lse * log2(e)
    const float* dv_s = lse_s + 64;
    const int q0 = tiles.at(it % tiles.n) * TILE;
    float s[32], dp[32];
    score_pair<KS>(s, dp, sk, sq, sv, sdo);  // S^T = K Q^T, dP^T = V dO^T
    auto elementwise = [&](auto open, auto local, auto cap) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * i + col + (e & 1);
          const int kl = key_r0 - k0 + 8 * (e >> 1);
          const int pos = q0 + ql + g.Sk - g.Sq;
          Vis vis;
          if constexpr (decltype(local)::value) {  // the key's rows [first, last]
            vis = {pos >= seen_s[kl] && pos <= seen_s[64 + kl], can_blind && pos < 0};
          } else {
            vis = {!g.causal || k0 + kl <= pos, g.causal && pos < 0};
          }
          pair<decltype(open)::value, decltype(cap)::value>(
              s[4 * i + e], dp[4 * i + e], q0 + ql < g.Sq && k0 + kl < g.Sk, vis.seen,
              vis.blind, lse_s[ql], dv_s[ql], g, inv_sk, s[4 * i + e], dp[4 * i + e]);
        }
    };
    dispatch_pairs(tile_open(q0, TILE, k0, TILE, g), masked, g.has_cap, elementwise);
    uint32_t pa[4][4], da[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    // dV += P^T dO, dK += dS^T Q: B = dO / Q, 16 query rows a step, MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < DBW; ++j) {
        const uint32_t at = (wg * DBW + j) * BLOCK_BYTES + kk * 16 * 128;
        wgmma_rs_mn(adv[j], pa[kk], sw128_desc(sdo + at, LBO_MN));
        wgmma_rs_mn(adk[j], da[kk], sw128_desc(sq + at, LBO_MN));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < DBW; ++j) {
      fence_regs(adv[j]);
      fence_regs(adk[j]);
    }
    __syncthreads();  // every warpgroup is done with buffer u
  }
  cp_wait_all();  // the K / V group of a block that saw no query tile

#pragma unroll
  for (int j = 0; j < DBW; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 64 * (wg * DBW + j) + 8 * i + col;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = key_r0 + 8 * rr;
        if (key >= g.Sk || d >= D) continue;
        const long long at = ((static_cast<long long>(b) * g.Sk + key) * KV + kvh) * D + d;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            adk[j][4 * i + 2 * rr] * g.scale, adk[j][4 * i + 2 * rr + 1] * g.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(adv[j][4 * i + 2 * rr], adv[j][4 * i + 2 * rr + 1]);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(128 * bf_groups(D), D <= 64 ? 3 : 1)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dvec,
            __nv_bfloat16* __restrict__ dq, Geo g, int KV) {
  constexpr int NW = bf_groups(D);
  constexpr int NT = 128 * NW;
  constexpr int DB = (D + 63) / 64;
  constexpr int DBW = DB / NW;
  constexpr int KS = (D + 15) / 16;
  constexpr int CH = 2 * KS;
  constexpr int OP = DB * BLOCK_BYTES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + OP;
  // buffer u: K at base + (2 + 2 u) OP, V right after it; the rows' spans'
  // lo and hi at span_s[0], span_s[64]
  int* span_s = reinterpret_cast<int*>(smem_raw + (base - smem_u32(smem_raw)) + 6 * OP);

  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x - b * g.H;
  const int kvh = h / g.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;  // the longest walks first
  const int q_last = min(q0 + TILE, g.Sq) - 1;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const float inv_sk = 1.0f / static_cast<float>(g.Sk);
  const bool masked = g.window > 0 || g.chunk > 0;  // edge steps test spans

  stage_bf16<D, CH, NT>(sq, q + b * g.qsb + h * g.qsh, g.qss, q0, g.Sq, tid);
  stage_bf16<D, CH, NT>(sdo, dout + b * g.dsb + h * g.dsh, g.dss, q0, g.Sq, tid);
  const __nv_bfloat16* kb = k + b * g.ksb + kvh * g.ksh;
  const __nv_bfloat16* vb = v + b * g.vsb + kvh * g.vsh;
  // the key tiles of the rows' spans: [kt.begin, kt.end)
  const KTiles<TILE> kt(q0, q_last, g);
  const int nk = kt.end - kt.begin;
  if (nk > 0) {
    stage_bf16<D, CH, NT>(base + 2 * OP, kb, g.kss, kt.begin * TILE, g.Sk, tid);
    stage_bf16<D, CH, NT>(base + 3 * OP, vb, g.vss, kt.begin * TILE, g.Sk, tid);
  }
  cp_commit();
  if (tid < TILE) {
    span_s[tid] = span_lo(q0 + tid + g.Sk - g.Sq, g);
    span_s[64 + tid] = span_hi(q0 + tid + g.Sk - g.Sq, g);
  }

  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: +0, +8
  const int col = 2 * (lane & 3);
  float lse_r[2], dv_r[2];  // lse * log2(e) and Dv of the rows
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    const long long at = (static_cast<long long>(b) * g.H + h) * g.Sq + row;
    lse_r[rr] = row < g.Sq ? lse[at] * LOG2E : 0.0f;
    dv_r[rr] = row < g.Sq ? dvec[at] : 0.0f;
  }
  float adq[DBW][32];
#pragma unroll
  for (int j = 0; j < DBW; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) adq[j][i] = 0.0f;
    fence_regs(adq[j]);
  }

  for (int t = 0; t < nk; ++t) {
    const int u = t & 1;
    if (t + 1 < nk) {
      const uint32_t nb = base + (2 + 2 * (u ^ 1)) * OP;
      stage_bf16<D, CH, NT>(nb, kb, g.kss, (kt.begin + t + 1) * TILE, g.Sk, tid);
      stage_bf16<D, CH, NT>(nb + OP, vb, g.vss, (kt.begin + t + 1) * TILE, g.Sk, tid);
    }
    cp_commit();
    cp_wait_one();
    fence_async_smem();
    __syncthreads();

    const uint32_t sk = base + (2 + 2 * u) * OP;
    const int k0 = (kt.begin + t) * TILE;
    float s[32], dp[32];
    score_pair<KS>(s, dp, sq, sk, sdo, sk + OP);  // S = Q K^T, dP = dO V^T
    auto elementwise = [&](auto open, auto local, auto cap) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          const int rl = r0 + 8 * rr;
          const int key = k0 + 8 * i + col + (e & 1);
          const Vis vis = row_vis<decltype(local)::value>(key, q0 + rl + g.Sk - g.Sq,
                                                          span_s[rl], span_s[64 + rl], g);
          pair<decltype(open)::value, decltype(cap)::value>(
              s[4 * i + e], dp[4 * i + e], q0 + rl < g.Sq && key < g.Sk, vis.seen, vis.blind,
              lse_r[rr], dv_r[rr], g, inv_sk, s[4 * i + e], dp[4 * i + e]);
        }
    };
    dispatch_pairs(tile_open(q0, TILE, k0, TILE, g), masked, g.has_cap, elementwise);
    uint32_t da[4][4];
    to_a_frags(dp, da);
    // dQ += dS K: B = K, 16 key rows a step, MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < DBW; ++j)
        wgmma_rs_mn(adq[j], da[kk],
                    sw128_desc(sk + (wg * DBW + j) * BLOCK_BYTES + kk * 16 * 128, LBO_MN));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < DBW; ++j) fence_regs(adq[j]);
    __syncthreads();  // every warpgroup is done with buffer u
  }
  cp_wait_all();

#pragma unroll
  for (int j = 0; j < DBW; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 64 * (wg * DBW + j) + 8 * i + col;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qpos = q0 + r0 + 8 * rr;
        if (qpos >= g.Sq || d >= D) continue;
        const long long at = ((static_cast<long long>(b) * g.Sq + qpos) * g.H + h) * D + d;
        *reinterpret_cast<__nv_bfloat162*>(dq + at) = __floats2bfloat162_rn(
            adq[j][4 * i + 2 * rr] * g.scale, adq[j][4 * i + 2 * rr + 1] * g.scale);
      }
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, register micro-tiles
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_KT = 32;  // keys a dK / dV block, keys a dQ step
constexpr int F_PS = TILE + 4;  // padded row of the P^T / dS^T tiles ([query][key] or [key][query])

__host__ __device__ constexpr int f_cols(int D) { return D < 64 ? 64 : D; }  // computed columns
__host__ __device__ constexpr int f_stride(int D) { return f_cols(D) + 4; }  // padded row

template <int D>
constexpr int f_dkdv_smem_bytes() {
  // K, V (32 rows); Q, dO (64 rows), lse, Dv, the rows' spans; P^T and
  // dS^T ([64 queries][36])
  return 4 * (2 * F_KT * f_stride(D) + 2 * TILE * (f_stride(D) + 2) + 2 * TILE * (F_KT + 4));
}

template <int D>
constexpr int f_dq_smem_bytes() {
  // Q, dO (64 rows), lse, Dv, the rows' spans; K, V (32 rows); dS^T
  // ([32 keys][68])
  return 4 * (2 * TILE * (f_stride(D) + 2) + 2 * F_KT * f_stride(D) + F_KT * F_PS);
}

// rows row0 .. row0 + NR - 1 of a (rows, D) f32 matrix (row stride rs)
// into a [NR][f_stride(D)] tile by 16-byte cp.async, every copy in flight
// at once (plain loads where the rows are not 16-byte aligned); columns
// past D and rows at or past n_rows are zero.  The caller commits and
// waits.
template <int D, int NR>
__device__ __forceinline__ void load_f32(float* dst, const float* src, long long rs, int row0,
                                         int n_rows, int tid) {
  constexpr int C4 = f_cols(D) / 4;
  constexpr int DS = f_stride(D);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(rs * 4)) & 15) == 0;
#pragma unroll 4
  for (int e = tid; e < NR * C4; e += F_THREADS) {
    const int r = e / C4;
    const int d = 4 * (e - r * C4);
    const int row = row0 + r;
    const bool ok = row < n_rows && d < D;
    const float* gp = ok ? src + row * rs + d : src;
    if (vec) {
      cp16(smem_u32(dst + r * DS + d), gp, ok);
    } else {
      *reinterpret_cast<float4*>(dst + r * DS + d) =
          ok ? make_float4(gp[0], gp[1], gp[2], gp[3]) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float at4(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// 4 x MB score pairs of a thread: s[i][m] = A[4 a0 + i] . B[b0 + 32 m] and
// dp[i][m] = A2[4 a0 + i] . B2[b0 + 32 m] over the first D columns of
// tiles with row stride f_stride(D)
template <int D, int MB>
__device__ __forceinline__ void f_scores(const float* A, const float* A2, const float* Bt,
                                         const float* B2, int a0, int b0, float (&s)[4][MB],
                                         float (&dp)[4][MB]) {
  constexpr int DS = f_stride(D);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < MB; ++m) s[i][m] = dp[i][m] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], bb[MB];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (4 * a0 + i) * DS + d);
#pragma unroll
    for (int m = 0; m < MB; ++m)
      bb[m] = *reinterpret_cast<const float4*>(Bt + (b0 + 32 * m) * DS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < MB; ++m) s[i][m] = dot4(a[i], bb[m], s[i][m]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A2 + (4 * a0 + i) * DS + d);
#pragma unroll
    for (int m = 0; m < MB; ++m)
      bb[m] = *reinterpret_cast<const float4*>(B2 + (b0 + 32 * m) * DS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < MB; ++m) dp[i][m] = dot4(a[i], bb[m], dp[i][m]);
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, D <= 128 ? 2 : 1)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dvec,
             float* __restrict__ dk, float* __restrict__ dv, Geo g, int KV) {
  constexpr int DS = f_stride(D);
  constexpr int NC = f_cols(D) / 64;  // float4 column groups a thread: 4 cg + 64 m
  constexpr int PS = F_KT + 4;
  extern __shared__ float smem[];
  float* ks = smem;                 // [32][DS]
  float* vs = ks + F_KT * DS;       // [32][DS]
  float* qs = vs + F_KT * DS;       // [64][DS]
  float* dos = qs + TILE * DS;      // [64][DS]
  float* lse_s = dos + TILE * DS;   // [64], lse * log2(e)
  float* dv_s = lse_s + TILE;       // [64]
  int* lo_s = reinterpret_cast<int*>(dv_s + TILE);  // [64], the rows' spans
  int* hi_s = lo_s + TILE;                          // [64]
  float* ps = reinterpret_cast<float*>(hi_s + TILE);  // P^T as [64 queries][PS]
  float* dss = ps + TILE * PS;      // dS^T as [64 queries][PS]

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int k0 = blockIdx.y * F_KT;
  const int tid = threadIdx.x;
  // scores: keys 4 kg + i, queries qg + 32 m; dK / dV: keys 2 kp + i,
  // columns 4 cg + 64 m
  const int kg = tid >> 5;
  const int qg = tid & 31;
  const int kp = tid >> 4;
  const int cg = tid & 15;
  const float inv_sk = 1.0f / static_cast<float>(g.Sk);
  const bool masked = g.window > 0 || g.chunk > 0;  // edge steps test spans

  load_f32<D, F_KT>(ks, k + b * g.ksb + kvh * g.ksh, g.kss, k0, g.Sk, tid);
  load_f32<D, F_KT>(vs, v + b * g.vsb + kvh * g.vsh, g.vss, k0, g.Sk, tid);

  float adk[2][NC][4], adv[2][NC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) adk[i][m][c] = adv[i][m][c] = 0.0f;

  cp_commit();
  // the (head, query tile) items that take part, heads outermost
  const QTiles tiles(k0, F_KT, g);
  for (int it = 0; it < g.G * tiles.n; ++it) {
    const int gi = it / tiles.n;
    const int h = kvh * g.G + gi;
    const int q0 = tiles.at(it - gi * tiles.n) * TILE;
    load_f32<D, TILE>(qs, q + b * g.qsb + h * g.qsh, g.qss, q0, g.Sq, tid);
    load_f32<D, TILE>(dos, dout + b * g.dsb + h * g.dsh, g.dss, q0, g.Sq, tid);
    cp_commit();
    if (tid < TILE) {
      const int row = q0 + tid;
      const long long at = (static_cast<long long>(b) * g.H + h) * g.Sq + row;
      lse_s[tid] = row < g.Sq ? lse[at] * LOG2E : 0.0f;
      dv_s[tid] = row < g.Sq ? dvec[at] : 0.0f;
      lo_s[tid] = span_lo(row + g.Sk - g.Sq, g);
      hi_s[tid] = span_hi(row + g.Sk - g.Sq, g);
    }
    cp_wait_all();  // this thread's copies
    __syncthreads();
    float s[4][2], dp[4][2];
    f_scores<D, 2>(ks, vs, qs, dos, kg, qg, s, dp);  // S^T = K Q^T, dP^T = V dO^T
    auto elementwise = [&](auto open, auto local, auto cap) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int ql = qg + 32 * m;
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 4 * kg + i;
          const Vis vis = row_vis<decltype(local)::value>(key, q0 + ql + g.Sk - g.Sq,
                                                          lo_s[ql], hi_s[ql], g);
          pair<decltype(open)::value, decltype(cap)::value>(
              s[i][m], dp[i][m], q0 + ql < g.Sq && key < g.Sk, vis.seen, vis.blind, lse_s[ql],
              dv_s[ql], g, inv_sk, p[i], ds[i]);
        }
        *reinterpret_cast<float4*>(ps + ql * PS + 4 * kg) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(dss + ql * PS + 4 * kg) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    };
    dispatch_pairs(tile_open(q0, TILE, k0, F_KT, g), masked, g.has_cap, elementwise);
    __syncthreads();
    // dV[key] += sum_r P[r, key] dO[r];  dK[key] += sum_r dS[r, key] Q[r]
    const int r_end = min(TILE, g.Sq - q0);
    for (int r = 0; r < r_end; ++r) {
      const float2 pv = *reinterpret_cast<const float2*>(ps + r * PS + 2 * kp);
      const float2 sv = *reinterpret_cast<const float2*>(dss + r * PS + 2 * kp);
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float4 ov = *reinterpret_cast<const float4*>(dos + r * DS + 4 * cg + 64 * m);
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * DS + 4 * cg + 64 * m);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float pi = i == 0 ? pv.x : pv.y, si = i == 0 ? sv.x : sv.y;
          adv[i][m][0] = fmaf(pi, ov.x, adv[i][m][0]);
          adv[i][m][1] = fmaf(pi, ov.y, adv[i][m][1]);
          adv[i][m][2] = fmaf(pi, ov.z, adv[i][m][2]);
          adv[i][m][3] = fmaf(pi, ov.w, adv[i][m][3]);
          adk[i][m][0] = fmaf(si, qv.x, adk[i][m][0]);
          adk[i][m][1] = fmaf(si, qv.y, adk[i][m][1]);
          adk[i][m][2] = fmaf(si, qv.z, adk[i][m][2]);
          adk[i][m][3] = fmaf(si, qv.w, adk[i][m][3]);
        }
      }
    }
    __syncthreads();  // every thread is done with the tiles, P^T and dS^T
  }
  cp_wait_all();  // the K / V copies of a block that saw no query tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * kp + i;
    if (key >= g.Sk) continue;
    const long long at = ((static_cast<long long>(b) * g.Sk + key) * KV + kvh) * D;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = 4 * cg + 64 * m;
      if (d >= D) continue;
      *reinterpret_cast<float4*>(dk + at + d) =
          make_float4(adk[i][m][0] * g.scale, adk[i][m][1] * g.scale, adk[i][m][2] * g.scale,
                      adk[i][m][3] * g.scale);
      *reinterpret_cast<float4*>(dv + at + d) =
          make_float4(adv[i][m][0], adv[i][m][1], adv[i][m][2], adv[i][m][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, D <= 128 ? 2 : 1)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dvec,
           float* __restrict__ dq, Geo g, int KV) {
  constexpr int DS = f_stride(D);
  constexpr int NC = f_cols(D) / 64;  // float4 column groups a thread: 4 dg + 64 m
  extern __shared__ float smem[];
  float* qs = smem;                 // [64][DS]
  float* dos = qs + TILE * DS;      // [64][DS]
  float* lse_s = dos + TILE * DS;   // [64], lse * log2(e)
  float* dv_s = lse_s + TILE;       // [64]
  int* lo_s = reinterpret_cast<int*>(dv_s + TILE);  // [64], the rows' spans
  int* hi_s = lo_s + TILE;                          // [64]
  float* ks = reinterpret_cast<float*>(hi_s + TILE);  // [32][DS]
  float* vs = ks + F_KT * DS;       // [32][DS]
  float* dst = vs + F_KT * DS;      // dS^T as [32 keys][F_PS]

  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x - b * g.H;
  const int kvh = h / g.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;  // the longest walks first
  const int q_last = min(q0 + TILE, g.Sq) - 1;
  const int tid = threadIdx.x;
  // scores: keys 4 kg + i, queries qg + 32 m; dQ: queries 4 qp + i, columns 4 dg + 64 m
  const int kg = tid >> 5;
  const int qg = tid & 31;
  const int qp = tid >> 4;
  const int dg = tid & 15;
  const float inv_sk = 1.0f / static_cast<float>(g.Sk);
  const bool masked = g.window > 0 || g.chunk > 0;  // edge steps test spans

  load_f32<D, TILE>(qs, q + b * g.qsb + h * g.qsh, g.qss, q0, g.Sq, tid);
  load_f32<D, TILE>(dos, dout + b * g.dsb + h * g.dsh, g.dss, q0, g.Sq, tid);
  if (tid < TILE) {
    const int row = q0 + tid;
    const long long at = (static_cast<long long>(b) * g.H + h) * g.Sq + row;
    lse_s[tid] = row < g.Sq ? lse[at] * LOG2E : 0.0f;
    dv_s[tid] = row < g.Sq ? dvec[at] : 0.0f;
    lo_s[tid] = span_lo(row + g.Sk - g.Sq, g);
    hi_s[tid] = span_hi(row + g.Sk - g.Sq, g);
  }

  float adq[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) adq[i][m][c] = 0.0f;

  // the key tiles of the rows' spans
  const KTiles<F_KT> kt(q0, q_last, g);
  const float* kb = k + b * g.ksb + kvh * g.ksh;
  const float* vb = v + b * g.vsb + kvh * g.vsh;
  cp_commit();
  for (int t = kt.begin; t < kt.end; ++t) {
    const int k0 = t * F_KT;
    load_f32<D, F_KT>(ks, kb, g.kss, k0, g.Sk, tid);
    load_f32<D, F_KT>(vs, vb, g.vss, k0, g.Sk, tid);
    cp_commit();
    cp_wait_all();  // this thread's copies
    __syncthreads();
    float s[4][2], dp[4][2];
    f_scores<D, 2>(ks, vs, qs, dos, kg, qg, s, dp);  // s[i][m] = K[4 kg + i] . Q[qg + 32 m]
    auto elementwise = [&](auto open, auto local, auto cap) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int ql = qg + 32 * m;
          float p, ds;
          const int key = k0 + 4 * kg + i;
          const Vis vis = row_vis<decltype(local)::value>(key, q0 + ql + g.Sk - g.Sq,
                                                          lo_s[ql], hi_s[ql], g);
          pair<decltype(open)::value, decltype(cap)::value>(
              s[i][m], dp[i][m], q0 + ql < g.Sq && key < g.Sk, vis.seen, vis.blind, lse_s[ql],
              dv_s[ql], g, inv_sk, p, ds);
          dst[(4 * kg + i) * F_PS + ql] = ds;
        }
    };
    dispatch_pairs(tile_open(q0, TILE, k0, F_KT, g), masked, g.has_cap, elementwise);
    __syncthreads();
    // dQ[r] += sum_c dS[r, c] K[c]
    const int c_end = min(F_KT, g.Sk - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 sv = *reinterpret_cast<const float4*>(dst + c * F_PS + 4 * qp);
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + c * DS + 4 * dg + 64 * m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float si = at4(sv, i);
          adq[i][m][0] = fmaf(si, kv.x, adq[i][m][0]);
          adq[i][m][1] = fmaf(si, kv.y, adq[i][m][1]);
          adq[i][m][2] = fmaf(si, kv.z, adq[i][m][2]);
          adq[i][m][3] = fmaf(si, kv.w, adq[i][m][3]);
        }
      }
    }
    __syncthreads();  // every thread is done with K, V and dS^T
  }
  cp_wait_all();  // the Q / dO copies of a block that saw no key tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * qp + i;
    if (qpos >= g.Sq) continue;
    const long long at = ((static_cast<long long>(b) * g.Sq + qpos) * g.H + h) * D;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = 4 * dg + 64 * m;
      if (d >= D) continue;
      *reinterpret_cast<float4*>(dq + at + d) =
          make_float4(adq[i][m][0] * g.scale, adq[i][m][1] * g.scale, adq[i][m][2] * g.scale,
                      adq[i][m][3] * g.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* dvec;
  void *dq, *dk, *dv;
};

template <int D>
int launch_bf16(const Ptrs& p, int B, int KV, const Geo& g, cudaStream_t s) {
  using E = __nv_bfloat16;
  const int threads = 128 * bf_groups(D), smem = bf_smem_bytes<D>();
  static bool ready = false;  // the shared-memory attribute, once per instance
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  const E* dout = static_cast<const E*>(p.dout);
  // dK / dV: a block per (sequence, KV head, 64-key tile); dQ: a block per
  // (sequence, head, 64-query tile)
  bwd_dkdv_bf16<D><<<dim3(B * KV, (g.Sk + TILE - 1) / TILE), threads, smem, s>>>(
      q, k, v, dout, p.lse, p.dvec, static_cast<E*>(p.dk), static_cast<E*>(p.dv), g, KV);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_bf16<D><<<dim3(B * g.H, (g.Sq + TILE - 1) / TILE), threads, smem, s>>>(
      q, k, v, dout, p.lse, p.dvec, static_cast<E*>(p.dq), g, KV);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Ptrs& p, int B, int KV, const Geo& g, cudaStream_t s) {
  const int smem_dkdv = f_dkdv_smem_bytes<D>(), smem_dq = f_dq_smem_bytes<D>();
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_dq);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  // dK / dV: a block per (sequence, KV head, F_KT-key tile); dQ: a block
  // per (sequence, head, 64-query tile)
  bwd_dkdv_f32<D><<<dim3(B * KV, (g.Sk + F_KT - 1) / F_KT), F_THREADS, smem_dkdv, s>>>(
      q, k, v, dout, p.lse, p.dvec, static_cast<float*>(p.dk), static_cast<float*>(p.dv), g,
      KV);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_f32<D><<<dim3(B * g.H, (g.Sq + TILE - 1) / TILE), F_THREADS, smem_dq, s>>>(
      q, k, v, dout, p.lse, p.dvec, static_cast<float*>(p.dq), g, KV);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int dtype, const Ptrs& p, int B, int KV, const Geo& g, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * g.Sq * g.H;
  const unsigned dot_blocks =
      static_cast<unsigned>((rows + DOT_THREADS / 32 - 1) / (DOT_THREADS / 32));
  if (dtype == 1) {
    bwd_dot<__nv_bfloat16><<<dot_blocks, DOT_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p.dout), static_cast<const __nv_bfloat16*>(p.out),
        p.dvec, B, g.Sq, g.H, D, g.dsb, g.dss, g.dsh);
  } else {
    bwd_dot<float><<<dot_blocks, DOT_THREADS, 0, s>>>(
        static_cast<const float*>(p.dout), static_cast<const float*>(p.out), p.dvec, B, g.Sq,
        g.H, D, g.dsb, g.dss, g.dsh);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return dtype == 1 ? launch_bf16<D>(p, B, KV, g, s) : launch_f32<D>(p, B, KV, g, s);
}

}  // namespace

// q: (B, Sq, H, D), k / v: (B, Sk, KV, D), dout: (B, Sq, H, D), read through
// their batch / sequence / head strides (in elements; the last axis
// contiguous); out: the forward's output (B, Sq, H, D) contiguous; lse:
// (B, H, Sq) f32 from the forward; dvec: (B, H, Sq) f32 scratch; dq / dk /
// dv: contiguous outputs in the inputs' dtype (0 = float32, 1 = bfloat16);
// window / chunk: the forward's masks' widths, 0 for none.
// Launches bwd_dot, the dK / dV kernel and the dQ kernel of the dtype, in
// that order, on `stream`.  Returns 0 on success, -1 for an unsupported
// head size or dtype, else the first failed launch's cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const float* lse, float* dvec, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
    int H, int KV, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long dsb, long long dss, long long dsh, int causal, int window, int chunk,
    int has_cap, float softcap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || KV <= 0 || H % KV || window < 0 || chunk < 0) return -1;
  const Ptrs p{q, k, v, out, dout, lse, dvec, dq, dk, dv};
  const Geo g{Sq, Sk, H, H / KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
              dsb, dss, dsh, causal, window, chunk, has_cap, softcap,
              1.0f / sqrtf(static_cast<float>(D)),
              LOG2E / sqrtf(static_cast<float>(D)), has_cap ? 1.0f / softcap : 0.0f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_d<8>(dtype, p, B, KV, g, s);
    case 16: return launch_d<16>(dtype, p, B, KV, g, s);
    case 32: return launch_d<32>(dtype, p, B, KV, g, s);
    case 64: return launch_d<64>(dtype, p, B, KV, g, s);
    case 128: return launch_d<128>(dtype, p, B, KV, g, s);
    case 256: return launch_d<256>(dtype, p, B, KV, g, s);
    default: return -1;
  }
}
