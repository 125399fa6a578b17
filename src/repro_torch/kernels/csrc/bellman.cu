// Banded RVI Bellman backup for Hopper (sm_90a), IEEE f32 on CUDA cores.
//
//   G[n, t, a] = sum_k pmfs[n, a, k] * h[n, t + k] + tails[n, t, a] * hso[n]
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bellman.py:
// bellman_banded (_kernel) and bellman_banded_batched (_kernel_batched).
// One __global__ serves both: the spec index is blockIdx.z, and the scalar
// wrapper launches it with n_specs = 1.  h is read up to h_len and as zero
// past it (h_len >= T + K - 1).
//
// Design.  A block owns TB base states of one spec and every action (up to
// A_TILE = 66; a larger A loops over action tiles inside the block).  Warp
// w owns actions [3 w, 3 w + 3) of the tile.  A warp's 32 lanes are TW
// t-groups x SW k-slices (TW * SW = 32); lane (g, s) keeps a 5 x 3 register
// tile -- base states t0 + 5 g + r, r < 5, by the warp's 3 actions -- and
// sums the k of slice s of every staged chunk.  SW, the split, is the
// wrapper's _split_plan of the shapes and the SM count; TB = 5 TW.
//
// What the first design lost time on, and what this one does about it:
// * Tiles of 32 actions walked padding (at A = 33 the second action tile
//   had one live action; at A = 9 two of four warps idled).  Here actions
//   are padded only to RA = 3, and 33 = 11 x 3 and 9 = 3 x 3: no padding on
//   either path, every warp has actions.
// * The card was mostly empty (6 blocks at the Table-I shape, 4 warps a
//   block).  Here the split shrinks the t tile and spreads k over lanes: at
//   the Table-I shape SW = 32 gives 26 blocks of 11 warps, 5 k steps a lane.
// * Staging was serial, 4 bytes a load, an integer divide per pmf element,
//   two barriers a chunk with no copy in flight during the FMAs, and a
//   whole restage for K = 129's last k.  Here the pmf rows, the h run and
//   the tails tile arrive by 16-byte cp.async (4-byte ones for a run's
//   unaligned head and tail words; each run lands at the same address mod 16
//   as in device memory, so the wrapper copies nothing).  When one chunk
//   covers K (K <= 256: every path) the pmf rows of the tile are one
//   contiguous run, and so is the tails tile when it spans all of A; each
//   is staged flat, a few 16-byte units a thread, no divide.  Wider K goes
//   in 256-wide chunks through a two-stage ring (chunk c + 1 in flight
//   while chunk c feeds the FMAs); the last chunk is staged at its own
//   width.  G leaves through the tails tile in coalesced stores.
// * 2 + 8 shared loads fed 16 FMAs.  Here a lane's 5 base states are
//   consecutive, so its window h[t + k .. t + k + 4] slides by one register
//   a step: one h load and 3 pmf loads feed 15 FMAs (5 a pmf load, 15 the
//   h load).  Bank-conflict-free: a slice is L = ceil(w / SW) | 1 steps
//   (odd), so the SW slices of a warp read one pmf row at offsets s L in SW
//   distinct banks, lanes of a slice read the same word (a broadcast), and
//   with SW = 1 the 32 t-groups read h at stride 5, odd, in 32 banks.
//
// The partial sums of the SW slices of a t-group are reduced once, by a
// butterfly of __shfl_xor_sync (step m adds slice s ^ m) in a fixed order:
// IEEE addition commutes, so every lane ends with the same sum, and there
// are no atomics: a run is deterministic.  Products and sums are IEEE f32
// (fmaf; no TF32, no tensor cores); the tail term is __fadd_rn(acc,
// __fmul_rn(tail, hso)).  The sum order is that of the split (slices in k
// order chunk after chunk, then the butterfly), and a batched launch may
// plan another split than N scalar ones: the two agree to rounding (held
// at 1e-5 / 1e-6), not bit for bit.  The kernel and its plain version
// agree at 1e-4 / 1e-5.
//
// Bound on an H100 SXM: 2 T A K flops over (T + K + A K + 2 T A) * 4 bytes.
// At the Table-I shape T = K = 129, A = 33 that is 0.000017 ms (operations)
// -- far under a launch, so the time there is latency.  At T = K = 4097,
// A = 33, 0.016539 ms (operations).  Times from chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md, section 6): 129 x 33 x 129 0.0035 ms
// (the first design 0.0114; an empty kernel on the same grid 0.0010);
// 4097 x 33 x 4097 0.079 ms (first design: 0.213), where 15 FMAs per 4
// shared loads make the loop shared-memory bound and the plan's 103 blocks
// leave 29 SMs idle; the sweep's 17 x 129 x 33 x 56 0.0036 ms (0.0089); the
// bank's 108 x 129 x 33 x 66 0.0069 ms (0.0229).  ptxas: 58 registers a
// thread, no spills; dynamic shared memory 18,688 B a block at the Table-I
// shape, 76,800 B at 4097 (two stages).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kernels/bellman.py repeats these constants and geometry()'s tile, chunk
// and slice arithmetic; tests/test_torch_bellman.py holds the two in step.
constexpr int RT = 5;                   // consecutive base states per lane
constexpr int RA = 3;                   // actions per lane (and per warp)
constexpr int MAX_WARPS = 22;           // warps per block: one per RA actions
constexpr int A_TILE = RA * MAX_WARPS;  // actions per block tile (66)
constexpr int KC = 256;                 // widest staged k chunk

// The launch's geometry, computed once on the host (no divides in the kernel).
struct Geometry {
  int sw_log2, tb, kc, n_chunks, stages, rows, sp, hs, rs, threads, grid_x;
  size_t smem;
};

Geometry geometry(int T, int A, int K, int sw_log2) {
  Geometry g;
  g.sw_log2 = sw_log2;
  g.tb = (32 >> sw_log2) * RT;
  g.kc = K < KC ? (K > 0 ? K : 1) : KC;
  g.n_chunks = (K + g.kc - 1) / g.kc;
  g.stages = g.n_chunks > 1 ? 2 : 1;
  const int warps = ((A < A_TILE ? A : A_TILE) + RA - 1) / RA;
  g.rows = warps * RA;
  g.sp = (g.kc + 3 + 3) & ~3;             // a pmf row: kc words + a 0..3 offset
  g.hs = (g.tb + g.kc - 1 + 3 + 3) & ~3;  // the h run + a 0..3 offset
  g.rs = (g.rows + 3 + 3) & ~3;           // a row of the tails / G tile
  g.threads = 32 * warps;
  g.grid_x = (T + g.tb - 1) / g.tb;
  g.smem = sizeof(float) * (static_cast<size_t>(g.stages) * (g.rows * g.sp + g.hs) +
                            static_cast<size_t>(g.tb) * g.rs);
  return g;
}

// Copies into shared memory take the shared-window address of the word:
// sbase + 4 * word, sbase converted once per thread.
// 16-byte copy of which the first `bytes` come from src, the rest zero-filled.
__device__ __forceinline__ void cp16(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src));
}

__device__ __forceinline__ int words_off16(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Stage `len` words from src into smem word dst + words_off16(src) (the
// same address mod 16), reading only the first `valid` of them and
// zero-filling the rest; sbase is the shared-window address of smem word 0.
// The 16-byte units go first (this thread takes units first, first +
// stride, ...), then the up to 3 head and 3 tail words of the run.
__device__ __forceinline__ void stage_run(float* smem, unsigned sbase, int dst,
                                          const float* src, int len, int valid,
                                          const float* safe, int first, int stride) {
  const int off = words_off16(src);
  dst += off;
  const int head = min(len, (4 - off) & 3);
  const int n16 = (len - head) >> 2;
  for (int u = first; u < n16; u += stride) {
    const int i = head + 4 * u;
    const int live = min(max(valid - i, 0), 4);
    cp16(sbase + 4u * (dst + i), live > 0 ? src + i : safe, 4 * live);
  }
  for (int v = first; v < 6; v += stride) {
    const int i = v < 3 ? v : head + 4 * n16 + v - 3;
    if (v < 3 ? i < head : i < len) {
      if (i < valid) cp4(sbase + 4u * (dst + i), src + i); else smem[dst + i] = 0.0f;
    }
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__global__ void __launch_bounds__(32 * MAX_WARPS)
bellman_banded_kernel(const float* __restrict__ h, const float* __restrict__ pmfs,
                      const float* __restrict__ tails, const float* __restrict__ hso,
                      float* __restrict__ out, int T, int A, int K, int h_len,
                      const Geometry geo) {
  extern __shared__ __align__(16) float smem[];
  const int sw_log2 = geo.sw_log2;
  const int n = blockIdx.z;
  const int t0 = blockIdx.x * geo.tb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sw = 1 << sw_log2;
  const int g = lane >> sw_log2;  // t-group of this lane in the warp
  const int s = lane & (sw - 1);  // k slice of this lane
  const int n_warps = blockDim.x >> 5;
  const int stage_words = geo.rows * geo.sp + geo.hs;
  const float* hn = h + static_cast<size_t>(n) * h_len;
  const float so = hso[n];

  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int tile_w = geo.stages * stage_words;  // the tile: tails in, G out

  for (int a0 = 0; a0 < A; a0 += geo.rows) {
    const int a_t = min(geo.rows, A - a0);
    const int n_t = min(geo.tb, T - t0);  // live rows of the tile
    const float* pn = pmfs + (static_cast<size_t>(n) * A + a0) * K;
    const float* tn = tails + (static_cast<size_t>(n) * T + t0) * A + a0;
    float* on = out + (static_cast<size_t>(n) * T + t0) * A + a0;
    int row[RA];  // the pmf rows this warp reads (padding repeats the last)
#pragma unroll
    for (int j = 0; j < RA; ++j) row[j] = min(warp * RA + j, a_t - 1);

    // A chunk that spans all of K (every chunk of a single-chunk K) is one
    // contiguous run of the pmf rows, staged flat with row stride K; a
    // narrower chunk goes row by row, row stride sp.  Likewise the tails
    // tile is one run (row stride A) when the action tile spans all of A.
    const bool flat_p = geo.n_chunks == 1;
    const bool flat_t = a_t == A;
    auto stage = [&](int c) {
      const int base = (c & (geo.stages - 1)) * stage_words;
      const int c0 = c * geo.kc;
      const int w = min(geo.kc, K - c0);
      if (flat_p) {
        stage_run(smem, sbase, base, pn, a_t * K, a_t * K, pn, threadIdx.x, blockDim.x);
      } else {
        for (int r = warp; r < a_t; r += n_warps)
          stage_run(smem, sbase, base + r * geo.sp, pn + static_cast<size_t>(r) * K + c0, w,
                    w, pn, lane, 32);
      }
      const int run = geo.tb + w - 1;
      stage_run(smem, sbase, base + geo.rows * geo.sp, hn + t0 + c0, run,
                min(max(h_len - (t0 + c0), 0), run), hn, threadIdx.x, blockDim.x);
    };
    // smem word of the tail / G of (tile row tb, action a)
    auto slot = [&](int tb, int a) {
      return flat_t ? tile_w + words_off16(tn) + tb * A + a
                    : tile_w + tb * geo.rs + words_off16(tn + static_cast<size_t>(tb) * A) + a;
    };

    // the tails tile rides with the first chunk
    if (flat_t) {
      stage_run(smem, sbase, tile_w, tn, n_t * A, n_t * A, tn, threadIdx.x, blockDim.x);
    } else {
      for (int r = warp; r < n_t; r += n_warps)
        stage_run(smem, sbase, tile_w + r * geo.rs, tn + static_cast<size_t>(r) * A, a_t,
                  a_t, tn, lane, 32);
    }
    if (geo.n_chunks > 0) stage(0);
    commit();

    float acc[RT][RA];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < RA; ++j) acc[r][j] = 0.0f;

    for (int c = 0; c < geo.n_chunks; ++c) {
      if (c + 1 < geo.n_chunks) {
        stage(c + 1);
        commit();
        wait_group<1>();
      } else {
        wait_group<0>();
      }
      __syncthreads();
      const int base = (c & (geo.stages - 1)) * stage_words;
      const int c0 = c * geo.kc;
      const int w = min(geo.kc, K - c0);
      const int L = ((w + sw - 1) >> sw_log2) | 1;
      const int ks = s * L;
      const int len = min(ks + L, w) - ks;
      if (len > 0) {
        // word offsets into smem (indexing smem itself keeps the loads LDS)
        const int hp = base + geo.rows * geo.sp + words_off16(hn + t0 + c0) + g * RT + ks;
        int pp[RA];
#pragma unroll
        for (int j = 0; j < RA; ++j)
          pp[j] = flat_p ? base + words_off16(pn) + row[j] * K + ks
                         : base + row[j] * geo.sp +
                               words_off16(pn + static_cast<size_t>(row[j]) * K + c0) + ks;
        float win[RT];
#pragma unroll
        for (int r = 0; r < RT - 1; ++r) win[r] = smem[hp + r];
#pragma unroll 4
        for (int kk = 0; kk < len; ++kk) {
          win[RT - 1] = smem[hp + kk + RT - 1];
          float p[RA];
#pragma unroll
          for (int j = 0; j < RA; ++j) p[j] = smem[pp[j] + kk];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int j = 0; j < RA; ++j) acc[r][j] = fmaf(p[j], win[r], acc[r][j]);
#pragma unroll
          for (int r = 0; r < RT - 1; ++r) win[r] = win[r + 1];
        }
      }
      __syncthreads();  // this stage is free for chunk c + 2
    }
    if (geo.n_chunks == 0) {
      wait_group<0>();
      __syncthreads();
    }

    // reduce the k slices of each t-group: a butterfly, the same on every lane
    for (int m = 1; m < sw; m <<= 1)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < RA; ++j)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], m);

    // G = acc + tail * hso, in place of the tail in the tile ...
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int tb = g * RT + r;
#pragma unroll
      for (int j = 0; j < RA; ++j) {
        const int a = warp * RA + j;
        if (((r * RA + j) & (sw - 1)) == s && tb < n_t && a < a_t) {
          const int w = slot(tb, a);
          smem[w] = __fadd_rn(acc[r][j], __fmul_rn(smem[w], so));
        }
      }
    }
    __syncthreads();
    // ... and out in coalesced runs
    if (flat_t) {
      const int w0 = slot(0, 0);
      for (int i = threadIdx.x; i < n_t * A; i += blockDim.x) on[i] = smem[w0 + i];
    } else {
      for (int r = warp; r < n_t; r += n_warps) {
        const int w0 = slot(r, 0);
        for (int a = lane; a < a_t; a += 32) on[static_cast<size_t>(r) * A + a] = smem[w0 + a];
      }
    }
    __syncthreads();  // the tile and the stages are free for the next action tile
  }
}

int log2_split(int split) {
  for (int l = 0; l <= 5; ++l)
    if ((1 << l) == split) return l;
  return -1;
}

}  // namespace

// Launch geometry of the kernel: out[0..4] = grid.x, grid.y, grid.z, threads
// per block, dynamic shared memory bytes.  Returns 0, or cudaErrorInvalidValue
// for a split that is not 1, 2, 4, ..., 32.
extern "C" int bellman_banded_geometry(int n_specs, int T, int A, int K, int split,
                                       long long* out) {
  const int l = log2_split(split);
  if (l < 0 || n_specs <= 0 || T <= 0 || A <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(T, A, K, l);
  out[0] = g.grid_x;
  out[1] = 1;
  out[2] = n_specs;
  out[3] = g.threads;
  out[4] = static_cast<long long>(g.smem);
  return 0;
}

// h: (n_specs, h_len), pmfs: (n_specs, A, K), tails: (n_specs, T, A),
// hso: (n_specs,), out: (n_specs, T, A); all f32, contiguous, on one card.
// split: the k slices of a warp (1, 2, 4, ..., 32; kernels/bellman.py's
// _split_plan).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bellman_banded_launch(const float* h, const float* pmfs,
                                     const float* tails, const float* hso,
                                     float* out, int n_specs, int T, int A,
                                     int K, int h_len, int split, void* stream) {
  if (n_specs <= 0 || T <= 0 || A <= 0) return 0;
  const int l = log2_split(split);
  if (l < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(T, A, K, l);
  if (g.smem > 48 * 1024) {  // above 48 KB only after opting in (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        bellman_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(g.grid_x, 1, n_specs);
  bellman_banded_kernel<<<grid, g.threads, g.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      h, pmfs, tails, hso, out, T, A, K, h_len, g);
  return static_cast<int>(cudaGetLastError());
}
