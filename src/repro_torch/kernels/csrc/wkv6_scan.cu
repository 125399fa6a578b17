// WKV6 recurrence of an RWKV6 (Finch) time-mix block for Hopper (sm_90a),
// IEEE f32 on the CUDA cores, f32 or bf16 r / k / v.
//
// Counterpart of the lax.scan of rwkv6_time_mix's `step`,
// src/repro/models/layers.py:599-627 (a scan, not a Pallas kernel; no TPU
// kernel is replaced, and PyTorch has no scan).  Per sequence b and head h,
// with a P x P f32 state S (the incoming state, or zeros) and per step t:
//
//   y_t[j]   = sum_i r_t[i] (S[i, j] + u[h, i] k_t[i] v_t[j])
//   S[i, j] <- w_t[i] S[i, j] + k_t[i] v_t[j]
//
// computed as y_t[j] = sum_g (sum_{i in group g} r_t[i] S[i, j]) + a_t v_t[j]
// with a_t = sum_i r_t[i] u[h, i] k_t[i]: the bonus is rank 1.
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
// flops per state entry a step (r^T S into y; w S + k v^T) and 5 a channel
// for the bonus.  At the RWKV6-3B serving path's prefill (b = 8, 128
// tokens, 40 heads of 64, bf16 r / k / v, the cache's state read and
// written) that is 0.85 GFLOP (0.0127 ms) over 47.2 MB (0.0141 ms): bound
// by bytes; the decode step (one token) reads and writes 5.2 MB of f32
// state: 0.0032 ms of bytes.  On the CUDA cores the 5 flops are 3
// instructions an entry (k v, then two FMAs): 0.0152 ms of issue at the
// path's prefill, the floor of any design that stays in IEEE f32 here.  No
// chain floor is needed: the walk's dependent chain is one FMA a step per
// state entry (~128 x 4 cycles at S = 128, under 0.0003 ms).
//
// Design (the first design, a block per head with four threads on each
// column loading a 16-byte (r, k, w) per state entry a step, took 0.1215 ms
// at the path's bf16 prefill; this one 0.0406-0.0411, tools/wkv6_ab.py on
// an H100 80GB HBM3 at 700 W, PERF.md section 6):
//
//   * a register tile of R rows x C columns a thread (8 x 4 at P = 64),
//     held for the whole walk: a step's r, k, w of the R rows and v of the
//     C columns are vector loads from shared memory that serve 3 R C
//     instructions.  Columns run across the lanes of a row group (LG = CW /
//     C lanes), row groups across warps; a block takes CW columns of one
//     head (P / CW blocks a head: 640 of 64 threads at the path's prefill,
//     80 at b = 1), each reading and writing only its own columns, so the
//     state may be updated in place; it is read and written as float4s;
//   * y without a shuffle tree a step: each row group stores its partial
//     sum of r^T S for its columns; after the tile's walk (one barrier)
//     eight lanes a step add the G partials in group order, then
//     a_t v_t[j] with a_t = sum_i r_i u_i k_i summed over their rows and
//     three xor shuffles, and store y as float4 rows;
//   * staging overlapped with the walk: a ring of three tile slots filled
//     by cp.async (16-byte copies at offsets fixed per thread) -- the tile
//     walked, the next landing, and the one after issued as the walk
//     starts; the y pass reads r, k, v of its own slot.  bf16 stays bf16 in
//     shared memory and is upcast exactly (its bits are the f32's upper
//     half) as it is read;
//   * decode (S = 1) is the same kernel: one tile, one float4 read and
//     write of the state a thread row.
//
// Tried and dropped (tools/wkv6_ab.py, the same card, PERF.md section 6):
// one column a thread with the rows across warps (C = 1, R = 16; r, k, w
// upcast into shared memory from registers) 0.0842 ms: broadcast float4
// loads cost a thread 12 bytes of shared memory per entry a step; one warp
// a step summing y by a shuffle tree 0.0518; copies issued by loops with
// per-copy index arithmetic 0.0455; r, k, v upcast once a tile into shared
// memory 0.0410 (no gain); tiles of 4 or 16 steps 0.0461 / 0.0431; 4 x 4
// and 8 x 2 tiles 0.0422 / 0.0439; 8 x 4 over a whole head (320 blocks)
// 0.0449; 8 x 8 and 16 x 4 0.0485 / 0.0538 (167-168 registers).
//
// What bounds it now (inferred, not measured: ncu does not run there): by
// the source's count a warp issues ~124 instructions a step (96 FP32, 20
// bf16 upcasts, 6 shared-memory accesses) and ~170 a tile for the staging
// and the y pass; 1280 warps on 528 schedulers put 3 on some against 2.4 on
// average, so the busiest schedulers issue ~0.028 ms of the 0.041 (at
// 1.98 GHz; the clock is not measured), the rest being latency (shared
// loads ahead of the FMAs, the y pass's shuffles and barriers) that 2-3
// warps a scheduler do not hide.  Tiles that balance the schedulers (4 x
// 4: 4.85 warps each) load more per entry and land at the same time.
//
// Instances (P: R x C a thread, CW columns a block, G row groups, NW warps;
// T = 8 steps a tile): 64: 8 x 4, 32, 8, 2; 32: 8 x 4, 32, 4, 1; 16: 4 x 2,
// 16, 4, 1.  ptxas (sm_90a, CUDA 12.8): bf16 64 / 32 / 16: 127 / 116 / 62
// registers, f32: 117 / 96 / 64; no spill, no stack frame; dynamic shared
// memory bf16 22016 / 11776 / 5888 bytes, f32 29696 / 16384 / 8192.
// The row groups G = P / R of each instance are mirrored by ROW_GROUPS in
// wkv6_scan.py (the CPU mirror of the kernel's split): keep them in step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 8;     // steps a tile
constexpr int RING = 3;  // tile slots: walked (then read by the y pass), landed, in flight

template <int P>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int R = 8, C = 4, CW = 32;  // rows and columns a thread, columns a block
};
template <>
struct Shape<32> {
  static constexpr int R = 8, C = 4, CW = 32;
};
template <>
struct Shape<16> {
  static constexpr int R = 4, C = 2, CW = 16;
};

template <typename In, int P>
struct Layout {
  static constexpr int R = Shape<P>::R, C = Shape<P>::C, CW = Shape<P>::CW;
  static constexpr int G = P / R;              // row groups
  static constexpr int LG = CW / C;            // lanes of a row group
  static constexpr int GW = 32 / LG;           // row groups a warp
  static constexpr int NW = G / GW;            // warps a block
  static constexpr int NT = 32 * NW;           // threads
  static constexpr int NS = P / CW;            // blocks a head
  static constexpr int LY = 8;                 // y pass: lanes a step
  static constexpr int RY = P / LY;            // y pass: rows of a_t a lane
  static constexpr int CY = CW / LY;           // y pass: columns a lane
  static constexpr int SY = NT / LY;           // y pass: steps at a time
  // a ring slot, in bytes: r, k [T][P] and v [T][CW] as given, w [T][P] f32
  static constexpr int RB = P * sizeof(In), WB = P * 4, VB = CW * sizeof(In);
  static constexpr int SLOT = T * (2 * RB + WB + VB);
  // shared memory: the ring, then the partial sums of y [T][G][CW] f32
  static constexpr int SMEM = RING * SLOT + T * G * CW * 4;
  static_assert(P % R == 0 && CW % C == 0 && P % CW == 0 && 32 % LG == 0, "tiles");
  static_assert(G % GW == 0 && NW >= 1, "whole warps of row groups");
  static_assert(RB % 16 == 0 && VB % 16 == 0, "16-byte rows for cp.async");
  static_assert((R * sizeof(In)) % 4 == 0 && (C * sizeof(In)) % 4 == 0, "vector reads");
  static_assert(P % LY == 0 && CW % LY == 0 && (RY * sizeof(In)) % 4 == 0 &&
                    (CY * sizeof(In)) % 4 == 0, "y pass");
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// bf16 -> f32 is exact: the bf16 bits are the f32's upper half
__device__ __forceinline__ float lo_bf16(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// N consecutive values as f32, in the widest loads the alignment (N values
// from an N-aligned index) allows
template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = x.x, o[4 * q + 1] = x.y, o[4 * q + 2] = x.z, o[4 * q + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      o[2 * q] = x.x, o[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = p[q];
  }
}
template <int N>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[q];
      const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[8 * q + 2 * e] = lo_bf16(wd[e]);
        o[8 * q + 2 * e + 1] = hi_bf16(wd[e]);
      }
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      o[4 * q] = lo_bf16(x.x), o[4 * q + 1] = hi_bf16(x.x);
      o[4 * q + 2] = lo_bf16(x.y), o[4 * q + 3] = hi_bf16(x.y);
    }
  } else {
    static_assert(N % 2 == 0, "bf16 pairs");
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const uint32_t x = reinterpret_cast<const uint32_t*>(p)[q];
      o[2 * q] = lo_bf16(x), o[2 * q + 1] = hi_bf16(x);
    }
  }
}

// N f32 to global or shared memory in the widest stores the alignment allows
template <int N>
__device__ __forceinline__ void stv(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(x[2 * q], x[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = x[q];
  }
}

template <typename In, int P>
__global__ void __launch_bounds__(Layout<In, P>::NT)
wkv6_kernel(const In* __restrict__ r, const In* __restrict__ k, const In* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* state_in, float* __restrict__ y, float* state_out, int S,
            int H) {
  using L = Layout<In, P>;
  constexpr int R = L::R, C = L::C, CW = L::CW, G = L::G;
  extern __shared__ float4 smem4[];
  char* const ring = reinterpret_cast<char*>(smem4);
  float* const part = reinterpret_cast<float*>(ring + RING * L::SLOT);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slice = static_cast<int>(blockIdx.x % L::NS);
  const long long bh = blockIdx.x / L::NS;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const int g = warp * L::GW + lane / L::LG;  // this thread's row group
  const int jc = (lane % L::LG) * C;          // its first column in the slice
  const int i0 = g * R;
  const int col0 = slice * CW;
  const long long step = static_cast<long long>(H) * P;  // between two steps
  const long long base = (b * S * H + h) * P;            // (b, 0, h, 0)
  const long long sbase = bh * P * P + col0 + jc;        // S[b, h, 0, col0 + jc]

  // a tile's r, k, w rows and v slice into a ring slot, 16 bytes a copy:
  // copy q of this thread is chunk tid + q NT of each array's [T][row]
  // slice, at a fixed offset from the tile's first step
  constexpr int CR = L::RB / 16, CWW = L::WB / 16, CV = L::VB / 16;  // copies a row
  constexpr int QR = (T * CR + L::NT - 1) / L::NT, QW = (T * CWW + L::NT - 1) / L::NT,
                QV = (T * CV + L::NT - 1) / L::NT;
  constexpr int EC = 16 / static_cast<int>(sizeof(In));  // r, k, v elements a copy
  int tr[QR], orr[QR], tw[QW], ow[QW], tv[QV], ov[QV];
#pragma unroll
  for (int q = 0; q < QR; ++q) {
    const int c = tid + q * L::NT;
    tr[q] = c < T * CR ? c / CR : T;
    orr[q] = static_cast<int>((c / CR) * step) + (c % CR) * EC;
  }
#pragma unroll
  for (int q = 0; q < QW; ++q) {
    const int c = tid + q * L::NT;
    tw[q] = c < T * CWW ? c / CWW : T;
    ow[q] = static_cast<int>((c / CWW) * step) + (c % CWW) * 4;
  }
#pragma unroll
  for (int q = 0; q < QV; ++q) {
    const int c = tid + q * L::NT;
    tv[q] = c < T * CV ? c / CV : T;
    ov[q] = static_cast<int>((c / CV) * step) + col0 + (c % CV) * EC;
  }
  auto issue = [&](int s1, int n1, int slot) {
    char* const d = ring + slot * L::SLOT;
    const long long t0 = base + s1 * step;
#pragma unroll
    for (int q = 0; q < QR; ++q) {
      if (tr[q] < n1) {
        const int c = tid + q * L::NT;
        cp16(d + c * 16, r + t0 + orr[q]);
        cp16(d + T * L::RB + c * 16, k + t0 + orr[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < QW; ++q)
      if (tw[q] < n1) cp16(d + 2 * T * L::RB + (tid + q * L::NT) * 16, w + t0 + ow[q]);
#pragma unroll
    for (int q = 0; q < QV; ++q)
      if (tv[q] < n1)
        cp16(d + 2 * T * L::RB + T * L::WB + (tid + q * L::NT) * 16, v + t0 + ov[q]);
  };

  issue(0, min(T, S), 0);
  cp_commit();
  issue(T, min(T, S - T), 1);  // nothing when S <= T: an empty group
  cp_commit();

  float st[R][C];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    if (state_in != nullptr) {
      ldv(state_in + sbase + static_cast<long long>(i0 + e) * P, st[e]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) st[e][c] = 0.f;
    }
  }
  // the y pass: lanes 8 q .. 8 q + 7 take a step; lane l of them rows
  // l RY .. l RY + RY - 1 of a_t and columns l CY .. l CY + CY - 1 of y
  const int ly = tid % L::LY;
  const unsigned ymask = 0xffu << (lane & ~(L::LY - 1));
  float lu[L::RY];
#pragma unroll
  for (int e = 0; e < L::RY; ++e) lu[e] = u[h * P + ly * L::RY + e];

  cp_wait_all_but_one();  // the first tile (the loop's barrier shows it to all)

  int slot = 0;
  for (int s0 = 0; s0 < S; s0 += T, slot = slot == RING - 1 ? 0 : slot + 1) {
    const int n = min(T, S - s0);
    __syncthreads();  // this tile is staged; the last tile's y pass is done
    const int nxt = slot >= RING - 2 ? slot + 2 - RING : slot + 2;
    issue(s0 + 2 * T, min(T, S - s0 - 2 * T), nxt);
    cp_commit();
    const char* const d = ring + slot * L::SLOT;
    const In* const rs = reinterpret_cast<const In*>(d);
    const In* const ks = reinterpret_cast<const In*>(d + T * L::RB);
    const float* const ws = reinterpret_cast<const float*>(d + 2 * T * L::RB);
    const In* const vs = reinterpret_cast<const In*>(d + 2 * T * L::RB + T * L::WB);
    auto walk = [&](int t) {
      float rr[R], kk[R], ww[R], vv[C], acc[C];
      ldv(rs + t * P + i0, rr);
      ldv(ks + t * P + i0, kk);
      ldv(ws + t * P + i0, ww);
      ldv(vs + t * CW + jc, vv);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
      for (int e = 0; e < R; ++e) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c] += rr[e] * st[e][c];
          st[e][c] = ww[e] * st[e][c] + kk[e] * vv[c];
        }
      }
      stv(part + (t * G + g) * CW + jc, acc);
    };
    if (n == T) {  // a whole tile, unrolled: a step's loads overlap the last one's math
#pragma unroll
      for (int t = 0; t < T; ++t) walk(t);
    } else {
      for (int t = 0; t < n; ++t) walk(t);
    }
    cp_wait_all_but_one();
    __syncthreads();  // the partials are in; the next tile has landed
    // y_t[j] = (sum_g partial_g) + a_t v_t[j], a_t = sum_i r_i u_i k_i
    for (int t = tid / L::LY; t < n; t += L::SY) {
      constexpr int RY = L::RY, CY = L::CY;
      float rr[RY], kk[RY], vv[CY], sum[CY], pg[CY];
      ldv(rs + t * P + ly * RY, rr);
      ldv(ks + t * P + ly * RY, kk);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < RY; ++e) a += rr[e] * lu[e] * kk[e];
#pragma unroll
      for (int m = 1; m < L::LY; m <<= 1) a += __shfl_xor_sync(ymask, a, m);
      const float* const pp = part + t * G * CW + ly * CY;
      ldv(pp, sum);
#pragma unroll
      for (int gg = 1; gg < G; ++gg) {
        ldv(pp + gg * CW, pg);
#pragma unroll
        for (int c = 0; c < CY; ++c) sum[c] += pg[c];
      }
      ldv(vs + t * CW + ly * CY, vv);
      float yq[CY];
#pragma unroll
      for (int c = 0; c < CY; ++c) yq[c] = sum[c] + a * vv[c];
      stv(y + base + (s0 + t) * step + col0 + ly * CY, yq);
    }
  }
#pragma unroll
  for (int e = 0; e < R; ++e)
    stv(state_out + sbase + static_cast<long long>(i0 + e) * P, st[e]);
}

template <typename In, int P>
int launch_p(const void* r, const void* k, const void* v, const float* w, const float* u,
             const float* state_in, float* y, float* state_out, int B, int S, int H,
             cudaStream_t s) {
  using L = Layout<In, P>;
  auto* kern = wkv6_kernel<In, P>;
  static const cudaError_t attr =
      L::SMEM > 48 * 1024
          ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM)
          : cudaSuccess;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * H * L::NS);
  kern<<<blocks, L::NT, L::SMEM, s>>>(static_cast<const In*>(r), static_cast<const In*>(k),
                                      static_cast<const In*>(v), w, u, state_in, y,
                                      state_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* state_in, float* y, float* state_out, int B, int S, int H, int P,
           cudaStream_t s) {
  switch (P) {
    case 16:
      return launch_p<In, 16>(r, k, v, w, u, state_in, y, state_out, B, S, H, s);
    case 32:
      return launch_p<In, 32>(r, k, v, w, u, state_in, y, state_out, B, S, H, s);
    case 64:
      return launch_p<In, 64>(r, k, v, w, u, state_in, y, state_out, B, S, H, s);
    default:
      return -1;
  }
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
  if (B <= 0 || S <= 0 || H <= 0 || static_cast<long long>(B) * H * P > 0x7fffffffLL ||
      static_cast<long long>(H) * P * T > 0x7fffffffLL)
    return -1;
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
