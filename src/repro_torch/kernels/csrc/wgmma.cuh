// wgmma building blocks shared by the bf16 attention kernels for Hopper
// (sm_90a): flash_attention.cu (forward) and flash_attention_bwd.cu
// (backward).  Tiles are 64 rows of bf16 in the 128-byte swizzled layout
// the wgmma descriptors name; products are m64n64k16 with f32
// accumulators, A from shared memory or registers, B from shared memory
// read K-major or MN-major (the transpose bit).  Included by those sources
// only; kernels/_build.py hashes it into each includer's library name.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WG_THREADS = 128;        // one warpgroup
constexpr int BLOCK_BYTES = 64 * 128;  // 64 rows x 64 bf16 columns

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the 16 bytes when !ok
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make this thread's generic-proxy writes of shared memory visible to
// wgmma, which reads shared memory through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows row0 .. row0 + 63 of a (rows, D) bf16 matrix (row stride rs
// elements) as NCH 16-byte chunks a row in the swizzled layout: chunk c of
// row r at block c / 8, byte r * 128 + ((c % 8) ^ (r % 8)) * 16.  Chunks
// past D and rows at or past n_rows are zero-filled.  NT threads copy.
template <int D, int NCH, int NT = WG_THREADS>
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long rs, int row0, int n_rows,
                                           int tid) {
#pragma unroll
  for (int e = tid; e < 64 * NCH; e += NT) {
    const int r = e / NCH;
    const int c = e - r * NCH;
    const int row = row0 + r;
    const bool ok = row < n_rows && c < D / 8;
    const __nv_bfloat16* g = ok ? src + row * rs + c * 8 : src;
    cp16(dst + (c >> 3) * BLOCK_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4), g,
         ok);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address >> 4 (bits 0-13), leading byte offset >> 4 (16-29), stride byte
// offset >> 4 (32-45: 1024 bytes between groups of 8 rows), layout type 1 =
// 128-byte swizzle (62-63).  A K-major operand takes leading offset 1, as
// CUTLASS sets it (a k16 step stays inside one 128-byte swizzle row; the
// start address advances 32 bytes a step).  The MN-major V tile is read one
// 64-column block a product, so the stride between such blocks is never
// crossed; its leading offset is set to the 8-row stride as well.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
constexpr uint32_t LBO_K = 1;
constexpr uint32_t LBO_MN = 1024 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads above the wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) += A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
