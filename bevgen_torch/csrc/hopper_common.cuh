// Hopper (sm_90a) pieces of the port's attention kernels: tiles of 64 rows
// of a 64-wide bf16 head copied into shared memory with cp.async in the
// 128-byte swizzle, the shared-memory descriptors that `wgmma` reads them
// through, and the m64n64k16 bf16 -> fp32 `wgmma` products, with both
// operands in shared memory or A in registers; and 2^x on the
// special-function unit for the softmax.
//
// One warpgroup (4 warps, 128 threads) owns a 64-row tile. Warp w holds
// rows 16w..16w+15 of every 64 x 64 fp32 accumulator, in the C layout of
// mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   d[j][0], d[j][1]  row g,     columns 8j + 2t, 8j + 2t + 1
//   d[j][2], d[j][3]  row g + 8, the same columns
// and the A fragments of a register operand in the A layout of
// mma.m16n8k16, so an accumulator turns into the A operand of the next
// product by packing pairs to bf16 (`pack_a`), as in FlashAttention-3.
//
// Shared tiles. A tile is 64 rows of 128 bytes (64 bf16), 8 KB, at a
// 1024-byte aligned address; the 16-byte chunk c of row r is stored at
// chunk c ^ (r % 8) of that row (the 128-byte swizzle, which spreads a
// column of chunks over all banks). `wgmma` reads such a tile in two ways:
//   K-major   the rows run along the product's M or N and the 64 columns
//             along its contraction (q, k, v or dO as the A or B of
//             q k^T-like products): leading offset unused, stride 1024
//             bytes between groups of 8 rows; the k-th 16-column slice
//             starts 32 k bytes in.
//   MN-major  the rows run along the contraction and the columns along N
//             (v, k, q or dO as the B of P v-like products, the transpose
//             bit set): stride 1024 bytes between groups of 8 rows of the
//             contraction, leading offset (between 64-column groups of N)
//             unused at N = 64; the k-th 16-row slice starts 2048 k bytes
//             in.
// cp.async writes through the generic proxy and `wgmma` reads through the
// async proxy, so a thread fences (`fence_proxy_async`) after its copies
// land and before the barrier that hands the tile to the products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int TILE_ROWS = 64;
constexpr int TILE_BYTES = TILE_ROWS * 128;  // 64 rows of 64 bf16
constexpr int WG_THREADS = 128;              // one warpgroup
constexpr int NT = TILE_ROWS / 8;            // n-tiles of a 64-wide accumulator

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned byte at or after p (dynamic shared memory is
// sized with 1024 bytes of slack for this).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ---- copies -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of a row-major (rows, 64) bf16 matrix into the
// swizzled tile at shared address dst: 512 chunks of 16 bytes, 4 a thread,
// neighbouring threads on neighbouring global addresses. Rows at or past
// `rows` are zero-filled (nothing is read for them).
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int r0, int rows, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * WG_THREADS;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r0 + r < rows;
    const __nv_bfloat16* p =
        src + static_cast<size_t>(ok ? r0 + r : 0) * 64 + c * 8;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), p, ok ? 16u : 0u);
  }
}

// Rows [r0, r0 + 64) of a (rows, D) bf16 matrix with row stride ld
// (elements, a multiple of 8) into a 64-wide swizzled tile, 4 chunks of 16
// bytes for each thread i of a warpgroup; rows at or past `rows` and
// columns at or past D (D = 32: the upper half) are zero-filled, and
// nothing is read for them.
template <int D>
__device__ __forceinline__ void load_tile_rows_async(uint32_t dst,
                                                     const __nv_bfloat16* src,
                                                     long long ld, int r0,
                                                     int rows, int i) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int idx = i + u * WG_THREADS;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r0 + r < rows && c < D / 8;
    const __nv_bfloat16* p = ok ? src + (r0 + r) * ld + c * 8 : src;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), p, ok ? 16u : 0u);
  }
}

// Entries [r0, r0 + 64) of a float vector of length n into 64 floats at
// shared address dst, one 4-byte copy a thread for threads 0-63; entries
// at or past n are zero. (4-byte copies: a (B, H, L) row starts 16-byte
// aligned only when L is a multiple of 4.)
__device__ __forceinline__ void load_vec_async(uint32_t dst, const float* src,
                                               int r0, int n, int i) {
  const bool ok = r0 + i < n;
  cp_async4(dst + 4 * i, src + (ok ? r0 + i : 0), ok ? 4u : 0u);
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled tile (128-byte swizzle,
// base offset 0: the tile is 1024-byte aligned).
__device__ __forceinline__ uint64_t matrix_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// the k-th 16-column slice of a K-major tile
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int k) {
  return matrix_desc(tile + 32 * k, 16, 1024);
}

// the k-th 16-row slice of an MN-major tile
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int k) {
  return matrix_desc(tile + 2048 * k, TILE_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous products: called on accumulators and register operands
// after wgmma_wait.
__device__ __forceinline__ void fence_operands(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[TILE_ROWS / 16][4]) {
#pragma unroll
  for (int j = 0; j < TILE_ROWS / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e]) :: "memory");
}

#define HOPPER_WGMMA_D32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_WGMMA_D32_OPERANDS(d)                                          \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),                 \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),             \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),             \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),             \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),             \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),             \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),             \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

// d (+)= A . B, both K-major in shared memory (A: 64 rows of the
// warpgroup, B: 64 rows of N), one 16-wide slice of the contraction.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[NT][4], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_WGMMA_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A . B with A (64 x 16 bf16) in registers, A fragments a[0..3], and
// B MN-major in shared memory (16 rows of the contraction, 64 columns).
__device__ __forceinline__ void wgmma_rs(float (&d)[NT][4], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_WGMMA_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HOPPER_WGMMA_D32
#undef HOPPER_WGMMA_D32_OPERANDS

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp, results
// below 2^-126 flushed to 0), which exp2f wraps in a denormal range fix-up
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- fragments ----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator as bf16 A fragments over its columns (n-tiles
// 2kk and 2kk + 1 make the kk-th 16-wide slice).
__device__ __forceinline__ void pack_a(uint32_t (&p)[TILE_ROWS / 16][4],
                                       const float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    p[j / 2][(j % 2) * 2 + 0] = pack_bf16(c[j][0], c[j][1]);
    p[j / 2][(j % 2) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

}  // namespace hopper
