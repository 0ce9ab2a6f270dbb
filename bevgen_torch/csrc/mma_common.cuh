// Shared pieces of the port's attention kernels (sm_90a): bf16 packing,
// the mma.sync m16n8k16 bf16 -> fp32 product, and the tile helpers of a
// block of 4 warps that owns 64 rows (16 per warp).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, col):   b0 (k 2t..2t+1, n g)   b1 (k 2t+8..2t+9, n g)
//   C (16x8):        c0,c1 (g, 2t..2t+1)    c2,c3 (g+8, 2t..2t+1)
// A C tile of 16 x 64 is float c[8][4] (n-tile j covers columns 8j..8j+7).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace mma_common {

constexpr int BLOCK_ROWS = 64;  // rows of a tile: queries or keys
constexpr int NUM_WARPS = BLOCK_ROWS / 16;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int NT = BLOCK_ROWS / 8;  // n-tiles of a 16 x 64 score tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 64) of two row-major (rows, D) bf16 matrices into shared
// tiles of row stride D + 8 (a 16-byte multiple); rows at or past `rows` are
// zero. Every 16-byte load of both tiles is issued before the first shared
// store, so they are all in flight at once: these loads are synchronous, and
// their latency, not their bandwidth, is what a block waits for.
template <int D>
__device__ __forceinline__ void load_tiles(__nv_bfloat16* dst_a,
                                           const __nv_bfloat16* src_a,
                                           __nv_bfloat16* dst_b,
                                           const __nv_bfloat16* src_b, int r0,
                                           int rows, int tid) {
  constexpr int LD = D + 8, VPR = D / 8;
  constexpr int PER = BLOCK_ROWS * VPR / NUM_THREADS;  // vectors per thread
  static_assert(BLOCK_ROWS * VPR % NUM_THREADS == 0, "whole vectors per thread");
  uint4 a[PER], b[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = tid + it * NUM_THREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    a[it] = b[it] = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) {
      const size_t off = static_cast<size_t>(r0 + r) * D + c;
      a[it] = *reinterpret_cast<const uint4*>(src_a + off);
      b[it] = *reinterpret_cast<const uint4*>(src_b + off);
    }
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = tid + it * NUM_THREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    *reinterpret_cast<uint4*>(dst_a + r * LD + c) = a[it];
    *reinterpret_cast<uint4*>(dst_b + r * LD + c) = b[it];
  }
}

// Rows [w, w + 16) of a shared tile as A fragments over the head dim.
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4],
                                       const __nv_bfloat16* s, int w, int g,
                                       int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = lds32(&s[(w + g) * LD + c]);
    a[kk][1] = lds32(&s[(w + g + 8) * LD + c]);
    a[kk][2] = lds32(&s[(w + g) * LD + c + 8]);
    a[kk][3] = lds32(&s[(w + g + 8) * LD + c + 8]);
  }
}

// c = A . B^T: the warp's 16 rows (A fragments over the head dim) against
// the 64 rows of a shared tile, contracted over the head dim.
template <int D>
__device__ __forceinline__ void mma_abt(float c[NT][4], const uint32_t a[D / 16][4],
                                        const __nv_bfloat16* s, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* r = &s[(j * 8 + g) * LD + kk * 16 + 2 * t];
      mma_16816(c[j], a[kk], lds32(r), lds32(r + 8));
    }
  }
}

// acc += P . B: P (16 x 64, bf16 A fragments from pack_a) times the 64 rows
// of a shared tile, contracted over those rows.
template <int D>
__device__ __forceinline__ void mma_ab(float acc[D / 8][4],
                                       const uint32_t p[BLOCK_ROWS / 16][4],
                                       const __nv_bfloat16* s, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < BLOCK_ROWS / 16; ++kk) {
    const int kr = kk * 16 + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int n = j * 8 + g;
      const uint32_t b0 = pack_raw(s[kr * LD + n], s[(kr + 1) * LD + n]);
      const uint32_t b1 = pack_raw(s[(kr + 8) * LD + n], s[(kr + 9) * LD + n]);
      mma_16816(acc[j], p[kk], b0, b1);
    }
  }
}

// A 16 x 64 fp32 C tile as bf16 A fragments for mma_ab (n-tiles 2kk and
// 2kk+1 make k-step kk).
__device__ __forceinline__ void pack_a(uint32_t p[BLOCK_ROWS / 16][4],
                                       const float c[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    p[j / 2][(j % 2) * 2 + 0] = pack_bf16(c[j][0], c[j][1]);
    p[j / 2][(j % 2) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

}  // namespace mma_common
