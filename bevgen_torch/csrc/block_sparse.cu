// Block-sparse attention forward for Hopper (sm_90a), bf16 in, fp32
// accumulate.
//
// Replaces the TPU kernel `block_sparse_attention`
// (bevgen_tpu/ops/pallas/block_sparse.py:182, kernel body `_kernel_body`
// :102, tiles planned by `plan_tiles` :51, mask rebuilt by `_allowed_tile`
// :77). For each batch b, head h and query row i of a sequence of L tokens:
//
//   s_ij = (q_i . k_j + bias[i, j]) * scale       (bias: one (L, L) fp32 or none)
//   keep_ij = layout[h, i / block, j / block]
//             and (i >= pad_start ? j == 0 : (j < nc or j <= i))
//   out_i = softmax_j(keep_ij ? s_ij : -1e9) . v_j
//
// The bias is added to the RAW scores and scaled with them (DeepSpeed's
// add_mask). Masked scores take -1e9, not -inf, as the dense reference
// does; every row has a visible column (the layouts keep their diagonal
// and pad rows see column 0), so masked terms are exactly 0 in fp32. The
// per-row logsumexp of the scores, in natural-log units, is written to
// `lse` when it is not null.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// nuScenes AR shapes (B=2, H=16, L=2368, D=64, 16-token blocks at density
// 1.0, so about half of the 148 x 148 blocks active: the causal band and
// the condition columns) the kept pairs cost 4 D FLOP each, about 23 GFLOP
// (0.023 ms), against 39 MB of q/k/v/out (0.012 ms): operations. (Estimates
// from the shapes; chip_smoke.py computes the bound from the layout it
// runs.) Beyond the bound, time goes to feeding the tensor cores (16 KB of
// K/V copied in for each 64 x 64 tile's two products), to the
// exponentials, and to the keep rule wherever it is evaluated.
//
// Design. One warpgroup (128 threads) per (b, h, 64-row query tile). The
// host lists, once per layout, the 64-wide key tiles that hold any active
// block for each (head, query tile) (`counts`, `indices`), and flags those
// whose every pair is kept (`full`); the block walks exactly those, in
// ascending order, which replaces the TPU's scalar-prefetched tile lists.
//   - Both products run on wgmma (hopper_common.cuh), m64n64k16 bf16 ->
//     fp32: S = q k^T with q and k as K-major operands in shared memory,
//     O += P v with P from registers (the fp32 scores rescaled, exponentiated
//     and packed to bf16 in place) and v as an MN-major operand.
//   - K/V tiles come through a ring of STAGES stages filled with cp.async in
//     the 128-byte swizzle: the copy of the next listed tile is in flight
//     while this tile's products and softmax run.
//   - A full tile skips the mask: no layout byte, no index rule, no bound
//     check. A partial tile (the causal diagonal, the pad rows, the
//     condition edge, the ragged end) applies the rule of
//     `block_sparse_mask.cuh` to every score, as before. At nuscenes_ar
//     10,240 of the 11,344 listed tiles (all heads) are full.
// The online softmax runs in fp32 in log2 units, its exponentials on the
// special-function unit (`exp2_approx`: weights under 2^-126 flush to 0,
// below anything the bf16 P keeps). No product runs on mma.sync.
//
// C interface: block_sparse_fwd_bf16(...) returns cudaGetLastError() after
// the launch; the Python wrapper raises if it is not 0.

#include <math_constants.h>

#include "block_sparse_mask.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e9f * LOG2E;  // the reference's -1e9, in log2 units
constexpr float LN2 = 0.6931471805599453f;
// head dim: 1024 / 16 heads in every AR configuration (nuscenes_ar,
// nuscenes_ar_tpu); the wrapper raises for any other
constexpr int HEAD_DIM = 64;
constexpr int STAGES = 2;  // K/V ring
// the q tile and the ring, with slack to align the first tile to 1024
constexpr int SMEM_BYTES = (1 + 2 * STAGES) * TILE_BYTES + 1024;

__global__ void __launch_bounds__(WG_THREADS)
block_sparse_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ bias,
                        const uint8_t* __restrict__ layout,
                        const int* __restrict__ counts,
                        const int* __restrict__ indices,
                        const uint8_t* __restrict__ full,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse,
                        int H, int L, int nb, int block, int nt, int nc,
                        int pad_start, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = smem_addr(align1024(smem_raw));
  const uint32_t ring = q_s + TILE_BYTES;  // stage st: K, then V

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x;
  const int q0 = qt * TILE_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* kb = k + bh * L * HEAD_DIM;
  const __nv_bfloat16* vb = v + bh * L * HEAD_DIM;
  const size_t plan = static_cast<size_t>(h) * nt + qt;
  const int n_tiles = counts[plan];
  const int* tiles = indices + plan * nt;
  const uint8_t* tile_full = full + plan * nt;

  // one commit group per listed tile (empty past the list, so the groups
  // stay counted alike); the q tile rides with the first
  auto load_kv = [&](int it) {
    if (it < n_tiles) {
      const uint32_t st = ring + (it % STAGES) * 2 * TILE_BYTES;
      const int kv0 = tiles[it] * TILE_ROWS;
      load_tile_async(st, kb, kv0, L, tid);
      load_tile_async(st + TILE_BYTES, vb, kv0, L, tid);
    }
    cp_async_commit();
  };
  load_tile_async(q_s, q + bh * L * HEAD_DIM, q0, L, tid);
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_kv(it);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  // rows past L (the ragged last tile) are computed and never stored
  const uint8_t* lay0 = block_sparse::layout_row(layout, h, nb, row0, block);
  const uint8_t* lay1 = block_sparse::layout_row(layout, h, nb, row1, block);
  const bool pad0 = row0 >= pad_start, pad1 = row1 >= pad_start;
  const float sc = scale * LOG2E;

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
  zero(acc);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile it is in place; every warp is done with it - 1
    load_kv(it + STAGES - 1);
    const uint32_t k_s = ring + (it % STAGES) * 2 * TILE_BYTES;
    const uint32_t v_s = k_s + TILE_BYTES;
    const int kv0 = tiles[it] * TILE_ROWS;

    float s[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      wgmma_ss(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // + bias on the raw scores, * scale, to log2 units; on a partial tile
    // masked pairs take MASKED and columns past L -inf (exactly 0 weight;
    // every tile holds a column < L)
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
    if (tile_full[it]) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float b0 = 0.f, b1 = 0.f;
          if (bias != nullptr) {
            const int col = kv0 + j * 8 + 2 * t + e;
            b0 = __ldg(bias + static_cast<size_t>(row0) * L + col);
            b1 = __ldg(bias + static_cast<size_t>(row1) * L + col);
          }
          s[j][e] = (s[j][e] + b0) * sc;
          s[j][2 + e] = (s[j][2 + e] + b1) * sc;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + j * 8 + 2 * t + e;
          float v0 = -CUDART_INF_F, v1 = -CUDART_INF_F;
          if (col < L) {
            const int cb = col / block;
            const bool k0 = __ldg(lay0 + cb) != 0 &&
                            BLOCK_SPARSE_ALLOWED(pad0, row0, col, nc);
            const bool k1 = __ldg(lay1 + cb) != 0 &&
                            BLOCK_SPARSE_ALLOWED(pad1, row1, col, nc);
            float b0 = 0.f, b1 = 0.f;
            if (bias != nullptr) {
              if (row0 < L) b0 = __ldg(bias + static_cast<size_t>(row0) * L + col);
              if (row1 < L) b1 = __ldg(bias + static_cast<size_t>(row1) * L + col);
            }
            v0 = k0 ? (s[j][e] + b0) * sc : MASKED;
            v1 = k1 ? (s[j][2 + e] + b1) * sc : MASKED;
          }
          s[j][e] = v0;
          s[j][2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // finite from the first tile on: a tile's first column is < L, so every
    // row has at least the masked value there
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2_approx(m0 - mn0), al1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2_approx(s[j][0] - m0);
      s[j][1] = exp2_approx(s[j][1] - m0);
      s[j][2] = exp2_approx(s[j][2] - m1);
      s[j][3] = exp2_approx(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    uint32_t pa[TILE_ROWS / 16][4];
    pack_a(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE_ROWS / 16; ++kk)
      wgmma_rs(acc, pa[kk], desc_mn_major(v_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(pa);
  }
  cp_async_wait<0>();

  // ---- epilogue: full row sums across the quad, normalise, store bf16
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = out + bh * L * HEAD_DIM;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row0) * HEAD_DIM + c]) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row1) * HEAD_DIM + c]) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    if (row0 < L) lse[bh * L + row0] = (m0 + log2f(l0)) * LN2;
    if (row1 < L) lse[bh * L + row1] = (m1 + log2f(l1)) * LN2;
  }
}

// Lets the kernel take SMEM_BYTES of dynamic shared memory, once per process.
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      block_sparse_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  return err;
}

}  // namespace

// The kernel's dynamic shared memory per block and the blocks that fit on
// one SM (registers and shared memory together), for reports. Returns a
// cudaError_t.
extern "C" int block_sparse_fwd_resources(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = SMEM_BYTES;
  cudaError_t err = allow_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, block_sparse_fwd_kernel, WG_THREADS, SMEM_BYTES);
  return static_cast<int>(err);
}

// q, k, v (B,H,L,D) bf16 contiguous; bias (L,L) fp32 or null; layout
// (H,nb,nb) uint8 with nb * block >= L; counts (H,nt), indices (H,nt,nt)
// int32 and full (H,nt,nt) uint8 with nt = ceil(L / 64): the key tiles of
// each (head, query tile) in ascending order and, for each, whether every
// pair of the 64 x 64 tile is kept; out (B,H,L,D) bf16; lse (B,H,L) fp32 or
// null. Returns cudaGetLastError().
extern "C" int block_sparse_fwd_bf16(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* layout, const void* counts,
                                     const void* indices, const void* full,
                                     void* out, void* lse, int B, int H, int L,
                                     int D, int nb, int block, int nt, int nc,
                                     int pad_start, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535 || B > 65535 || block <= 0 ||
      nb <= 0 || static_cast<long long>(nb) * block < L ||
      nt != (L + TILE_ROWS - 1) / TILE_ROWS || full == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  block_sparse_fwd_kernel<<<dim3(nt, H, B), WG_THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(layout), static_cast<const int*>(counts),
      static_cast<const int*>(indices), static_cast<const uint8_t*>(full),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, L, nb,
      block, nt, nc, pad_start, scale);
  return static_cast<int>(cudaGetLastError());
}
