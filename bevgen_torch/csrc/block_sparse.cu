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
// the condition columns) the active blocks cost 4*D*16^2 FLOP each per
// (b, h), about 23 GFLOP (24 us), against 39 MB of q/k/v/out (12 us):
// operations. (Estimates from the shapes; chip_smoke.py computes the bound
// from the layout it runs.)
//
// Design. One thread block of 4 warps per (b, h, 64-row query tile); each
// warp owns 16 query rows, held as mma.sync A fragments for the whole loop.
// The host lists, once per layout, the 64-wide key tiles that hold any
// active block for each (head, query tile) (`counts`, `indices`); the block
// loops over exactly those, in ascending order, which replaces the TPU's
// scalar-prefetched tile lists. Each visited K/V tile is staged in shared
// memory; scores and P.V run on the tensor cores (m16n8k16 bf16 -> fp32)
// with an online softmax in fp32 (log2 units). Inside a visited tile the
// mask comes from the row and column indices and the layout bytes of this
// head (read through the read-only cache), so no (L, L) mask is read from
// memory (the rule is `block_sparse_mask.cuh`, shared with the backward).
// What this first version leaves on the table: synchronous loads (no
// cp.async/TMA pipeline), mma.sync instead of wgmma, and a per-element
// layout lookup.
//
// C interface: block_sparse_fwd_bf16(...) returns cudaGetLastError() after
// the launch; the Python wrapper raises if it is not 0.

#include "block_sparse_mask.cuh"
#include "mma_common.cuh"

namespace {

using namespace mma_common;

constexpr float MASKED = -1e9f * LOG2E;  // the reference's -1e9, in log2 units
constexpr float LN2 = 0.6931471805599453f;
// head dim: 1024 / 16 heads in every AR configuration (nuscenes_ar,
// nuscenes_ar_tpu); the wrapper raises for any other
constexpr int HEAD_DIM = 64;

__global__ void __launch_bounds__(NUM_THREADS)
block_sparse_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ bias,
                        const uint8_t* __restrict__ layout,
                        const int* __restrict__ counts,
                        const int* __restrict__ indices,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse,
                        int H, int L, int nb, int block, int nt, int nc,
                        int pad_start, float scale) {
  constexpr int D = HEAD_DIM;
  constexpr int LD = D + 8;      // smem row stride in bf16 (16-byte multiple)
  constexpr int KSTEPS = D / 16; // mma k-steps over the head dim
  constexpr int NT_O = D / 8;    // output n-tiles per warp

  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BLOCK_ROWS * LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x;
  const int q0 = qt * BLOCK_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* qb = q + bh * L * D;
  const __nv_bfloat16* kb = k + bh * L * D;
  const __nv_bfloat16* vb = v + bh * L * D;

  // q tile (the second tile of the pair is a scratch copy into k_s,
  // overwritten by the first K tile)
  load_tiles<D>(q_s, qb, k_s, qb, q0, L, tid);
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[KSTEPS][4];
  load_a<D>(qa, q_s, wr, g, t);

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  // rows past L (the ragged last tile) are computed and never stored
  const uint8_t* lay0 = block_sparse::layout_row(layout, h, nb, row0, block);
  const uint8_t* lay1 = block_sparse::layout_row(layout, h, nb, row1, block);
  const bool pad0 = row0 >= pad_start, pad1 = row1 >= pad_start;
  const float sc = scale * LOG2E;

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = counts[h * nt + qt];
  const int* tiles = indices + (static_cast<size_t>(h) * nt + qt) * nt;
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = tiles[it] * BLOCK_ROWS;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tiles<D>(k_s, kb, v_s, vb, kv0, L, tid);
    __syncthreads();

    float s[NT][4];
    mma_abt<D>(s, qa, k_s, g, t);

    // + bias on the raw scores, * scale, mask, to log2 units; columns past
    // L are -inf (exactly 0 weight; every tile holds a column < L)
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
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
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // finite from the first tile on: a tile's first column is < L, so every
    // row has at least the masked value there
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    uint32_t pa[BLOCK_ROWS / 16][4];
    pack_a(pa, s);
    mma_ab<D>(acc, pa, v_s, g, t);
  }

  // ---- epilogue: full row sums across the quad, normalise, store bf16
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = out + bh * L * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row0) * D + c]) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row1) * D + c]) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    if (row0 < L) lse[bh * L + row0] = (m0 + log2f(l0)) * LN2;
    if (row1 < L) lse[bh * L + row1] = (m1 + log2f(l1)) * LN2;
  }
}

void launch(const void* q, const void* k, const void* v, const void* bias,
            const void* layout, const void* counts, const void* indices,
            void* out, void* lse, int B, int H, int L, int nb, int block,
            int nt, int nc, int pad_start, float scale, cudaStream_t stream) {
  const dim3 grid(nt, H, B);
  block_sparse_fwd_kernel<<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(layout), static_cast<const int*>(counts),
      static_cast<const int*>(indices), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, L, nb, block, nt, nc, pad_start, scale);
}

}  // namespace

// q, k, v (B,H,L,D) bf16 contiguous; bias (L,L) fp32 or null; layout
// (H,nb,nb) uint8 with nb * block >= L; counts (H,nt) and indices (H,nt,nt)
// int32 with nt = ceil(L / 64), the key tiles of each (head, query tile) in
// ascending order; out (B,H,L,D) bf16; lse (B,H,L) fp32 or null.
// Returns cudaGetLastError().
extern "C" int block_sparse_fwd_bf16(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* layout, const void* counts,
                                     const void* indices, void* out, void* lse,
                                     int B, int H, int L, int D, int nb,
                                     int block, int nt, int nc, int pad_start,
                                     float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535 || B > 65535 || block <= 0 ||
      nb <= 0 || static_cast<long long>(nb) * block < L ||
      nt != (L + BLOCK_ROWS - 1) / BLOCK_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  launch(q, k, v, bias, layout, counts, indices, out, lse, B, H, L, nb, block,
         nt, nc, pad_start, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
