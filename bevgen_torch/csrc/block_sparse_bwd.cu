// Block-sparse attention backward for Hopper (sm_90a), bf16 in, fp32
// accumulate.
//
// Replaces the TPU kernel `block_sparse_attention_bwd`
// (bevgen_tpu/ops/pallas/block_sparse.py:439, kernel bodies
// `_bwd_dq_kernel` :273 and `_bwd_dkv_kernel` :370), the training backward
// of every SparseGPT attention. For the forward of block_sparse.cu,
//
//   s_ij = (q_i . k_j + bias[i, j]) * scale,   kept pairs only
//   P    = exp(s - lse)                         (lse from the forward, natural log)
//   dP   = dO v^T,   delta_i = sum_d dO_id O_id (O: the forward's bf16 output)
//   dS   = P * (dP - delta),  zero on every pair that is not kept
//   dq   = scale dS k,  dk = scale dS^T q,  dv = P^T dO
//   dbias = scale * sum over (b, h) of dS       (only with a bias)
//
// The bias is added to the RAW scores before the scale, so its gradient is
// scale dS. A pair is kept by the layout byte of its block and the index
// rule (`block_sparse_mask.cuh`, shared with the forward); P of a pair that
// is not kept is exactly 0, as exp(-1e9 - lse) is in the reference.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): five
// products (S, dP, dq, dk, dv) of D multiply-adds per kept pair, 10 D FLOP.
// At the nuScenes AR training shape (B=4, H=16, L=2368, D=64, 16-token
// blocks at density 1.0: 44,947,168 kept (h, row, col) pairs per sample)
// that is 115 GFLOP, about 0.116 ms, against 155 MB of q/k/v/out/dO read and
// dq/dk/dv written (0.046 ms): operations. (Estimates from the shapes;
// chip_smoke.py computes the bound from the pairs the layout keeps.)
//
// Design. Blocks of a CUDA grid run in no order, so each sum gets a kernel
// whose block owns its output tile and loops over the summed axis, with no
// atomics and a result that does not depend on scheduling (the design of
// attention_bwd.cu):
//
//   1. dq    grid (nt, H, B): a block owns 64 query rows, forms delta =
//            rowsum(dO * O) for them (written for kernels 2 and 3), and loops
//            over the key tiles the forward's plan lists for (head, q tile):
//            S, dP, dS, dq += dS k.
//   2. dkdv  grid (nt, H, B): a block owns 64 keys (K and V as A fragments
//            in registers) and loops over the TRANSPOSED plan, the q tiles
//            whose list holds this key tile: S^T, dP^T, dv += P^T dO,
//            dk += dS^T q. Each listed (q tile, key tile) pair is visited
//            once by kernel 1 and once by kernel 2.
//   3. dbias grid (nt, nt): a block owns a 64 x 64 tile of dbias and loops
//            over the heads whose plan lists that tile and over the batch:
//            S, dP, dS. A tile no head lists is written as zeros. Launched
//            only with a bias.
//
// The price is recomputation: S and dP are formed twice without a bias (7
// products of D per kept pair where the bound counts 5) and three times
// with one. P and dS are rounded to bf16 before the dv, dq and dk products;
// dbias sums fp32 dS. Loads are synchronous and the products mma.sync
// m16n8k16, with the mask looked up per element: a first version.
//
// C interface: block_sparse_bwd_bf16(...) launches the kernels in that
// order on one stream and returns the first cudaGetLastError() that is not 0.

#include "block_sparse_mask.cuh"
#include "mma_common.cuh"

namespace {

using namespace mma_common;

// head dim: 1024 / 16 heads in every AR configuration; the wrapper raises
// for any other
constexpr int D = 64;
constexpr int LD = D + 8;       // smem row stride in bf16 (16-byte multiple)
constexpr int KSTEPS = D / 16;  // mma k-steps over the head dim
constexpr int NT_O = D / 8;     // output n-tiles per warp

// ---- 1. dq (and delta) ------------------------------------------------------
__global__ void __launch_bounds__(NUM_THREADS)
block_sparse_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           const uint8_t* __restrict__ layout,
                           const int* __restrict__ counts,
                           const int* __restrict__ indices,
                           const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int H, int L,
                           int nb, int block, int nt, int nc, int pad_start,
                           float scale) {
  constexpr int HD = D / 2;
  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BLOCK_ROWS * LD];
  __shared__ float lse_s[BLOCK_ROWS];
  __shared__ float dl_s[BLOCK_ROWS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, q0 = qt * BLOCK_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* kb = k + bh * L * D;
  const __nv_bfloat16* vb = v + bh * L * D;
  const __nv_bfloat16* dob = dout + bh * L * D;

  load_tiles<D>(q_s, q + bh * L * D, do_s, dob, q0, L, tid);
  {  // delta = rowsum(dO * O), two threads per row
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    float d = 0.f;
    if (row < L) {
      const size_t off = static_cast<size_t>(row) * D + half * HD;
      const uint4* po = reinterpret_cast<const uint4*>(o + bh * L * D + off);
      const uint4* pd = reinterpret_cast<const uint4*>(dob + off);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        uint4 uo = po[i], ud = pd[i];
        const __nv_bfloat16* eo = reinterpret_cast<const __nv_bfloat16*>(&uo);
        const __nv_bfloat16* ed = reinterpret_cast<const __nv_bfloat16*>(&ud);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d += __bfloat162float(eo[j]) * __bfloat162float(ed[j]);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      dl_s[r] = d;
      // a row past L gets lse +inf, so its P is 0 and its dS is 0
      lse_s[r] = row < L ? lse[bh * L + row] * LOG2E : CUDART_INF_F;
      if (row < L) delta[bh * L + row] = d;
    }
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
  load_a<D>(qa, q_s, wr, g, t);
  load_a<D>(da, do_s, wr, g, t);
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const uint8_t* lay0 = block_sparse::layout_row(layout, h, nb, row0, block);
  const uint8_t* lay1 = block_sparse::layout_row(layout, h, nb, row1, block);
  const bool pad0 = row0 >= pad_start, pad1 = row1 >= pad_start;
  const float lse0 = lse_s[wr + g], lse1 = lse_s[wr + g + 8];
  const float dl0 = dl_s[wr + g], dl1 = dl_s[wr + g + 8];
  const float sc = scale * LOG2E;

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

    float s[NT][4], dp[NT][4];
    mma_abt<D>(s, qa, k_s, g, t);   // S = q k^T (raw)
    mma_abt<D>(dp, da, v_s, g, t);  // dP = dO v^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + j * 8 + 2 * t + e;
        float p0 = 0.f, p1 = 0.f;
        if (col < L) {
          float b0 = 0.f, b1 = 0.f;
          if (bias != nullptr) {
            if (row0 < L) b0 = __ldg(bias + static_cast<size_t>(row0) * L + col);
            if (row1 < L) b1 = __ldg(bias + static_cast<size_t>(row1) * L + col);
          }
          const int cb = col / block;
          if (__ldg(lay0 + cb) != 0 && BLOCK_SPARSE_ALLOWED(pad0, row0, col, nc))
            p0 = exp2f((s[j][e] + b0) * sc - lse0);
          if (__ldg(lay1 + cb) != 0 && BLOCK_SPARSE_ALLOWED(pad1, row1, col, nc))
            p1 = exp2f((s[j][2 + e] + b1) * sc - lse1);
        }
        s[j][e] = p0 * (dp[j][e] - dl0);  // dS
        s[j][2 + e] = p1 * (dp[j][2 + e] - dl1);
      }
    }
    uint32_t dsa[BLOCK_ROWS / 16][4];
    pack_a(dsa, s);
    mma_ab<D>(acc, dsa, k_s, g, t);  // dq += dS k
  }

  __nv_bfloat16* dqb = dq + bh * L * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(&dqb[static_cast<size_t>(row0) * D + c]) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(&dqb[static_cast<size_t>(row1) * D + c]) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// ---- 2. dk, dv --------------------------------------------------------------
__global__ void __launch_bounds__(NUM_THREADS)
block_sparse_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias,
                             const uint8_t* __restrict__ layout,
                             const int* __restrict__ counts_t,
                             const int* __restrict__ indices_t,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int L,
                             int nb, int block, int nt, int nc, int pad_start,
                             float scale) {
  constexpr int BLD = BLOCK_ROWS + 1;  // bias tile stride (fp32)
  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BLOCK_ROWS * LD];
  __shared__ float bias_s[BLOCK_ROWS * BLD];
  __shared__ float lse_s[BLOCK_ROWS];
  __shared__ float dl_s[BLOCK_ROWS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x, k0 = kt * BLOCK_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;

  // this block's K and V tiles, staged through q_s/do_s, as A fragments
  load_tiles<D>(q_s, k + bh * L * D, do_s, v + bh * L * D, k0, L, tid);
  __syncthreads();
  const int wk = warp * 16;
  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  load_a<D>(ka, q_s, wk, g, t);
  load_a<D>(va, do_s, wk, g, t);
  const int key0 = k0 + wk + g, key1 = key0 + 8;
  // the keys' layout columns; keys past L are never kept
  const int kb0 = key0 < L ? key0 / block : -1;
  const int kb1 = key1 < L ? key1 / block : -1;
  const float sc = scale * LOG2E;

  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  const __nv_bfloat16* qb = q + bh * L * D;
  const __nv_bfloat16* dob = dout + bh * L * D;
  const int n_tiles = counts_t[h * nt + kt];
  const int* tiles = indices_t + (static_cast<size_t>(h) * nt + kt) * nt;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = tiles[it] * BLOCK_ROWS;
    __syncthreads();  // every warp is done with the previous tiles
    load_tiles<D>(q_s, qb, do_s, dob, q0, L, tid);
    if (tid < BLOCK_ROWS) {
      const int row = q0 + tid;
      lse_s[tid] = row < L ? lse[bh * L + row] * LOG2E : CUDART_INF_F;
      dl_s[tid] = row < L ? delta[bh * L + row] : 0.f;
    }
    if (bias != nullptr) {
      for (int i = tid; i < BLOCK_ROWS * BLOCK_ROWS; i += NUM_THREADS) {
        const int r = i / BLOCK_ROWS, c = i % BLOCK_ROWS;
        bias_s[r * BLD + c] =
            (q0 + r < L && k0 + c < L)
                ? __ldg(bias + static_cast<size_t>(q0 + r) * L + k0 + c)
                : 0.f;
      }
    }
    __syncthreads();

    // transposed tiles: rows are this warp's 16 keys, columns 64 queries
    float st[NT][4], dpt[NT][4];
    mma_abt<D>(st, ka, q_s, g, t);    // S^T = k q^T (raw)
    mma_abt<D>(dpt, va, do_s, g, t);  // dP^T = v dO^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e, row = q0 + qc;
        const float lq = lse_s[qc], dq_ = dl_s[qc];
        const uint8_t* lay = block_sparse::layout_row(layout, h, nb, row, block);
        const bool pad = row >= pad_start;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          b0 = bias_s[qc * BLD + wk + g];
          b1 = bias_s[qc * BLD + wk + g + 8];
        }
        float p0 = 0.f, p1 = 0.f;
        if (kb0 >= 0 && __ldg(lay + kb0) != 0 &&
            BLOCK_SPARSE_ALLOWED(pad, row, key0, nc))
          p0 = exp2f((st[j][e] + b0) * sc - lq);
        if (kb1 >= 0 && __ldg(lay + kb1) != 0 &&
            BLOCK_SPARSE_ALLOWED(pad, row, key1, nc))
          p1 = exp2f((st[j][2 + e] + b1) * sc - lq);
        st[j][e] = p0;
        st[j][2 + e] = p1;
        dpt[j][e] = p0 * (dpt[j][e] - dq_);  // dS^T
        dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dq_);
      }
    }
    uint32_t pa[BLOCK_ROWS / 16][4], dsa[BLOCK_ROWS / 16][4];
    pack_a(pa, st);
    pack_a(dsa, dpt);
    mma_ab<D>(dva, pa, do_s, g, t);  // dv += P^T dO
    mma_ab<D>(dka, dsa, q_s, g, t);  // dk += dS^T q
  }

  __nv_bfloat16* dkb = dk + bh * L * D;
  __nv_bfloat16* dvb = dv + bh * L * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (key0 < L) {
      const size_t off = static_cast<size_t>(key0) * D + c;
      *reinterpret_cast<uint32_t*>(&dkb[off]) =
          pack_bf16(dka[j][0] * scale, dka[j][1] * scale);
      *reinterpret_cast<uint32_t*>(&dvb[off]) = pack_bf16(dva[j][0], dva[j][1]);
    }
    if (key1 < L) {
      const size_t off = static_cast<size_t>(key1) * D + c;
      *reinterpret_cast<uint32_t*>(&dkb[off]) =
          pack_bf16(dka[j][2] * scale, dka[j][3] * scale);
      *reinterpret_cast<uint32_t*>(&dvb[off]) = pack_bf16(dva[j][2], dva[j][3]);
    }
  }
}

// ---- 3. dbias ---------------------------------------------------------------
// Does head h's transposed plan list query tile qt for key tile kt? The
// lists are ascending; the answer is the same for every thread.
__device__ __forceinline__ bool tile_listed(const int* counts_t,
                                            const int* indices_t, int h,
                                            int nt, int kt, int qt) {
  const int n = counts_t[h * nt + kt];
  const int* list = indices_t + (static_cast<size_t>(h) * nt + kt) * nt;
  for (int i = 0; i < n; ++i) {
    const int x = list[i];
    if (x >= qt) return x == qt;
  }
  return false;
}

__global__ void __launch_bounds__(NUM_THREADS)
block_sparse_bwd_dbias_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const uint8_t* __restrict__ layout,
                              const int* __restrict__ counts_t,
                              const int* __restrict__ indices_t,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dbias, int B, int H, int L,
                              int nb, int block, int nt, int nc,
                              int pad_start, float scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BLOCK_ROWS * LD];
  __shared__ float lse_s[BLOCK_ROWS];
  __shared__ float dl_s[BLOCK_ROWS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, kt = blockIdx.y;
  const int q0 = qt * BLOCK_ROWS, k0 = kt * BLOCK_ROWS;
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float sc = scale * LOG2E;

  // this block's bias tile in score-fragment order, and its dbias sums
  float bl[NT][4], acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + j * 8 + 2 * t + e;
      bl[j][e] = (row0 < L && col < L)
                     ? __ldg(bias + static_cast<size_t>(row0) * L + col) : 0.f;
      bl[j][2 + e] = (row1 < L && col < L)
                         ? __ldg(bias + static_cast<size_t>(row1) * L + col) : 0.f;
      acc[j][e] = acc[j][2 + e] = 0.f;
    }
  }

  for (int h = 0; h < H; ++h) {
    if (!tile_listed(counts_t, indices_t, h, nt, kt, qt)) continue;
    const uint8_t* lay0 = block_sparse::layout_row(layout, h, nb, row0, block);
    const uint8_t* lay1 = block_sparse::layout_row(layout, h, nb, row1, block);
    const bool pad0 = row0 >= pad_start, pad1 = row1 >= pad_start;
    for (int b = 0; b < B; ++b) {
      const size_t bh = static_cast<size_t>(b) * H + h;
      __syncthreads();  // every warp is done with the previous tiles
      load_tiles<D>(q_s, q + bh * L * D, do_s, dout + bh * L * D, q0, L, tid);
      load_tiles<D>(k_s, k + bh * L * D, v_s, v + bh * L * D, k0, L, tid);
      if (tid < BLOCK_ROWS) {
        const int row = q0 + tid;
        lse_s[tid] = row < L ? lse[bh * L + row] * LOG2E : CUDART_INF_F;
        dl_s[tid] = row < L ? delta[bh * L + row] : 0.f;
      }
      __syncthreads();

      uint32_t qa[KSTEPS][4], da[KSTEPS][4];
      load_a<D>(qa, q_s, wr, g, t);
      load_a<D>(da, do_s, wr, g, t);
      float s[NT][4], dp[NT][4];
      mma_abt<D>(s, qa, k_s, g, t);
      mma_abt<D>(dp, da, v_s, g, t);
      const float lse0 = lse_s[wr + g], lse1 = lse_s[wr + g + 8];
      const float dl0 = dl_s[wr + g], dl1 = dl_s[wr + g + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + 2 * t + e;
          if (col < L) {
            const int cb = col / block;
            if (__ldg(lay0 + cb) != 0 && BLOCK_SPARSE_ALLOWED(pad0, row0, col, nc))
              acc[j][e] += exp2f((s[j][e] + bl[j][e]) * sc - lse0) *
                           (dp[j][e] - dl0);
            if (__ldg(lay1 + cb) != 0 && BLOCK_SPARSE_ALLOWED(pad1, row1, col, nc))
              acc[j][2 + e] += exp2f((s[j][2 + e] + bl[j][2 + e]) * sc - lse1) *
                               (dp[j][2 + e] - dl1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + j * 8 + 2 * t + e;
      if (col < L) {
        if (row0 < L) dbias[static_cast<size_t>(row0) * L + col] = acc[j][e] * scale;
        if (row1 < L) dbias[static_cast<size_t>(row1) * L + col] = acc[j][2 + e] * scale;
      }
    }
  }
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv (B,H,L,D) bf16 contiguous, D = 64; bias
// (L,L) fp32 or null, and dbias (L,L) fp32 or null (only with a bias: the
// dbias kernel runs when it is given);
// layout (H,nb,nb) uint8 with nb * block >= L; counts/indices (H,nt) and
// (H,nt,nt) int32, the forward's plan (key tiles of each query tile), and
// counts_t/indices_t its transpose (query tiles of each key tile), both
// ascending, nt = ceil(L / 64); lse (B,H,L) fp32 from the forward (natural
// log); delta (B,H,L) fp32 scratch. Returns the first cudaGetLastError()
// that is not 0.
extern "C" int block_sparse_bwd_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* layout, const void* counts, const void* indices,
    const void* counts_t, const void* indices_t, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* dbias, int B, int H, int L, int hd, int nb, int block,
    int nt, int nc, int pad_start, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535 || B > 65535 || block <= 0 ||
      nb <= 0 || static_cast<long long>(nb) * block < L ||
      nt != (L + BLOCK_ROWS - 1) / BLOCK_ROWS || hd != D ||
      (bias == nullptr && dbias != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dop = static_cast<const bf*>(dout);
  const float* bp = static_cast<const float*>(bias);
  const uint8_t* lp = static_cast<const uint8_t*>(layout);
  const int* ct = static_cast<const int*>(counts_t);
  const int* it = static_cast<const int*>(indices_t);
  const float* lsep = static_cast<const float*>(lse);
  float* dlp = static_cast<float*>(delta);

  block_sparse_bwd_dq_kernel<<<dim3(nt, H, B), NUM_THREADS, 0, s>>>(
      qp, kp, vp, bp, lp, static_cast<const int*>(counts),
      static_cast<const int*>(indices), static_cast<const bf*>(out), dop, lsep,
      dlp, static_cast<bf*>(dq), H, L, nb, block, nt, nc, pad_start, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  block_sparse_bwd_dkdv_kernel<<<dim3(nt, H, B), NUM_THREADS, 0, s>>>(
      qp, kp, vp, bp, lp, ct, it, dop, lsep, dlp, static_cast<bf*>(dk),
      static_cast<bf*>(dv), H, L, nb, block, nt, nc, pad_start, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (dbias != nullptr) {
    block_sparse_bwd_dbias_kernel<<<dim3(nt, nt), NUM_THREADS, 0, s>>>(
        qp, kp, vp, bp, lp, ct, it, dop, lsep, dlp, static_cast<float*>(dbias),
        B, H, L, nb, block, nt, nc, pad_start, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
