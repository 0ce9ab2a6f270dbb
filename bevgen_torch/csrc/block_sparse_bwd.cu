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
// Beyond the bound, time goes to feeding the tensor cores (16 KB copied in
// for each tile pair a pass visits), to the exponentials, to the keep rule
// wherever it is evaluated, and to the recomputation of the two passes.
//
// Design. Blocks of a CUDA grid run in no order, so each sum gets a kernel
// whose block owns its output tile and loops over the summed axis, with no
// atomics and a result that does not depend on scheduling (the two passes
// of the TPU kernel):
//
//   1. dq    grid (nt, H, B): a warpgroup owns 64 query rows (q and dO in
//            shared memory), forms delta = rowsum(dO * O) for them (written
//            for kernel 2), and walks the key tiles the forward's plan lists
//            for (head, q tile), K/V through a ring: S = q k^T and dP = dO v^T
//            (both operands K-major in shared memory), dS, then dq += dS k
//            (dS from registers, k MN-major).
//   2. dkdv  grid (nt, H, B): a warpgroup owns 64 keys (k and v in shared
//            memory) and walks the TRANSPOSED plan, the q tiles whose list
//            holds this key tile, q/dO with their lse and delta through a
//            ring: S^T = k q^T, dP^T = v dO^T, then dv += P^T dO and dk +=
//            dS^T q (P^T, dS^T from registers; dO, q MN-major). Each listed
//            (q tile, key tile) pair is visited once by kernel 1 and once by
//            kernel 2.
//   3. dbias grid (nt, nt): a block owns a 64 x 64 tile of dbias and loops
//            over the heads whose plan lists that tile and over the batch:
//            S, dP, dS. A tile no head lists is written as zeros. Launched
//            only with a bias; no path has one (no preset has a camera
//            bias), so it keeps the first version's mma.sync m16n8k16 and
//            synchronous loads (mma_common.cuh).
//
// Kernels 1 and 2 run every product on wgmma m64n64k16 (hopper_common.cuh);
// none stays on mma.sync. Their rings (STAGES stages, filled with cp.async
// in the 128-byte swizzle) keep the next tile's copy in flight while this
// tile's products run, and the products are committed in groups so that
// the exponentials of P run while dP is formed (and, in kernel 2, dS^T
// while dv += P^T dO runs). The tile plans flag full tiles (every pair kept):
// those skip the mask, the partial ones apply the rule to every pair. P is
// exponentiated on the special-function unit (`exp2_approx`). The
// fp32 bias tile of kernel 2 lives in dynamic shared memory, allocated only
// with a bias. The price is recomputation: S and dP are formed in both
// passes without a bias (7 products of D per kept pair where the bound
// counts 5) and three times with one. P and dS are rounded to bf16 before
// the dv, dq and dk products; dbias sums fp32 dS.
//
// C interface: block_sparse_bwd_bf16(...) launches the kernels in that
// order on one stream and returns the first cudaGetLastError() that is not 0.

#include <math_constants.h>

#include "block_sparse_mask.cuh"
#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
// head dim: 1024 / 16 heads in every AR configuration; the wrapper raises
// for any other
constexpr int D = 64;
constexpr int KSTEPS = D / 16;  // 16-wide slices of the head dim
constexpr int STAGES = 2;       // the rings of kernels 1 and 2

namespace wg {

using namespace hopper;

// ---- 1. dq (and delta) ------------------------------------------------------
// q, dO, then the ring (stage st: K, then V)
constexpr int DQ_SMEM = (2 + 2 * STAGES) * TILE_BYTES + 1024;

__global__ void __launch_bounds__(WG_THREADS)
block_sparse_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           const uint8_t* __restrict__ layout,
                           const int* __restrict__ counts,
                           const int* __restrict__ indices,
                           const uint8_t* __restrict__ full,
                           const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int H, int L,
                           int nb, int block, int nt, int nc, int pad_start,
                           float scale) {
  constexpr int HD = D / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float dl_s[TILE_ROWS];
  const uint32_t q_s = smem_addr(align1024(smem_raw));
  const uint32_t do_s = q_s + TILE_BYTES;
  const uint32_t ring = do_s + TILE_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, q0 = qt * TILE_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* kb = k + bh * L * D;
  const __nv_bfloat16* vb = v + bh * L * D;
  const __nv_bfloat16* dob = dout + bh * L * D;
  const size_t plan = static_cast<size_t>(h) * nt + qt;
  const int n_tiles = counts[plan];
  const int* tiles = indices + plan * nt;
  const uint8_t* tile_full = full + plan * nt;

  auto load_kv = [&](int it) {
    if (it < n_tiles) {
      const uint32_t st = ring + (it % STAGES) * 2 * TILE_BYTES;
      const int kv0 = tiles[it] * TILE_ROWS;
      load_tile_async(st, kb, kv0, L, tid);
      load_tile_async(st + TILE_BYTES, vb, kv0, L, tid);
    }
    cp_async_commit();
  };
  load_tile_async(q_s, q + bh * L * D, q0, L, tid);
  load_tile_async(do_s, dob, q0, L, tid);
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_kv(it);

  {  // delta = rowsum(dO * O), two threads per row, straight from memory
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
      if (row < L) delta[bh * L + row] = d;
    }
  }
  __syncthreads();  // dl_s

  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const uint8_t* lay0 = block_sparse::layout_row(layout, h, nb, row0, block);
  const uint8_t* lay1 = block_sparse::layout_row(layout, h, nb, row1, block);
  const bool pad0 = row0 >= pad_start, pad1 = row1 >= pad_start;
  // a row past L gets lse +inf, so its P is 0 and its dS is 0
  const float lse0 = row0 < L ? lse[bh * L + row0] * LOG2E : CUDART_INF_F;
  const float lse1 = row1 < L ? lse[bh * L + row1] * LOG2E : CUDART_INF_F;
  const float dl0 = dl_s[wr + g], dl1 = dl_s[wr + g + 8];
  const float sc = scale * LOG2E;

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

    // S, then dP, as two groups: P is formed while dP is in flight
    float s[NT][4], dp[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // S = q k^T (raw)
      wgmma_ss(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // dP = dO v^T
      wgmma_ss(dp, desc_k_major(do_s, kk), desc_k_major(v_s, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);

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
          s[j][e] = exp2_approx((s[j][e] + b0) * sc - lse0);
          s[j][2 + e] = exp2_approx((s[j][2 + e] + b1) * sc - lse1);
        }
      }
    } else {
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
              p0 = exp2_approx((s[j][e] + b0) * sc - lse0);
            if (__ldg(lay1 + cb) != 0 && BLOCK_SPARSE_ALLOWED(pad1, row1, col, nc))
              p1 = exp2_approx((s[j][2 + e] + b1) * sc - lse1);
          }
          s[j][e] = p0;
          s[j][2 + e] = p1;
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // dS = P (dP - delta)
      s[j][0] *= dp[j][0] - dl0;
      s[j][1] *= dp[j][1] - dl0;
      s[j][2] *= dp[j][2] - dl1;
      s[j][3] *= dp[j][3] - dl1;
    }
    uint32_t dsa[TILE_ROWS / 16][4];
    pack_a(dsa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE_ROWS / 16; ++kk)  // dq += dS k
      wgmma_rs(acc, dsa[kk], desc_mn_major(k_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(dsa);
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = dq + bh * L * D;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
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
// k, v, then the ring (stage st: q, dO), then the lse and delta of each
// stage's 64 rows (after the tiles, which stay 1024-byte aligned), then,
// with a bias only, the (64 x 65) fp32 bias tile
constexpr int VEC_BYTES = 2 * TILE_ROWS * 4;
constexpr int BLD = TILE_ROWS + 1;  // bias tile stride (fp32)
constexpr int DKDV_SMEM = (2 + 2 * STAGES) * TILE_BYTES + STAGES * VEC_BYTES + 1024;
constexpr int DKDV_BIAS_SMEM = DKDV_SMEM + TILE_ROWS * BLD * 4;

__global__ void __launch_bounds__(WG_THREADS)
block_sparse_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias,
                             const uint8_t* __restrict__ layout,
                             const int* __restrict__ counts_t,
                             const int* __restrict__ indices_t,
                             const uint8_t* __restrict__ full_t,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int L,
                             int nb, int block, int nt, int nc, int pad_start,
                             float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t k_s = smem_addr(smem);
  const uint32_t v_s = k_s + TILE_BYTES;
  const uint32_t ring = v_s + TILE_BYTES;
  const uint32_t vecs = ring + STAGES * 2 * TILE_BYTES;
  const uint8_t* vecs_p = smem + (2 + 2 * STAGES) * TILE_BYTES;
  float* bias_s = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * TILE_BYTES +
                                           STAGES * VEC_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x, k0 = kt * TILE_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* qb = q + bh * L * D;
  const __nv_bfloat16* dob = dout + bh * L * D;
  const size_t plan = static_cast<size_t>(h) * nt + kt;
  const int n_tiles = counts_t[plan];
  const int* tiles = indices_t + plan * nt;
  const uint8_t* tile_full = full_t + plan * nt;

  auto load_qdo = [&](int it) {
    if (it < n_tiles) {
      const int st = it % STAGES;
      const uint32_t s0 = ring + st * 2 * TILE_BYTES;
      const int r0 = tiles[it] * TILE_ROWS;
      load_tile_async(s0, qb, r0, L, tid);
      load_tile_async(s0 + TILE_BYTES, dob, r0, L, tid);
      // lse (threads 0-63) and delta (64-127) of the 64 rows; zero past L
      const uint32_t vec = vecs + st * VEC_BYTES + (tid / TILE_ROWS) * TILE_ROWS * 4;
      load_vec_async(vec, (tid < TILE_ROWS ? lse : delta) + bh * L, r0, L,
                     tid % TILE_ROWS);
    }
    cp_async_commit();
  };
  load_tile_async(k_s, k + bh * L * D, k0, L, tid);
  load_tile_async(v_s, v + bh * L * D, k0, L, tid);
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_qdo(it);

  const int wk = warp * 16;
  const int key0 = k0 + wk + g, key1 = key0 + 8;
  // the keys' layout columns; keys past L are never kept
  const int kb0 = key0 < L ? key0 / block : -1;
  const int kb1 = key1 < L ? key1 / block : -1;
  const float sc = scale * LOG2E;

  float dka[NT][4], dva[NT][4];
  zero(dka);
  zero(dva);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile it is in place; every warp is done with it - 1
    load_qdo(it + STAGES - 1);
    const int st = it % STAGES;
    const uint32_t q_s = ring + st * 2 * TILE_BYTES;
    const uint32_t do_s = q_s + TILE_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(vecs_p + st * VEC_BYTES);
    const float* dl_s = lse_s + TILE_ROWS;
    const int q0 = tiles[it] * TILE_ROWS;
    if (bias != nullptr) {
      for (int i = tid; i < TILE_ROWS * TILE_ROWS; i += WG_THREADS) {
        const int r = i / TILE_ROWS, c = i % TILE_ROWS;
        bias_s[r * BLD + c] =
            (q0 + r < L && k0 + c < L)
                ? __ldg(bias + static_cast<size_t>(q0 + r) * L + k0 + c)
                : 0.f;
      }
      __syncthreads();
    }

    // transposed tiles: rows are the warpgroup's 64 keys, columns 64
    // queries. S^T, then dP^T, as two groups: P^T is formed while dP^T is
    // in flight, and dS^T while dv += P^T dO is.
    float st_[NT][4], dpt[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // S^T = k q^T (raw)
      wgmma_ss(st_, desc_k_major(k_s, kk), desc_k_major(q_s, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // dP^T = v dO^T
      wgmma_ss(dpt, desc_k_major(v_s, kk), desc_k_major(do_s, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(st_);

    const bool is_full = tile_full[it] != 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;
        const float lq = lse_s[qc] * LOG2E;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          b0 = bias_s[qc * BLD + wk + g];
          b1 = bias_s[qc * BLD + wk + g + 8];
        }
        float p0, p1;
        if (is_full) {
          p0 = exp2_approx((st_[j][e] + b0) * sc - lq);
          p1 = exp2_approx((st_[j][2 + e] + b1) * sc - lq);
        } else {
          // rows past L (zero lse) are never kept
          const int row = q0 + qc;
          const uint8_t* lay = block_sparse::layout_row(layout, h, nb, row, block);
          const bool pad = row >= pad_start;
          p0 = p1 = 0.f;
          if (row < L && kb0 >= 0 && __ldg(lay + kb0) != 0 &&
              BLOCK_SPARSE_ALLOWED(pad, row, key0, nc))
            p0 = exp2_approx((st_[j][e] + b0) * sc - lq);
          if (row < L && kb1 >= 0 && __ldg(lay + kb1) != 0 &&
              BLOCK_SPARSE_ALLOWED(pad, row, key1, nc))
            p1 = exp2_approx((st_[j][2 + e] + b1) * sc - lq);
        }
        st_[j][e] = p0;
        st_[j][2 + e] = p1;
      }
    }
    uint32_t pa[TILE_ROWS / 16][4], dsa[TILE_ROWS / 16][4];
    pack_a(pa, st_);
    wgmma_wait<0>();
    fence_operands(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE_ROWS / 16; ++kk)  // dv += P^T dO
      wgmma_rs(dva, pa[kk], desc_mn_major(do_s, kk));
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dq_ = dl_s[j * 8 + 2 * t + e];
        dpt[j][e] = st_[j][e] * (dpt[j][e] - dq_);
        dpt[j][2 + e] = st_[j][2 + e] * (dpt[j][2 + e] - dq_);
      }
    }
    pack_a(dsa, dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE_ROWS / 16; ++kk)  // dk += dS^T q
      wgmma_rs(dka, dsa[kk], desc_mn_major(q_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dva);
    fence_operands(dka);
    fence_operands(pa);
    fence_operands(dsa);
  }
  cp_async_wait<0>();

  __nv_bfloat16* dkb = dk + bh * L * D;
  __nv_bfloat16* dvb = dv + bh * L * D;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
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

}  // namespace wg

// ---- 3. dbias ---------------------------------------------------------------
namespace sync_mma {

using namespace mma_common;

constexpr int LD = D + 8;  // smem row stride in bf16 (16-byte multiple)

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

}  // namespace sync_mma

// Lets kernels 1 and 2 take their dynamic shared memory (above the default
// 48 KB), once per process.
cudaError_t allow_smem() {
  static const cudaError_t err[2] = {
      cudaFuncSetAttribute(wg::block_sparse_bwd_dq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           wg::DQ_SMEM),
      cudaFuncSetAttribute(wg::block_sparse_bwd_dkdv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           wg::DKDV_BIAS_SMEM)};
  return err[0] != cudaSuccess ? err[0] : err[1];
}

}  // namespace

// Dynamic shared memory per block and the blocks that fit on one SM
// (registers and shared memory together) of kernel 0 (dq), 1 (dk/dv) or 2
// (dk/dv with a bias), for reports. Returns a cudaError_t.
extern "C" int block_sparse_bwd_resources(int kernel, int* smem_bytes,
                                          int* blocks_per_sm) {
  if (kernel < 0 || kernel > 2) return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = kernel == 0 ? wg::DQ_SMEM
                            : kernel == 1 ? wg::DKDV_SMEM : wg::DKDV_BIAS_SMEM;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kernel == 0)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, wg::block_sparse_bwd_dq_kernel, hopper::WG_THREADS,
        *smem_bytes));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wg::block_sparse_bwd_dkdv_kernel, hopper::WG_THREADS,
      *smem_bytes));
}

// q, k, v, out, dout, dq, dk, dv (B,H,L,D) bf16 contiguous, D = 64; bias
// (L,L) fp32 or null, and dbias (L,L) fp32 or null (only with a bias: the
// dbias kernel runs when it is given);
// layout (H,nb,nb) uint8 with nb * block >= L; counts/indices/full (H,nt),
// (H,nt,nt) int32 and (H,nt,nt) uint8, the forward's plan (key tiles of
// each query tile, and whether every pair of each is kept), and
// counts_t/indices_t/full_t its transpose (query tiles of each key tile),
// both ascending, nt = ceil(L / 64); lse (B,H,L) fp32 from the forward
// (natural log); delta (B,H,L) fp32 scratch. Returns the first
// cudaGetLastError() that is not 0.
extern "C" int block_sparse_bwd_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* layout, const void* counts, const void* indices,
    const void* full, const void* counts_t, const void* indices_t,
    const void* full_t, const void* out, const void* dout, const void* lse,
    void* delta, void* dq, void* dk, void* dv, void* dbias, int B, int H,
    int L, int hd, int nb, int block, int nt, int nc, int pad_start,
    float scale, void* stream) {
  using hopper::TILE_ROWS;
  using hopper::WG_THREADS;
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535 || B > 65535 || block <= 0 ||
      nb <= 0 || static_cast<long long>(nb) * block < L ||
      nt != (L + TILE_ROWS - 1) / TILE_ROWS || hd != D || full == nullptr ||
      full_t == nullptr || (bias == nullptr && dbias != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
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

  wg::block_sparse_bwd_dq_kernel<<<dim3(nt, H, B), WG_THREADS, wg::DQ_SMEM, s>>>(
      qp, kp, vp, bp, lp, static_cast<const int*>(counts),
      static_cast<const int*>(indices), static_cast<const uint8_t*>(full),
      static_cast<const bf*>(out), dop, lsep, dlp, static_cast<bf*>(dq), H, L,
      nb, block, nt, nc, pad_start, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int dkdv_smem = bias != nullptr ? wg::DKDV_BIAS_SMEM : wg::DKDV_SMEM;
  wg::block_sparse_bwd_dkdv_kernel<<<dim3(nt, H, B), WG_THREADS, dkdv_smem, s>>>(
      qp, kp, vp, bp, lp, ct, it, static_cast<const uint8_t*>(full_t), dop,
      lsep, dlp, static_cast<bf*>(dk), static_cast<bf*>(dv), H, L, nb, block,
      nt, nc, pad_start, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (dbias != nullptr) {
    sync_mma::block_sparse_bwd_dbias_kernel<<<dim3(nt, nt), mma_common::NUM_THREADS,
                                         0, s>>>(
        qp, kp, vp, bp, lp, ct, it, dop, lsep, dlp, static_cast<float*>(dbias),
        B, H, L, nb, block, nt, nc, pad_start, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
