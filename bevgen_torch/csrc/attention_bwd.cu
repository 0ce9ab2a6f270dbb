// Attention backward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel `fused_bias_attention_bwd`
// (bevgen_tpu/ops/pallas/fused_attention.py:198, kernel body `_bwd_kernel`
// :138), the training backward of every MUSE attention. Inputs come after the
// cosine prologue: q (B,H,N,D), k/v (B,H,M,D) bf16 with the null column at
// column 0, bias (N,M) fp32 or null, keep (B,) int32 or null, dO (B,H,N,D)
// bf16, and from the forward (cosine_attention.cu) its output O and the
// per-row logsumexp in log2 units. With column j valid when j < M and
// (keep[b] != 0 or j == 0):
//
//   P    = softmax_j(sm_scale q k^T + bias)  = exp2((sm_scale q.k_j + bias) log2e - lse2)
//   dP   = dO v^T,   delta_i = sum_d dO_id O_id   (= sum_j P_ij dP_ij)
//   dS   = P * (dP - delta), zero on invalid columns
//   dq   = sm_scale dS k,  dk = sm_scale dS^T q,  dv = P^T dO
//   dbias = sum over (b, h) of dS   (shared by the batch and the heads)
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// five products (S, dP, dq, dk, dv) are 5 N M D multiply-adds, 10 N M D
// FLOP, per (b, h). Self-attention at B=8, H=16, N=1792, M=1793, D=64 is 263
// GFLOP, about 0.27 ms: operations. Cross-attention (M=257) is 38 GFLOP
// (0.038 ms) against about 100 MB of inputs and outputs (0.030 ms):
// operations too. (Estimates from the shapes; chip_smoke.py computes the
// bound per call.)
//
// Design. The TPU kernel sums dk/dv by revisiting an output block along the
// q-tile grid axis and dbias along the head-group axis; blocks of a CUDA grid
// run in no order, so each of the three sums gets a kernel whose block owns
// its output tile and loops over the summed axis, with no atomics and a
// result that does not depend on scheduling:
//
//   1. dq    grid (N/64, H, B): a block owns 64 query rows, computes
//            delta = rowsum(dO * O) for them (written for kernels 2 and 3),
//            and loops over the key tiles: S, dP, dS, dq += dS k.
//   2. dkdv  grid (M/64, H, B): a block owns 64 keys (K and V as A fragments
//            in registers) and loops over the query tiles: S^T, dP^T, then
//            dv += P^T dO and dk += dS^T q. Blocks of a dropped sample past
//            the first key tile write zeros and stop.
//   3. dbias grid (N/64, M/64): a block owns a 64 x 64 tile of dbias (in
//            registers, with its bias tile) and loops over (b, h): S, dP, dS.
//            Launched only with a bias.
//
// The price of that choice is recomputation: S and dP are formed three times
// (9 products of N M D per (b, h) where the bound counts 5), but no
// (B,H,N,M) tensor and no atomic touches device memory. dS is rounded to bf16
// for the dq and dk products (as P is for dv); dbias sums fp32 dS. Loads are
// synchronous and the products are mma.sync m16n8k16: a first version.
//
// C interface: attention_bwd_bf16(...) launches the kernels in that order on
// one stream and returns the first cudaGetLastError() that is not 0.

#include "mma_common.cuh"

namespace {

using namespace mma_common;

// ---- 1. dq (and delta) ------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ bias, const int* __restrict__ keep,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int H, int N, int M,
                   float sm_scale) {
  constexpr int LD = D + 8, HD = D / 2, KSTEPS = D / 16, NT_O = D / 8;
  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BLOCK_ROWS * LD];
  __shared__ float lse_s[BLOCK_ROWS];
  __shared__ float dl_s[BLOCK_ROWS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BLOCK_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* kb = k + bh * M * D;
  const __nv_bfloat16* vb = v + bh * M * D;
  const __nv_bfloat16* dob = dout + bh * N * D;

  load_tiles<D>(q_s, q + bh * N * D, do_s, dob, q0, N, tid);
  {  // delta = rowsum(dO * O), two threads per row
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    float d = 0.f;
    if (row < N) {
      const size_t off = static_cast<size_t>(row) * D + half * HD;
      const uint4* po = reinterpret_cast<const uint4*>(o + bh * N * D + off);
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
      // a padded row gets lse +inf, so its P is 0 and its dS is 0
      lse_s[r] = row < N ? lse[bh * N + row] : CUDART_INF_F;
      if (row < N) delta[bh * N + row] = d;
    }
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
  load_a<D>(qa, q_s, wr, g, t);
  load_a<D>(da, do_s, wr, g, t);
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float lse0 = lse_s[wr + g], lse1 = lse_s[wr + g + 8];
  const float dl0 = dl_s[wr + g], dl1 = dl_s[wr + g + 8];
  const bool kept = (keep == nullptr) || (keep[b] != 0);
  const int n_tiles = kept ? (M + BLOCK_ROWS - 1) / BLOCK_ROWS : 1;

  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * BLOCK_ROWS;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tiles<D>(k_s, kb, v_s, vb, kv0, M, tid);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    mma_abt<D>(s, qa, k_s, g, t);   // S = q k^T (unscaled)
    mma_abt<D>(dp, da, v_s, g, t);  // dP = dO v^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + j * 8 + 2 * t + e;
        float p0 = 0.f, p1 = 0.f;
        if (col < M && (kept || col == 0)) {
          float b0 = 0.f, b1 = 0.f;
          if (bias != nullptr) {
            if (row0 < N) b0 = __ldg(bias + static_cast<size_t>(row0) * M + col);
            if (row1 < N) b1 = __ldg(bias + static_cast<size_t>(row1) * M + col);
          }
          p0 = exp2f((s[j][e] * sm_scale + b0) * LOG2E - lse0);
          p1 = exp2f((s[j][2 + e] * sm_scale + b1) * LOG2E - lse1);
        }
        s[j][e] = p0 * (dp[j][e] - dl0);  // dS
        s[j][2 + e] = p1 * (dp[j][2 + e] - dl1);
      }
    }
    uint32_t dsa[BLOCK_ROWS / 16][4];
    pack_a(dsa, s);
    mma_ab<D>(acc, dsa, k_s, g, t);  // dq += dS k
  }

  __nv_bfloat16* dqb = dq + bh * N * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(&dqb[static_cast<size_t>(row0) * D + c]) =
          pack_bf16(acc[j][0] * sm_scale, acc[j][1] * sm_scale);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(&dqb[static_cast<size_t>(row1) * D + c]) =
          pack_bf16(acc[j][2] * sm_scale, acc[j][3] * sm_scale);
  }
}

// ---- 2. dk, dv --------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     const int* __restrict__ keep,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int N, int M,
                     float sm_scale) {
  constexpr int LD = D + 8, VPR = D / 8, KSTEPS = D / 16, NT_O = D / 8;
  constexpr int BLD = BLOCK_ROWS + 1;  // bias tile stride (fp32)
  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BLOCK_ROWS * LD];
  __shared__ float bias_s[BLOCK_ROWS * BLD];
  __shared__ float lse_s[BLOCK_ROWS];
  __shared__ float dl_s[BLOCK_ROWS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BLOCK_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  __nv_bfloat16* dkb = dk + bh * M * D;
  __nv_bfloat16* dvb = dv + bh * M * D;
  const bool kept = (keep == nullptr) || (keep[b] != 0);

  if (!kept && k0 > 0) {
    // a dropped sample attends to the null column only: no other key of it
    // gets a gradient
    for (int i = tid; i < BLOCK_ROWS * VPR; i += NUM_THREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      if (k0 + r < M) {
        const size_t off = static_cast<size_t>(k0 + r) * D + c;
        *reinterpret_cast<uint4*>(dkb + off) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dvb + off) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  // this block's K and V tiles, staged through q_s/do_s, as A fragments
  load_tiles<D>(q_s, k + bh * M * D, do_s, v + bh * M * D, k0, M, tid);
  __syncthreads();
  const int wk = warp * 16;
  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  load_a<D>(ka, q_s, wk, g, t);
  load_a<D>(va, do_s, wk, g, t);
  const int key0 = k0 + wk + g, key1 = key0 + 8;
  const bool live0 = key0 < M && (kept || key0 == 0);
  const bool live1 = key1 < M && (kept || key1 == 0);

  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  const __nv_bfloat16* qb = q + bh * N * D;
  const __nv_bfloat16* dob = dout + bh * N * D;
  const int n_qt = (N + BLOCK_ROWS - 1) / BLOCK_ROWS;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BLOCK_ROWS;
    __syncthreads();  // every warp is done with the previous tiles
    load_tiles<D>(q_s, qb, do_s, dob, q0, N, tid);
    if (tid < BLOCK_ROWS) {
      const int row = q0 + tid;
      lse_s[tid] = row < N ? lse[bh * N + row] : CUDART_INF_F;
      dl_s[tid] = row < N ? delta[bh * N + row] : 0.f;
    }
    if (bias != nullptr) {
      for (int i = tid; i < BLOCK_ROWS * BLOCK_ROWS; i += NUM_THREADS) {
        const int r = i / BLOCK_ROWS, c = i % BLOCK_ROWS;
        bias_s[r * BLD + c] =
            (q0 + r < N && k0 + c < M)
                ? __ldg(bias + static_cast<size_t>(q0 + r) * M + k0 + c)
                : 0.f;
      }
    }
    __syncthreads();

    // transposed tiles: rows are this warp's 16 keys, columns 64 queries
    float st[NT][4], dpt[NT][4];
    mma_abt<D>(st, ka, q_s, g, t);    // S^T = k q^T
    mma_abt<D>(dpt, va, do_s, g, t);  // dP^T = v dO^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;
        const float lq = lse_s[qc], dq_ = dl_s[qc];
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          b0 = bias_s[qc * BLD + wk + g];
          b1 = bias_s[qc * BLD + wk + g + 8];
        }
        const float p0 = live0 ? exp2f((st[j][e] * sm_scale + b0) * LOG2E - lq) : 0.f;
        const float p1 = live1 ? exp2f((st[j][2 + e] * sm_scale + b1) * LOG2E - lq) : 0.f;
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

#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (key0 < M) {
      const size_t off = static_cast<size_t>(key0) * D + c;
      *reinterpret_cast<uint32_t*>(&dkb[off]) =
          pack_bf16(dka[j][0] * sm_scale, dka[j][1] * sm_scale);
      *reinterpret_cast<uint32_t*>(&dvb[off]) = pack_bf16(dva[j][0], dva[j][1]);
    }
    if (key1 < M) {
      const size_t off = static_cast<size_t>(key1) * D + c;
      *reinterpret_cast<uint32_t*>(&dkb[off]) =
          pack_bf16(dka[j][2] * sm_scale, dka[j][3] * sm_scale);
      *reinterpret_cast<uint32_t*>(&dvb[off]) = pack_bf16(dva[j][2], dva[j][3]);
    }
  }
}

// ---- 3. dbias ---------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attn_bwd_dbias_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      const int* __restrict__ keep,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dbias, int B, int H, int N, int M,
                      float sm_scale) {
  constexpr int LD = D + 8, KSTEPS = D / 16;
  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BLOCK_ROWS * LD];
  __shared__ float lse_s[BLOCK_ROWS];
  __shared__ float dl_s[BLOCK_ROWS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BLOCK_ROWS, k0 = blockIdx.y * BLOCK_ROWS;
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;

  // this block's bias tile in score-fragment order, and its dbias sums
  float bl[NT][4], acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + j * 8 + 2 * t + e;
      bl[j][e] = (row0 < N && col < M)
                     ? __ldg(bias + static_cast<size_t>(row0) * M + col) : 0.f;
      bl[j][2 + e] = (row1 < N && col < M)
                         ? __ldg(bias + static_cast<size_t>(row1) * M + col) : 0.f;
      acc[j][e] = acc[j][2 + e] = 0.f;
    }
  }

  for (int b = 0; b < B; ++b) {
    const bool kept = (keep == nullptr) || (keep[b] != 0);
    if (!kept && k0 > 0) continue;  // only the null column is live (block-uniform)
    for (int h = 0; h < H; ++h) {
      const size_t bh = static_cast<size_t>(b) * H + h;
      __syncthreads();  // every warp is done with the previous tiles
      load_tiles<D>(q_s, q + bh * N * D, do_s, dout + bh * N * D, q0, N, tid);
      load_tiles<D>(k_s, k + bh * M * D, v_s, v + bh * M * D, k0, M, tid);
      if (tid < BLOCK_ROWS) {
        const int row = q0 + tid;
        lse_s[tid] = row < N ? lse[bh * N + row] : CUDART_INF_F;
        dl_s[tid] = row < N ? delta[bh * N + row] : 0.f;
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
          if (col < M && (kept || col == 0)) {
            const float p0 = exp2f((s[j][e] * sm_scale + bl[j][e]) * LOG2E - lse0);
            const float p1 = exp2f((s[j][2 + e] * sm_scale + bl[j][2 + e]) * LOG2E - lse1);
            acc[j][e] += p0 * (dp[j][e] - dl0);
            acc[j][2 + e] += p1 * (dp[j][2 + e] - dl1);
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
      if (col < M) {
        if (row0 < N) dbias[static_cast<size_t>(row0) * M + col] = acc[j][e];
        if (row1 < N) dbias[static_cast<size_t>(row1) * M + col] = acc[j][2 + e];
      }
    }
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* bias,
               const void* keep, const void* o, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv,
               void* dbias, int B, int H, int N, int M, float sm_scale,
               cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dop = static_cast<const bf*>(dout);
  const float* bp = static_cast<const float*>(bias);
  const int* kpp = static_cast<const int*>(keep);
  const float* lp = static_cast<const float*>(lse);
  float* dlp = static_cast<float*>(delta);
  const int nq = (N + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int nk = (M + BLOCK_ROWS - 1) / BLOCK_ROWS;

  attn_bwd_dq_kernel<D><<<dim3(nq, H, B), NUM_THREADS, 0, s>>>(
      qp, kp, vp, bp, kpp, static_cast<const bf*>(o), dop, lp, dlp,
      static_cast<bf*>(dq), H, N, M, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  attn_bwd_dkdv_kernel<D><<<dim3(nk, H, B), NUM_THREADS, 0, s>>>(
      qp, kp, vp, bp, kpp, dop, lp, dlp, static_cast<bf*>(dk),
      static_cast<bf*>(dv), H, N, M, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (dbias != nullptr) {
    attn_bwd_dbias_kernel<D><<<dim3(nq, nk), NUM_THREADS, 0, s>>>(
        qp, kp, vp, bp, kpp, dop, lp, dlp, static_cast<float*>(dbias), B, H,
        N, M, sm_scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// q, o, dout, dq (B,H,N,D) and k, v, dk, dv (B,H,M,D) bf16 contiguous, the
// null column at k/v column 0; bias (N,M) fp32 or null, and dbias (N,M) fp32
// exactly when bias is given; keep (B,) int32 or null; lse (B,H,N) fp32 from
// the forward (log2 units); delta (B,H,N) fp32 scratch. Returns the first
// cudaGetLastError() that is not 0.
extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const void* bias, const void* keep,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, void* dbias, int B,
                                  int H, int N, int M, int D, float sm_scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || H > 65535 || B > 65535 ||
      (M + BLOCK_ROWS - 1) / BLOCK_ROWS > 65535 ||
      (bias == nullptr) != (dbias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_bwd<32>(q, k, v, bias, keep, o, dout, lse, delta, dq, dk,
                            dv, dbias, B, H, N, M, sm_scale, s);
    case 64:
      return launch_bwd<64>(q, k, v, bias, keep, o, dout, lse, delta, dq, dk,
                            dv, dbias, B, H, N, M, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
