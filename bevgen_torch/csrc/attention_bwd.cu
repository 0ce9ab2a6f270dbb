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
// bound per call.) Beyond the bound, time goes to the recomputation (S and
// dP are formed in all three kernels: 9 products where the bound counts 5
// with a bias, 7 without), to the tiles the blocks pull through L2 (reckoned
// per call by chip_smoke.py:bwd_l2_bytes) and to the exponentials.
//
// Design. Blocks of a CUDA grid run in no order, so each sum gets a kernel
// whose block owns its output tile and loops over the summed axis, with no
// atomics: two calls on the same inputs give the same bits.
//
//   1. dq    grid (N/64, B*H/2): a block of two warpgroups owns 64 query
//            rows of two (b, h) pairs, one pair a warpgroup (q and dO in
//            shared memory), forms delta = rowsum(dO * O) for them (written
//            for kernels 2 and 3) and walks the key tiles: S = q k^T and
//            dP = dO v^T (both operands K-major in shared memory), dS in
//            registers, then dq += dS k (dS from registers, k MN-major).
//   2. dkdv  grid (M/64, B*H/2): a warpgroup owns 64 keys of its pair (k
//            and v in shared memory) and walks the query tiles, q/dO with
//            their lse and delta through the ring: S^T = k q^T, dP^T = v
//            dO^T, then dv += P^T dO and dk += dS^T q (P^T, dS^T from
//            registers; dO, q MN-major). Keys past the first of a dropped
//            sample get zeros and no products.
//   3. dbias grid (N/64, M/128), with a bias only: a block of two
//            warpgroups owns 64 query rows by 128 keys of dbias (64 keys a
//            warpgroup, in registers, beside its bias entries) and loops
//            over (b, h) in order: S, dP, dS; the q/dO tiles of each (b, h)
//            serve both warpgroups.
//
// Every product runs on wgmma m64n64k16 (hopper_common.cuh). The K/V (or
// q/dO, or q/dO/K/V) tiles of the next step come through cp.async rings (two
// stages in kernels 1 and 2, three in kernel 3), issued after the barrier
// that frees their stage, and the products are committed in groups so that
// the exponentials (`ex2.approx`) run while dP is formed (and, in kernel 2,
// dS^T while dv += P^T dO runs). The fp32 bias tile of a step is staged once
// per block in shared memory, log2 e folded in, and serves both pairs; the
// bias rows must start on 16-byte boundaries (the wrapper pads a bias whose
// M is not a multiple of 4). The mask is evaluated only where it can change
// a stored result: the partial last key tile in kernel 1 (at M = 1793, the
// 29th), the partial last query tile in kernel 2, and the tiles of a dropped
// sample. D = 32 runs as a 64-wide tile whose upper half is zero-filled. q,
// k, v, O, dO, dq, dk and dv go by (b, h, row) strides with a contiguous
// last dim. dS is rounded to bf16 for the dq and dk products (as P is for
// dv); dbias sums fp32 dS.
//
// C interface: attention_bwd_bf16(...) launches the kernels in that order on
// one stream and returns the first cudaGetLastError() that is not 0.

#include <math_constants.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int PAIRS = 2;                   // (b, h) pairs of a dq or dk/dv block
constexpr int THREADS = PAIRS * WG_THREADS;
constexpr int STAGES = 2;                  // rings of kernels 1 and 2
constexpr int DB_STAGES = 3;               // ring of kernel 3
// staged bias rows (floats): kernel 1 reads them along the row, kernel 2
// across rows; each stride keeps its reads free of bank conflicts
constexpr int DQ_BIAS_LD = TILE_ROWS + 8;
constexpr int KV_BIAS_LD = TILE_ROWS + 4;
constexpr int VEC_BYTES = 2 * TILE_ROWS * 4;  // lse and delta of 64 rows

// kernel 1: q tiles, dO tiles, ring (stage, pair: K, V), bias ring
constexpr int DQ_RING = 2 * PAIRS * TILE_BYTES;
constexpr int DQ_BIAS = DQ_RING + STAGES * PAIRS * 2 * TILE_BYTES;
constexpr int DQ_BIAS_BYTES = TILE_ROWS * DQ_BIAS_LD * 4;
constexpr int DQ_SMEM = DQ_BIAS + STAGES * DQ_BIAS_BYTES + 1024;
// kernel 2: k tiles, v tiles, ring (stage, pair: q, dO), vectors (stage,
// pair), bias ring
constexpr int KV_RING = 2 * PAIRS * TILE_BYTES;
constexpr int KV_VECS = KV_RING + STAGES * PAIRS * 2 * TILE_BYTES;
constexpr int KV_BIAS = KV_VECS + STAGES * PAIRS * VEC_BYTES;
constexpr int KV_BIAS_BYTES = TILE_ROWS * KV_BIAS_LD * 4;
constexpr int KV_SMEM = KV_BIAS + STAGES * KV_BIAS_BYTES + 1024;
// kernel 3: ring (stage: q, dO, K of each warpgroup, V of each), vectors
constexpr int DB_TILES = 2 + 2 * PAIRS;
constexpr int DB_VECS = DB_STAGES * DB_TILES * TILE_BYTES;
constexpr int DB_SMEM = DB_VECS + DB_STAGES * VEC_BYTES + 1024;
constexpr int DB_KEYS = PAIRS * TILE_ROWS;  // keys of a dbias block

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* bias;
  const int* keep;
  const float* lse;
  float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dbias;
  int B, H, N, M;
  int ldb;  // bias row stride in floats, a multiple of 4
  float sm_scale;
  // (b, h, row) strides in elements of q, k, v, o, dout, dq, dk, dv
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
};

__device__ __forceinline__ bool sample_kept(const Params& p, int b) {
  return p.keep == nullptr || p.keep[b] != 0;
}

// rows [r0, r0 + 64) x columns [c0, c0 + 64) of the bias into a staged
// tile of row stride LD floats, 4 chunks of 16 bytes for each of the
// block's threads; entries past N or M are zero (a chunk that starts before
// column M may run into the row's padding)
template <int LD>
__device__ __forceinline__ void load_bias_async(const Params& p, float* dst,
                                                int r0, int c0, int tid) {
#pragma unroll
  for (int u = 0; u < TILE_ROWS * TILE_ROWS / 4 / THREADS; ++u) {
    const int idx = tid + u * THREADS;
    const int r = idx >> 4, c = (idx & 15) * 4;
    const bool ok = r0 + r < p.N && c0 + c < p.M;
    const float* src = ok ? p.bias + static_cast<size_t>(r0 + r) * p.ldb + c0 + c : p.bias;
    cp_async16(smem_addr(dst + r * LD + c), src, ok ? 16u : 0u);
  }
}

// log2 e into the bias entries this thread copied, once they have landed
template <int LD>
__device__ __forceinline__ void fold_bias(float* bs, int tid) {
#pragma unroll
  for (int u = 0; u < TILE_ROWS * TILE_ROWS / 4 / THREADS; ++u) {
    const int idx = tid + u * THREADS;
    float4* e = reinterpret_cast<float4*>(bs + (idx >> 4) * LD + (idx & 15) * 4);
    float4 x = *e;
    x.x *= LOG2E;
    x.y *= LOG2E;
    x.z *= LOG2E;
    x.w *= LOG2E;
    *e = x;
  }
}

// ---- 1. dq (and delta) ------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_kernel(const Params p) {
  constexpr int KSTEPS = D / 16, NT_O = D / 8, HD = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = align1024(smem_raw);
  const uint32_t sbase = smem_addr(base);
  __shared__ float dl_s[PAIRS][TILE_ROWS];
  __shared__ __align__(16) float zero_s[TILE_ROWS];

  const int tid = threadIdx.x;
  // the warpgroup index, broadcast so that the compiler sees it uniform
  // across the warpgroup (the wgmma path branches on it)
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int wt = tid % WG_THREADS;
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int N = p.N, M = p.M, H = p.H, BH = p.B * p.H;
  const int q0 = blockIdx.x * TILE_ROWS;
  const int all_tiles = (M + TILE_ROWS - 1) / TILE_ROWS;

  // key tiles of each pair: all of them, the first of a dropped sample,
  // none past B * H
  int tiles[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int bh_i = blockIdx.y * PAIRS + i;
    tiles[i] = bh_i >= BH ? 0 : (sample_kept(p, bh_i / H) ? all_tiles : 1);
  }
  const int n_tiles = max(tiles[0], tiles[1]);
  const int my_tiles = wg == 0 ? tiles[0] : tiles[1];
  const int bh = blockIdx.y * PAIRS + wg;
  const bool live = bh < BH;
  const int b = live ? bh / H : 0, h = live ? bh % H : 0;
  const bool kept = live && sample_kept(p, b);

  const __nv_bfloat16* kb = p.k + b * p.sk[0] + h * p.sk[1];
  const __nv_bfloat16* vb = p.v + b * p.sv[0] + h * p.sv[1];
  const __nv_bfloat16* dob = p.dout + b * p.sdo[0] + h * p.sdo[1];
  const uint32_t q_s = sbase + wg * TILE_BYTES;
  const uint32_t do_s = sbase + (PAIRS + wg) * TILE_BYTES;
  auto k_stage = [&](int it) {
    return sbase + DQ_RING + ((it % STAGES) * PAIRS + wg) * 2 * TILE_BYTES;
  };
  auto bias_stage = [&](int it) {
    return reinterpret_cast<float*>(base + DQ_BIAS + (it % STAGES) * DQ_BIAS_BYTES);
  };
  // one commit group per key tile: this pair's K and V tiles, this
  // thread's share of the bias tile
  auto load_kv = [&](int it) {
    if (it < n_tiles) {
      if (it < my_tiles) {
        const uint32_t st = k_stage(it);
        load_tile_rows_async<D>(st, kb, p.sk[2], it * TILE_ROWS, M, wt);
        load_tile_rows_async<D>(st + TILE_BYTES, vb, p.sv[2], it * TILE_ROWS, M, wt);
      }
      if (p.bias != nullptr)
        load_bias_async<DQ_BIAS_LD>(p, bias_stage(it), q0, it * TILE_ROWS, tid);
    }
    cp_async_commit();
  };
  if (live) {
    load_tile_rows_async<D>(q_s, p.q + b * p.sq[0] + h * p.sq[1], p.sq[2], q0, N, wt);
    load_tile_rows_async<D>(do_s, dob, p.sdo[2], q0, N, wt);
  }
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_kv(it);
  if (tid < TILE_ROWS) zero_s[tid] = 0.f;

  {  // delta = rowsum(dO * O), two threads per row, straight from memory
    const int r = wt / 2, hf = wt % 2, row = q0 + r;
    float d = 0.f;
    if (live && row < N) {
      const uint4* po = reinterpret_cast<const uint4*>(
          p.o + b * p.so[0] + h * p.so[1] + row * p.so[2] + hf * HD);
      const uint4* pd = reinterpret_cast<const uint4*>(dob + row * p.sdo[2] + hf * HD);
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
    if (hf == 0) {
      dl_s[wg][r] = d;
      if (live && row < N) p.delta[static_cast<size_t>(bh) * N + row] = d;
    }
  }
  __syncthreads();  // dl_s, zero_s

  const int lr0 = warp * 16 + g;
  const int row0 = q0 + lr0, row1 = row0 + 8;
  // rows past N are not stored, whatever their lse
  const float lse0 = live && row0 < N ? p.lse[static_cast<size_t>(bh) * N + row0] : 0.f;
  const float lse1 = live && row1 < N ? p.lse[static_cast<size_t>(bh) * N + row1] : 0.f;
  const float dl0 = dl_s[wg][lr0], dl1 = dl_s[wg][lr0 + 8];
  const float sc = p.sm_scale * LOG2E;

  float acc[NT][4];
  zero(acc);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();
    if (p.bias != nullptr) fold_bias<DQ_BIAS_LD>(bias_stage(it), tid);
    fence_proxy_async();
    __syncthreads();  // tile it is in place; every warp is done with it - 1
    load_kv(it + STAGES - 1);
    if (it >= my_tiles) continue;

    const uint32_t k_s = k_stage(it), v_s = k_s + TILE_BYTES;
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

    const float* bs0 = p.bias != nullptr ? bias_stage(it) + lr0 * DQ_BIAS_LD : zero_s;
    const float* bs1 = p.bias != nullptr ? bs0 + 8 * DQ_BIAS_LD : zero_s;
    const int kv0 = it * TILE_ROWS;
    if (kv0 + TILE_ROWS <= M && kept) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b0 = *reinterpret_cast<const float2*>(bs0 + j * 8 + 2 * t);
        const float2 b1 = *reinterpret_cast<const float2*>(bs1 + j * 8 + 2 * t);
        s[j][0] = exp2_approx(fmaf(s[j][0], sc, b0.x) - lse0);
        s[j][1] = exp2_approx(fmaf(s[j][1], sc, b0.y) - lse0);
        s[j][2] = exp2_approx(fmaf(s[j][2], sc, b1.x) - lse1);
        s[j][3] = exp2_approx(fmaf(s[j][3], sc, b1.y) - lse1);
      }
    } else {
      // the partial last tile, or the first tile of a dropped sample
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = j * 8 + 2 * t + e, col = kv0 + cl;
          const bool ok = col < M && (kept || col == 0);
          s[j][e] = ok ? exp2_approx(fmaf(s[j][e], sc, bs0[cl]) - lse0) : 0.f;
          s[j][2 + e] = ok ? exp2_approx(fmaf(s[j][2 + e], sc, bs1[cl]) - lse1) : 0.f;
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

  if (!live) return;
  __nv_bfloat16* dqb = p.dq + b * p.sdq[0] + h * p.sdq[1];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(&dqb[row0 * p.sdq[2] + c]) =
          pack_bf16(acc[j][0] * p.sm_scale, acc[j][1] * p.sm_scale);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(&dqb[row1 * p.sdq[2] + c]) =
          pack_bf16(acc[j][2] * p.sm_scale, acc[j][3] * p.sm_scale);
  }
}

// ---- 2. dk, dv --------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkdv_kernel(const Params p) {
  constexpr int KSTEPS = D / 16, NT_O = D / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = align1024(smem_raw);
  const uint32_t sbase = smem_addr(base);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int wt = tid % WG_THREADS;
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int N = p.N, M = p.M, H = p.H, BH = p.B * p.H;
  const int k0 = blockIdx.x * TILE_ROWS;

  // a pair's keys get gradients when it is live and kept, or (a dropped
  // sample) in the first key tile, where the null column is
  bool active[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int bh_i = blockIdx.y * PAIRS + i;
    active[i] = bh_i < BH && (k0 == 0 || sample_kept(p, bh_i / H));
  }
  const int n_qt = (active[0] || active[1]) ? (N + TILE_ROWS - 1) / TILE_ROWS : 0;
  const bool my_active = wg == 0 ? active[0] : active[1];
  const int bh = blockIdx.y * PAIRS + wg;
  const bool live = bh < BH;
  const int b = live ? bh / H : 0, h = live ? bh % H : 0;
  const bool kept = live && sample_kept(p, b);

  const uint32_t k_s = sbase + wg * TILE_BYTES;
  const uint32_t v_s = sbase + (PAIRS + wg) * TILE_BYTES;
  const __nv_bfloat16* qb = p.q + b * p.sq[0] + h * p.sq[1];
  const __nv_bfloat16* dob = p.dout + b * p.sdo[0] + h * p.sdo[1];
  auto q_stage = [&](int it) {
    return sbase + KV_RING + ((it % STAGES) * PAIRS + wg) * 2 * TILE_BYTES;
  };
  auto vec_stage = [&](int it) {  // lse, then delta, of this pair's 64 rows
    return KV_VECS + ((it % STAGES) * PAIRS + wg) * VEC_BYTES;
  };
  auto bias_stage = [&](int it) {
    return reinterpret_cast<float*>(base + KV_BIAS + (it % STAGES) * KV_BIAS_BYTES);
  };
  // one commit group per query tile: this pair's q and dO tiles with their
  // lse and delta, this thread's share of the bias tile
  auto load_qdo = [&](int it) {
    if (it < n_qt) {
      const int r0 = it * TILE_ROWS;
      if (my_active) {
        const uint32_t st = q_stage(it);
        load_tile_rows_async<D>(st, qb, p.sq[2], r0, N, wt);
        load_tile_rows_async<D>(st + TILE_BYTES, dob, p.sdo[2], r0, N, wt);
        // lse (threads 0-63) and delta (64-127) of the 64 rows; zero past N
        load_vec_async(sbase + vec_stage(it) + (wt / TILE_ROWS) * TILE_ROWS * 4,
                       (wt < TILE_ROWS ? p.lse : p.delta) + static_cast<size_t>(bh) * N,
                       r0, N, wt % TILE_ROWS);
      }
      if (p.bias != nullptr)
        load_bias_async<KV_BIAS_LD>(p, bias_stage(it), r0, k0, tid);
    }
    cp_async_commit();
  };
  if (my_active) {
    load_tile_rows_async<D>(k_s, p.k + b * p.sk[0] + h * p.sk[1], p.sk[2], k0, M, wt);
    load_tile_rows_async<D>(v_s, p.v + b * p.sv[0] + h * p.sv[1], p.sv[2], k0, M, wt);
  }
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_qdo(it);

  const int wk = warp * 16;
  const int key0 = k0 + wk + g, key1 = key0 + 8;
  // a dropped sample: only the null column (key 0) is live. Keys past M are
  // not stored, so they need no mask.
  const bool live0 = kept || key0 == 0, live1 = kept || key1 == 0;
  const float sc = p.sm_scale * LOG2E;

  float dka[NT][4], dva[NT][4];
  zero(dka);
  zero(dva);

  for (int it = 0; it < n_qt; ++it) {
    cp_async_wait<STAGES - 2>();
    if (p.bias != nullptr) fold_bias<KV_BIAS_LD>(bias_stage(it), tid);
    fence_proxy_async();
    __syncthreads();  // tile it is in place; every warp is done with it - 1
    load_qdo(it + STAGES - 1);
    if (!my_active) continue;

    const uint32_t q_s = q_stage(it), do_s = q_s + TILE_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(base + vec_stage(it));
    const float* dl_s = lse_s + TILE_ROWS;
    const float* bt = bias_stage(it);
    const int q0 = it * TILE_ROWS;

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

    // the partial last query tile (rows past N read as zeros, lse 0) and a
    // dropped sample's keys past the null column are masked
    const bool masked = !kept || q0 + TILE_ROWS > N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;
        const float lq = lse_s[qc];
        float b0 = 0.f, b1 = 0.f;
        if (p.bias != nullptr) {
          b0 = bt[qc * KV_BIAS_LD + wk + g];
          b1 = bt[qc * KV_BIAS_LD + wk + g + 8];
        }
        float p0 = exp2_approx(fmaf(st_[j][e], sc, b0) - lq);
        float p1 = exp2_approx(fmaf(st_[j][2 + e], sc, b1) - lq);
        if (masked) {
          const bool q_ok = q0 + qc < N;
          p0 = q_ok && live0 ? p0 : 0.f;
          p1 = q_ok && live1 ? p1 : 0.f;
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

  if (!live) return;  // an inactive live pair writes zeros
  __nv_bfloat16* dkb = p.dk + b * p.sdk[0] + h * p.sdk[1];
  __nv_bfloat16* dvb = p.dv + b * p.sdv[0] + h * p.sdv[1];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (key0 < M) {
      *reinterpret_cast<uint32_t*>(&dkb[key0 * p.sdk[2] + c]) =
          pack_bf16(dka[j][0] * p.sm_scale, dka[j][1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(&dvb[key0 * p.sdv[2] + c]) =
          pack_bf16(dva[j][0], dva[j][1]);
    }
    if (key1 < M) {
      *reinterpret_cast<uint32_t*>(&dkb[key1 * p.sdk[2] + c]) =
          pack_bf16(dka[j][2] * p.sm_scale, dka[j][3] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(&dvb[key1 * p.sdv[2] + c]) =
          pack_bf16(dva[j][2], dva[j][3]);
    }
  }
}

// ---- 3. dbias ---------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dbias_kernel(const Params p) {
  constexpr int KSTEPS = D / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = align1024(smem_raw);
  const uint32_t sbase = smem_addr(base);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int wt = tid % WG_THREADS;
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int N = p.N, M = p.M, H = p.H, BH = p.B * p.H;
  const int q0 = blockIdx.x * TILE_ROWS;
  const int kb0 = blockIdx.y * DB_KEYS;        // the block's first key
  const int kw0 = kb0 + wg * TILE_ROWS;        // this warpgroup's first key
  const int lr0 = warp * 16 + g;
  const int row0 = q0 + lr0, row1 = row0 + 8;

  // a dropped sample has only the null column: a block past the first
  // skips it, a warpgroup past the first key tile does no products for it
  auto skipped = [&](int it) { return kb0 > 0 && !sample_kept(p, it / H); };
  auto stage = [&](int it) { return sbase + (it % DB_STAGES) * DB_TILES * TILE_BYTES; };
  // one commit group per (b, h): the q and dO tiles (warpgroups 0 and 1),
  // each warpgroup's K and V tiles, the lse and delta of the 64 rows
  auto load = [&](int it) {
    if (it < BH && !skipped(it)) {
      const int b = it / H, h = it % H;
      const uint32_t st = stage(it);
      if (wg == 0)
        load_tile_rows_async<D>(st, p.q + b * p.sq[0] + h * p.sq[1], p.sq[2], q0, N, wt);
      else
        load_tile_rows_async<D>(st + TILE_BYTES, p.dout + b * p.sdo[0] + h * p.sdo[1],
                                p.sdo[2], q0, N, wt);
      const uint32_t kv = st + (2 + 2 * wg) * TILE_BYTES;
      load_tile_rows_async<D>(kv, p.k + b * p.sk[0] + h * p.sk[1], p.sk[2], kw0, M, wt);
      load_tile_rows_async<D>(kv + TILE_BYTES, p.v + b * p.sv[0] + h * p.sv[1], p.sv[2],
                              kw0, M, wt);
      if (wg == 0)
        load_vec_async(sbase + DB_VECS + (it % DB_STAGES) * VEC_BYTES +
                           (wt / TILE_ROWS) * TILE_ROWS * 4,
                       (wt < TILE_ROWS ? p.lse : p.delta) + static_cast<size_t>(it) * N,
                       q0, N, wt % TILE_ROWS);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < DB_STAGES - 1; ++it) load(it);

  // this warpgroup's bias entries in score-fragment order (log2 e folded
  // in), and its dbias sums
  const float sc = p.sm_scale * LOG2E;
  float bl[NT][4], acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = kw0 + j * 8 + 2 * t + e;
      bl[j][e] = row0 < N && col < M
                     ? __ldg(p.bias + static_cast<size_t>(row0) * p.ldb + col) * LOG2E : 0.f;
      bl[j][2 + e] = row1 < N && col < M
                         ? __ldg(p.bias + static_cast<size_t>(row1) * p.ldb + col) * LOG2E
                         : 0.f;
      acc[j][e] = acc[j][2 + e] = 0.f;
    }
  }

  for (int it = 0; it < BH; ++it) {
    cp_async_wait<DB_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // step it is in place; every warp is done with it - 1
    load(it + DB_STAGES - 1);
    const bool kept = sample_kept(p, it / H);
    if (skipped(it) || (!kept && kw0 > 0)) continue;

    const uint32_t st = stage(it);
    const uint32_t q_s = st, do_s = st + TILE_BYTES;
    const uint32_t k_s = st + (2 + 2 * wg) * TILE_BYTES, v_s = k_s + TILE_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(base + DB_VECS +
                                                        (it % DB_STAGES) * VEC_BYTES);
    const float* dl_s = lse_s + TILE_ROWS;
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
    // rows past N and keys past M are not stored: no mask but a dropped
    // sample's null column
    const float lse0 = lse_s[lr0], lse1 = lse_s[lr0 + 8];
    if (kept) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2_approx(fmaf(s[j][0], sc, bl[j][0]) - lse0);
        s[j][1] = exp2_approx(fmaf(s[j][1], sc, bl[j][1]) - lse0);
        s[j][2] = exp2_approx(fmaf(s[j][2], sc, bl[j][2]) - lse1);
        s[j][3] = exp2_approx(fmaf(s[j][3], sc, bl[j][3]) - lse1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool null_col = kw0 + j * 8 + 2 * t + e == 0;
          s[j][e] = null_col ? exp2_approx(fmaf(s[j][e], sc, bl[j][e]) - lse0) : 0.f;
          s[j][2 + e] =
              null_col ? exp2_approx(fmaf(s[j][2 + e], sc, bl[j][2 + e]) - lse1) : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(dp);
    const float dl0 = dl_s[lr0], dl1 = dl_s[lr0 + 8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // dbias += dS = P (dP - delta)
      acc[j][0] += s[j][0] * (dp[j][0] - dl0);
      acc[j][1] += s[j][1] * (dp[j][1] - dl0);
      acc[j][2] += s[j][2] * (dp[j][2] - dl1);
      acc[j][3] += s[j][3] * (dp[j][3] - dl1);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = kw0 + j * 8 + 2 * t + e;
      if (col < M) {
        if (row0 < N) p.dbias[static_cast<size_t>(row0) * M + col] = acc[j][e];
        if (row1 < N) p.dbias[static_cast<size_t>(row1) * M + col] = acc[j][2 + e];
      }
    }
  }
}

// Lets the three kernels of head dim D take their dynamic shared memory
// (above the default 48 KB), once per process.
template <int D>
cudaError_t allow_smem() {
  static const cudaError_t err[3] = {
      cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM),
      cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM),
      cudaFuncSetAttribute(attn_bwd_dbias_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, DB_SMEM)};
  for (cudaError_t e : err)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <int D>
cudaError_t occupancy(int kernel, int* smem, int* blocks_per_sm) {
  const cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return err;
  switch (kernel) {
    case 0:
      *smem = DQ_SMEM;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, attn_bwd_dq_kernel<D>, THREADS, DQ_SMEM);
    case 1:
      *smem = KV_SMEM;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, attn_bwd_dkdv_kernel<D>, THREADS, KV_SMEM);
    default:
      *smem = DB_SMEM;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, attn_bwd_dbias_kernel<D>, THREADS, DB_SMEM);
  }
}

template <int D>
cudaError_t launch_bwd(const Params& p, cudaStream_t s) {
  const cudaError_t attr = allow_smem<D>();
  if (attr != cudaSuccess) return attr;
  const int pairs = (p.B * p.H + PAIRS - 1) / PAIRS;
  const int nq = (p.N + TILE_ROWS - 1) / TILE_ROWS;
  const int nk = (p.M + TILE_ROWS - 1) / TILE_ROWS;
  attn_bwd_dq_kernel<D><<<dim3(nq, pairs), THREADS, DQ_SMEM, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<D><<<dim3(nk, pairs), THREADS, KV_SMEM, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.dbias == nullptr) return err;
  attn_bwd_dbias_kernel<D><<<dim3(nq, (p.M + DB_KEYS - 1) / DB_KEYS), THREADS,
                             DB_SMEM, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory per block and the blocks that fit on one SM
// (registers and shared memory together) of kernel 0 (dq), 1 (dk/dv) or 2
// (dbias) at head dim D, for reports. Returns a cudaError_t.
extern "C" int attention_bwd_resources(int kernel, int D, int* smem,
                                       int* blocks_per_sm) {
  if (kernel < 0 || kernel > 2 || (D != 32 && D != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(D == 32 ? occupancy<32>(kernel, smem, blocks_per_sm)
                                  : occupancy<64>(kernel, smem, blocks_per_sm));
}

// q, o, dout, dq (B,H,N,D) and k, v, dk, dv (B,H,M,D) bf16, each with a
// contiguous last dim, the null column at k/v column 0; bias (N,M) fp32
// with a contiguous last dim, or null, and dbias (N,M) fp32 contiguous
// exactly when bias is given; keep (B,) int32 or null; lse (B,H,N) fp32 from
// the forward (log2 units) and delta (B,H,N) fp32 scratch, contiguous.
// strides: 25 int64, the (b, h, row) strides in elements of q, k, v, o,
// dout, dq, dk and dv, each a multiple of 8, then the bias row stride, a
// multiple of 4 (0 without a bias); every pointer 16-byte aligned. Returns
// the first cudaGetLastError() that is not 0.
extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const void* bias, const void* keep,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, void* dbias, int B,
                                  int H, int N, int M, int D,
                                  const long long* strides, float sm_scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || strides == nullptr ||
      (static_cast<long long>(B) * H + PAIRS - 1) / PAIRS > 65535 ||
      (bias == nullptr) != (dbias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bias != nullptr && (strides[24] % 4 != 0 || strides[24] < M ||
                          strides[24] > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  Params p{static_cast<const bf*>(q), static_cast<const bf*>(k),
           static_cast<const bf*>(v), static_cast<const bf*>(o),
           static_cast<const bf*>(dout), static_cast<const float*>(bias),
           static_cast<const int*>(keep), static_cast<const float*>(lse),
           static_cast<float*>(delta), static_cast<bf*>(dq),
           static_cast<bf*>(dk), static_cast<bf*>(dv),
           static_cast<float*>(dbias), B, H, N, M,
           static_cast<int>(strides[24]), sm_scale,
           {}, {}, {}, {}, {}, {}, {}, {}};
  long long* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return static_cast<int>(launch_bwd<32>(p, s));
    case 64:
      return static_cast<int>(launch_bwd<64>(p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
