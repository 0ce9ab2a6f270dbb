// Attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate, in two
// modes of one kernel template.
//
// Cosine mode replaces the TPU kernel `fused_cosine_attention_fwd_fb2`
// (bevgen_tpu/ops/pallas/fused_attention.py:737, kernel body
// `_qknorm_kernel_fb2` :445) and its variants fb/fb2c/chunked/strip, which
// compute the same function. For each batch b, head h and query row i:
//
//   q^      = l2n(q[b,h,i]) * q_scale * sm_scale      (fp32, rounded to bf16)
//   k^_0    = l2n(bf16(null_kv[0,h])) * k_scale,  v_0 = null_kv[1,h],  bias 0
//   k^_j    = k[b,h,j-1]  (already l2-normalised and k_scale-d), v_j = v[b,h,j-1]
//   s_ij    = q^ . k^_j + bias[i, j-1]            (bias: one (N, M) fp32 strip)
//   out     = softmax_j(s_ij) . v_j
//
// keep[b] == 0 masks every real column: the row sees only the null column.
//
// Plain mode replaces `fused_bias_attention_fwd` (fused_attention.py:84,
// kernel body `_kernel` :29): s_ij = sm_scale * q_i . k_j + bias[i, j] over
// the M columns of k, whose column 0 (the null column) is exempt from keep.
//
// Either mode can also write the per-row logsumexp of the scores in log2
// units, lse2_i = log2(sum_j 2^(s_ij * log2 e)), which the backward
// (attention_bwd.cu) uses to recompute the softmax; a null pointer skips it.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// self-attention at B=2, H=16, N=M=1792, D=64 does 4*B*H*N*(M+1)*D = 26 GFLOP
// (about 27 us) against 42 MB of q/k/v/bias/out (about 13 us): operations.
// Cross-attention at M=256 does 3.8 GFLOP (about 4 us) against 19 MB (about
// 6 us): bytes. (Estimates from the shapes, not measurements.) Beyond the
// bound, the time follows the bytes the blocks pull through L2: every block
// reads the K/V of its heads and the bias strip of its rows once.
//
// Design. A block of four warpgroups (512 threads) owns 128 query rows of two
// (b, h) pairs: warpgroup w takes pair w % 2 and rows 64 (w / 2) .. +63. The
// two pairs share each staged bias tile (the bias is one strip for every b
// and h) and the two row halves share each staged K/V tile, so per call L2
// carries half the K/V bytes and half the bias bytes of one warpgroup per
// (b, h, 64 rows).
//   - Both products run on wgmma (hopper_common.cuh), m64n64k16 bf16 ->
//     fp32: S = q^ k^T with the q tile and the K tile as K-major operands in
//     shared memory; O += P v with P from registers (the scores rescaled,
//     exponentiated and packed to bf16 in place) and v as an MN-major operand.
//   - K, V and the bias tile of the next 64 keys come through cp.async rings
//     (2 stages for K and the bias, 3 for V), started right after the barrier
//     that frees their stages, so they are in flight while this tile's
//     products and softmax run. S of tile j and P.V of tile j-1 are two
//     commit groups started back to back; both land before tile j's softmax.
//     The exponentials of one warpgroup overlap the products of the other
//     three on the SM. Holding P of tile j-1 through tile j's softmax (so
//     that the warpgroup's own exponentials overlap its P.V) needs more than
//     the 128 registers a thread of a 512-thread block has: it spilled, and
//     the spill-free form of it (addresses recomputed per tile) was slower
//     than this order on the H100.
//   - The bias tile (128 rows x 64 fp32, rows padded to 72 floats so the
//     score fragments read it without bank conflicts) is staged once per
//     block by 16-byte copies, and each thread folds log2 e into the entries
//     it copied once they land. The bias rows must start on 16-byte
//     boundaries (row stride ldb a multiple of 4 floats): the wrappers copy
//     a bias whose M is not a multiple of 4 (plain mode's M = N + 1) into
//     padded rows. Copying such rows 4 bytes at a time, or from the 16-byte
//     boundary before each row, was slower on the H100 by far more than the
//     padded copy costs.
//   - The cosine prologue is fused: each warpgroup normalises its 64 q rows
//     in fp32, folds in q_scale * sm_scale, rounds to bf16 and writes them
//     into its swizzled q tile; the null column seeds the online softmax
//     (p = 1 at s_0), so there is no padded K/V copy. Plain mode copies q in.
//   - Masks only where needed: the last, partial key tile, and column 0 of
//     the first tile in plain mode for a dropped sample (which then stops).
//     A dropped sample in cosine mode skips the key loop.
//   - D = 32 runs as a 64-wide tile whose upper half is zero-filled: zero
//     columns add nothing to q.k, and the upper half of the output is not
//     stored.
//   - q, k, v and out are read and written through (b, h, row) strides; the
//     last dim is contiguous.
// The online softmax runs in fp32 in log2 units, its exponentials on the
// special-function unit (`exp2_approx`).
//
// C interface: cosine_attention_fwd_bf16(...) and bias_attention_fwd_bf16(...)
// return cudaGetLastError() after the launch; the Python wrapper raises if it
// is not 0.

#include <math_constants.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int PAIRS = 2;                        // (b, h) pairs of a block
constexpr int HALVES = 2;                       // 64-row halves of a block
constexpr int ROWS = HALVES * TILE_ROWS;        // query rows of a block
constexpr int WARPGROUPS = PAIRS * HALVES;
constexpr int THREADS = WARPGROUPS * WG_THREADS;
constexpr int K_STAGES = 2, V_STAGES = 3, BIAS_STAGES = 2;
constexpr int BIAS_LD = TILE_ROWS + 8;          // floats per staged bias row
constexpr int BIAS_BYTES = ROWS * BIAS_LD * 4;
// shared layout: the warpgroups' q tiles, the K ring, the V ring (one tile
// per pair and stage), the bias ring; slack to align the first tile to 1024
constexpr int K_OFF = WARPGROUPS * TILE_BYTES;
constexpr int V_OFF = K_OFF + K_STAGES * PAIRS * TILE_BYTES;
constexpr int BIAS_OFF = V_OFF + V_STAGES * PAIRS * TILE_BYTES;
constexpr int SMEM_BYTES = BIAS_OFF + BIAS_STAGES * BIAS_BYTES + 1024;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* null_kv;
  const float* q_scale;
  const float* k_scale;
  const float* bias;
  const int* keep;
  __nv_bfloat16* out;
  float* lse;
  int B, H, N, M;
  int ldb;  // bias row stride in floats, a multiple of 4
  float sm_scale;
  // (b, h, row) strides in elements of q, k, v, out
  long long sq[3], sk[3], sv[3], so[3];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [r0, r0 + 64) of a (rows, D) bf16 matrix with row stride ld (elements)
// into a 64-wide swizzled tile, 4 chunks of 16 bytes for each of the
// warpgroup's threads i; rows at or past `rows` and columns at or past D are
// zero-filled (nothing is read for them).
template <int D>
__device__ __forceinline__ void load_rows_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int ld, int r0, int rows,
                                                int i) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int idx = i + u * WG_THREADS;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r0 + r < rows && c < D / 8;
    const __nv_bfloat16* p =
        ok ? src + static_cast<long long>(r0 + r) * ld + c * 8 : src;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), p, ok ? 16u : 0u);
  }
}

// O += P v for one 64-key tile: P in registers, v MN-major at v_s; one
// commit group
__device__ __forceinline__ void pv(float (&acc)[NT][4],
                                   const uint32_t (&pa)[TILE_ROWS / 16][4],
                                   uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < TILE_ROWS / 16; ++kk)
    wgmma_rs(acc, pa[kk], desc_mn_major(v_s, kk));
  wgmma_commit();
}

template <int D, bool COSINE>
__global__ void __launch_bounds__(THREADS, 1)
attention_fwd_kernel(const Params p) {
  static_assert(D == 32 || D == 64, "head dim: 32 or 64");
  constexpr int KSTEPS = D / 16;  // wgmma k-steps of S over the head dim
  constexpr int NT_O = D / 8;     // stored n-tiles of the output
  constexpr int HD = D / 2;       // prologue: two threads per query row

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = align1024(smem_raw);
  const uint32_t sbase = smem_addr(base);
  __shared__ float nk_s[PAIRS][TILE_ROWS], nv_s[PAIRS][TILE_ROWS];
  __shared__ float s0_s[WARPGROUPS][TILE_ROWS];
  __shared__ __align__(16) float zero_s[TILE_ROWS];

  const int tid = threadIdx.x;
  // the warpgroup index, broadcast so that the compiler sees it uniform
  // across the warpgroup (the wgmma path branches on it)
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int wt = tid % WG_THREADS;
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = wg % PAIRS, half_rows = wg / PAIRS;
  const int q0 = blockIdx.x * ROWS;
  const int N = p.N, M = p.M, H = p.H, BH = p.B * p.H;
  const int all_tiles = (M + TILE_ROWS - 1) / TILE_ROWS;

  // key tiles of each pair: all of them; a dropped sample sees none of k
  // (cosine) or column 0 of the first tile (plain); none past B * H
  int tiles[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int bh = blockIdx.y * PAIRS + i;
    const bool in = bh < BH;
    const bool kept_i = in && (p.keep == nullptr || p.keep[bh / H] != 0);
    tiles[i] = !in ? 0 : (kept_i ? all_tiles : (COSINE ? 0 : 1));
  }
  const int n_tiles = max(tiles[0], tiles[1]);
  const int my_tiles = pair == 0 ? tiles[0] : tiles[1];
  const int bh = blockIdx.y * PAIRS + pair;
  const bool live = bh < BH;
  const int b = live ? bh / H : 0, h = live ? bh % H : 0;
  const bool kept = live && (p.keep == nullptr || p.keep[b] != 0);

  // this warpgroup copies the K (warpgroups 0, 1) or V (2, 3) tiles of its pair
  const bool copies_k = wg < PAIRS;
  const __nv_bfloat16* kv_src = copies_k ? p.k + b * p.sk[0] + h * p.sk[1]
                                         : p.v + b * p.sv[0] + h * p.sv[1];
  const int kv_ld = static_cast<int>(copies_k ? p.sk[2] : p.sv[2]);

  auto stage_ptr = [&](int it, bool k) {
    return k ? sbase + K_OFF + ((it % K_STAGES) * PAIRS + pair) * TILE_BYTES
             : sbase + V_OFF + ((it % V_STAGES) * PAIRS + pair) * TILE_BYTES;
  };
  auto bias_stage = [&](int it) {
    return reinterpret_cast<float*>(base + BIAS_OFF +
                                    (it % BIAS_STAGES) * BIAS_BYTES);
  };
  // one commit group per key tile: this pair's K or V tile, this thread's
  // share of the bias tile
  auto load_tile = [&](int it) {
    const int kv0 = it * TILE_ROWS;
    if (it < my_tiles)
      load_rows_async<D>(stage_ptr(it, copies_k), kv_src, kv_ld, kv0, M, wt);
    if (p.bias != nullptr) {
      // a chunk that starts before column M may run into the row's padding
      const uint32_t dst = smem_addr(bias_stage(it));
#pragma unroll
      for (int u = 0; u < ROWS * TILE_ROWS / 4 / THREADS; ++u) {
        const int idx = tid + u * THREADS;
        const int r = idx >> 4, c = (idx & 15) * 4;
        const bool ok = q0 + r < N && kv0 + c < M;
        const float* src =
            ok ? p.bias + static_cast<size_t>(q0 + r) * p.ldb + kv0 + c : p.bias;
        cp_async16(dst + (r * BIAS_LD + c) * 4, src, ok ? 16u : 0u);
      }
    }
    cp_async_commit();
  };
  // log2 e into the bias entries this thread copied, once they have landed
  auto fold_bias = [&](int it) {
    float* bs = bias_stage(it);
#pragma unroll
    for (int u = 0; u < ROWS * TILE_ROWS / 4 / THREADS; ++u) {
      const int idx = tid + u * THREADS;
      float4* e =
          reinterpret_cast<float4*>(bs + (idx >> 4) * BIAS_LD + (idx & 15) * 4);
      float4 x = *e;
      x.x *= LOG2E;
      x.y *= LOG2E;
      x.z *= LOG2E;
      x.w *= LOG2E;
      *e = x;
    }
  };

  const uint32_t q_s = sbase + wg * TILE_BYTES;
  const int qrow0 = q0 + half_rows * TILE_ROWS;  // this warpgroup's first row
  if (!COSINE && live)
    load_rows_async<D>(q_s, p.q + b * p.sq[0] + h * p.sq[1],
                       static_cast<int>(p.sq[2]), qrow0, N, wt);
  if (n_tiles > 0) load_tile(0);
  if (tid < TILE_ROWS) zero_s[tid] = 0.f;

  if (COSINE) {
    // ---- null column of each pair: k^_0 = bf16(l2n(bf16(null_k)) * k_scale),
    // v_0 = bf16(null_v), as the reference's prologue rounds them; zero past D
    if (half_rows == 0 && warp == 0) {
      const float* nk = p.null_kv + static_cast<size_t>(h) * D;
      const float* nv = p.null_kv + static_cast<size_t>(H + h) * D;
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float x = live ? round_bf16(nk[d]) : 0.f;
        ss += x * x;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float nrm = fmaxf(sqrtf(ss), 1e-12f);
      for (int d = lane; d < TILE_ROWS; d += 32) {
        const bool in = live && d < D;
        nk_s[pair][d] = in ? round_bf16(round_bf16(nk[d]) / nrm * p.k_scale[d]) : 0.f;
        nv_s[pair][d] = in ? round_bf16(nv[d]) : 0.f;
      }
    }
    __syncthreads();

    // ---- q prologue: l2norm in fp32, * q_scale * sm_scale, bf16 into the
    // swizzled q tile; the null-column score s0 = q^ . k^_0 comes out of the
    // same pass
    const int r = wt / 2, hf = wt % 2;
    const int row = qrow0 + r;
    float x[HD];
    if (live && row < N) {
      const uint4* src = reinterpret_cast<const uint4*>(
          p.q + b * p.sq[0] + h * p.sq[1] + row * p.sq[2] + hf * HD);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        uint4 u = src[i];
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) x[i * 8 + j] = __bfloat162float(e[j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < HD; ++i) x[i] = 0.f;
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) ss += x[i] * x[i];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    float s0 = 0.f;
    uint8_t* qrow = base + wg * TILE_BYTES + r * 128;
#pragma unroll
    for (int cc = 0; cc < HD / 8; ++cc) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = cc * 8 + 2 * e, d = hf * HD + i;
        const float a = round_bf16(x[i] / nrm * p.q_scale[d] * p.sm_scale);
        const float c = round_bf16(x[i + 1] / nrm * p.q_scale[d + 1] * p.sm_scale);
        w[e] = pack_bf16(a, c);
        s0 += a * nk_s[pair][d] + c * nk_s[pair][d + 1];
      }
      const int chunk = hf * (HD / 8) + cc;
      *reinterpret_cast<uint4*>(qrow + ((chunk ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
#pragma unroll
    for (int cc = 0; cc < (TILE_ROWS - D) / 16; ++cc) {  // zero columns past D
      const int chunk = D / 8 + hf * ((TILE_ROWS - D) / 16) + cc;
      *reinterpret_cast<uint4*>(qrow + ((chunk ^ (r & 7)) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    if (hf == 0) s0_s[wg][r] = s0 * LOG2E;
    fence_proxy_async();  // the q tile, written here, is read by wgmma
  }
  __syncthreads();

  // online-softmax state for rows r0 = 16 warp + g and r1 = r0 + 8 of this
  // warpgroup, in log2 units; cosine mode seeds it with the null column
  // (p = 1 at the running max s0)
  const int lr0 = warp * 16 + g;
  const int row0 = qrow0 + lr0, row1 = row0 + 8;
  float m0, m1, l0, l1;
  float acc[NT][4];
  if (COSINE) {
    m0 = s0_s[wg][lr0];
    m1 = s0_s[wg][lr0 + 8];
    l0 = l1 = (t == 0) ? 1.f : 0.f;  // per-thread partial sums
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      acc[j][0] = acc[j][2] = nv_s[pair][c];
      acc[j][1] = acc[j][3] = nv_s[pair][c + 1];
    }
  } else {
    m0 = m1 = -CUDART_INF_F;
    l0 = l1 = 0.f;
    zero(acc);
  }
  // sm_scale is folded into q^ in cosine mode; log2 e into the staged bias
  const float sc = (COSINE ? 1.f : p.sm_scale) * LOG2E;
  uint32_t pa[TILE_ROWS / 16][4];  // P of the previous tile, bf16 A fragments

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    if (p.bias != nullptr) fold_bias(it);
    fence_proxy_async();
    __syncthreads();  // tile it is in place; every warp is done with it - 1
    if (it + 1 < n_tiles) load_tile(it + 1);

    if (it < my_tiles) {
      float s[NT][4];
      wgmma_fence();
      const uint32_t k_s = stage_ptr(it, true);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss(s, desc_k_major(q_s, kk), desc_k_major(k_s, kk), kk);
      wgmma_commit();
      // P.V of the previous tile, queued behind S: both land before the
      // softmax, which then needs no P and no V tile live
      if (it > 0) pv(acc, pa, stage_ptr(it - 1, false));
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(acc);
      fence_operands(pa);

      // * scale + bias, to log2 units; mask the partial last tile and, in
      // plain mode, a dropped sample's columns past the null column
      const float* bs0 =
          p.bias != nullptr
              ? bias_stage(it) + (half_rows * TILE_ROWS + lr0) * BIAS_LD
              : zero_s;
      const float* bs1 = p.bias != nullptr ? bs0 + 8 * BIAS_LD : zero_s;
      const int kv0 = it * TILE_ROWS;
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
      if (kv0 + TILE_ROWS <= M && (COSINE || kept)) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 b0 = *reinterpret_cast<const float2*>(bs0 + j * 8 + 2 * t);
          const float2 b1 = *reinterpret_cast<const float2*>(bs1 + j * 8 + 2 * t);
          s[j][0] = fmaf(s[j][0], sc, b0.x);
          s[j][1] = fmaf(s[j][1], sc, b0.y);
          s[j][2] = fmaf(s[j][2], sc, b1.x);
          s[j][3] = fmaf(s[j][3], sc, b1.y);
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = j * 8 + 2 * t + e, col = kv0 + cl;
            const bool ok = col < M && (COSINE || kept || col == 0);
            s[j][e] = ok ? fmaf(s[j][e], sc, bs0[cl]) : -CUDART_INF_F;
            s[j][2 + e] = ok ? fmaf(s[j][2 + e], sc, bs1[cl]) : -CUDART_INF_F;
            mx0 = fmaxf(mx0, s[j][e]);
            mx1 = fmaxf(mx1, s[j][2 + e]);
          }
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      // the first tile always holds a live column (the null column in plain
      // mode), so the running max is finite from here on
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2_approx(m0 - mn0), al1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2_approx(s[j][0] - m0);
        s[j][1] = exp2_approx(s[j][1] - m0);
        s[j][2] = exp2_approx(s[j][2] - m1);
        s[j][3] = exp2_approx(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      // rescale, then P of this tile
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }
      pack_a(pa, s);
    } else if (it == my_tiles && my_tiles > 0) {
      // this pair's last P.V (a dropped sample in plain mode stops at tile 0)
      wgmma_fence();
      pv(acc, pa, stage_ptr(it - 1, false));
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pa);
    }
  }
  if (my_tiles > 0 && my_tiles == n_tiles) {
    wgmma_fence();
    pv(acc, pa, stage_ptr(n_tiles - 1, false));
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
  if (!live) return;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = p.out + b * p.so[0] + h * p.so[1];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(&ob[row0 * p.so[2] + c]) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(&ob[row1 * p.so[2] + c]) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (p.lse != nullptr && t == 0) {
    const size_t lb = static_cast<size_t>(bh) * N;
    if (row0 < N) p.lse[lb + row0] = m0 + log2f(l0);
    if (row1 < N) p.lse[lb + row1] = m1 + log2f(l1);
  }
}

// Lets the kernel take SMEM_BYTES of dynamic shared memory, once per process.
template <int D, bool COSINE>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<D, COSINE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return err;
}

template <int D, bool COSINE>
cudaError_t occupancy(int* blocks_per_sm) {
  cudaError_t err = allow_smem<D, COSINE>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_fwd_kernel<D, COSINE>, THREADS, SMEM_BYTES);
  return err;
}

template <int D, bool COSINE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const cudaError_t attr = allow_smem<D, COSINE>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.N + ROWS - 1) / ROWS, (p.B * p.H + PAIRS - 1) / PAIRS);
  attention_fwd_kernel<D, COSINE><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <bool COSINE>
int dispatch(Params p, int D, const long long* strides, void* stream) {
  // plain mode needs the null column at column 0 of k
  if (p.B <= 0 || p.H <= 0 || p.N <= 0 || p.M < (COSINE ? 0 : 1) ||
      (static_cast<long long>(p.B) * p.H + PAIRS - 1) / PAIRS > 65535 ||
      strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // bias rows on 16-byte boundaries, each at least M long
  if (p.bias != nullptr &&
      (strides[12] % 4 != 0 || strides[12] < p.M || strides[12] > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  p.ldb = static_cast<int>(strides[12]);
  // every row starts on a 16-byte boundary (cp.async, 16-byte q loads)
  // and the row strides fit an int
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0 || (i % 3 == 2 && strides[i] > 0x7fffffffLL))
      return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return static_cast<int>(launch<32, COSINE>(p, s));
    case 64:
      return static_cast<int>(launch<64, COSINE>(p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The kernel's dynamic shared memory per block and the blocks that fit on
// one SM (registers and shared memory together) for head dim D and the
// cosine (1) or plain (0) mode, for reports. Returns a cudaError_t.
extern "C" int attention_fwd_resources(int D, int cosine, int* smem_bytes,
                                       int* blocks_per_sm) {
  *smem_bytes = SMEM_BYTES;
  if (D != 32 && D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      D == 32 ? (cosine ? occupancy<32, true>(blocks_per_sm)
                        : occupancy<32, false>(blocks_per_sm))
              : (cosine ? occupancy<64, true>(blocks_per_sm)
                        : occupancy<64, false>(blocks_per_sm));
  return static_cast<int>(err);
}

// q (B,H,N,D), k/v (B,H,M,D) bf16 with a contiguous last dim, k already
// l2n * k_scale; null_kv (2,H,1,D), q_scale/k_scale (D,) fp32 contiguous;
// bias (N,M) fp32 with a contiguous last dim or null; keep (B,) int32 or
// null; out (B,H,N,D) bf16 with a contiguous last dim; lse (B,H,N) fp32
// contiguous or null. strides: 13 int64, the (b, h, row) strides in
// elements of q, k, v and out, each a multiple of 8, then the bias row
// stride, a multiple of 4; every pointer 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int cosine_attention_fwd_bf16(const void* q, const void* k,
                                         const void* v, const void* null_kv,
                                         const void* q_scale,
                                         const void* k_scale, const void* bias,
                                         const void* keep, void* out, void* lse,
                                         int B, int H, int N, int M, int D,
                                         const long long* strides,
                                         float sm_scale, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           static_cast<const float*>(null_kv),
           static_cast<const float*>(q_scale),
           static_cast<const float*>(k_scale),
           static_cast<const float*>(bias),
           static_cast<const int*>(keep),
           static_cast<__nv_bfloat16*>(out),
           static_cast<float*>(lse),
           B, H, N, M, 0, sm_scale, {}, {}, {}, {}};
  return dispatch<true>(p, D, strides, stream);
}

// q (B,H,N,D), k/v (B,H,M,D) bf16 with a contiguous last dim and the null
// column at k/v column 0; bias (N,M) fp32 with a contiguous last dim or
// null; keep (B,) int32 or null; out (B,H,N,D) bf16 with a contiguous last dim; lse (B,H,N)
// fp32 contiguous or null; strides as above. Returns cudaGetLastError().
extern "C" int bias_attention_fwd_bf16(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* keep, void* out, void* lse,
                                       int B, int H, int N, int M, int D,
                                       const long long* strides,
                                       float sm_scale, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           nullptr, nullptr, nullptr,
           static_cast<const float*>(bias),
           static_cast<const int*>(keep),
           static_cast<__nv_bfloat16*>(out),
           static_cast<float*>(lse),
           B, H, N, M, 0, sm_scale, {}, {}, {}, {}};
  return dispatch<false>(p, D, strides, stream);
}
