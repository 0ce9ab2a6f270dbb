// Cosine attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel `fused_cosine_attention_fwd_fb2`
// (bevgen_tpu/ops/pallas/fused_attention.py:737, kernel body
// `_qknorm_kernel_fb2` :445) and its variants fb/fb2c/chunked/strip, which
// compute the same function. For each batch b, head h and query row i:
//
//   q^      = l2n(q[b,h,i]) * q_scale * sm_scale      (fp32, rounded to bf16)
//   k^_0    = l2n(null_kv[0,h]) * k_scale,  v_0 = null_kv[1,h],  bias 0
//   k^_j    = k[b,h,j-1]  (already l2-normalised and k_scale-d), v_j = v[b,h,j-1]
//   s_ij    = q^ . k^_j + bias[i, j-1]            (bias: one (N, M) fp32 strip)
//   out     = softmax_j(s_ij) . v_j
//
// keep[b] == 0 masks every real column: the row sees only the null column.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// self-attention at B=2, H=16, N=M=1792, D=64 does 4*B*H*N*(M+1)*D = 26 GFLOP
// (about 27 us) against 42 MB of q/k/v/bias/out (about 13 us): operations.
// Cross-attention at M=256 does 3.8 GFLOP (about 4 us) against 19 MB (about
// 6 us): bytes. (Estimates from the shapes, not measurements.)
//
// Design. One thread block of 4 warps per (b, h, 64-row query tile); each
// warp owns 16 query rows. The prologue normalises the q tile in fp32,
// folds in q_scale * sm_scale, rounds to bf16 and keeps it as mma.sync A
// fragments in registers for the whole kernel. The null column is the first
// score of an online softmax (running max, running sum), so it needs no
// padded K/V copy and no extra column in device memory. K/V tiles of 64
// keys are staged in shared memory; scores and P.V both run on the tensor
// cores (mma.sync m16n8k16 bf16 -> fp32), P never leaves registers, and the
// bias strip is read once per (b, h) block straight into the score
// fragments. Rows whose keep flag is 0 skip the key loop. What this first
// version leaves on the table: loads are synchronous (no cp.async/TMA
// pipeline) and mma.sync reaches a fraction of the wgmma rate.
//
// C interface: cosine_attention_fwd_bf16(...) returns cudaGetLastError()
// after the launch; the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_KV = 64;
constexpr int NUM_WARPS = BLOCK_Q / 16;
constexpr int NUM_THREADS = NUM_WARPS * 32;
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

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
cosine_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ null_kv,
                            const float* __restrict__ q_scale,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ bias,
                            const int* __restrict__ keep,
                            __nv_bfloat16* __restrict__ out,
                            int H, int N, int M, float sm_scale) {
  static_assert(D == 32 || D == 64, "head dim: 32 or 64 (static smem < 48 KB)");
  constexpr int LD = D + 8;      // smem row stride in bf16 (16-byte multiple)
  constexpr int HD = D / 2;      // prologue: two threads per query row
  constexpr int VPR = D / 8;     // 16-byte vectors per K/V row
  constexpr int KSTEPS = D / 16; // mma k-steps over the head dim
  constexpr int NT_S = BLOCK_KV / 8;   // score n-tiles per warp
  constexpr int NT_O = D / 8;          // output n-tiles per warp

  __shared__ __align__(16) __nv_bfloat16 q_s[BLOCK_Q * LD];
  __shared__ __align__(16) __nv_bfloat16 k_s[BLOCK_KV * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BLOCK_KV * LD];
  __shared__ float nk_s[D];
  __shared__ float nv_s[D];
  __shared__ float s0_s[BLOCK_Q];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* qb = q + bh * N * D;
  const __nv_bfloat16* kb = k + bh * M * D;
  const __nv_bfloat16* vb = v + bh * M * D;

  // ---- null column: k^_0 = bf16(l2n(null_k) * k_scale), v_0 = bf16(null_v)
  if (warp == 0) {
    const float* nk = null_kv + static_cast<size_t>(h) * D;
    const float* nv = null_kv + static_cast<size_t>(H + h) * D;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss += nk[d] * nk[d];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    for (int d = lane; d < D; d += 32) {
      nk_s[d] = round_bf16(nk[d] / nrm * k_scale[d]);
      nv_s[d] = round_bf16(nv[d]);
    }
  }
  __syncthreads();

  // ---- q prologue: l2norm in fp32, * q_scale * sm_scale, bf16 into smem;
  // the null-column score s0 = q^ . k^_0 comes out of the same pass.
  {
    const int r = tid / 2, half = tid % 2;
    const int row = q0 + r;
    float x[HD];
    if (row < N) {
      const uint4* src = reinterpret_cast<const uint4*>(
          qb + static_cast<size_t>(row) * D + half * HD);
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
#pragma unroll
    for (int i = 0; i < HD; i += 2) {
      const int d = half * HD + i;
      const float a = round_bf16(x[i] / nrm * q_scale[d] * sm_scale);
      const float c = round_bf16(x[i + 1] / nrm * q_scale[d + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(&q_s[r * LD + d]) = pack_bf16(a, c);
      s0 += a * nk_s[d] + c * nk_s[d + 1];
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    if (half == 0) s0_s[r] = s0 * LOG2E;
  }
  __syncthreads();

  // ---- this warp's 16 query rows as A fragments, held for the whole loop
  const int wr = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = lds32(&q_s[(wr + g) * LD + c]);
    qa[kk][1] = lds32(&q_s[(wr + g + 8) * LD + c]);
    qa[kk][2] = lds32(&q_s[(wr + g) * LD + c + 8]);
    qa[kk][3] = lds32(&q_s[(wr + g + 8) * LD + c + 8]);
  }

  // online-softmax state for rows r0 = wr+g and r1 = wr+g+8, in log2 units,
  // seeded with the null column (p = 1 at the running max s0)
  float m0 = s0_s[wr + g], m1 = s0_s[wr + g + 8];
  float l0 = (t == 0) ? 1.f : 0.f, l1 = l0;  // per-thread partial sums
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    acc[j][0] = nv_s[c];
    acc[j][1] = nv_s[c + 1];
    acc[j][2] = nv_s[c];
    acc[j][3] = nv_s[c + 1];
  }

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const bool kept = (keep == nullptr) || (keep[b] != 0);
  const int n_tiles = kept ? (M + BLOCK_KV - 1) / BLOCK_KV : 0;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * BLOCK_KV;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BLOCK_KV * VPR; i += NUM_THREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kz = make_uint4(0u, 0u, 0u, 0u), vz = kz;
      if (kv0 + r < M) {
        const size_t off = static_cast<size_t>(kv0 + r) * D + c;
        kz = *reinterpret_cast<const uint4*>(kb + off);
        vz = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LD + c]) = kz;
      *reinterpret_cast<uint4*>(&v_s[r * LD + c]) = vz;
    }
    __syncthreads();

    // S = Q^ K^T for this warp's 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kr = &k_s[(j * 8 + g) * LD + kk * 16 + 2 * t];
        mma_16816(s[j], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // + bias, mask the ragged edge, to log2 units, row max
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + j * 8 + 2 * t + e;
        float v0 = s[j][e], v1 = s[j][2 + e];
        if (col < M) {
          if (bias != nullptr) {
            if (row0 < N) v0 += __ldg(bias + static_cast<size_t>(row0) * M + col);
            if (row1 < N) v1 += __ldg(bias + static_cast<size_t>(row1) * M + col);
          }
          v0 *= LOG2E;
          v1 *= LOG2E;
        } else {
          v0 = -CUDART_INF_F;
          v1 = -CUDART_INF_F;
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

    // P = exp2(S - m) -> bf16 A fragments (two score n-tiles per k-step)
    uint32_t pa[BLOCK_KV / 16][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BLOCK_KV / 16; ++kk) {
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const int n = j * 8 + g;
        const uint32_t b0 = pack_raw(v_s[kr * LD + n], v_s[(kr + 1) * LD + n]);
        const uint32_t b1 = pack_raw(v_s[(kr + 8) * LD + n], v_s[(kr + 9) * LD + n]);
        mma_16816(acc[j], pa[kk], b0, b1);
      }
    }
  }

  // ---- epilogue: full row sums across the quad, normalise, store bf16
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = out + bh * N * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row0) * D + c]) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(&ob[static_cast<size_t>(row1) * D + c]) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* null_kv,
            const void* q_scale, const void* k_scale, const void* bias,
            const void* keep, void* out, int B, int H, int N, int M,
            float sm_scale, cudaStream_t stream) {
  const dim3 grid((N + BLOCK_Q - 1) / BLOCK_Q, H, B);
  cosine_attention_fwd_kernel<D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(null_kv),
      static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(bias), static_cast<const int*>(keep),
      static_cast<__nv_bfloat16*>(out), H, N, M, sm_scale);
}

}  // namespace

// q (B,H,N,D), k/v (B,H,M,D) bf16 contiguous; k already l2n * k_scale.
// null_kv (2,H,1,D), q_scale/k_scale (D,) fp32; bias (N,M) fp32 or null;
// keep (B,) int32 or null; out (B,H,N,D) bf16. Returns cudaGetLastError().
extern "C" int cosine_attention_fwd_bf16(const void* q, const void* k,
                                         const void* v, const void* null_kv,
                                         const void* q_scale,
                                         const void* k_scale, const void* bias,
                                         const void* keep, void* out, int B,
                                         int H, int N, int M, int D,
                                         float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M < 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      launch<32>(q, k, v, null_kv, q_scale, k_scale, bias, keep, out, B, H, N,
                 M, sm_scale, s);
      break;
    case 64:
      launch<64>(q, k, v, null_kv, q_scale, k_scale, bias, keep, out, B, H, N,
                 M, sm_scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
