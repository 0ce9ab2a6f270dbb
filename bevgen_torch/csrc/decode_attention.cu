// Single-position (decode-time) attention for Hopper (sm_90a): one query
// row against a cache prefix, bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel `decode_attention`
// (bevgen_tpu/ops/pallas/decode_attention.py:72, kernel body `_kernel` :44),
// the per-layer attention of the AR sparse GPT's KV-cached decode step. For
// each (b, h) row of q (b, H, dh) and the first pl positions of its K/V
// cache row:
//
//   s_j = q . K_j * scale + addend[h, j]
//   p   = softmax_j(s)           (fp32, then rounded to bf16 as the reference does)
//   out = sum_j p_j V_j          (fp32 accumulate, bf16 out)
//
// `addend` (H, pl) fp32 carries the camera bias * scale where the column is
// visible and -1e9 where it is masked.
//
// What bounds it on an H100 SXM (3.35 TB/s): it reads every K and V entry
// of the prefix once and does 4 FLOP per entry, so bytes. At the nuScenes AR
// shapes (b=2, H=16, dh=64, pl=2368) that is 19.4 MB, about 5.8 us.
//
// Design. One thread block of 512 threads per (b, h) row, so any b*H is
// taken (the TPU kernel needed multiples of 8 rows). Groups of dh/8
// threads read one cache row as 16-byte vectors; each thread issues four
// rows' loads before it uses any, so many loads are in flight. Pass 1
// writes the scores into shared memory (pl floats), a block reduction
// gives their max and sum, and pass 2 reads V once, each group summing
// p_j V_j over its rows; the groups' partial sums meet in shared memory.
// K and V are read with the caller's row stride, so the decode step hands
// in a prefix view of its full-width caches without a copy. What this
// first version leaves on the table: with b*H = 32 blocks on 132 SMs most
// of the card is idle; splitting pl across blocks (a second combine pass)
// is the first lever.
//
// C interface: decode_attention_bf16(...) returns cudaGetLastError() after
// the launch; the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // cache rows whose loads a thread issues together
// head dim: 1024 / 16 heads in every AR configuration (nuscenes_ar,
// nuscenes_ar_tpu); the wrapper raises for any other
constexpr int HEAD_DIM = 64;

__device__ __forceinline__ void bf16x8(const uint4& u, float f[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}

// block-wide reduction (max or sum) of one float per thread
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ addend,
                        __nv_bfloat16* __restrict__ out, int H, int pl,
                        long long row_stride, float scale) {
  constexpr int D = HEAD_DIM;
  constexpr int G = D / 8;             // threads per cache row (16 B each)
  constexpr int RPP = THREADS / G;     // cache rows per pass of the block
  static_assert(32 % G == 0, "a row's threads share a warp");
  extern __shared__ float scores[];    // pl floats
  __shared__ float red[WARPS];
  __shared__ float part[RPP * D];      // per-group partial sums of P.V

  const int tid = threadIdx.x;
  const int lg = tid % G, grp = tid / G;
  const int row = blockIdx.x;          // b * H + h
  const int h = row % H;
  const __nv_bfloat16* kr = k + static_cast<size_t>(row) * row_stride + lg * 8;
  const __nv_bfloat16* vr = v + static_cast<size_t>(row) * row_stride + lg * 8;
  const float* ad = addend + static_cast<size_t>(h) * pl;

  float qf[8];
  bf16x8(*reinterpret_cast<const uint4*>(q + static_cast<size_t>(row) * D + lg * 8), qf);

  // ---- pass 1: scores into shared memory
  // every thread runs the same trip count (the row reduction is a warp
  // shuffle); rows past pl are skipped inside
  for (int j0 = grp; j0 - grp < pl; j0 += UNROLL * RPP) {
    uint4 kv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * RPP;
      kv[u] = j < pl ? *reinterpret_cast<const uint4*>(kr + static_cast<size_t>(j) * D)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[8];
      bf16x8(kv[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += qf[i] * kf[i];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int j = j0 + u * RPP;
      if (lg == 0 && j < pl) scores[j] = dot * scale + ad[j];
    }
  }
  __syncthreads();

  // ---- softmax statistics
  float mx = -CUDART_INF_F;
  for (int j = tid; j < pl; j += THREADS) mx = fmaxf(mx, scores[j]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int j = tid; j < pl; j += THREADS) {
    const float p = expf(scores[j] - mx);
    scores[j] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, red);  // its barriers publish scores[]

  // ---- pass 2: P.V, the weights rounded to bf16 before the product
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int j0 = grp; j0 - grp < pl; j0 += UNROLL * RPP) {
    uint4 vv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * RPP;
      vv[u] = j < pl ? *reinterpret_cast<const uint4*>(vr + static_cast<size_t>(j) * D)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * RPP;
      if (j < pl) {
        const float p = __bfloat162float(__float2bfloat16(scores[j] / sum));
        float vf[8];
        bf16x8(vv[u], vf);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += p * vf[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[grp * D + lg * 8 + i] = acc[i];
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
    for (int r = 0; r < RPP; ++r) o += part[r * D + tid];
    out[static_cast<size_t>(row) * D + tid] = __float2bfloat16(o);
  }
}

int launch(const void* q, const void* k, const void* v, const void* addend,
           void* out, int rows, int H, int pl, long long row_stride,
           float scale, cudaStream_t stream) {
  constexpr int D = HEAD_DIM;
  constexpr size_t STATIC_SMEM = (WARPS + (THREADS / (D / 8)) * D) * sizeof(float);
  const size_t dyn = static_cast<size_t>(pl) * sizeof(float);
  if (STATIC_SMEM + dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attention_kernel<<<rows, THREADS, dyn, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(addend),
      static_cast<__nv_bfloat16*>(out), H, pl, row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b,H,D) bf16 contiguous; k, v: the (b,H) rows of a cache, row r at
// k + r * row_stride elements, its first pl positions read as (pl, D)
// contiguous bf16; addend (H,pl) fp32 contiguous; out (b,H,D) bf16.
// Returns cudaGetLastError() (or the error of setting the kernel's shared
// memory size).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* addend,
                                     void* out, int b, int H, int pl, int D,
                                     long long row_stride, float scale,
                                     void* stream) {
  if (b <= 0 || H <= 0 || pl <= 0 || row_stride < static_cast<long long>(pl) * D ||
      static_cast<long long>(b) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, addend, out, b * H, H, pl, row_stride, scale,
                static_cast<cudaStream_t>(stream));
}
