// Shared pieces of the row-normalisation kernels (`fused_glue.cu`,
// `layernorm.cu`): one thread block per row, the row's values kept in
// shared memory as fp32 between the statistics and the normalisation, the
// sum and the sum of squares reduced with warp shuffles and shared memory,
// and the scale-only LayerNorm of the reference,
//
//   mu = E[v], var = E[v^2] - mu^2 (fp32, not clamped), rstd = rsqrt(var + 1e-5)
//   out = bf16((v - mu) * rstd * gamma)
//
// Each thread owns the columns i = (tid + k * THREADS) * V of the row, V
// consecutive bf16 at a time (V = 2 where the width is even, so every
// access is a 4-byte bf16x2; V = 1 otherwise), in both passes: it reads back
// only the shared-memory entries it wrote itself.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rownorm {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-5f;
// the row's fp32 copy lives in dynamic shared memory: at most the 227 KB a
// block may have, less the reduction's static buffer
constexpr int MAX_WIDTH = (227 * 1024 - WARPS * 8) / 4;

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float f[V]) {
  if constexpr (V == 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = t.x;
    f[1] = t.y;
  } else {
    f[0] = __bfloat162float(*p);
  }
}

// round f to bf16 (nearest, ties to even), store it at p, and leave the
// stored values in f
template <int V>
__device__ __forceinline__ void round_store(__nv_bfloat16* p, float f[V]) {
  if constexpr (V == 2) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[0], f[1]);
    *reinterpret_cast<__nv_bfloat162*>(p) = b;
    const float2 t = __bfloat1622float2(b);
    f[0] = t.x;
    f[1] = t.y;
  } else {
    const __nv_bfloat16 b = __float2bfloat16_rn(f[0]);
    *p = b;
    f[0] = __bfloat162float(b);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (sum, sum of squares) over the block's threads; called once per kernel
__device__ __forceinline__ float2 block_sum2(float2 v) {
  __shared__ float2 red[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float2 t = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  return t;
}

// the second pass: out[i] = bf16((row[i] - mu) * rstd * gamma[i]) over this
// thread's columns, with the statistics from the first pass's sums
template <int V>
__device__ __forceinline__ void write_normed(const float* row, const float* __restrict__ gamma,
                                             __nv_bfloat16* __restrict__ out, int width,
                                             float2 sums) {
  const float inv = 1.0f / static_cast<float>(width);
  const float mu = sums.x * inv;
  const float var = sums.y * inv - mu * mu;
  const float rstd = rsqrtf(var + EPS);
  for (int i = threadIdx.x * V; i < width; i += THREADS * V) {
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = (row[i + v] - mu) * rstd * gamma[i + v];
    round_store<V>(out + i, o);
  }
}

// launch `kernel` with one block per row and `width` floats of dynamic
// shared memory; returns the error of the launch (or of raising the
// kernel's shared-memory limit)
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, long long rows, int width, cudaStream_t stream,
                Args... args) {
  if (rows <= 0 || rows > 2147483647LL || width <= 0 || width > MAX_WIDTH)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(width) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(rows), THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rownorm
