// The transformer's fused "glue" passes for Hopper (sm_90a): residual add +
// scale-only LayerNorm, and GEGLU + scale-only LayerNorm, bf16 in and out,
// fp32 statistics.
//
// Replaces the TPU kernels of bevgen_tpu/ops/pallas/fused_glue.py:
//
//   residual_layernorm_fwd (:71, kernel body `_res_ln_kernel` :59):
//     x_new = bf16(x + d);  normed = LN(x_new) * gamma
//     for x, d (rows, F) bf16 and gamma (F,) fp32; both outputs (rows, F)
//     bf16. The statistics are taken from the rounded x_new, as the TPU
//     kernel does, so x_new is bit for bit what `x + d` gives in bf16.
//
//   geglu_layernorm_fwd (:171, kernel body `_geglu_ln_kernel` :157):
//     h = bf16(gate * gelu(a));  out = LN(h) * gamma
//     for y (rows, 2F) bf16 laid out [a | gate] and gamma (F,) fp32; out
//     (rows, F) bf16. gelu is the exact one, 0.5 a (1 + erf(a / sqrt 2)),
//     with erff (the TPU kernel's polynomial erf stood in for a Mosaic
//     primitive it lacked). The TPU wrapper took y with each half padded to
//     a multiple of 128 lanes; this kernel takes the unpadded layout the
//     projection writes, for any F.
//
// The LayerNorm: see row_norm.cuh (var = E[v^2] - mu^2, eps 1e-5).
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Residual + LN reads x
// and d and writes two outputs (8 bytes per element); at the MUSE serving
// shape (3584 x 1024) that is 29.4 MB, 8.8 us. GEGLU + LN reads 4 bytes and
// writes 2 per output element; at 3584 x 2730, 58.7 MB, 17.5 us. The
// arithmetic (about 7 and 12 fp32 operations per element, erff counted as
// one) is far below the card's fp32 rate.
//
// Design, a first version: one block of 256 threads per row, bf16x2
// accesses where F is even (scalar otherwise: at F = 2730 a row of y is
// 10,920 bytes, so 16-byte vectors would not stay aligned), the row kept
// as fp32 in shared memory between the two passes, so the inputs are read
// from memory once. Left for later: 16-byte accesses where rows allow,
// several rows per block and a persistent grid.
//
// C interface: each function returns cudaGetLastError() after the launch;
// the Python wrapper (bevgen_torch/ops/fused_glue.py) raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_norm.cuh"

namespace {

using rownorm::THREADS;

template <int V>
__global__ void __launch_bounds__(THREADS)
glue_residual_norm_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ d,
                          const float* __restrict__ gamma,
                          __nv_bfloat16* __restrict__ xo,
                          __nv_bfloat16* __restrict__ no, int F) {
  extern __shared__ float row[];  // the rounded x_new, F floats
  const size_t base = static_cast<size_t>(blockIdx.x) * F;
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x * V; i < F; i += THREADS * V) {
    float a[V], b[V];
    rownorm::load<V>(x + base + i, a);
    rownorm::load<V>(d + base + i, b);
#pragma unroll
    for (int v = 0; v < V; ++v) a[v] += b[v];
    rownorm::round_store<V>(xo + base + i, a);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      row[i + v] = a[v];
      s.x += a[v];
      s.y += a[v] * a[v];
    }
  }
  rownorm::write_normed<V>(row, gamma, no + base, F, rownorm::block_sum2(s));
}

template <int V>
__global__ void __launch_bounds__(THREADS)
glue_geglu_norm_kernel(const __nv_bfloat16* __restrict__ y,
                       const float* __restrict__ gamma,
                       __nv_bfloat16* __restrict__ out, int F) {
  extern __shared__ float row[];  // h rounded to bf16, F floats
  const __nv_bfloat16* ya = y + static_cast<size_t>(blockIdx.x) * 2 * F;
  const __nv_bfloat16* yg = ya + F;
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x * V; i < F; i += THREADS * V) {
    float a[V], g[V];
    rownorm::load<V>(ya + i, a);
    rownorm::load<V>(yg + i, g);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float h = rownorm::round_bf16(
          g[v] * (a[v] * 0.5f * (1.0f + erff(a[v] * 0.70710678118654752f))));
      row[i + v] = h;
      s.x += h;
      s.y += h * h;
    }
  }
  rownorm::write_normed<V>(row, gamma, out + static_cast<size_t>(blockIdx.x) * F, F,
                           rownorm::block_sum2(s));
}

}  // namespace

// x, d, xo, no: (rows, F) contiguous bf16; gamma (F,) contiguous fp32.
extern "C" int residual_layernorm_bf16(const void* x, const void* d,
                                       const void* gamma, void* xo, void* no,
                                       long long rows, int F, void* stream) {
  auto args = [&](auto kernel) {
    return rownorm::launch_rows(
        kernel, rows, F, static_cast<cudaStream_t>(stream),
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(d),
        static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(xo),
        static_cast<__nv_bfloat16*>(no), F);
  };
  return F % 2 == 0 ? args(glue_residual_norm_kernel<2>)
                    : args(glue_residual_norm_kernel<1>);
}

// y: (rows, 2F) contiguous bf16, [a | gate]; gamma (F,) contiguous fp32;
// out: (rows, F) contiguous bf16.
extern "C" int geglu_layernorm_bf16(const void* y, const void* gamma,
                                    void* out, long long rows, int F,
                                    void* stream) {
  auto args = [&](auto kernel) {
    return rownorm::launch_rows(
        kernel, rows, F, static_cast<cudaStream_t>(stream),
        static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(gamma),
        static_cast<__nv_bfloat16*>(out), F);
  };
  return F % 2 == 0 ? args(glue_geglu_norm_kernel<2>)
                    : args(glue_geglu_norm_kernel<1>);
}
