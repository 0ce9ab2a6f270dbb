// Scale-only LayerNorm for Hopper (sm_90a), bf16 in and out, fp32
// statistics.
//
// Replaces the TPU kernel `fused_layernorm`
// (bevgen_tpu/ops/pallas/layernorm.py:54, kernel body `_ln_kernel` :35):
//
//   out = bf16((x - mu) * rsqrt(var + 1e-5) * scale),  var = E[x^2] - mu^2
//
// for x (rows, D) bf16 (any leading dims flattened) and scale (D,) fp32.
// The TPU kernel took its two row sums on the matrix unit (a product with
// a ones matrix) and padded D to 128 lanes; here a row is one thread block
// and its sums are warp shuffles, for any D.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes, 4 per element (x read
// once, out written once); at (2, 1792, 1024), 14.7 MB, 4.4 us.
//
// Design, a first version: the row pass of row_norm.cuh, one block of 256
// threads per row, bf16x2 accesses where D is even, the row kept as fp32 in
// shared memory between the statistics and the normalisation.
//
// C interface: layernorm_bf16(...) returns cudaGetLastError() after the
// launch; the Python wrapper (bevgen_torch/ops/layernorm.py) raises if it
// is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_norm.cuh"

namespace {

using rownorm::THREADS;

template <int V>
__global__ void __launch_bounds__(THREADS)
glue_scale_norm_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ gamma,
                       __nv_bfloat16* __restrict__ out, int D) {
  extern __shared__ float row[];  // x as fp32, D floats
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x * V; i < D; i += THREADS * V) {
    float a[V];
    rownorm::load<V>(x + base + i, a);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      row[i + v] = a[v];
      s.x += a[v];
      s.y += a[v] * a[v];
    }
  }
  rownorm::write_normed<V>(row, gamma, out + base, D, rownorm::block_sum2(s));
}

}  // namespace

// x, out: (rows, D) contiguous bf16; gamma (D,) contiguous fp32.
extern "C" int layernorm_bf16(const void* x, const void* gamma, void* out,
                              long long rows, int D, void* stream) {
  auto args = [&](auto kernel) {
    return rownorm::launch_rows(
        kernel, rows, D, static_cast<cudaStream_t>(stream),
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<__nv_bfloat16*>(out), D);
  };
  return D % 2 == 0 ? args(glue_scale_norm_kernel<2>)
                    : args(glue_scale_norm_kernel<1>);
}
