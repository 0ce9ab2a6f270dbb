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
// Under tensor parallelism (tp ways) a rank holds Fl = F / tp columns of a
// and of gate, so the GEGLU + LN row statistics span every rank's columns.
// Two kernels take the place of the one above on such a rank (no TPU kernel
// of its own: GSPMD ran the Pallas kernel on the gathered operands):
//
//   geglu_stats_bf16  y (rows, 2 Fl) [a | gate] -> stats (rows, 2) fp32,
//                     the row's (sum h, sum h^2) over the rank's columns,
//                     h = bf16(gate * gelu(a)) as above;
//   geglu_norm_bf16   y, stats summed over tp, gamma (Fl,) the rank's gains
//                     -> out (rows, Fl) bf16 = (h - mu) * rsqrt(var + 1e-5)
//                     * gamma, mu and var over the whole F = Fl * tp.
//
// Between them the caller sums the (rows, 2) statistics over tp
// (ops/fused_glue.py). The second kernel recomputes h from y: the formula
// and its rounding are the first kernel's, so h is bit for bit the same.
// Writing h out and reading it back moves as many bytes (read 4 bytes and
// write 2 per element, then read 2 and write 2, against read 4 and read 4,
// write 2): 10 bytes per output element either way, beside the whole
// kernel's 6, and recomputing needs no scratch tensor. At argoverse_muse
// and tp = 2, Fl = 1365 is odd, so both take the scalar V = 1 path.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Residual + LN reads x
// and d and writes two outputs (8 bytes per element); at the MUSE serving
// shape (3584 x 1024) that is 29.4 MB, 8.8 us. GEGLU + LN reads 4 bytes and
// writes 2 per output element; at 3584 x 2730, 58.7 MB, 17.5 us. The
// arithmetic (about 7 and 12 fp32 operations per element, erff counted as
// one) is far below the card's fp32 rate. The split pair at a tp = 2
// rank's serving shape (1536 x 1365 at b = 2) moves 10 bytes per output
// element, 21.0 MB together, 6.3 us; bytes bound it too.
//
// Design, a first version: one block of 256 threads per row, bf16x2
// accesses where F is even (scalar otherwise: at F = 2730 a row of y is
// 10,920 bytes, so 16-byte vectors would not stay aligned), the row kept
// as fp32 in shared memory between the two passes, so the inputs are read
// from memory once. Left for later: 16-byte accesses where rows allow,
// several rows per block and a persistent grid.
//
// The split pair keeps the block-per-row walk without the shared-memory
// row: the statistics kernel needs no second pass, and the norm kernel reads
// y once. It takes y at any 2-byte alignment: bf16x2 accesses where Fl is
// even and y (and out) are 4-byte aligned, single elements otherwise. A
// redesign for Hopper was built and measured slower at a tp = 2 rank's rows
// (1536 and 3072 x 1365), so it was not kept: each row's 16-byte aligned
// span by one TMA bulk copy into a shared-memory ring, a producer warp and
// teams of warps on the block's rows, one persistent block per SM, warp
// shuffle sums and gamma staged once per block. The pair is held back by
// geglu_h's instructions (erff), which it runs twice per element of the
// rank, and not by its bytes: with y hot in L2 it takes about 80% of its
// cold time. What could still pay is in PERF.md, section 7.
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

// h = bf16(gate * gelu(a)) with the exact erf gelu, as an fp32 value
__device__ __forceinline__ float geglu_h(float a, float g) {
  return rownorm::round_bf16(g * (a * 0.5f * (1.0f + erff(a * 0.70710678118654752f))));
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
      const float h = geglu_h(a[v], g[v]);
      row[i + v] = h;
      s.x += h;
      s.y += h * h;
    }
  }
  rownorm::write_normed<V>(row, gamma, out + static_cast<size_t>(blockIdx.x) * F, F,
                           rownorm::block_sum2(s));
}

// a rank's share of the GEGLU + LN statistics: (sum h, sum h^2) of its Fl
// columns, one block per row
template <int V>
__global__ void __launch_bounds__(THREADS)
glue_geglu_stats_kernel(const __nv_bfloat16* __restrict__ y,
                        float2* __restrict__ stats, int Fl) {
  const __nv_bfloat16* ya = y + static_cast<size_t>(blockIdx.x) * 2 * Fl;
  const __nv_bfloat16* yg = ya + Fl;
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x * V; i < Fl; i += THREADS * V) {
    float a[V], g[V];
    rownorm::load<V>(ya + i, a);
    rownorm::load<V>(yg + i, g);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float h = geglu_h(a[v], g[v]);
      s.x += h;
      s.y += h * h;
    }
  }
  s = rownorm::block_sum2(s);
  if (threadIdx.x == 0) stats[blockIdx.x] = s;
}

// the rank's normalised columns from the statistics summed over tp (width
// F = Fl * tp), recomputing h; the arithmetic of rownorm::write_normed
template <int V>
__global__ void __launch_bounds__(THREADS)
glue_geglu_norm_split_kernel(const __nv_bfloat16* __restrict__ y,
                             const float2* __restrict__ stats,
                             const float* __restrict__ gamma,
                             __nv_bfloat16* __restrict__ out, int Fl, int F) {
  const __nv_bfloat16* ya = y + static_cast<size_t>(blockIdx.x) * 2 * Fl;
  const __nv_bfloat16* yg = ya + Fl;
  __nv_bfloat16* o = out + static_cast<size_t>(blockIdx.x) * Fl;
  const float2 s = stats[blockIdx.x];
  const float inv = 1.0f / static_cast<float>(F);
  const float mu = s.x * inv;
  const float var = s.y * inv - mu * mu;
  const float rstd = rsqrtf(var + rownorm::EPS);
  for (int i = threadIdx.x * V; i < Fl; i += THREADS * V) {
    float a[V], g[V], r[V];
    rownorm::load<V>(ya + i, a);
    rownorm::load<V>(yg + i, g);
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = (geglu_h(a[v], g[v]) - mu) * rstd * gamma[i + v];
    rownorm::round_store<V>(o + i, r);
  }
}

// one block per row, no dynamic shared memory
template <typename Kernel, typename... Args>
int launch_split(Kernel kernel, long long rows, int Fl, cudaStream_t stream,
                 Args... args) {
  if (rows <= 0 || rows > 2147483647LL || Fl <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

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

// y: (rows, 2 Fl) contiguous bf16, [a | gate] of a rank's columns, at any
// 2-byte alignment; stats: (rows, 2) contiguous fp32, 8-byte aligned.
extern "C" int geglu_stats_bf16(const void* y, void* stats, long long rows,
                                int Fl, void* stream) {
  auto args = [&](auto kernel) {
    return launch_split(kernel, rows, Fl, static_cast<cudaStream_t>(stream),
                        static_cast<const __nv_bfloat16*>(y),
                        static_cast<float2*>(stats), Fl);
  };
  return Fl % 2 == 0 && aligned4(y) ? args(glue_geglu_stats_kernel<2>)
                                     : args(glue_geglu_stats_kernel<1>);
}

// y: (rows, 2 Fl) contiguous bf16, at any 2-byte alignment; stats: (rows,
// 2) fp32, summed over tp, 8-byte aligned; gamma (Fl,) contiguous fp32; out
// (rows, Fl) contiguous bf16; F the whole width (Fl * tp).
extern "C" int geglu_norm_bf16(const void* y, const void* stats,
                               const void* gamma, void* out, long long rows,
                               int Fl, int F, void* stream) {
  if (F < Fl) return static_cast<int>(cudaErrorInvalidValue);
  auto args = [&](auto kernel) {
    return launch_split(kernel, rows, Fl, static_cast<cudaStream_t>(stream),
                        static_cast<const __nv_bfloat16*>(y),
                        static_cast<const float2*>(stats),
                        static_cast<const float*>(gamma),
                        static_cast<__nv_bfloat16*>(out), Fl, F);
  };
  return Fl % 2 == 0 && aligned4(y) && aligned4(out)
             ? args(glue_geglu_norm_split_kernel<2>)
             : args(glue_geglu_norm_split_kernel<1>);
}
