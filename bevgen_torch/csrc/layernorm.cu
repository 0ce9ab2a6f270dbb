// Scale-only LayerNorm for Hopper (sm_90a), bf16 in and out, fp32
// statistics.
//
// Replaces the TPU kernel `fused_layernorm`
// (bevgen_tpu/ops/pallas/layernorm.py:54, kernel body `_ln_kernel` :35):
//
//   out = bf16((x - mu) * rsqrt(var + 1e-5) * scale),  var = E[x^2] - mu^2
//
// for x (rows, D) bf16 (any leading dims flattened) and scale (D,) fp32,
// the variance not clamped. The TPU kernel took its two row sums on the
// matrix unit (a product with a ones matrix) and padded D to 128 lanes;
// here a row's sums are warp shuffles, for any D.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes, 4 per element (x read
// once, out written once); at (2, 1792, 1024), 14.7 MB, 4.4 us. A row is a
// few KB, so the kernel lives on how many bytes each SM keeps in flight and
// on how little fixed work (barriers, shared memory) each row costs.
//
// Two variants, both written by hand; the wrapper picks one with an
// explicit rule (bevgen_torch/ops/layernorm.py:layernorm_variant):
//
// * the register form (`layernorm_warp_kernel<NCH>`), for D a multiple of
//   8 up to WARP_MAX_WIDTH and x, scale and out 16-byte aligned. One warp
//   per row, the row held in registers: lane l owns the 8-column chunks
//   c = l + 32 k (k < NCH, c < D / 8), read and written as 16-byte uint4
//   accesses, so a warp's access is 512 contiguous bytes. The lane's partial
//   sum and sum of squares go through an xor-shuffle tree (offsets 16, 8,
//   4, 2, 1); no shared memory, no __syncthreads. The grid is persistent,
//   one wave (SM count x resident blocks, fewer when the rows are few), and
//   the rows are dealt block-first: warp w of block b takes rows
//   b + G * (w + WARPS * j), j = 0, 1, ..., for G blocks, so every SM gets
//   the same share. Each warp loads scale once (float4, kept in registers)
//   and issues the next row's loads before the current row's reduction and
//   store, so it keeps two rows in flight.
// * the general form (`layernorm_block_kernel<V>`), the first version of
//   this kernel, for every other case (D not a multiple of 8, a pointer off
//   16 bytes, D above the cap): the row pass of row_norm.cuh, one block of
//   256 threads per row, bf16x2 accesses (V = 2) where D is even and x and
//   out are 4-byte aligned, single elements (V = 1) otherwise, the row kept
//   as fp32 in shared memory between the statistics and the normalisation.
//
// C interface: layernorm_warp_bf16 / layernorm_block_bf16 return
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the variant does not take); the Python wrapper raises if it is not 0.
// layernorm_resources reports a variant's shared memory and resident blocks
// per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_norm.cuh"

namespace {

constexpr int WARP_THREADS = 256;  // 8 warps a block
constexpr int WARPS = WARP_THREADS / 32;
constexpr int CHUNK = 8;           // bf16 in one 16-byte access
// chunks a lane holds at most: D <= 32 * 8 * 8 = 2048 (bevgen_torch/ops/
// layernorm.py:WARP_MAX_WIDTH); the instances are NCH = 1, 2, 4, 8
constexpr int MAX_NCH = 8;
constexpr int WARP_MAX_WIDTH = 32 * CHUNK * MAX_NCH;

__device__ __forceinline__ void unpack8(const uint4& u, float f[CHUNK]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[CHUNK]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// issue the loads of one row's chunks owned by this lane (streaming: x is
// read once)
template <int NCH>
__device__ __forceinline__ void load_row(const uint4* __restrict__ row, int lane,
                                         int nchunks, uint4 (&v)[NCH]) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c = lane + 32 * k;
    if (c < nchunks) v[k] = __ldcs(row + c);
  }
}

template <int NCH>
__global__ void __launch_bounds__(WARP_THREADS)
layernorm_warp_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ gamma,
                      __nv_bfloat16* __restrict__ out, long long rows, int D) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nchunks = D / CHUNK;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  long long r = blockIdx.x + static_cast<long long>(gridDim.x) * warp;
  if (r >= rows) return;

  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 cur[NCH], nxt[NCH];
  load_row<NCH>(xv + r * nchunks, lane, nchunks, cur);

  // scale, once per warp: 8 floats per chunk as two float4
  float4 g[NCH][2];
  const float4* gv = reinterpret_cast<const float4*>(gamma);
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c = lane + 32 * k;
    if (c < nchunks) {
      g[k][0] = __ldg(gv + 2 * c);
      g[k][1] = __ldg(gv + 2 * c + 1);
    }
  }
  const float inv = 1.0f / static_cast<float>(D);

  for (; r < rows; r += step) {
    // the next row's loads go out before this row's reduction and store
    const long long rn = r + step;
    if (rn < rows) load_row<NCH>(xv + rn * nchunks, lane, nchunks, nxt);

    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (lane + 32 * k < nchunks) {
        float f[CHUNK];
        unpack8(cur[k], f);
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
          s += f[i];
          ss += f[i] * f[i];
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s * inv;
    const float var = ss * inv - mu * mu;
    const float rstd = rsqrtf(var + rownorm::EPS);

    uint4* orow = ov + r * nchunks;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = lane + 32 * k;
      if (c < nchunks) {
        float f[CHUNK];
        unpack8(cur[k], f);
        const float gk[CHUNK] = {g[k][0].x, g[k][0].y, g[k][0].z, g[k][0].w,
                                 g[k][1].x, g[k][1].y, g[k][1].z, g[k][1].w};
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) f[i] = (f[i] - mu) * rstd * gk[i];
        orow[c] = pack8(f);
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) cur[k] = nxt[k];
  }
}

template <int V>
__global__ void __launch_bounds__(rownorm::THREADS)
layernorm_block_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ gamma,
                       __nv_bfloat16* __restrict__ out, int D) {
  extern __shared__ float row[];  // x as fp32, D floats
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x * V; i < D; i += rownorm::THREADS * V) {
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

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// resident blocks per SM of the register form's instance, and the SM count,
// queried once per device
struct WarpGrid {
  int sms = 0;
  int blocks[MAX_NCH + 1] = {};
};

template <int NCH>
cudaError_t warp_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, layernorm_warp_kernel<NCH>, WARP_THREADS, 0);
}

cudaError_t warp_grid(int nch, int* sms, int* blocks) {
  static WarpGrid cache[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  WarpGrid& c = cache[dev];
  if (c.sms == 0) {
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  if (c.blocks[nch] == 0) {
    switch (nch) {
      case 1: e = warp_occupancy<1>(&c.blocks[nch]); break;
      case 2: e = warp_occupancy<2>(&c.blocks[nch]); break;
      case 4: e = warp_occupancy<4>(&c.blocks[nch]); break;
      case 8: e = warp_occupancy<8>(&c.blocks[nch]); break;
      default: return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
  }
  *sms = c.sms;
  *blocks = c.blocks[nch];
  return cudaSuccess;
}

// the instance for width D: the fewest chunks per lane that cover D / 8
int warp_instance(int D) {
  const int need = (D / CHUNK + 31) / 32;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

}  // namespace

// The register form. x, out: (rows, D) contiguous bf16; gamma (D,)
// contiguous fp32; D a multiple of 8, at most WARP_MAX_WIDTH; all three
// 16-byte aligned.
extern "C" int layernorm_warp_bf16(const void* x, const void* gamma, void* out,
                                   long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0 || D % CHUNK != 0 || D > WARP_MAX_WIDTH ||
      !aligned(x, 16) || !aligned(gamma, 16) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = warp_instance(D);
  int sms = 0, per_sm = 0;
  const cudaError_t e = warp_grid(nch, &sms, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (rows + WARPS - 1) / WARPS;
  const unsigned grid = static_cast<unsigned>(need < wave ? need : wave);
  auto args = [&](auto kernel) {
    kernel<<<grid, WARP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<__nv_bfloat16*>(out), rows, D);
    return static_cast<int>(cudaGetLastError());
  };
  switch (nch) {
    case 1: return args(layernorm_warp_kernel<1>);
    case 2: return args(layernorm_warp_kernel<2>);
    case 4: return args(layernorm_warp_kernel<4>);
    default: return args(layernorm_warp_kernel<8>);
  }
}

// The general form. x, out: (rows, D) contiguous bf16 at any 2-byte
// alignment; gamma (D,) contiguous fp32.
extern "C" int layernorm_block_bf16(const void* x, const void* gamma, void* out,
                                    long long rows, int D, void* stream) {
  auto args = [&](auto kernel) {
    return rownorm::launch_rows(
        kernel, rows, D, static_cast<cudaStream_t>(stream),
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<__nv_bfloat16*>(out), D);
  };
  const bool pairs = D % 2 == 0 && aligned(x, 4) && aligned(out, 4);
  return pairs ? args(layernorm_block_kernel<2>) : args(layernorm_block_kernel<1>);
}

// Resources of one instance: which = NCH (1, 2, 4, 8) for the register
// form, -V (-1, -2) for the general form at width D (its dynamic shared
// memory is D floats). Writes the dynamic shared bytes and the resident
// blocks per SM.
extern "C" int layernorm_resources(int which, int D, int* smem, int* blocks_per_sm) {
  if (which > 0) {
    int sms = 0;
    *smem = 0;
    return static_cast<int>(warp_grid(which, &sms, blocks_per_sm));
  }
  const size_t bytes = static_cast<size_t>(D) * sizeof(float);
  *smem = static_cast<int>(bytes);
  auto query = [&](auto kernel) {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, rownorm::THREADS, bytes));
  };
  if (which == -2) return query(layernorm_block_kernel<2>);
  if (which == -1) return query(layernorm_block_kernel<1>);
  return static_cast<int>(cudaErrorInvalidValue);
}
