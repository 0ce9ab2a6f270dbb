// The int8 serving path's pointwise kernels for Hopper (sm_90a). The
// port-only part of int8 serving: on the TPU, XLA fuses each of these into
// the int8 dot (bevgen_tpu/ops/quant.py, no Pallas kernel). The products
// themselves, `w8_linear` and the fused W8A8 `int8_linear` (which runs the
// quantizers and the epilogue below inside it, for every product that is
// not split by rows under tp), are in csrc/int8_gemm.cu.
//
//   quantize_static   q = int8(clip(round(x * (1 / in_scale[k])), +-127))
//                     (bevgen_tpu/ops/quant.py:66): x (rows, K) bf16,
//                     q (rows, Kp) with zeros in the columns K..Kp-1 (Kp a
//                     multiple of 8, as torch._int_mm takes it).
//   quantize_dynamic  per row scale = max(amax, 1e-8) * fp32(1/127) (the
//                     reference's `/ 127.0` as XLA compiles it) and
//                     q = int8(clip(round(x / scale), +-127)) (quant.py:57),
//                     the same padding; one warp per row.
//   int8_epilogue     out = T(f32(acc) * w_scale[col] (* x_scale[row]))
//                     (quant.py:100-110): acc (rows, Np) int32 from
//                     torch._int_mm, out (rows, N) in bf16 (the path's) or
//                     fp32, without the N padding.
//
// With torch._int_mm between them they make the three-launch chain of a
// W8A8 product, which serves the products split by rows under tensor
// parallelism (tp) and is the card's comparison route for `int8_linear`.
// A row-split product holds the rank's columns of x and rows of the
// weight, and the sum over tp comes between the pieces (ops/quant.py):
//
//   row_amax          the dynamic path's first half: amax (rows,) fp32 of the
//                     rank's columns; the caller takes the max over tp;
//   quantize_scaled   its second half: scale = max(amax, 1e-8) * fp32(1/127)
//                     from that max, formed once per row, and the rank's
//                     int8 columns with it, as quantize_dynamic writes them.
//                     The int32 accumulators are then summed over tp (exact)
//                     before one int8_epilogue, so the output equals one
//                     process's bit for bit;
//   w8_tail           the AR product's tail, bf16(bf16(y * bf16(scale)) +
//                     bias), on the sum over tp of the raw products
//                     (`w8_linear` without a scale), the bias added once.
//
// Bit-exactness with the reference: the static path multiplies by the fp32
// reciprocal (1 / in_scale, correctly rounded, nvcc's default -prec-div),
// the dynamic path multiplies amax by the fp32 constant 1/127 and divides
// x by the scale (__fdiv_rn), both round half to even (rintf),
// the products are single __fmul_rn: on the same fp32 inputs the int8
// values, row scales and the epilogue's fp32 values equal the plain
// PyTorch versions' and the JAX package's.
//
// What bounds them on an H100 SXM (3.35 TB/s): bytes, for all of them at
// the serving shapes. quantize_* read 2 bytes and write 1 per element (3584
// x 1024 bf16 at MUSE b=2: 11.0 MB, 3.3 us); the epilogue reads 4 and
// writes 2 per output element (3584 x 5460: 117 MB, 35 us). The tp pieces:
// row_amax reads 2 bytes per element (a tp = 2 rank's to_out input, 1536 x
// 512 at b = 2: 1.6 MB, 0.47 us), quantize_scaled 2 and writes 1, w8_tail
// reads 2 and writes 2 per element.
//
// Design. One pass each, 8 (quantize) or 4 (epilogue) consecutive elements
// a thread, with 16-byte loads where the row length and the address allow,
// scalar accesses otherwise. Only bf16 activations: the port's attention
// kernels take nothing else, so no other dtype reaches these on the card.
//
// C interface: each function returns cudaGetLastError() after the launch;
// the Python wrapper (bevgen_torch/ops/quant.py) raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// round half to even, then clip to +-127 (jnp.round / torch.round, clip)
__device__ __forceinline__ int q8(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// 8 consecutive bf16 of a row as fp32: one 16-byte load where VEC, else 8
// scalar loads of the columns < K (zeros past it)
template <bool VEC>
__device__ __forceinline__ void load8(const bf16* row, int c, int K, float v[8]) {
  if constexpr (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c + j < K ? __bfloat162float(row[c + j]) : 0.f;
  }
}

// columns c..c+7 of a row: the vector load where all 8 lie below K
template <bool VEC>
__device__ __forceinline__ void load_cols(const bf16* row, int c, int K, float v[8]) {
  if (c + 8 <= K) {
    load8<VEC>(row, c, K, v);
  } else {
    load8<false>(row, c, K, v);
  }
}

// the 8 int8 values of columns c..c+7 (0 past K) as one 8-byte store
__device__ __forceinline__ void store8(int8_t* q, const int v[8]) {
  *reinterpret_cast<uint2*>(q) =
      make_uint2(pack4(v[0], v[1], v[2], v[3]), pack4(v[4], v[5], v[6], v[7]));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_static_kernel(const bf16* __restrict__ x, const float* __restrict__ in_scale,
                       int8_t* __restrict__ q, long long rows, int K, int Kp) {
  const int groups = Kp / 8;
  const long long total = rows * groups;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = i / groups;
    const int c = static_cast<int>(i - r * groups) * 8;
    float v[8];
    int o[8];
    load_cols<VEC>(x + r * K, c, K, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the reference's order: the fp32 reciprocal first, then one multiply
      o[j] = c + j < K ? q8(__fmul_rn(v[j], __fdiv_rn(1.0f, in_scale[c + j])))
                       : 0;
    }
    store8(q + r * Kp + c, o);
  }
}

// the dynamic path's pieces, one warp per row: the row's amax over its
// columns (every lane holds it after the shuffles) ...
template <bool VEC>
__device__ __forceinline__ float warp_row_amax(const bf16* xr, int K, int Kp,
                                               int lane) {
  float amax = 0.f;
  for (int c = lane * 8; c < Kp; c += 32 * 8) {
    float v[8];
    load_cols<VEC>(xr, c, K, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return amax;
}

// ... the row scale from it, formed once: the reference's / 127.0 as XLA
// compiles it ...
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
}

// ... and the int8 row with that scale (the row is read again, from L1)
template <bool VEC>
__device__ __forceinline__ void warp_quantize_row(const bf16* xr, int8_t* qr,
                                                  float s, int K, int Kp,
                                                  int lane) {
  for (int c = lane * 8; c < Kp; c += 32 * 8) {
    float v[8];
    int o[8];
    load_cols<VEC>(xr, c, K, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = c + j < K ? q8(__fdiv_rn(v[j], s)) : 0;
    store8(qr + c, o);
  }
}

__device__ __forceinline__ long long warp_row() {
  return blockIdx.x * static_cast<long long>(THREADS / 32) + (threadIdx.x >> 5);
}

// one warp per row: the row's amax, its scale and the int8 row
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_dynamic_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, long long rows, int K,
                        int Kp) {
  const int lane = threadIdx.x & 31;
  const long long r = warp_row();
  if (r >= rows) return;
  const bf16* xr = x + r * K;
  const float s = row_scale(warp_row_amax<VEC>(xr, K, Kp, lane));
  if (lane == 0) scale[r] = s;
  warp_quantize_row<VEC>(xr, q + r * Kp, s, K, Kp, lane);
}

// the row-split form's first half (tp): the amax of the rank's columns,
// which the caller reduces with a max over tp
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
row_amax_kernel(const bf16* __restrict__ x, float* __restrict__ amax,
                long long rows, int K, int Kp) {
  const int lane = threadIdx.x & 31;
  const long long r = warp_row();
  if (r >= rows) return;
  const float a = warp_row_amax<VEC>(x + r * K, K, Kp, lane);
  if (lane == 0) amax[r] = a;
}

// its second half: the scale from the amax over every rank's columns, then
// the rank's int8 columns with it
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_scaled_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ amax, int8_t* __restrict__ q,
                       float* __restrict__ scale, long long rows, int K,
                       int Kp) {
  const int lane = threadIdx.x & 31;
  const long long r = warp_row();
  if (r >= rows) return;
  const float s = row_scale(amax[r]);
  if (lane == 0) scale[r] = s;
  warp_quantize_row<VEC>(x + r * K, q + r * Kp, s, K, Kp, lane);
}

// 4 consecutive output columns a thread where VEC (N % 4 == 0: 16-byte acc
// loads), one otherwise
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_epilogue_kernel(const int32_t* __restrict__ acc,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ x_scale, T* __restrict__ out,
                     long long rows, int N, int Np) {
  constexpr int E = VEC ? 4 : 1;
  const int groups = (N + E - 1) / E;
  const long long total = rows * groups;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = i / groups;
    const int c = static_cast<int>(i - r * groups) * E;
    const float xs = x_scale != nullptr ? x_scale[r] : 1.f;
    int a[E];
    if constexpr (VEC) {
      const int4 u = *reinterpret_cast<const int4*>(acc + r * Np + c);
      a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
    } else {
      a[0] = acc[r * Np + c];
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      float f = __fmul_rn(__int2float_rn(a[j]), w_scale[c + j]);
      if (x_scale != nullptr) f = __fmul_rn(f, xs);
      out[r * N + c + j] = from_f32<T>(f);
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the AR product's tail on `a` of column n: bf16(a), times bf16(scale),
// plus the bias, each step rounded to bf16 (int8_gemm.cu's w8_finish)
__device__ __forceinline__ bf16 w8_finish(float a, const float* scale,
                                          const bf16* bias, int n) {
  float o = round_bf16(__fmul_rn(round_bf16(a), round_bf16(scale[n])));
  if (bias != nullptr) o = __fadd_rn(o, __bfloat162float(bias[n]));
  return __float2bfloat16_rn(o);
}

// the tail alone, on the bf16 product summed over tp: w8_finish per element
__global__ void __launch_bounds__(THREADS)
w8_tail_kernel(const bf16* __restrict__ y, const float* __restrict__ scale,
               const bf16* __restrict__ bias, bf16* __restrict__ out,
               long long M, int N) {
  const long long total = M * N;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * THREADS) {
    const int n = static_cast<int>(i % N);
    out[i] = w8_finish(__bfloat162float(y[i]), scale, bias, n);
  }
}

unsigned grid_for(long long total) {
  long long blocks = (total + THREADS - 1) / THREADS;
  const long long cap = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  return static_cast<unsigned>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int epilogue_t(const void* acc, const void* w_scale, const void* x_scale,
               void* out, long long rows, int N, int Np, cudaStream_t s) {
  const bool vec = N % 4 == 0 && aligned16(acc);
  const unsigned grid = grid_for(rows * (vec ? N / 4 : N));
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(static_cast<const int32_t*>(acc),
                                    static_cast<const float*>(w_scale),
                                    static_cast<const float*>(x_scale),
                                    static_cast<T*>(out), rows, N, Np);
  };
  vec ? args(int8_epilogue_kernel<T, true>) : args(int8_epilogue_kernel<T, false>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, K) contiguous bf16; in_scale (K,) fp32; q (>= rows, Kp) int8, Kp
// a multiple of 8 >= K.
extern "C" int quantize_static(const void* x, const void* in_scale, void* q,
                               long long rows, int K, int Kp, void* stream) {
  const bool vec = K % 8 == 0 && aligned16(x);
  const unsigned grid = grid_for(rows * (Kp / 8));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(x),
                                    static_cast<const float*>(in_scale),
                                    static_cast<int8_t*>(q), rows, K, Kp);
  };
  vec ? args(quantize_static_kernel<true>) : args(quantize_static_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, K) contiguous bf16; q (>= rows, Kp) int8; scale (rows,) fp32.
extern "C" int quantize_dynamic(const void* x, void* q, void* scale,
                                long long rows, int K, int Kp, void* stream) {
  const bool vec = K % 8 == 0 && aligned16(x);
  const unsigned grid =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(x),
                                    static_cast<int8_t*>(q),
                                    static_cast<float*>(scale), rows, K, Kp);
  };
  vec ? args(quantize_dynamic_kernel<true>) : args(quantize_dynamic_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, K) contiguous bf16; amax (rows,) fp32: the row's max |x| over
// its K columns.
extern "C" int row_amax(const void* x, void* amax, long long rows, int K,
                        void* stream) {
  const int Kp = (K + 7) / 8 * 8;
  const bool vec = K % 8 == 0 && aligned16(x);
  const unsigned grid =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(x),
                                    static_cast<float*>(amax), rows, K, Kp);
  };
  vec ? args(row_amax_kernel<true>) : args(row_amax_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, K) contiguous bf16; amax (rows,) fp32, the max over tp; q (>= rows,
// Kp) int8; scale (rows,) fp32 out.
extern "C" int quantize_scaled(const void* x, const void* amax, void* q,
                               void* scale, long long rows, int K, int Kp,
                               void* stream) {
  const bool vec = K % 8 == 0 && aligned16(x);
  const unsigned grid =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(x),
                                    static_cast<const float*>(amax),
                                    static_cast<int8_t*>(q),
                                    static_cast<float*>(scale), rows, K, Kp);
  };
  vec ? args(quantize_scaled_kernel<true>) : args(quantize_scaled_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

// acc (>= rows, Np) int32; w_scale (N,) fp32; x_scale (rows,) fp32 or NULL;
// out (rows, N), bf16 (out_fp32 0) or fp32 (1).
extern "C" int int8_epilogue(const void* acc, const void* w_scale,
                             const void* x_scale, void* out, long long rows,
                             int N, int Np, int out_fp32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_fp32 ? epilogue_t<float>(acc, w_scale, x_scale, out, rows, N, Np, s)
                  : epilogue_t<bf16>(acc, w_scale, x_scale, out, rows, N, Np, s);
}

// y (M, N) contiguous bf16, the raw product summed over tp; scale (N,) fp32;
// bias (N,) bf16 or NULL; out (M, N) bf16.
extern "C" int w8_tail(const void* y, const void* scale, const void* bias,
                       void* out, long long M, int N, void* stream) {
  w8_tail_kernel<<<grid_for(M * N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const float*>(scale),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}
