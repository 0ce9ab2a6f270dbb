// The int8 products of the serving path for Hopper (sm_90a): the AR tree's
// weight-only product `w8_linear` and the MUSE tree's W8A8 product
// `int8_linear`. Port-only kernels: on the TPU, XLA fuses each product with
// its quantizer and rescale into one dot (bevgen_tpu/ops/quant.py:57-110,
// bevgen_tpu/models/stage2/ar_cached.py:41-49; no Pallas kernel).
//
//   w8_linear    out = bf16(bf16(bf16(x @ Wq^T) * bf16(scale)) + bias), fp32
//                sums: x (M, K) bf16, Wq (N, K) int8. scale NULL (bias NULL
//                too): the raw product bf16(x @ Wq^T) of a row-split rank,
//                whose tail (`w8_tail`, csrc/int8.cu) runs after the sum
//                over tp.
//   int8_linear  out = T(f32(acc) * w_scale[n] (* x_scale[m])), acc = the
//                exact int32 product of the quantized x and Wq: x (rows, K)
//                bf16 is quantized inside the kernel, statically
//                (q = int8(clip(rint(x * (1 / in_scale[k])), +-127)), the
//                correctly rounded fp32 reciprocal) or dynamically (per row
//                scale = max(amax, 1e-8) * fp32(1/127), q = rint(x / scale)
//                correctly rounded); Wq is the padded operand (>= N rows,
//                ldw >= K columns, ldw a multiple of 16); T bf16 or fp32.
//                The fp32 operations are those of quantize_static /
//                quantize_dynamic and int8_epilogue (csrc/int8.cu) in the
//                same order, and int32 sums are exact in any order, so the
//                output equals that three-launch chain bit for bit.
//
// What bounds them on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 1,979
// TOP/s int8, dense):
//   w8_linear, decode (M <= 8, the AR steps): bytes, the int8 weights read
//   once: qkv 3072 x 1024 is 3.1 MB, 0.94 us; the whole product is a few us,
//   so what counts is how many bytes are in flight at once and how soon the
//   last block finishes.
//   w8_linear, prefill (M = b * 256): operations at K = 1024 (512 x 1024 x
//   1024: 1.07 GFLOP, 1.09 us against 3.1 MB, 0.94 us).
//   int8_linear: operations at the MUSE shapes (proj_in, 3584 x 5460 x
//   1024: 40 GOP, 20.2 us; its bytes 7.3 MB of x, 5.6 MB of Wq and 39 MB
//   of bf16 output, 15.5 us).
//
// Design.
//   w8_linear, decode form (w8_decode_kernel): a block takes 16 weight rows
//   (16 outputs) and a K range; when the columns alone give fewer than 128
//   blocks, K is split over a thread block cluster of up to 8 blocks
//   (`splits`, chosen in Python: ops/quant.py:w8_plan). At its start the
//   lanes of one warp ask the Tensor Memory Accelerator for the block's
//   whole panel (16 rows of its K range, one bulk copy a row, each row padded
//   so that the fragment loads hit every bank) and the M rows of x over the
//   same range, all on one mbarrier: every byte of the product is requested at
//   once (16-64 KB a block, 1-2 blocks an SM at the AR shapes). The 8 warps
//   split the K range by 16-column
//   chunks; each chunk is one mma.sync m16n8k16 with the 16 weight rows as
//   A (int8 widened to bf16 in registers, exactly) and x^T as B (n = 8
//   covers M <= 8). The k order inside a chunk is permuted, the same way for
//   A and B, so that a thread reads 4 contiguous bytes of a weight row and
//   8 of an x row. The warps' sums are added in warp order in shared
//   memory and the cluster's in rank order through distributed shared
//   memory (no atomics: the same inputs give the same bits).
//   w8_linear, prefill form (w8_prefill_kernel<WGS>): WGS warpgroups of 64
//   rows of x each, 64 output columns, K in steps of 64 through a ring of 6
//   stages that one thread fills with TMA tensor copies (x's tile in the
//   128-byte swizzle, the int8 tile as it is, 4 KB), 4 steps ahead; each
//   step the block widens the int8 tile to bf16 into the swizzled layout
//   that a wgmma B descriptor reads (two buffers), and each warpgroup runs
//   wgmma m64n64k16 (fp32 sums) with A and B in shared memory, one step
//   still in flight while the next is widened. The int8 tile is widened in
//   shared memory rather than as a register A operand (out^T = Wq x^T) so
//   that the accumulator comes out in rows of x and the bf16 tail stores
//   whole column pairs of the output.
//   int8_linear (int8_linear_kernel): two warpgroups take 128 rows of x; a
//   block walks `tiles_per_block` output tiles of 128 columns (the plan,
//   ops/quant.py:int8_linear_plan). Wq's k-tiles (128 x 128 int8, the
//   128-byte swizzle) come through a ring of 5 stages, each one TMA tensor
//   copy issued by one thread 3 steps ahead. (Per-thread cp.async copies of
//   the same tiles, 4 a thread, kept too few bytes in flight: a step took as
//   long without the products as with them.)
//   The quantizer is the prologue. Where the whole A panel fits (K <= 1024,
//   every MUSE product but proj_out) the blocks that share 128 rows (the
//   plan's groups, up to 8) form a thread block cluster: each quantizes
//   every groups-th k-tile of the panel, the next one's x loaded while one
//   is quantized, and stores it in the wgmma A layout into every block's
//   shared memory (distributed shared memory), so x is read and quantized
//   once for the 128 rows rather than once a block; on the dynamic path
//   each first takes the rows' amax over its k-tiles and the cluster
//   combines them (a max, so in any order). Else the panel streams through
//   3 slots, each block quantizing the next k-tile while the tensor cores
//   run the current one, and again for each output tile. The products are
//   wgmma.mma_async m64n128k32 s32.s8.s8 with both operands in shared
//   memory and the int32 accumulators in registers; the epilogue scales
//   them in registers and writes the output once, without the N padding.
//
// C interface: each function returns cudaGetLastError() (or the error of a
// refused setting) after the launch; the Python wrappers
// (bevgen_torch/ops/quant.py) raise if it is not 0.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the AR product's tail on the fp32 sum `a` of column n (w8_tail_kernel's)
__device__ __forceinline__ bf16 w8_finish(float a, const float* scale,
                                          const bf16* bias, int n) {
  if (scale == nullptr) return __float2bfloat16_rn(a);
  float o = round_bf16(__fmul_rn(round_bf16(a), round_bf16(scale[n])));
  if (bias != nullptr) o = __fadd_rn(o, __bfloat162float(bias[n]));
  return __float2bfloat16_rn(o);
}

// Four int8 (the bytes of w) as two bf16 pairs, exactly: the fp32 with bits
// 0x4B0000uu is 2^23 + uu, so byte v ^ 0x80 placed there less 2^23 + 128 is
// v; an integer of |v| <= 128 has zeros in the low 16 bits of its fp32, so
// its upper half is its bf16. lo = (byte 0, byte 1), hi = (byte 2, byte 3),
// the first of each pair in the low half.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// ---- mbarriers and bulk copies (the Tensor Memory Accelerator) -----------

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
}

// wait for the phase of `bar` with the given parity to complete
__device__ __forceinline__ void mbar_wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// the box of a 2-D tensor map at (column c0, row r0) into shared dst,
// completing on `bar`; elements past the tensor's extent arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
         "r"(bar) : "memory");
}

// Host: a 2-D tensor map over a row-major (rows, cols) matrix of `elem`-byte
// elements with a row stride of ld elements, box (box_rows, box_cols),
// through cuTensorMapEncodeTiled (fetched once by the runtime, so nothing
// links libcuda). Returns false where the encoder refuses.
bool make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                     const void* base, uint64_t rows, uint64_t cols, uint64_t ld,
                     uint32_t box_rows, uint32_t box_cols,
                     CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * static_cast<uint64_t>(elem)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- w8_linear, decode form ----------------------------------------------

namespace dec {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;         // weight rows (outputs) a block takes
constexpr int MAX_M = 8;         // rows of x: the n = 8 of mma.m16n8k16
constexpr int MAX_SPLITS = 8;    // blocks of a cluster (the portable maximum)
constexpr int PART = ROWS * MAX_M;

// Row strides of the staged panel and x (bytes) for a K range of kc: the
// panel's a multiple of 16 with an odd quotient (the 8 rows of a fragment
// load fall on 8 different 16-byte bank groups), x's a multiple of 32 with
// an odd quotient (a half warp's 4 rows on 4 different 32-byte groups).
__host__ __device__ __forceinline__ int w_ld(int kc) {
  return kc + ((kc / 16) % 2 == 0 ? 16 : 32);
}
__host__ __device__ __forceinline__ int x_ld(int kc) {
  return 2 * kc + ((2 * kc / 32) % 2 == 0 ? 32 : 64);
}
size_t smem_bytes(int M, int kc) {
  return static_cast<size_t>(ROWS) * w_ld(kc) + static_cast<size_t>(M) * x_ld(kc);
}
}  // namespace dec

__global__ void __launch_bounds__(dec::THREADS)
w8_decode_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, const bf16* __restrict__ bias,
                 bf16* __restrict__ out, int M, int N, int K, int splits) {
  using namespace dec;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float part_s[WARPS][PART];          // each warp's sums
  __shared__ float split_s[MAX_SPLITS][PART];    // each rank's (rank 0's copy)
  __shared__ __align__(8) uint64_t bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x / splits) * ROWS;
  const int kc = K / splits, k0 = rank * kc;
  const int wld = w_ld(kc), xld = x_ld(kc);
  const int rows = min(ROWS, N - n0);
  uint8_t* const w_s = smem;
  uint8_t* const x_s = smem + ROWS * wld;

  const uint32_t b = hopper::smem_addr(&bar);
  if (tid == 0) {
    mbar_init(b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {   // one copy a lane: lanes 0-15 the weight rows, 16-23 x's
    if (lane == 0)
      mbar_expect(b, static_cast<uint32_t>(rows * kc + M * 2 * kc));
    __syncwarp();
    if (lane < rows)
      bulk_copy(hopper::smem_addr(w_s + lane * wld),
                w + static_cast<size_t>(n0 + lane) * K + k0, kc, b);
    else if (lane >= ROWS && lane < ROWS + M)
      bulk_copy(hopper::smem_addr(x_s + (lane - ROWS) * xld),
                x + static_cast<size_t>(lane - ROWS) * K + k0, 2 * kc, b);
  }
  mbar_wait(b);

  // warp w: the 16-column chunks w, w + 8, ... of the range. In chunk c the
  // fragment's k = 2t, 2t + 1, 2t + 8, 2t + 9 are the columns 16c + 4t ..
  // 16c + 4t + 3, for the weights (A) and x (B) alike.
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const bool ra = g < rows, rb = g + 8 < rows, xm = g < M;
  const uint8_t* wa = w_s + g * wld + 4 * t;
  const uint8_t* wb = wa + 8 * wld;
  const uint8_t* xr = x_s + g * xld + 8 * t;
  const int chunks = kc / 16;
#pragma unroll 4
  for (int c = warp; c < chunks; c += WARPS) {
    const uint32_t w0 = ra ? *reinterpret_cast<const uint32_t*>(wa + 16 * c) : 0u;
    const uint32_t w1 = rb ? *reinterpret_cast<const uint32_t*>(wb + 16 * c) : 0u;
    const uint2 xv = xm ? *reinterpret_cast<const uint2*>(xr + 32 * c)
                        : make_uint2(0u, 0u);
    uint32_t a[4];
    s8x4_to_bf16(w0, a[0], a[2]);
    s8x4_to_bf16(w1, a[1], a[3]);
    mma_common::mma_16816(acc, a, xv.x, xv.y);
  }
  // acc: (row g, x rows 2t, 2t + 1) and (row g + 8, the same)
  part_s[warp][g * MAX_M + 2 * t] = acc[0];
  part_s[warp][g * MAX_M + 2 * t + 1] = acc[1];
  part_s[warp][(g + 8) * MAX_M + 2 * t] = acc[2];
  part_s[warp][(g + 8) * MAX_M + 2 * t + 1] = acc[3];
  __syncthreads();
  float s = 0.f;
  if (tid < PART) {
#pragma unroll
    for (int i = 0; i < WARPS; ++i) s += part_s[i][tid];
  }
  if (splits > 1) {
    if (tid < PART) cluster.map_shared_rank(&split_s[0][0], 0)[rank * PART + tid] = s;
    cluster.sync();
    if (rank != 0) return;
    if (tid < PART) {
      s = 0.f;
      for (int r = 0; r < splits; ++r) s += split_s[r][tid];
    }
  }
  const int nl = tid / MAX_M, m = tid % MAX_M;
  if (tid < PART && nl < rows && m < M)
    out[static_cast<size_t>(m) * N + n0 + nl] = w8_finish(s, scale, bias, n0 + nl);
}

// ---- w8_linear, prefill form ---------------------------------------------

namespace pre {
constexpr int BN = 64;            // output columns (weight rows) a block
constexpr int BK = 64;            // K step
constexpr int STAGES = 6;
constexpr int X_TILE = hopper::TILE_BYTES;   // 64 rows x 64 bf16, swizzled
constexpr int W8_TILE = BN * BK;             // 4 KB of int8, as it is
constexpr int WB_TILE = hopper::TILE_BYTES;  // the same widened to bf16
__host__ __device__ constexpr int stage_bytes(int wgs) { return wgs * X_TILE + W8_TILE; }
size_t smem_bytes(int wgs) {
  return 1024 + static_cast<size_t>(STAGES) * stage_bytes(wgs) + 2 * WB_TILE;
}
}  // namespace pre

template <int WGS>
__global__ void __launch_bounds__(WGS * hopper::WG_THREADS)
w8_prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ scale, const bf16* __restrict__ bias,
                  bf16* __restrict__ out, int M, int N, int K) {
  using namespace pre;
  constexpr int THREADS = WGS * hopper::WG_THREADS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];   // stage s landed
  uint8_t* const smem = hopper::align1024(smem_raw);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / hopper::WG_THREADS, 0);
  const int i = tid % hopper::WG_THREADS;
  const int warp = i >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * 64 * WGS;
  const int mw = m0 + 64 * wg;     // this warpgroup's first row
  const int KT = (K + BK - 1) / BK;
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t wb_base = base + STAGES * stage_bytes(WGS);
  const uint32_t bar0 = hopper::smem_addr(&full[0]);
  auto x_tile = [&](int s, int q) { return base + s * stage_bytes(WGS) + q * X_TILE; };
  auto w8_tile = [&](int s) { return smem + s * stage_bytes(WGS) + WGS * X_TILE; };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // step kt into stage kt % STAGES by one thread: the block's rows of x
  // (64 x 64 bf16 a warpgroup, the 128-byte swizzle) and its int8 tile (64
  // x 64, as it is); zeros past M, N and K
  auto load = [&](int kt) {
    if (tid == 0 && kt < KT) {
      const int s = kt % STAGES;
      const uint32_t bar = bar0 + 8 * s;
      mbar_expect(bar, stage_bytes(WGS));
#pragma unroll
      for (int q = 0; q < WGS; ++q)
        tma_load_2d(x_tile(s, q), &xmap, kt * BK, m0 + 64 * q, bar);
      tma_load_2d(hopper::smem_addr(w8_tile(s)), &wmap, kt * BK, n0, bar);
    }
  };

  // the int8 tile of stage s as bf16 in the swizzled K-major layout
  auto widen = [&](int s, int buf) {
    uint8_t* const dst = smem + STAGES * stage_bytes(WGS) + buf * WB_TILE;
    const uint8_t* const src = w8_tile(s);
#pragma unroll
    for (int u = 0; u < BN * BK / 16 / THREADS; ++u) {
      const int idx = tid + u * THREADS;
      const int r = idx >> 2, c = idx & 3;
      const uint4 q = *reinterpret_cast<const uint4*>(src + r * BK + 16 * c);
      uint4 lo, hi;
      s8x4_to_bf16(q.x, lo.x, lo.y);
      s8x4_to_bf16(q.y, lo.z, lo.w);
      s8x4_to_bf16(q.z, hi.x, hi.y);
      s8x4_to_bf16(q.w, hi.z, hi.w);
      *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * c) ^ (r & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
    }
  };

  float acc[hopper::NT][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) load(s);
  // the bf16 scale and bias of the thread's 16 output columns, loaded once
  float sc_r[2 * hopper::NT], bias_r[2 * hopper::NT];
#pragma unroll
  for (int j = 0; j < 2 * hopper::NT; ++j) {
    const int n = n0 + 8 * (j / 2) + 2 * t + j % 2;
    sc_r[j] = scale != nullptr && n < N ? round_bf16(scale[n]) : 0.f;
    bias_r[j] = bias != nullptr && n < N ? __bfloat162float(bias[n]) : 0.f;
  }
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait_parity(bar0 + 8 * (kt % STAGES), (kt / STAGES) & 1);
    __syncthreads();                 // step kt - 2 is done in both warpgroups
    load(kt + STAGES - 2);           // into its stage
    widen(kt % STAGES, kt % 2);
    hopper::fence_proxy_async();
    __syncthreads();                 // the widened tile
    const uint32_t xa = x_tile(kt % STAGES, wg);
    const uint32_t wbt = wb_base + (kt % 2) * WB_TILE;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_ss(acc, hopper::desc_k_major(xa, kk),
                       hopper::desc_k_major(wbt, kk), kt > 0 || kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);

  // acc[j][e]: row 16 warp + g (+ 8), column 8j + 2t (+ 1)
  const bool pairs = N % 2 == 0;
  auto finish = [&](float a, int c) {   // w8_finish on the staged scale, bias
    if (scale == nullptr) return __float2bfloat16_rn(a);
    float o = round_bf16(__fmul_rn(round_bf16(a), sc_r[c]));
    if (bias != nullptr) o = __fadd_rn(o, bias_r[c]);
    return __float2bfloat16_rn(o);
  };
#pragma unroll
  for (int j = 0; j < hopper::NT; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mw + 16 * warp + g + 8 * h;
      if (m >= M) continue;
      bf16* o = out + static_cast<size_t>(m) * N + n;
      const bf16 v0 = finish(acc[j][2 * h], 2 * j);
      if (pairs) {
        const bf16 v1 = finish(acc[j][2 * h + 1], 2 * j + 1);
        *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(v0, v1);
      } else {
        o[0] = v0;
        if (n + 1 < N) o[1] = finish(acc[j][2 * h + 1], 2 * j + 1);
      }
    }
  }
}

// ---- int8_linear -----------------------------------------------------------

namespace i8 {
constexpr int THREADS = 256;            // two warpgroups of 64 rows each
constexpr int BM = 128, BN = 128, BK = 128;
constexpr int A_WG_BYTES = 64 * BK;     // a warpgroup's rows of an A k-tile
constexpr int A_BYTES = 2 * A_WG_BYTES;
constexpr int B_BYTES = BN * BK;
constexpr int SB = 5;                   // stages of Wq's ring
constexpr int SA = 3;                   // A slots when the panel streams
constexpr int KT_RESIDENT = 8;          // k-tiles of a resident A panel, at most
constexpr int NTJ = BN / 8;             // n-tiles of an accumulator
size_t smem_bytes(int kt, bool resident) {
  const int f = kt * BK > 2 * BM ? kt * BK : 2 * BM;
  return 1024 + static_cast<size_t>(resident ? kt : SA) * A_BYTES +
         static_cast<size_t>(SB) * B_BYTES + static_cast<size_t>(f) * 4;
}
}  // namespace i8

// 16 bf16 of a row of x, two a word (the first in the low half): columns
// col .. col + 15, zeros past K and for an invalid row. VW, the same for the
// whole launch: elements a load (8: 16-byte loads, K % 8 == 0 and x 16-byte
// aligned; 2: 4-byte loads; 1: 2-byte loads).
struct Chunk16 {
  uint32_t w[8];
};

__device__ __forceinline__ Chunk16 load_chunk16(const bf16* x, int m, int col,
                                                int K, bool valid, int VW) {
  Chunk16 c;
#pragma unroll
  for (int j = 0; j < 8; ++j) c.w[j] = 0u;
  if (!valid) return c;
  const bf16* p = x + static_cast<size_t>(m) * K + col;
  if (VW == 8 && col + 16 <= K) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint4 b = *reinterpret_cast<const uint4*>(p + 8);
    c.w[0] = a.x; c.w[1] = a.y; c.w[2] = a.z; c.w[3] = a.w;
    c.w[4] = b.x; c.w[5] = b.y; c.w[6] = b.z; c.w[7] = b.w;
  } else if (VW == 2 && col + 16 <= K) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c.w[j] = *reinterpret_cast<const uint32_t*>(p + 2 * j);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t lo = col + 2 * j < K ? __bfloat16_as_ushort(p[2 * j]) : 0u;
      const uint32_t hi = col + 2 * j + 1 < K ? __bfloat16_as_ushort(p[2 * j + 1]) : 0u;
      c.w[j] = lo | (hi << 16);
    }
  }
  return c;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// clip(rint(v), +-127) (round half to even) in the low byte: clipped first,
// which gives the same integer, then rounded by adding 1.5 * 2^23
__device__ __forceinline__ uint32_t q8_byte(float v) {
  v = fminf(fmaxf(v, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(v, 12582912.f));
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2,
                                          uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// The 16 int8 of a chunk: static (mul = the 16 reciprocals 1 / in_scale)
// or dynamic (the row's scale s and rcp, its correctly rounded reciprocal).
// The dynamic quotient x / s must round to fp32 as __fdiv_rn does: q = x *
// rcp lies within 3 * 2^-24 |x / s| of that quotient, under 2^-15 for |x /
// s| <= 128 (every |x| <= amax of its row, so under 127.0001), so both round
// to the same integer unless a half-integer h lies within 2^-15 of q. There
// (0.25% of bf16 values, nearly all exact ties x / s = h, which bf16 inputs
// make common) the residual fma(-h, s, x) is zero exactly when x / s = h,
// and the quotient is then h; otherwise the division decides. Both run in
// branches the warp takes only when one of its lanes needs them.
template <bool STATIC>
__device__ __forceinline__ uint4 quantize16(const Chunk16& c, const float* mul,
                                            float s, float rcp) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[2 * j] = bf16_lo(c.w[j]);
    v[2 * j + 1] = bf16_hi(c.w[j]);
  }
  if constexpr (STATIC) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = __fmul_rn(v[j], mul[j]);
  } else {
    float q[16];
    uint32_t near = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      q[j] = __fmul_rn(v[j], rcp);
      near |= static_cast<uint32_t>(fabsf(q[j] - rintf(q[j])) >=
                                    0.5f - 3.0517578125e-5f) << j;
    }
    if (__any_sync(0xffffffffu, near != 0u)) {
      uint32_t divide = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (near >> j & 1u) {
          const float r = rintf(q[j]);
          const float h = r + copysignf(0.5f, q[j] - r);
          if (__fmaf_rn(-h, s, v[j]) == 0.f) q[j] = h;
          else divide |= 1u << j;
        }
      }
      if (__any_sync(0xffffffffu, divide != 0u)) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (divide >> j & 1u) q[j] = __fdiv_rn(v[j], s);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = q[j];
  }
  uint32_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = q8_byte(v[j]);
  return make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                    pack4(b[8], b[9], b[10], b[11]),
                    pack4(b[12], b[13], b[14], b[15]));
}

#define I8_WGMMA_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define I8_ROW(j) \
  "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])

// d (+)= A . B, int8 with int32 sums: A 64 rows of the warpgroup, B 128
// rows of N, both K-major in shared memory, one 32-wide slice of the
// contraction. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[i8::NTJ][4], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " I8_WGMMA_D64
      ", %64, %65, p;\n"
      "}\n"
      : I8_ROW(0), I8_ROW(1), I8_ROW(2), I8_ROW(3), I8_ROW(4), I8_ROW(5),
        I8_ROW(6), I8_ROW(7), I8_ROW(8), I8_ROW(9), I8_ROW(10), I8_ROW(11),
        I8_ROW(12), I8_ROW(13), I8_ROW(14), I8_ROW(15)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef I8_WGMMA_D64
#undef I8_ROW

__device__ __forceinline__ void fence_acc(int (&d)[i8::NTJ][4]) {
#pragma unroll
  for (int j = 0; j < i8::NTJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e]) :: "memory");
}

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void store_pair(T* o, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

template <typename T, bool STATIC>
__global__ void __launch_bounds__(i8::THREADS, 1)
int8_linear_kernel(const bf16* __restrict__ x,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ in_scale, T* __restrict__ out,
                   int rows, int N, int K, int tiles_per_block, int resident,
                   int VW, int csize) {
  using namespace i8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[SB];   // Wq's stage s landed
  __shared__ float ws_s[BN];                   // w_scale of the output tile
  __shared__ float amax_s[BM];                 // the rows' amax over this block's k-tiles
  uint8_t* const smem = hopper::align1024(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = csize > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = tid >> 5, lane = tid & 31;
  const int KT = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int total = min(tiles_per_block, n_tiles - tile0) * KT;
  const int m0 = blockIdx.y * BM;
  uint8_t* const a_s = smem;
  uint8_t* const b_s = smem + (resident ? KT : SA) * A_BYTES;
  float* const f_s = reinterpret_cast<float*>(b_s + SB * B_BYTES);
  const uint32_t a_addr = hopper::smem_addr(a_s), b_addr = hopper::smem_addr(b_s);
  const uint32_t bar0 = hopper::smem_addr(&full[0]);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < SB; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step idx = (output tile tile0 + idx / KT, k-tile idx % KT): Wq's k-tile
  // into stage idx % SB, one tensor copy by one thread (the 128-byte swizzle;
  // zeros past N and K)
  auto load_b = [&](int idx) {
    if (tid == 0 && idx < total) {
      const int nt = tile0 + idx / KT, kt = idx % KT;
      const uint32_t bar = bar0 + 8 * (idx % SB);
      mbar_expect(bar, B_BYTES);
      tma_load_2d(b_addr + (idx % SB) * B_BYTES, &wmap, kt * BK, nt * BN, bar);
    }
  };

  // A: a thread quantizes the 16 columns 16 ac.. of a k-tile in rows ar,
  // ar + 32, ar + 64, ar + 96 of the block, from x loaded a k-tile before
  // (two register sets, xa and xb, used in turns)
  const int ac = tid & 7, ar = tid >> 3;
  Chunk16 xa[4], xb[4];
  auto load_x = [&](Chunk16 (&xr)[4], int kt) {
    const int col = kt * BK + 16 * ac;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + ar + 32 * u;
      xr[u] = load_chunk16(x, m, col, K, m < rows && col < K, VW);
    }
  };
  // k-tile kt of x quantized into A slot `slot` of `copies` blocks of the
  // cluster (the resident panel: every block's; a streamed slot: its own)
  auto store_a = [&](const Chunk16 (&xr)[4], int kt, int slot, int copies) {
    float mul[16];
    if constexpr (STATIC) {
#pragma unroll
      for (int j = 0; j < 16; ++j) mul[j] = f_s[kt * BK + 16 * ac + j];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ar + 32 * u;
      const uint4 q = quantize16<STATIC>(xr[u], mul, STATIC ? 0.f : f_s[r],
                                         STATIC ? 0.f : f_s[BM + r]);
      const int off = slot * A_BYTES + (r >> 6) * A_WG_BYTES + (r & 63) * 128 +
                      ((ac ^ (r & 7)) << 4);
      for (int c = 0; c < copies; ++c) {
        uint8_t* const dst = copies > 1 ? cluster.map_shared_rank(a_s, c) : a_s;
        *reinterpret_cast<uint4*>(dst + off) = q;
      }
    }
  };
  // the k-tiles this block quantizes: of a resident panel those of its
  // cluster rank (kt = crank, crank + csize, ...), of a streamed one all
  const int kt_first = resident ? crank : 0;
  const int kt_step = resident ? csize : 1;

#pragma unroll
  for (int s = 0; s < SB - 2; ++s) load_b(s);
  if constexpr (STATIC) {
    // 1 / in_scale, the loads of a thread issued before its divisions
    for (int k0 = 0; k0 < KT * BK; k0 += 4 * THREADS) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + tid + u * THREADS;
        v[u] = k < K ? in_scale[k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + tid + u * THREADS;
        if (k < KT * BK) f_s[k] = k < K ? __fdiv_rn(1.0f, v[u]) : 0.f;
      }
    }
  } else {
    // each row's amax over this block's k-tiles (the 8 threads of a row, two
    // k-tiles at once), over the cluster's through distributed shared memory
    // (a max, so in any order), then its scale and the scale's reciprocal
    float amax[4] = {0.f, 0.f, 0.f, 0.f};
    auto fold = [&](const Chunk16 (&xr)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          amax[u] = fmaxf(amax[u], fmaxf(fabsf(bf16_lo(xr[u].w[j])),
                                         fabsf(bf16_hi(xr[u].w[j]))));
    };
    for (int kt = kt_first; kt < KT; kt += 2 * kt_step) {
      load_x(xa, kt);
      load_x(xb, kt + kt_step);
      fold(xa);
      fold(xb);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        amax[u] = fmaxf(amax[u], __shfl_xor_sync(0xffffffffu, amax[u], o));
    }
    if (csize > 1) {
      if (ac == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) amax_s[ar + 32 * u] = amax[u];
      }
      cluster.sync();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        for (int c = 0; c < csize; ++c)
          amax[u] = fmaxf(amax[u], cluster.map_shared_rank(amax_s, c)[ar + 32 * u]);
    }
    if (ac == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float s = __fmul_rn(fmaxf(amax[u], 1e-8f), 1.0f / 127.0f);
        f_s[ar + 32 * u] = s;
        f_s[BM + ar + 32 * u] = __frcp_rn(s);
      }
    }
  }
  __syncthreads();
  if (resident) {
    // the panel, quantized once: this block's k-tiles into every block of
    // the cluster (all of them started: the cluster barrier), the next
    // k-tile's x loaded while one is quantized
    if (STATIC && csize > 1) cluster.sync();
    if (kt_first < KT) load_x(xa, kt_first);
    for (int kt = kt_first; kt < KT; kt += 2 * kt_step) {
      if (kt + kt_step < KT) load_x(xb, kt + kt_step);
      store_a(xa, kt, kt, csize);
      if (kt + kt_step >= KT) break;
      if (kt + 2 * kt_step < KT) load_x(xa, kt + 2 * kt_step);
      store_a(xb, kt + kt_step, kt + kt_step, csize);
    }
    if (csize > 1) {
      hopper::fence_proxy_async();
      cluster.sync();                  // every block's panel is whole
    }
  } else {
    // streamed: step 0's k-tile quantized; steps 1 and 2's x in flight
    load_x(xa, 0);
    if (1 < total) load_x(xb, 1 % KT);
    store_a(xa, 0, 0, 1);
    if (2 < total) load_x(xa, 2 % KT);
  }

  int acc[NTJ][4] = {};
  const int g = lane >> 2, t = lane & 3;
  const int wr = 64 * wg + 16 * (warp & 3);   // the warp's first row in the block
  // step idx; streamed: cur holds x of step idx + 1, refilled with idx + 3
  auto step = [&](int idx, Chunk16 (&cur)[4]) {
    const int kt = idx % KT, first = kt == 0, last = kt == KT - 1;
    mbar_wait_parity(bar0 + 8 * (idx % SB), (idx / SB) & 1);  // Wq's k-tile
    hopper::fence_proxy_async();       // the quantized A, for wgmma
    __syncthreads();                   // ... of every thread; step idx - 2 is done
    load_b(idx + SB - 2);
    if (first && tid < BN) {           // the tile's w_scale, read by its epilogue
      const int n = (tile0 + idx / KT) * BN + tid;
      ws_s[tid] = n < N ? w_scale[n] : 0.f;
    }
    const uint32_t at = a_addr + (resident ? kt : idx % SA) * A_BYTES + wg * A_WG_BYTES;
    const uint32_t bt = b_addr + (idx % SB) * B_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 32; ++j)
      wgmma_s8_n128(acc, hopper::desc_k_major(at, j), hopper::desc_k_major(bt, j),
                    !first || j > 0);
    hopper::wgmma_commit();
    if (!resident && idx + 1 < total) {   // the next k-tile, while this one runs
      store_a(cur, (idx + 1) % KT, (idx + 1) % SA, 1);
      if (idx + 3 < total) load_x(cur, (idx + 3) % KT);
    }
    hopper::wgmma_wait<1>();
    if (last) {
      if (KT == 1) __syncthreads();    // ws_s, written in this same step
      hopper::wgmma_wait<0>();
      fence_acc(acc);
      const int nt = tile0 + idx / KT;
      // acc[j][e]: row wr + g (+ 8), column 8j + 2t (+ 1) of the tile
#pragma unroll
      for (int j = 0; j < NTJ; ++j) {
        const int n = nt * BN + 8 * j + 2 * t;
        if (n >= N) continue;
        const float s0 = ws_s[8 * j + 2 * t], s1 = ws_s[8 * j + 2 * t + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr + g + 8 * h, m = m0 + r;
          if (m >= rows) continue;
          float f0 = __fmul_rn(__int2float_rn(acc[j][2 * h]), s0);
          float f1 = __fmul_rn(__int2float_rn(acc[j][2 * h + 1]), s1);
          if constexpr (!STATIC) {
            f0 = __fmul_rn(f0, f_s[r]);
            f1 = __fmul_rn(f1, f_s[r]);
          }
          T* o = out + static_cast<size_t>(m) * N + n;
          if (N % 2 == 0) {
            store_pair<T>(o, f0, f1);
          } else {
            o[0] = to_out<T>(f0);
            if (n + 1 < N) o[1] = to_out<T>(f1);
          }
        }
      }
    }
  };
  for (int idx = 0; idx < total; idx += 2) {
    step(idx, xb);
    if (idx + 1 < total) step(idx + 1, xa);
  }
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// Lets `kernel` take `bytes` of dynamic shared memory, raising its limit
// only when a call needs more than before.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <typename T, bool STATIC>
int launch_int8_linear(const void* x, const void* w, const void* w_scale,
                       const void* in_scale, void* out, int rows, int N, int K,
                       int ldw, int groups, int tiles_per_block, int resident,
                       int csize, cudaStream_t s) {
  static size_t allowed = 0;
  auto kernel = int8_linear_kernel<T, STATIC>;
  const int vw = K % 8 == 0 && aligned(x, 16) ? 8 : K % 2 == 0 && aligned(x, 4) ? 2 : 1;
  CUtensorMap wmap;
  if (!make_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, ldw,
                       i8::BN, i8::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kt = (K + i8::BK - 1) / i8::BK;
  const size_t smem = i8::smem_bytes(kt, resident != 0);
  const cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, (rows + i8::BM - 1) / i8::BM);
  cfg.blockDim = dim3(i8::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), wmap,
      static_cast<const float*>(w_scale), static_cast<const float*>(in_scale),
      static_cast<T*>(out), rows, N, K, tiles_per_block, resident, vw, csize);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) contiguous bf16, 16-byte aligned; w (N, K) contiguous int8,
// 16-byte aligned; K % 16 == 0; scale (N,) fp32 or NULL (the raw product:
// bias NULL too); bias (N,) bf16 or NULL; out (M, N) bf16. form 0: the
// decode form (M <= 8), param = the cluster's K splits (1, 2, 4 or 8, K a
// multiple of 16 * splits); form 1: the prefill form, param = warpgroups a
// block (1 or 2). ops/quant.py:w8_plan chooses both.
extern "C" int w8_linear(const void* x, const void* w, const void* scale,
                         const void* bias, void* out, long long M, int N, int K,
                         int form, int param, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || !aligned(x, 16) ||
      !aligned(w, 16) || M > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(out);
  const int m = static_cast<int>(M);
  if (form == 0) {
    const int splits = param;
    if (m > dec::MAX_M || (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
        K % (16 * splits) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    static size_t allowed = 0;
    const size_t smem = dec::smem_bytes(m, K / splits);
    const cudaError_t e = allow_smem(w8_decode_kernel, smem, allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned blocks = static_cast<unsigned>((N + dec::ROWS - 1) / dec::ROWS) * splits;
    if (splits == 1) {   // no cluster: its launch costs more than one block
      w8_decode_kernel<<<blocks, dec::THREADS, smem, s>>>(xb, wq, sc, bb, o, m, N,
                                                          K, splits);
      return static_cast<int>(cudaGetLastError());
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(dec::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, w8_decode_kernel, xb, wq, sc, bb, o, m, N, K, splits);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (form == 1 && (param == 1 || param == 2)) {
    CUtensorMap xmap, wmap;
    if (!make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, K, K,
                         64, pre::BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, K,
                         pre::BN, pre::BK, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + pre::BN - 1) / pre::BN, (m + 64 * param - 1) / (64 * param));
    const size_t smem = pre::smem_bytes(param);
    if (param == 1) {
      static size_t allowed = 0;
      const cudaError_t e = allow_smem(w8_prefill_kernel<1>, smem, allowed);
      if (e != cudaSuccess) return static_cast<int>(e);
      w8_prefill_kernel<1><<<grid, hopper::WG_THREADS, smem, s>>>(xmap, wmap, sc, bb,
                                                                  o, m, N, K);
    } else {
      static size_t allowed = 0;
      const cudaError_t e = allow_smem(w8_prefill_kernel<2>, smem, allowed);
      if (e != cudaSuccess) return static_cast<int>(e);
      w8_prefill_kernel<2><<<grid, 2 * hopper::WG_THREADS, smem, s>>>(
          xmap, wmap, sc, bb, o, m, N, K);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (rows, K) contiguous bf16; w (>= N, ldw) contiguous int8, 16-byte
// aligned, ldw a multiple of 16 >= K (the padded operand); w_scale (N,)
// fp32; in_scale (K,) fp32 (static) or NULL (dynamic); out (rows, N), bf16
// (out_fp32 0) or fp32 (1). groups x tiles_per_block covers the 128-column
// output tiles; resident: the A panel stays in shared memory (K <= 1024);
// cluster: the blocks of one 128-row block (groups a multiple of it, <= 8,
// 1 unless resident) that quantize its panel together.
// ops/quant.py:int8_linear_plan chooses the four.
extern "C" int int8_linear(const void* x, const void* w, const void* w_scale,
                           const void* in_scale, void* out, long long rows,
                           int N, int K, int ldw, int out_fp32, int groups,
                           int tiles_per_block, int resident, int cluster,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + i8::BN - 1) / i8::BN;
  const int kt = (K + i8::BK - 1) / i8::BK;
  if (rows <= 0 || N <= 0 || K <= 0 || ldw < K || ldw % 16 != 0 ||
      !aligned(w, 16) || groups <= 0 || tiles_per_block <= 0 ||
      static_cast<long long>(groups) * tiles_per_block < n_tiles ||
      static_cast<long long>(groups - 1) * tiles_per_block >= n_tiles ||
      (resident && kt > i8::KT_RESIDENT) || cluster < 1 || cluster > 8 ||
      groups % cluster != 0 || (cluster > 1 && !resident) ||
      (rows + i8::BM - 1) / i8::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = static_cast<int>(rows);
  const auto launch = out_fp32
      ? (in_scale != nullptr ? launch_int8_linear<float, true>
                             : launch_int8_linear<float, false>)
      : (in_scale != nullptr ? launch_int8_linear<bf16, true>
                             : launch_int8_linear<bf16, false>);
  return launch(x, w, w_scale, in_scale, out, r, N, K, ldw, groups,
                tiles_per_block, resident, cluster, s);
}
