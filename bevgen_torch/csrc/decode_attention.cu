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
// shapes (b=2, H=16, dh=64, pl=2368) that is 19.4 MB, about 5.8 us; at pl
// 512 about 1.3 us, below the fixed cost of a launch. Beyond the bound the
// time goes to that fixed cost, which a cluster raises (its launch and its
// two barriers), and to the work a block does after its data lands.
//
// Design. One launch per call: each (b, h) row is split across a thread
// block cluster of C blocks, C = splits_for(pl) <= 8 (the portable
// maximum): about ROWS_PER_BLOCK cache rows a block, so b = 2, H = 16 at
// pl 2368 runs 256 blocks on the 132 SMs instead of 32, while a short
// prefix pays for fewer cluster members. Block r of a cluster takes the
// contiguous chunk of ceil(pl / C) <= 320 cache rows starting at
// r * ceil(pl / C) (empty where pl < C); pl is at most MAX_PL = 2560.
//   - At its start one thread of the block asks the Tensor Memory
//     Accelerator for bulk copies of the chunk's first STAGE_ROWS = 288 K
//     rows, then of its V rows (each one contiguous range), into shared
//     memory, in two pieces each that complete on their own mbarriers, so
//     that phase A starts on the first piece while the rest streams in.
//     Each group of dh/8 threads loads the K and V of its row past those
//     (if any) and the addend of its rows into registers. The whole chunk
//     is in flight at once (at pl 2368, 2 x 296 x 128 B = 76 KB per block)
//     without the per-SM limit on outstanding loads that per-thread copies
//     run into, and a block takes at most 74 KB of shared memory, so at
//     least 3 fit on an SM and all 32 clusters of b = 2, H = 16 are
//     resident at once.
//   - Phase A: as K lands, each group forms the scores of its ten rows
//     (kept in registers: phase B walks the same rows); two block
//     reductions give the chunk's max and its sum of exp(s - max). The
//     exponentials (and in phase B the weights) of a group's rows are
//     spread over its lanes and shared by shuffles, not repeated on each.
//   - Exchange: after a cluster barrier lanes 0..C-1 of every warp read the
//     C (max, sum) pairs through distributed shared memory; the row's max
//     m and sum l combine them in rank order (an empty chunk adds nothing).
//   - Phase B: as V lands, p_j = bf16(exp(s_j - m) / l), the reference's
//     rounding with the row's statistics, and the block sums p_j V_j over
//     its chunk into a 64-float partial, which it writes into block 0's
//     shared memory (the K region, free by then).
//   - Combine: after a second cluster barrier block 0 sums the C partials
//     in rank order and writes the bf16 output. No block touches another's
//     shared memory after that barrier, so none waits for another to leave.
// Every sum runs in a fixed order, so two calls on the same inputs give the
// same bits. K and V are read with the caller's row stride, so the decode
// step hands in a prefix view of its full-width caches without a copy.
//
// C interface: decode_attention_bf16(...) returns cudaGetLastError() after
// the launch; the Python wrapper raises if it is not 0.

#include <cooperative_groups.h>
#include <math_constants.h>

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SPLITS = 8;        // blocks of a (b, h) row's cluster, at most
constexpr int ROWS_PER_BLOCK = 192;  // cache rows a block takes, about
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// head dim: 1024 / 16 heads in every AR configuration (nuscenes_ar,
// nuscenes_ar_tpu); the wrapper raises for any other
constexpr int HEAD_DIM = 64;
constexpr int ROW_BYTES = HEAD_DIM * 2;
constexpr int G = HEAD_DIM / 8;       // threads per cache row (16 B each)
constexpr int RPP = THREADS / G;      // cache rows per pass of the block
constexpr int KB = 10;                // rows of a group (one every RPP)
constexpr int MAX_ROWS = KB * RPP;    // rows of a block: 320
constexpr int STAGE_ROWS = MAX_ROWS - RPP;  // of them staged in shared memory: 288
constexpr int PIECE_U = KB / 2;       // the second copy piece starts at row RPP * PIECE_U
constexpr int MAX_PL = MAX_SPLITS * MAX_ROWS;
// the K region also holds, once K is consumed, the per-warp partials and
// (block 0) the chunks' partials
constexpr int PARTS_BYTES = (WARPS + MAX_SPLITS) * HEAD_DIM * 4;
static_assert(32 % G == 0, "a row's threads share a warp");
static_assert(KB <= 2 * G, "a group's lanes hold the exponentials of its rows");

__device__ __forceinline__ void bf16x8(const uint4& u, float f[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}

// ---- mbarriers and bulk copies (the Tensor Memory Accelerator)

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

// one arrival that also expects `bytes` of copies to complete on `bar`
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

// wait for the first phase of `bar` to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
}

template <bool MAX>
__device__ __forceinline__ float warp_reduce(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  return x;
}

// The cluster size of a call with prefix length pl.
int splits_for(int pl) {
  const int c = (pl + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  return c < 1 ? 1 : (c > MAX_SPLITS ? MAX_SPLITS : c);
}

__host__ __device__ __forceinline__ int chunk_rows(int pl, int splits) {
  return (pl + splits - 1) / splits;
}

// The K region of a block's dynamic shared memory (its staged K rows, and
// room for the partials), then the V region (its staged V rows).
__host__ __device__ __forceinline__ int k_region(int staged) {
  return staged * ROW_BYTES > PARTS_BYTES ? staged * ROW_BYTES : PARTS_BYTES;
}
size_t smem_bytes(int pl, int splits) {
  const int chunk = chunk_rows(pl, splits);
  const int staged = chunk < STAGE_ROWS ? chunk : STAGE_ROWS;
  return static_cast<size_t>(k_region(staged)) + static_cast<size_t>(staged) * ROW_BYTES;
}

__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ addend,
                        __nv_bfloat16* __restrict__ out, int H, int pl,
                        int splits, long long row_stride, float scale) {
  constexpr int D = HEAD_DIM;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float red_m[WARPS], red_l[WARPS];
  __shared__ float stat_s[2];                 // this chunk's max and sum
  __shared__ __align__(8) uint64_t bars[4];   // K and V, two pieces each, landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lg = tid % G, grp = tid / G;
  const int row = blockIdx.x / splits;  // b * H + h
  const int h = row % H;
  const int chunk = chunk_rows(pl, splits);
  const int c0 = rank * chunk;
  const int n = max(0, min(pl, c0 + chunk) - c0);  // this block's rows, <= MAX_ROWS
  const int staged = min(chunk, STAGE_ROWS);        // of the region; min(n, ..) are copied
  uint8_t* const k_s = smem;
  uint8_t* const v_s = smem + k_region(staged);
  float (*const part_s)[D] = reinterpret_cast<float (*)[D]>(k_s);          // [WARPS][D]
  float (*const parts_s)[D] = reinterpret_cast<float (*)[D]>(k_s) + WARPS; // [MAX_SPLITS][D]

  const __nv_bfloat16* kr = k + static_cast<size_t>(row) * row_stride + static_cast<size_t>(c0) * D;
  const __nv_bfloat16* vr = v + static_cast<size_t>(row) * row_stride + static_cast<size_t>(c0) * D;
  const float* ad = addend + static_cast<size_t>(h) * pl + c0;

  // ---- the chunk's first rows of K, then of V, by bulk copies in two
  // pieces each; the group's row past them and its rows' addend into
  // registers
  const uint32_t bar0 = hopper::smem_addr(&bars[0]);  // K0, K1, V0, V1: 8 bytes apart
  const int copied = min(n, STAGE_ROWS);
  const int split = min(copied, PIECE_U * RPP);      // rows of the first piece
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r0 = i % 2 == 0 ? 0 : split;
      const int rows = i % 2 == 0 ? split : copied - split;
      if (rows > 0) {
        const uint32_t bytes = static_cast<uint32_t>(rows) * ROW_BYTES;
        mbar_expect(bar0 + 8 * i, bytes);
        bulk_copy(hopper::smem_addr(i < 2 ? k_s : v_s) + r0 * ROW_BYTES,
                  (i < 2 ? kr : vr) + static_cast<size_t>(r0) * D, bytes, bar0 + 8 * i);
      }
    }
  }
  // wait for piece i's rows, if it has any
  auto wait_piece = [&](int i) {
    if ((i % 2 == 0 ? split : copied - split) > 0) mbar_wait(bar0 + 8 * i);
  };
  const int jx = STAGE_ROWS + grp;  // the group's register row
  uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = make_uint4(0u, 0u, 0u, 0u);
  if (jx < n) {
    kx = *reinterpret_cast<const uint4*>(kr + static_cast<size_t>(jx) * D + lg * 8);
    vx = *reinterpret_cast<const uint4*>(vr + static_cast<size_t>(jx) * D + lg * 8);
  }
  float sc[KB];  // the addend, then the scores, of the group's rows
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    const int j = grp + u * RPP;
    sc[u] = j < n ? ad[j] : 0.f;
  }
  float qf[8];
  bf16x8(*reinterpret_cast<const uint4*>(q + static_cast<size_t>(row) * D + lg * 8), qf);

  // ---- phase A: the scores of the group's rows and the chunk's max; rows
  // past n get -inf
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    if (u == 0) wait_piece(0);
    if (u == PIECE_U) wait_piece(1);
    const int j = grp + u * RPP;
    uint4 kk = kx;
    if (u < KB - 1) {
      kk = j < n ? *reinterpret_cast<const uint4*>(k_s + j * ROW_BYTES + lg * 16)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    float kf[8];
    bf16x8(kk, kf);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dot += qf[i] * kf[i];
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    sc[u] = j < n ? dot * scale + sc[u] : -CUDART_INF_F;
    mx = fmaxf(mx, sc[u]);
  }
  mx = warp_reduce<true>(mx);
  if (lane == 0) red_m[warp] = mx;
  __syncthreads();  // red_m; every warp is done with K
  mx = red_m[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red_m[w]);
  // lane lg of a group holds the scores of its rows lg and lg + G
  float s0 = -CUDART_INF_F, s1 = -CUDART_INF_F;
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    if (u % G == lg) {
      if (u < G) s0 = sc[u];
      else s1 = sc[u];
    }
  }
  float sum = (s0 > -CUDART_INF_F ? expf(s0 - mx) : 0.f) +
              (s1 > -CUDART_INF_F ? expf(s1 - mx) : 0.f);
  sum = warp_reduce<false>(sum);
  if (lane == 0) red_l[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    sum = red_l[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += red_l[w];
    stat_s[0] = mx;  // -inf and 0 for an empty chunk
    stat_s[1] = sum;
  }

  // ---- exchange: the row's max and sum from the cluster's chunks, in rank order
  cluster.sync();
  float mr = -CUDART_INF_F, lr = 0.f;
  if (lane < splits) {
    const float* rs = cluster.map_shared_rank(stat_s, lane);
    mr = rs[0];
    lr = rs[1];
  }
  float m = mr;
#pragma unroll
  for (int o = MAX_SPLITS / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  m = __shfl_sync(0xffffffffu, m, 0);
  const float wr = lr > 0.f ? lr * expf(mr - m) : 0.f;
  float l = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) l += __shfl_sync(0xffffffffu, wr, r);

  // ---- phase B: P.V over the chunk, the weights rounded to bf16 first
  const float p0 = s0 > -CUDART_INF_F ? __bfloat162float(__float2bfloat16(expf(s0 - m) / l)) : 0.f;
  const float p1 = s1 > -CUDART_INF_F ? __bfloat162float(__float2bfloat16(expf(s1 - m) / l)) : 0.f;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    if (u == 0) wait_piece(2);
    if (u == PIECE_U) wait_piece(3);
    const int j = grp + u * RPP;
    const float p = __shfl_sync(0xffffffffu, u < G ? p0 : p1, (lane & ~(G - 1)) | (u % G));
    if (j < n) {
      const uint4 vv = u < KB - 1
          ? *reinterpret_cast<const uint4*>(v_s + j * ROW_BYTES + lg * 16) : vx;
      float vf[8];
      bf16x8(vv, vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += p * vf[i];
    }
  }
  // the warp's groups (lanes lg, lg + 8, lg + 16, lg + 24), then the warps
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  if (lane < G)
#pragma unroll
    for (int i = 0; i < 8; ++i) part_s[warp][lg * 8 + i] = acc[i];
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += part_s[w][tid];
    cluster.map_shared_rank(&parts_s[0][0], 0)[rank * D + tid] = o;
  }

  // ---- combine: block 0 sums the chunks' partials in rank order. No block
  // touches another's shared memory after this barrier.
  cluster.sync();
  if (rank == 0 && tid < D) {
    float o = 0.f;
    for (int r = 0; r < splits; ++r) o += parts_s[r][tid];
    out[static_cast<size_t>(row) * D + tid] = __float2bfloat16(o);
  }
}

// Lets the kernel take `bytes` of dynamic shared memory beside its static
// arrays (above 48 KB in all it needs the opt-in), raising the limit only
// when a call needs more than before.
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 0;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

cudaLaunchConfig_t launch_config(int rows, int splits, size_t dyn,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The cluster size at prefix length pl, the dynamic shared memory per
// block, the blocks that fit on one SM (registers and shared memory
// together) and the clusters the card holds at once, for reports. Returns a
// cudaError_t.
extern "C" int decode_attention_resources(int pl, int* cluster, int* smem,
                                          int* blocks_per_sm,
                                          int* max_clusters) {
  if (pl <= 0 || pl > MAX_PL) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = splits_for(pl);
  const size_t dyn = smem_bytes(pl, splits);
  *cluster = splits;
  *smem = static_cast<int>(dyn);
  cudaError_t err = allow_smem(dyn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, decode_attention_kernel, THREADS, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, splits, dyn, nullptr, attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(max_clusters, decode_attention_kernel, &cfg));
}

// q (b,H,D) bf16 contiguous; k, v: the (b,H) rows of a cache, row r at
// k + r * row_stride elements, its first pl <= MAX_PL positions read as (pl, D)
// contiguous bf16, every row 16-byte aligned; addend (H,pl) fp32
// contiguous; out (b,H,D) bf16. Returns cudaGetLastError() (or the error of
// setting the kernel's shared memory size).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* addend,
                                     void* out, int b, int H, int pl, int D,
                                     long long row_stride, float scale,
                                     void* stream) {
  if (b <= 0 || H <= 0 || pl <= 0 || row_stride < static_cast<long long>(pl) * D ||
      row_stride % 8 != 0 || pl > MAX_PL ||
      static_cast<long long>(b) * H * MAX_SPLITS > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = splits_for(pl);
  const size_t dyn = smem_bytes(pl, splits);
  const cudaError_t attr_err = allow_smem(dyn);
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(b * H, splits, dyn, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(addend), static_cast<__nv_bfloat16*>(out), H, pl,
      splits, row_stride, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
