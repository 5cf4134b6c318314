// Weight-only int8 products for Hopper (sm_90a) at decode rows: the grouped
// W8A16 decode kernel, the per-weight entry and the dequantize entry.
//
// Not the port of a Pallas kernel. The JAX package stores int8 weights with
// per-output-channel f32 scales (dynamo_tpu/ops/quant.py) and needs no
// kernel: XLA fuses `wmat`'s dequantize (quant.py:70-77) into the matmul's
// operand pipeline. PyTorch does not, and an eager dequantize + matmul reads
// the int8 weight, writes it as bf16 and reads that back. This source is the
// fused product the port needs instead (dynamo_tpu_torch/ops/quant.py).
//
// The function: y[M, N] = x[M, K] @ (f32(q[K, N]) * s[N]), f32 accumulation,
// y in x's type. q is the JAX layout [d_in, d_out], row-major: each k row is
// contiguous along N. s multiplies the f32 sum of each column once, after
// the accumulation (the same product as scaling each weight first, up to
// rounding).
//
// Bound: at decode (M = slots <= 16) the call must read K * N weight bytes
// once, plus N scales, x and y, over the card's 3.35 TB/s: llama3-8b's
// w_gate (4096 x 14336) is ~58.7 MB, ~17.5 us; lm_head (4096 x 128256)
// ~525 MB, ~157 us; wk (4096 x 1024) ~4.2 MB, ~1.3 us. Its 2 M K N
// operations sit far below the tensor-core roof: the bytes bound it.
//
// w8a16_group (bf16 x, 1 <= M <= 16; every decode-step product of the
// serving route): one launch computes up to three products that share x
// (wq | wk | wv, w_gate | w_up; one weight for wo, w_down, the head). Where
// the time went before it, measured on an H100 80GB HBM3 at 700 W
// (tools/torch_w8a16_probe.py, PERF.md §6; ms at M = 8, an empty cluster
// launch of the grid / the grid streaming its weights only / the whole
// per-weight register-ring kernel below): wk 0.0011 / 0.0039 / 0.0101,
// w_gate 0.0014 / 0.0215 / 0.0285, lm_head 0.0036 / 0.1683 / 0.1971. The
// launch itself was ~1 us; the chain around the loads (x, the MMAs, two
// cluster barriers, rank 0 reading every block's sums) cost more, and
// seven launches a layer paid it seven times. The design:
// - One launch a group. The weights' column tiles of 128 form one column
//   space; each tile knows its weight (tile0), and the grid treats the
//   group as one product (ops/quant.py group_config, from shapes only: no
//   host sync, capturable).
// - A ring of 4 stages in shared memory, each a [64 k, 128 column] int8 box
//   of q and a [16 row, 64 k] box of x, both by TMA (128-byte swizzle; zeros
//   past K, N and M), each stage on an mbarrier. One producer warp issues
//   the q boxes of the first stages from the block's first cycle, then
//   waits for the previous kernel (griddepcontrol.wait: the launch is a
//   programmatic dependent one, so the blocks start while that kernel
//   drains) and only then loads x. Where TMA cannot read (N % 16 != 0, K %
//   8 != 0, a base not 16-byte aligned) the producer warp copies the same
//   boxes itself, laid out as TMA lays them.
// - Four consumer warps, 16 k rows of a stage each, widen int8 to bf16 out
//   of shared memory (a byte permute and an f32 subtract to an exact f32,
//   whose top half is the bf16) and run mma.sync.m16n8k16 with the weight
//   as A (16 columns x 16 k) and x^T as B (16 k x 8 rows): y^T = W^T x^T.
//   Lane (g, t) reads 16 bytes (chunk (g >> 1) | (g & 1) << 2) of k rows t,
//   t + 4, t + 8, t + 12, so the 8 lanes of a quarter warp hit 8 bank
//   groups; logical k (2t, 2t + 1, 2t + 8, 2t + 9) is those rows, and x's
//   values are read at the same rows. Up to 16 rows of x take one pass:
//   each widened fragment feeds two n8 MMAs (RG = 2), so M = 9..16 reads
//   each weight once.
// - The sums: the four warps' fragments meet in shared memory in warp
//   order. With one split the block scales, rounds and stores; with more,
//   the splits of a tile run as one cluster (at most 8) and rank r adds
//   every rank's sum of its share of the values in rank order (distributed
//   shared memory), scales and stores. Deterministic: a captured graph and
//   an eager call agree to the bit. No trigger of the next launch: y is
//   complete when the grid is.
// - The grid, by measurement (PERF.md §6): a block streams at most ~10-12
//   GB/s whatever its ring depth (4, 6 and 7 stages timed the same, and
//   consumers that skipped the MMAs gained only 2-5% at the large
//   products), so the card's bytes need about two resident blocks an SM;
//   three fit (75,328 bytes of shared memory, at most 136 registers). A split grid aims at 1.7 blocks an SM (cluster
//   grids of 240 or more blocks ran up to 1.5x slower at 132 SMs); with as
//   many tiles, one split and each block walks tiles b, b + blocks, ...,
//   so the blocks in flight read neighbouring columns (walking consecutive
//   tiles instead cost lm_head 270 us against 213). Splitting a q box over
//   several TMA issues, cp.async in place of TMA and the L2 promotion made
//   no gain.
//
// w8a16_gemm, the per-weight entry (one launch a weight):
// - f32 x (the card-side f32 parity runs), CUDA cores (w8a16_kernel; an
//   f32 x cannot go through bf16 operands): grid (column tiles of 256,
//   splits over K, passes of MT rows of x); 8 warps, lane l of every warp
//   owning columns 8l .. 8l + 7 of the tile, the block walking its split's
//   K range in chunks of 64 rows (warp w takes rows 8w .. 8w + 7): each lane
//   loads its 8 rows x 8 columns as 8-byte loads, the next chunk's rows
//   before the current chunk's math; x's 64 x MT slice staged in shared
//   memory as f32 (double-buffered); int8 -> f32 by a byte permute and an
//   f32 subtract; MT x 8 FMAs a row. The 8 warps' sums reduce in shared
//   memory in a fixed order; with more than one split each block writes its
//   f32 partial and w8a16_reduce adds the splits in order and scales.
// - bf16 x, the register-ring kernel (w8a16_mma_kernel; mma_tile in
//   w8a16_common.cuh): the decode kernel before w8a16_group, on no route
//   now and kept as the old column of chip_smoke.py's times. Grid (splits
//   over K, column tiles of 128, passes of 8 rows); 8 warps, two chunks of
//   128 k rows in flight in registers; the splits of a tile one cluster,
//   rank 0 adding the others' sums.
//
// w8a16_dequant: w[K, N] = (f32(q) * s) rounded to nearest even in the
// output type: `wmat` on the card, bit-identical to `(q.float() * s).to(dt)`.
// ops/quant.linear uses it for an f32 x past GEMV_MAX_M rows in front of
// torch.matmul, the route the JAX package leaves to XLA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/build.py); loaded
// with ctypes. The tensor maps are encoded on the host for each call
// (cuTensorMapEncodeTiled, looked up in the libcuda the CUDA runtime has
// loaded) and passed by value as __grid_constant__ parameters. Each entry
// returns the cudaError_t of its launches. The per-weight kernels' block
// bodies live in w8a16_common.cuh, shared with w8a16_moe_gemm.cu.

#include "w8a16_common.cuh"

#include <cuda.h>
#include <dlfcn.h>

#include <cstring>

namespace {

template <int MT, typename XT>
__global__ void __launch_bounds__(kThreads)
    w8a16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, XT* __restrict__ y,
                 float* __restrict__ part, int M, int K, int N, int per,
                 int vec) {
  cuda_core_tile<MT, XT>(x, q, s, y, part, M, K, N, per, vec, blockIdx.x,
                         blockIdx.y, blockIdx.z * MT);
}

// grid (splits, column tiles, passes of 8 rows), launched as clusters of
// the `splits` blocks of one tile and pass
template <int WARPS, int DEPTH>
__global__ void __launch_bounds__(WARPS * 32)
    w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ s,
                     __nv_bfloat16* __restrict__ y, int M, int K, int N,
                     int per, int vec16, int xvec) {
  mma_tile<WARPS, DEPTH>(x, q, s, y, M, K, N, per, vec16, xvec, blockIdx.y,
                         blockIdx.x, blockIdx.z * kMmaRows);
}

// y = (sum of the splits' partials, in split order) * s
template <typename XT>
__global__ void __launch_bounds__(256)
    w8a16_reduce(const float* __restrict__ part, const float* __restrict__ s,
                 XT* __restrict__ y, int M, int N, int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float a = 0.f;
  for (int sp = 0; sp < splits; ++sp) a += part[sp * total + i];
  y[i] = from_f32<XT>(a * s[i % N]);
}

// w = (f32(q) * s) in OT, kDeqElems elements a thread: one 16-byte load
// and 16-byte stores (vec: N % 16 == 0 and aligned, so the 16 share a row)
constexpr int kDeqElems = 16;

__device__ __forceinline__ void store16(float* w, const float* v) {
#pragma unroll
  for (int i = 0; i < kDeqElems; i += 4)
    *reinterpret_cast<float4*>(w + i) = make_float4(v[i], v[i + 1], v[i + 2],
                                                    v[i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* w, const float* v) {
#pragma unroll
  for (int i = 0; i < kDeqElems; i += 8) {
    uint4 o;
    uint32_t* u = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b =
          __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(w + i) = o;
  }
}

template <typename OT>
__global__ void __launch_bounds__(256)
    w8a16_dequant_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ s, OT* __restrict__ w,
                         int K, int N, int vec) {
  const size_t total = static_cast<size_t>(K) * N;
  const size_t i0 =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kDeqElems;
  if (i0 >= total) return;
  if (vec && i0 + kDeqElems <= total) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(q + i0));
    const int n = static_cast<int>(i0 % N);
    float f[kDeqElems];
    i8x4_to_f32(v.x, f);
    i8x4_to_f32(v.y, f + 4);
    i8x4_to_f32(v.z, f + 8);
    i8x4_to_f32(v.w, f + 12);
#pragma unroll
    for (int c = 0; c < kDeqElems; ++c) f[c] *= __ldg(s + n + c);
    store16(w + i0, f);
    return;
  }
  for (int c = 0; c < kDeqElems && i0 + c < total; ++c)
    w[i0 + c] = from_f32<OT>(static_cast<float>(q[i0 + c]) * s[(i0 + c) % N]);
}

template <int MT, typename XT>
cudaError_t launch_gemm(const void* x, const int8_t* q, const float* s,
                        void* y, float* part, int M, int K, int N, int splits,
                        int per, int vec, cudaStream_t st) {
  const dim3 grid((N + kTileN - 1) / kTileN, splits, (M + MT - 1) / MT);
  w8a16_kernel<MT, XT><<<grid, kThreads, 0, st>>>(
      static_cast<const XT*>(x), q, s, static_cast<XT*>(y),
      splits > 1 ? part : nullptr, M, K, N, per, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(M) * N;
  w8a16_reduce<XT><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      part, s, static_cast<XT*>(y), M, N, splits);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const int8_t* q, const float* s,
                       void* y, int M, int K, int N, int splits, int per,
                       cudaStream_t st) {
  auto kernel = w8a16_mma_kernel<kMmaWarps, kMmaDepth>;
  if (splits > 8) {
    // clusters past the portable 8 need the kernel's opt-in, once
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      opted_in = true;
    }
  }
  const int vec16 =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 ? 1 : 0;
  const int xvec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0 ? 1 : 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kMmaTileN - 1) / kMmaTileN,
                     (M + kMmaRows - 1) / kMmaRows);
  cfg.blockDim = dim3(kMmaWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), q, s,
      static_cast<__nv_bfloat16*>(y), M, K, N, per, vec16, xvec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// -- the grouped decode kernel (bf16 x, M <= 16) --------------------------------

constexpr int kGrpTileN = 128;       // columns a tile: one 128-byte TMA box row
constexpr int kGrpChunkK = 64;       // k rows a stage
constexpr int kGrpStages = 4;        // stages of the ring
constexpr int kGrpConsumers = 4;     // consumer warps: 16 k rows of a stage each
constexpr int kGrpThreads = (kGrpConsumers + 1) * 32;
constexpr int kGrpMaxW = 3;          // weights a launch
constexpr int kGrpMaxSplits = 8;     // splits a cluster (the portable limit)
constexpr int kGrpQBytes = kGrpChunkK * kGrpTileN;       // 8192: a q box
constexpr int kGrpXRows = 16;                            // rows of x a box
constexpr int kGrpXBytes = kGrpXRows * kGrpChunkK * 2;   // 2048: an x box
constexpr int kGrpStageBytes = kGrpQBytes + kGrpXBytes;  // 1024-aligned
// the consumer warps' partial sums of a tile: [warp][lane][64 + 1] f32 (16
// rows: 2 row groups x 8 MMAs x 4 values a lane, + 1 against bank conflicts)
constexpr int kGrpPartStride = 65;
constexpr int kGrpPartBytes = kGrpConsumers * 32 * kGrpPartStride * 4;
constexpr int kGrpSmemBytes = kGrpStages * kGrpStageBytes + kGrpPartBytes +
                              2 * 8 * kGrpStages + 1024;
static_assert(kGrpStageBytes % 1024 == 0, "each box 1024-byte aligned");
// three blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block
static_assert(3 * (kGrpSmemBytes + 1024) <= 233472, "three blocks an SM");

// one launch's weights: weight i's q [K, n[i]] int8, s [n[i]] f32 and y
// [M, n[i]] bf16; its column tiles are tile0[i] .. tile0[i + 1] - 1 of the
// launch's column space (every entry past nw holds the total); tma[i]: its
// boxes stream through TMA (else the producer warp copies them); x_tma: x's
// boxes too
struct GroupArgs {
  const int8_t* q[kGrpMaxW];
  const float* s[kGrpMaxW];
  __nv_bfloat16* y[kGrpMaxW];
  int n[kGrpMaxW];
  int tma[kGrpMaxW];
  int tile0[kGrpMaxW + 1];
  int x_tma, M, K, per, tiles_per_block;
};

// a kernel parameter's array entry i without dynamic indexing (which would
// copy the parameter struct to local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kGrpMaxW], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : v[2];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a box of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the byte offset of 16-byte chunk c of 128-byte row r in a box, as TMA's
// 128-byte swizzle places it (the box 1024-byte aligned)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// the producer warp's copy of a [64 k, 128 column] q box where TMA cannot
// read the weight (N % 16 != 0 or q not 16-byte aligned): byte loads, zeros
// past K and N, laid out as TMA lays it out
__device__ __forceinline__ void copy_q_box(uint8_t* dst,
                                           const int8_t* __restrict__ q,
                                           int K, int N, int col, int k,
                                           int lane) {
  for (int e = lane; e < kGrpChunkK * 8; e += 32) {
    const int r = e >> 3, c = e & 7;
    uint32_t b[4] = {0u, 0u, 0u, 0u};
    if (k + r < K) {
      const int8_t* row = q + static_cast<size_t>(k + r) * N + col + 16 * c;
      for (int i = 0; i < 16; ++i)
        if (col + 16 * c + i < N)
          b[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[i]))
                       << (8 * (i & 3));
    }
    *reinterpret_cast<uint4*>(dst + swz(r, c)) =
        make_uint4(b[0], b[1], b[2], b[3]);
  }
}

// the same for a [rows of x, 64 k] x box where TMA cannot read x (K % 8 != 0
// or x not 16-byte aligned): zeros past M and K
__device__ __forceinline__ void copy_x_box(uint8_t* dst,
                                           const __nv_bfloat16* __restrict__ x,
                                           int M, int K, int k, int rows,
                                           int lane) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  for (int e = lane; e < rows * 8; e += 32) {
    const int r = e >> 3, c = e & 7;
    uint32_t h[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 8; ++i) {
      const int kk = k + 8 * c + i;
      if (r < M && kk < K)
        h[i >> 1] |= static_cast<uint32_t>(xs[static_cast<size_t>(r) * K + kk])
                     << (16 * (i & 1));
    }
    *reinterpret_cast<uint4*>(dst + swz(r, c)) =
        make_uint4(h[0], h[1], h[2], h[3]);
  }
}

// the 16-byte chunk of a 128-column tile that lane group g holds: lanes
// 2p and 2p + 1 of a quarter warp take chunks p and p + 4, so that with the
// swizzle the 8 lanes of a quarter warp read 8 different bank groups
__device__ __forceinline__ int lane_chunk(int g) {
  return (g >> 1) | ((g & 1) << 2);
}

// grid (splits, blocks); the splits of one column tile run as one cluster
// (clusters of `splits` blocks along x), tiles_per_block == 1 then; with
// one split a block walks up to tiles_per_block tiles, `blocks` apart. RG:
// row groups
// of 8 (1: M <= 8, 2: M <= 16), each widened weight fragment feeding RG
// MMAs.
template <int RG>
__global__ void __launch_bounds__(kGrpThreads, 3)
    w8a16_group_kernel(const __grid_constant__ CUtensorMap map0,
                       const __grid_constant__ CUtensorMap map1,
                       const __grid_constant__ CUtensorMap map2,
                       const __grid_constant__ CUtensorMap map_x,
                       const __nv_bfloat16* __restrict__ x,
                       const GroupArgs a) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128B swizzle repeats every 8 rows of 128 bytes
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  float* part = reinterpret_cast<float*>(ring + kGrpStages * kGrpStageBytes);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t bar0 = smem_u32(ring + kGrpStages * kGrpStageBytes +
                                 kGrpPartBytes);
  auto full = [&](int i) { return bar0 + 8u * i; };
  auto empty = [&](int i) { return bar0 + 8u * (kGrpStages + i); };

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int splits = static_cast<int>(gridDim.x);
  const int M = a.M, K = a.K;
  const int k_lo = blockIdx.x * a.per * kGrpChunkK;
  const int k_hi = min(K, k_lo + a.per * kGrpChunkK);
  const int nck = (k_hi - k_lo + kGrpChunkK - 1) / kGrpChunkK;
  // block b walks tiles b, b + blocks, b + 2 blocks, ... (at most
  // tiles_per_block): the blocks in flight together read neighbouring
  // tiles, whole rows of the weight at a time
  const int tiles = a.tile0[kGrpMaxW];
  const int nblk = static_cast<int>(gridDim.y);
  const int ntile = min(a.tiles_per_block,
                        (tiles - 1 - static_cast<int>(blockIdx.y)) / nblk + 1);
  auto tile_of = [&](int j) { return static_cast<int>(blockIdx.y) + j * nblk; };
  const int items = ntile * nck;   // (tile, chunk) pairs, in order
  // the weight of tile t and its first column
  auto locate = [&](int t, int& w, int& col) {
    w = t >= a.tile0[2] ? 2 : t >= a.tile0[1] ? 1 : 0;
    col = (t - (w == 0 ? 0 : w == 1 ? a.tile0[1] : a.tile0[2])) * kGrpTileN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGrpStages; ++i) {
      mbar_init(full(i), 2);               // the q box's and the x box's
      mbar_init(empty(i), kGrpConsumers);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kGrpConsumers) {
    // -- producer warp: the weights from the block's first cycle (they do
    // not depend on the previous kernel); x once that kernel is done -------
    auto load_q = [&](int it) {
      const int st = it % kGrpStages;
      int w, col;
      locate(tile_of(it / nck), w, col);
      const int kc = k_lo + (it % nck) * kGrpChunkK;
      mbar_wait(empty(st), ((it / kGrpStages) & 1) ^ 1);
      if (pick(a.tma, w)) {
        if (lane == 0) {
          mbar_expect_tx(full(st), kGrpQBytes);
          tma_load_2d(ring_s + st * kGrpStageBytes,
                      w == 0 ? &map0 : w == 1 ? &map1 : &map2, full(st), col,
                      kc);
        }
      } else {
        copy_q_box(ring + st * kGrpStageBytes, pick(a.q, w), K, pick(a.n, w),
                   col, kc, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(full(st));
      }
    };
    auto load_x = [&](int it) {
      const int st = it % kGrpStages;
      const int kc = k_lo + (it % nck) * kGrpChunkK;
      if (a.x_tma) {
        if (lane == 0) {
          mbar_expect_tx(full(st), 8 * RG * kGrpChunkK * 2);
          tma_load_2d(ring_s + st * kGrpStageBytes + kGrpQBytes, &map_x,
                      full(st), kc, 0);
        }
      } else {
        copy_x_box(ring + st * kGrpStageBytes + kGrpQBytes, x, M, K, kc,
                   8 * RG, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(full(st));
      }
    };
    const int head = min(items, kGrpStages);
    for (int it = 0; it < head; ++it) load_q(it);
    // x is the previous kernel's output (a no-op without a programmatic
    // dependent launch)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int it = 0; it < head; ++it) load_x(it);
    for (int it = head; it < items; ++it) {
      load_q(it);
      load_x(it);
    }
  } else {
    // -- consumer warps -----------------------------------------------------
    // every y store follows the previous kernel's end
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int g = lane >> 2, t4 = lane & 3;
    const int cg = lane_chunk(g);
    int it = 0;
    for (int j = 0; j < ntile; ++j) {
      int w, col;
      locate(tile_of(j), w, col);
      float acc[RG][8][4];
#pragma unroll
      for (int h = 0; h < RG; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[h][j][i] = 0.f;
      for (int c = 0; c < nck; ++c, ++it) {
        const int st = it % kGrpStages;
        mbar_wait(full(st), (it / kGrpStages) & 1);
        const uint8_t* sq = ring + st * kGrpStageBytes;
        const uint8_t* sx = sq + kGrpQBytes;
        // the lane's weight rows 16 warp + t4 + 4 r (r = 0..3), its 16
        // columns; and x's values at the same k rows of rows g (+ 8):
        // logical k 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of the MMA
        uint4 wv[4];
        uint32_t xb[RG][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * warp + t4 + 4 * r;
          wv[r] = *reinterpret_cast<const uint4*>(sq + swz(row, cg));
        }
#pragma unroll
        for (int h = 0; h < RG; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int kk = 16 * warp + t4 + 4 * r;
            v[r] = *reinterpret_cast<const unsigned short*>(
                sx + swz(8 * h + g, kk >> 3) + 2 * (kk & 7));
          }
          xb[h][0] = v[0] | (v[1] << 16);
          xb[h][1] = v[2] | (v[3] << 16);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float f[4][2];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t word = (j >> 1) == 0   ? wv[r].x
                                  : (j >> 1) == 1 ? wv[r].y
                                  : (j >> 1) == 2 ? wv[r].z
                                                  : wv[r].w;
            const uint32_t biased = word ^ 0x80808080u;
            const int byte = 2 * (j & 1);
            f[r][0] = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                                  0x7650 + byte)) -
                      8388736.f;
            f[r][1] = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                                  0x7650 + byte + 1)) -
                      8388736.f;
          }
          const uint32_t a0 = pack_bf16x2(f[0][0], f[1][0]);
          const uint32_t a1 = pack_bf16x2(f[0][1], f[1][1]);
          const uint32_t a2 = pack_bf16x2(f[2][0], f[3][0]);
          const uint32_t a3 = pack_bf16x2(f[2][1], f[3][1]);
#pragma unroll
          for (int h = 0; h < RG; ++h)
            mma_bf16(acc[h][j], a0, a1, a2, a3, xb[h][0], xb[h][1]);
        }
        // the stage goes back to the producer (the MMAs, warp-wide, have
        // consumed every lane's loads)
        if (lane == 0) mbar_arrive(empty(st));
      }

      // the tile's sum: the 4 warps' fragments, added in warp order
      float* mine = part + (warp * 32 + lane) * kGrpPartStride;
#pragma unroll
      for (int h = 0; h < RG; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) mine[32 * h + 4 * j + i] = acc[h][j][i];
      asm volatile("bar.sync 1, %0;" ::"n"(kGrpConsumers * 32) : "memory");
      const float* sg = pick(a.s, w);
      __nv_bfloat16* yg = pick(a.y, w);
      const int n = pick(a.n, w);
      // fragment value e: lane l = e / (32 RG), index e % (32 RG) = 32 h +
      // 4 j + i -> y row 8 h + 2 (l % 4) + (i & 1), column 16 lane_chunk(l /
      // 4) + 2 j + (i >> 1) of the tile
      for (int e = threadIdx.x; e < 32 * 32 * RG; e += kGrpConsumers * 32) {
        const int l = e / (32 * RG), idx = e % (32 * RG);
        const int off = l * kGrpPartStride + idx;
        float v = part[off];
#pragma unroll
        for (int wi = 1; wi < kGrpConsumers; ++wi)
          v += part[wi * 32 * kGrpPartStride + off];
        if (splits > 1) {
          part[off] = v;   // the block's sum, read across the cluster
          continue;
        }
        const int m = 8 * (idx >> 5) + 2 * (l & 3) + (idx & 1);
        const int c = col + 16 * lane_chunk(l >> 2) + 2 * ((idx >> 2) & 7) +
                      ((idx >> 1) & 1);
        if (m < M && c < n)
          yg[static_cast<size_t>(m) * n + c] =
              __float2bfloat16_rn(v * __ldg(sg + c));
      }
      // the partial sums are free for the block's next tile
      asm volatile("bar.sync 1, %0;" ::"n"(kGrpConsumers * 32) : "memory");
    }
  }
  if (splits == 1) return;

  // -- the splits' sums meet across the cluster (one tile a cluster): rank r
  // adds every rank's sum of its share of the values, in rank order, and
  // writes y ----------------------------------------------------------------
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (warp < kGrpConsumers) {
    int w, col;
    locate(tile_of(0), w, col);
    const float* sg = pick(a.s, w);
    __nv_bfloat16* yg = pick(a.y, w);
    const int n = pick(a.n, w);
    const int rank = static_cast<int>(cluster.block_rank());
    for (int e = rank * kGrpConsumers * 32 + threadIdx.x; e < 32 * 32 * RG;
         e += splits * kGrpConsumers * 32) {
      const int l = e / (32 * RG), idx = e % (32 * RG);
      const int m = 8 * (idx >> 5) + 2 * (l & 3) + (idx & 1);
      const int c = col + 16 * lane_chunk(l >> 2) + 2 * ((idx >> 2) & 7) +
                    ((idx >> 1) & 1);
      if (m >= M || c >= n) continue;
      const int off = l * kGrpPartStride + idx;
      float v = 0.f;
      for (int r = 0; r < splits; ++r)
        v += cluster.map_shared_rank(part, r)[off];
      yg[static_cast<size_t>(m) * n + c] =
          __float2bfloat16_rn(v * __ldg(sg + c));
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded into the process (so the library links no libcuda of its own)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a row-major [d1, d0] tensor (d0 contiguous, esize bytes an element) read
// in boxes of [b1, b0], 128B-swizzled, zeros past its edges
bool encode_2d(CUtensorMap* map, EncodeTiled fn, CUtensorMapDataType type,
               int esize, const void* ptr, int d0, int d1, int b0, int b1) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d0) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RG>
cudaError_t launch_group(const CUtensorMap* maps, const void* x,
                         const GroupArgs& a, int splits, int blocks,
                         cudaStream_t st) {
  auto kernel = w8a16_group_kernel<RG>;
  static bool opted_in = false;   // one shared-memory opt-in an instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGrpSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a programmatic dependent launch: the blocks start while the previous
  // kernel drains, and wait for it only before reading x
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, blocks, 1);
  cfg.blockDim = dim3(kGrpThreads);
  cfg.dynamicSmemBytes = kGrpSmemBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1], maps[2], maps[3],
      static_cast<const __nv_bfloat16*>(x), a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_rows(int mt, const void* x, const int8_t* q,
                          const float* s, void* y, float* part, int M, int K,
                          int N, int splits, int per, int vec,
                          cudaStream_t st) {
  switch (mt) {
    case 1:
      return launch_gemm<1, XT>(x, q, s, y, part, M, K, N, splits, per, vec,
                                st);
    case 2:
      return launch_gemm<2, XT>(x, q, s, y, part, M, K, N, splits, per, vec,
                                st);
    case 4:
      return launch_gemm<4, XT>(x, q, s, y, part, M, K, N, splits, per, vec,
                                st);
    case 8:
      return launch_gemm<8, XT>(x, q, s, y, part, M, K, N, splits, per, vec,
                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] (dtype 0 = f32, 1 = bf16), q [K, N] int8, s [N] f32, y [M, N] in
// x's dtype; part: f32 [splits, M, N] scratch when splits > 1 (else
// ignored); per: k chunks a split (64 rows for f32, 16 x kMmaWarps for
// bf16); mt: rows of x a block pass of the f32 kernel (1, 2, 4 or 8; a bf16
// x always takes 8, the MMA's n8).
extern "C" int w8a16_gemm(const void* x, const void* q, const void* s,
                          void* y, void* part, int M, int K, int N, int splits,
                          int per, int mt, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  // every split holds rows; the f32 kernel's splits reduce through `part`,
  // the bf16 kernel's within a cluster of at most kClusterMax blocks
  const int chunk = dtype == 1 ? 16 * kMmaWarps : kChunkK;
  if (K <= 0 || splits <= 0 || per <= 0 ||
      static_cast<long long>(splits - 1) * per * chunk >= K ||
      (dtype == 0 && splits > 1 && part == nullptr) ||
      (dtype == 1 && splits > kClusterMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int vec =
      N % kCols == 0 && reinterpret_cast<uintptr_t>(qp) % 8 == 0 ? 1 : 0;
  const float* sp = static_cast<const float*>(s);
  float* pp = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_rows<float>(mt, x, qp, sp, y, pp, M, K, N,
                                                 splits, per, vec, st));
  if (dtype == 1)
    return static_cast<int>(launch_mma(x, qp, sp, y, M, K, N, splits, per, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// w [K, N] = (f32(q) * s) in dtype (0 = f32, 1 = bf16)
extern "C" int w8a16_dequant(const void* q, const void* s, void* w, int K,
                             int N, int dtype, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  // 16-byte loads of q and 16-byte stores of w (bf16: 32 bytes, f32: 64)
  const int vec = N % kDeqElems == 0 &&
                          reinterpret_cast<uintptr_t>(qp) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(w) % 16 == 0
                      ? 1
                      : 0;
  const size_t total = static_cast<size_t>(K) * N;
  const unsigned blocks = static_cast<unsigned>(
      (total + 256 * kDeqElems - 1) / (256 * kDeqElems));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    w8a16_dequant_kernel<float><<<blocks, 256, 0, st>>>(
        qp, sp, static_cast<float*>(w), K, N, vec);
  else if (dtype == 1)
    w8a16_dequant_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        qp, sp, static_cast<__nv_bfloat16*>(w), K, N, vec);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}


// The grouped decode product: y_i [M, N_i] = x [M, K] @ (f32(q_i [K, N_i]) *
// s_i [N_i]) in bf16 for the nw (1 to 3) weights of one x, in one launch.
// x bf16 [M, K] with 1 <= M <= 16; splits over K (at most 8, one cluster a
// column tile) of `per` chunks of 64 rows; with one split, tiles_per_block
// consecutive column tiles of 128 a block (else 1). The grid comes from the
// shapes (ops/quant.py group_config); anything else is refused.
extern "C" int w8a16_group(const void* x, const void* q0, const void* q1,
                           const void* q2, const void* s0, const void* s1,
                           const void* s2, void* y0, void* y1, void* y2,
                           int n0, int n1, int n2, int nw, int M, int K,
                           int splits, int per, int tiles_per_block,
                           void* stream) {
  const void* qs[kGrpMaxW] = {q0, q1, q2};
  const void* ss[kGrpMaxW] = {s0, s1, s2};
  void* ys[kGrpMaxW] = {y0, y1, y2};
  const int ns[kGrpMaxW] = {n0, n1, n2};
  const int chunks = (K + kGrpChunkK - 1) / kGrpChunkK;
  if (nw < 1 || nw > kGrpMaxW || M < 1 || M > kGrpXRows || K < 1 ||
      x == nullptr || splits < 1 || splits > kGrpMaxSplits || per < 1 ||
      tiles_per_block < 1 || (splits > 1 && tiles_per_block != 1) ||
      static_cast<long long>(splits - 1) * per >= chunks ||
      static_cast<long long>(splits) * per < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  GroupArgs a = {};
  CUtensorMap maps[kGrpMaxW + 1];
  memset(maps, 0, sizeof(maps));
  for (int i = 0; i < nw; ++i) {
    if (ns[i] < 1 || qs[i] == nullptr || ss[i] == nullptr || ys[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    a.q[i] = static_cast<const int8_t*>(qs[i]);
    a.s[i] = static_cast<const float*>(ss[i]);
    a.y[i] = static_cast<__nv_bfloat16*>(ys[i]);
    a.n[i] = ns[i];
    // TMA reads rows of 16-byte multiples from a 16-byte aligned base
    a.tma[i] = ns[i] % 16 == 0 &&
               reinterpret_cast<uintptr_t>(qs[i]) % 16 == 0;
    if (a.tma[i] && !encode_2d(&maps[i], fn, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                               1, qs[i], ns[i], K, kGrpTileN, kGrpChunkK))
      return static_cast<int>(cudaErrorInvalidValue);
    a.tile0[i + 1] = a.tile0[i] + (ns[i] + kGrpTileN - 1) / kGrpTileN;
  }
  for (int i = nw; i < kGrpMaxW; ++i) a.tile0[i + 1] = a.tile0[nw];
  const int rg = M <= 8 ? 1 : 2;
  a.x_tma = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (a.x_tma && !encode_2d(&maps[kGrpMaxW], fn,
                            CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M,
                            kGrpChunkK, 8 * rg))
    return static_cast<int>(cudaErrorInvalidValue);
  a.M = M;
  a.K = K;
  a.per = per;
  a.tiles_per_block = tiles_per_block;
  const int blocks =
      (a.tile0[kGrpMaxW] + tiles_per_block - 1) / tiles_per_block;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rg == 1 ? launch_group<1>(maps, x, a, splits, blocks, st)
              : launch_group<2>(maps, x, a, splits, blocks, st);
  return static_cast<int>(err);
}
