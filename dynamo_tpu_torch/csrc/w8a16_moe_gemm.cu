// Grouped W8A16 product for the expert MLPs of a mixture-of-experts layer
// (sm_90a): one launch computes one projection (gate, up or down) for every
// expert of one layer.
//
// Not the port of a Pallas kernel. The JAX package runs the expert products
// as einsums over `wmat`-dequantized stacks (dynamo_tpu/ops/moe.py:77-82)
// and XLA fuses the dequantize; PyTorch does not (w8a16_gemm.cu says why
// that costs bytes). ops/quant.grouped_linear launches this kernel for the
// decode-time products (ops/moe.py), where each expert sees a few rows.
//
// y[e, m, :] = x[e, m, :] @ (f32(q[e]) * s[e]), f32 accumulation, y in x's
// type, for every expert e with active[e] > 0. x [E, M, K] is the dispatch's
// capacity buffer (M = B * C rows an expert: 8 at decode with 8 slots, where
// C = 1); q [E, K, N] int8 and s [E, 1, N] f32 are one layer's slice of the
// stacked expert weights [L, E, K, N], addressed at the layer's offset, never
// copied; active [E] int32 on the device holds the rows routed to each
// expert, counted from the routing after the validity mask.
//
// An expert with active[e] == 0 reads no weight byte: its blocks write zeros
// into their tile of y and return. The zeros are required: the dispatch
// multiplies an unrouted slot's output by a zero combine weight, and
// 0 x NaN from an unwritten y would poison the sum. The decision is read on
// the device, never on the host, so a decode window stays one captured
// graph. With 8 independent slots choosing 2 of 8 experts a layer touches
// 8 x (1 - 0.75^8) ~ 7.2 experts on average; with one live slot, 2.
//
// Bound: the active experts' K x N weight bytes plus their N scales, x and
// y, over the card's 3.35 TB/s. At Mixtral's shapes (K 4096 -> N 14336 for
// gate and up, 14336 -> 4096 for down) one projection of one layer with all
// 8 experts active moves ~470 MB, ~0.140 ms; a decode step that touches
// every expert reads 45.1 GB of experts, ~13.5 ms.
//
// Design: w8a16_gemm.cu's two block bodies (w8a16_common.cuh) with an
// expert axis in the grid, so M <= 8 rows fill the MMA's n8 as there.
// - bf16 x, tensor cores: grid (splits over K, column tiles of 128,
//   experts x passes of 8 rows), the splits of one tile as one thread-block
//   cluster merged in distributed shared memory. An inactive expert's
//   cluster returns as a whole (every block reads the same active[e]), so no
//   block waits at a cluster barrier for one that left.
// - f32 x (the tests' precision; the small reference on the card): grid
//   (column tiles of 256, 1, experts x passes of MT rows), the CUDA-core body
//   over the whole K range (one split, no scratch).
// The host picks the splits from the shapes alone, counting every expert's
// tiles (ops/quant.gemm_config, groups = E), so a call needs no host sync.
// Deterministic: a captured graph and an eager call agree to the bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/build.py); loaded
// with ctypes. The entry returns the cudaError_t of its launch.

#include "w8a16_common.cuh"

namespace {

// zeros into rows m0 .. m0 + rows - 1, columns n0 .. n0 + cols - 1 of y
template <typename XT>
__device__ __forceinline__ void zero_tile(XT* __restrict__ y, int M, int N,
                                          int m0, int rows, int n0,
                                          int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int m = m0 + i / cols, n = n0 + i % cols;
    if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = from_f32<XT>(0.f);
  }
}

template <int WARPS, int DEPTH>
__global__ void __launch_bounds__(WARPS * 32)
    moe_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q, const float* __restrict__ s,
                   const int* __restrict__ active,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N,
                   int per, int passes, int vec16, int xvec) {
  const int e = blockIdx.z / passes;
  const int m0 = (blockIdx.z % passes) * kMmaRows;
  y += static_cast<size_t>(e) * M * N;
  if (__ldg(active + e) == 0) {
    // the cluster's rank 0 (split 0) owns the tile's output
    if (blockIdx.x == 0)
      zero_tile(y, M, N, m0, kMmaRows, blockIdx.y * kMmaTileN, kMmaTileN);
    return;
  }
  mma_tile<WARPS, DEPTH>(x + static_cast<size_t>(e) * M * K,
                         q + static_cast<size_t>(e) * K * N,
                         s + static_cast<size_t>(e) * N, y, M, K, N, per,
                         vec16, xvec, blockIdx.y, blockIdx.x, m0);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
    moe_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s,
                   const int* __restrict__ active, float* __restrict__ y,
                   int M, int K, int N, int per, int passes, int vec) {
  const int e = blockIdx.z / passes;
  const int m0 = (blockIdx.z % passes) * MT;
  y += static_cast<size_t>(e) * M * N;
  if (__ldg(active + e) == 0) {
    zero_tile(y, M, N, m0, MT, blockIdx.x * kTileN, kTileN);
    return;
  }
  cuda_core_tile<MT, float>(x + static_cast<size_t>(e) * M * K,
                            q + static_cast<size_t>(e) * K * N,
                            s + static_cast<size_t>(e) * N, y, nullptr, M, K,
                            N, per, vec, blockIdx.x, 0, m0);
}

cudaError_t launch_moe_mma(const void* x, const int8_t* q, const float* s,
                           const int* active, void* y, int E, int M, int K,
                           int N, int splits, int per, cudaStream_t st) {
  auto kernel = moe_mma_kernel<kMmaWarps, kMmaDepth>;
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
  // an expert's slice starts K * N bytes (x: M * K values) after the one
  // before, so the base pointers' alignment holds for every expert
  const int vec16 =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 ? 1 : 0;
  const int xvec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0 ? 1 : 0;
  const int passes = (M + kMmaRows - 1) / kMmaRows;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kMmaTileN - 1) / kMmaTileN, E * passes);
  cfg.blockDim = dim3(kMmaWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), q, s, active,
      static_cast<__nv_bfloat16*>(y), M, K, N, per, passes, vec16, xvec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_moe_f32(const void* x, const int8_t* q, const float* s,
                           const int* active, void* y, int E, int M, int K,
                           int N, cudaStream_t st) {
  const int vec =
      N % kCols == 0 && reinterpret_cast<uintptr_t>(q) % 8 == 0 ? 1 : 0;
  const int passes = (M + MT - 1) / MT;
  const int per = (K + kChunkK - 1) / kChunkK;
  const dim3 grid((N + kTileN - 1) / kTileN, 1, E * passes);
  moe_f32_kernel<MT><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), q, s, active, static_cast<float*>(y), M,
      K, N, per, passes, vec);
  return cudaGetLastError();
}

}  // namespace

// x [E, M, K] (dtype 0 = f32, 1 = bf16), q [E, K, N] int8, s [E, N] f32,
// active [E] int32, y [E, M, N] in x's dtype, all contiguous. bf16: splits
// over K (at most kClusterMax, each holding rows: per chunks of 16 x
// kMmaWarps rows of k); f32: one split and mt rows of x a block pass (1, 2,
// 4 or 8).
extern "C" int w8a16_moe_gemm(const void* x, const void* q, const void* s,
                              const void* active, void* y, int E, int M,
                              int K, int N, int splits, int per, int mt,
                              int dtype, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  const int* ap = static_cast<const int*>(active);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K <= 0 || splits <= 0 || per <= 0 || splits > kClusterMax ||
        static_cast<long long>(splits - 1) * per * 16 * kMmaWarps >= K)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch_moe_mma(x, qp, sp, ap, y, E, M, K, N, splits, per, st));
  }
  if (dtype != 0 || K <= 0 || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mt) {
    case 1:
      return static_cast<int>(
          launch_moe_f32<1>(x, qp, sp, ap, y, E, M, K, N, st));
    case 2:
      return static_cast<int>(
          launch_moe_f32<2>(x, qp, sp, ap, y, E, M, K, N, st));
    case 4:
      return static_cast<int>(
          launch_moe_f32<4>(x, qp, sp, ap, y, E, M, K, N, st));
    case 8:
      return static_cast<int>(
          launch_moe_f32<8>(x, qp, sp, ap, y, E, M, K, N, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
