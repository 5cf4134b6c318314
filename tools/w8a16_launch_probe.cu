// Probe kernels that split the W8A16 decode kernel's time a launch into
// parts (tools/torch_w8a16_probe.py builds and drives them):
// - probe_empty: an empty kernel launched on a given grid, as a cluster of
//   `cluster` blocks along x, with a given dynamic shared memory and,
//   optionally, as a programmatic dependent launch: the cost of launching
//   and retiring that grid;
// - probe_stream: the per-weight register-ring kernel's grid (splits over K,
//   column tiles of 128; csrc/w8a16_common.cuh mma_tile) streaming its
//   weight bytes with that kernel's loads (8 warps, a lane's 4 rows of 16
//   bytes a chunk of 128 rows, two chunks in flight) and nothing else: no
//   x, no MMA, no reduction, no cluster barrier. The bytes are folded into
//   one word that is stored only if it equals `magic`, so the loads stay.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (the flags of
// dynamo_tpu_torch/ops/build.py); loaded with ctypes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__global__ void probe_empty_kernel() {}

constexpr int kWarps = 8;
constexpr int kChunkK = 16 * kWarps;   // k rows a chunk
constexpr int kTileN = 128;
constexpr int kDepth = 2;

__global__ void __launch_bounds__(kWarps * 32)
    probe_stream_kernel(const int8_t* __restrict__ q, int K, int N, int per,
                        uint32_t magic, uint32_t* __restrict__ sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_lane = blockIdx.y * kTileN + 16 * g;
  const int k_lo = blockIdx.x * per * kChunkK;
  const int k_hi = min(K, k_lo + per * kChunkK);
  auto load = [&](int kc, uint4* w) {
    const int kb = kc + 16 * warp + 4 * t;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kb + r;
      w[r] = k < k_hi && n_lane + 16 <= N
                 ? __ldg(reinterpret_cast<const uint4*>(
                       q + static_cast<size_t>(k) * N + n_lane))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 buf[kDepth + 1][4];
#pragma unroll
  for (int d = 0; d <= kDepth; ++d)
#pragma unroll
    for (int r = 0; r < 4; ++r) buf[d][r] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (k_lo + d * kChunkK < k_hi) load(k_lo + d * kChunkK, buf[d]);
  uint32_t acc = 0u;
  for (int kc = k_lo; kc < k_hi; kc += kChunkK) {
    if (kc + kDepth * kChunkK < k_hi) load(kc + kDepth * kChunkK, buf[kDepth]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      acc ^= buf[0][r].x ^ buf[0][r].y ^ buf[0][r].z ^ buf[0][r].w;
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
#pragma unroll
      for (int r = 0; r < 4; ++r) buf[d][r] = buf[d + 1][r];
  }
  if (acc == magic) *sink = acc;
}

cudaError_t launch(void (*kernel)(), dim3 grid, int threads, int cluster,
                   int smem, int pdl, cudaStream_t st) {
  cudaLaunchAttribute attr[2];
  int n = 0;
  attr[n].id = cudaLaunchAttributeClusterDimension;
  attr[n].val.clusterDim.x = cluster;
  attr[n].val.clusterDim.y = 1;
  attr[n].val.clusterDim.z = 1;
  ++n;
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// an empty kernel on grid (gx, gy), `threads` a block, clusters of
// `cluster` along x, `smem` bytes of dynamic shared memory, pdl != 0: a
// programmatic dependent launch
extern "C" int probe_empty(int gx, int gy, int threads, int cluster, int smem,
                           int pdl, void* stream) {
  static int opted = 0;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  return static_cast<int>(launch(probe_empty_kernel, dim3(gx, gy), threads,
                                 cluster, smem, pdl,
                                 static_cast<cudaStream_t>(stream)));
}

// the per-weight kernel's grid (splits, column tiles of 128), clusters of
// `splits`, streaming q [K, N] (N % 16 == 0, 16-byte aligned) in splits of
// `per` chunks of 128 rows
extern "C" int probe_stream(const void* q, int K, int N, int splits, int per,
                            unsigned magic, void* sink, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kTileN - 1) / kTileN);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (splits > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_stream_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, probe_stream_kernel, static_cast<const int8_t*>(q), K, N, per,
      static_cast<uint32_t>(magic), static_cast<uint32_t*>(sink));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
