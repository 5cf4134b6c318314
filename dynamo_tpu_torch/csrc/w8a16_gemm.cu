// Weight-only int8 products for Hopper (sm_90a): the W8A16 GEMM and the
// dequantize entry.
//
// Not the port of a Pallas kernel. The JAX package stores int8 weights with
// per-output-channel f32 scales (dynamo_tpu/ops/quant.py) and needs no
// kernel: XLA fuses `wmat`'s dequantize (quant.py:70-77) into the matmul's
// operand pipeline. PyTorch does not, and an eager dequantize + matmul reads
// the int8 weight, writes it as bf16 and reads that back. This source is the
// fused product the port needs instead (dynamo_tpu_torch/ops/quant.py).
//
// w8a16_gemm: y[M, N] = x[M, K] @ (f32(q[K, N]) * s[N]), f32 accumulation,
// y in x's type (f32 or bf16). q is the JAX layout [d_in, d_out], row-major:
// each k row is contiguous along N. s multiplies the f32 sum of each column
// once, after the accumulation (the same product as scaling each weight
// first, up to rounding).
//
// Bound: at decode (M = slots <= 8) the call must read K * N weight bytes
// once, plus N scales, x and y, over the card's 3.35 TB/s: llama3-8b's
// w_gate (4096 x 14336) is ~58.7 MB, ~17.5 us; lm_head (4096 x 128256)
// ~525 MB, ~157 us; wk (4096 x 1024) ~4.2 MB, ~1.3 us, which is launch
// latency. Its 2 * M * K * N operations sit far below the tensor-core roof;
// on the CUDA cores, M = 8 is ~8 FMAs per weight byte, about as long as the
// bytes take (a first version of this file did exactly that for bf16 too
// and ran at ~24% of the bound, behind cuBLAS's bf16 product). So a bf16 x
// goes through the tensor cores and the lanes only convert the weights.
//
// bf16 x, tensor cores (w8a16_mma_kernel): y^T = W^T . x^T as
// mma.sync.m16n8k16 (bf16 operands, f32 accumulate), the weight as the A
// operand (16 output columns x 16 k) and x^T as B (16 k x 8 rows of x), so
// M <= 8 fills the instruction's n8 with no padding. Grid (splits over K,
// column tiles of 128, passes of 8 rows of x); a block is 8 warps on the
// same 128 columns, walking its split's K range in chunks of 128 rows,
// warp w taking rows 16w .. 16w + 15 of each chunk. The MMA's k order within a
// step and its row order are free, so they are chosen to fit the loads:
// lane (g, t) = (lane / 4, lane % 4) loads 16 contiguous bytes, columns
// 16g .. 16g + 15, from each of the 4 rows 4t .. 4t + 3 of its warp's step
// (a warp reads 4 x 128 contiguous bytes per load instruction), and x's 4
// values x[g][4t .. 4t + 3] as one 8-byte load; logical k (2t, 2t + 1,
// 2t + 8, 2t + 9) is physical row 4t + (0, 1, 2, 3), and MMA j (8 a step)
// takes columns 16g + 2j (its row g) and 16g + 2j + 1 (row g + 8). int8 ->
// bf16 exactly: a byte permute and an f32 subtract to an exact f32, whose
// top half is the bf16 (|v| <= 128), packed two at a time by a byte permute.
// The next two chunks' weight bytes (64 a lane each) and x values load
// before the current chunk's 8 MMAs. The warps' sums reduce in shared
// memory, in warp order; the splits of one tile run as one thread-block
// cluster (at most 16), and rank 0 adds the other blocks' sums out of their
// shared memory (distributed shared memory) in rank order, applies s and
// writes y: no partials in device memory and no second kernel. The host
// picks the splits from the shapes (ops/quant.py gemm_config): about 1.5
// blocks per SM, so the grid stays within one wave of resident blocks (a
// second, mostly idle wave costs more than it hides), and at least 4
// chunks a split. Timed on the card, 8 warps with two chunks in flight
// beat 4 warps or one chunk in flight at the llama3-8b projections.
//
// f32 x, CUDA cores (w8a16_kernel; an f32 x cannot go through bf16
// operands): grid (column tiles of 256, splits over K, passes of MT rows of
// x). A block is 8 warps; lane l of every warp owns columns 8l .. 8l + 7 of
// the tile, and the block walks its split's K range in chunks of 64 rows,
// warp w taking rows 8w .. 8w + 7 of each chunk. Per chunk:
// - each lane loads its 8 rows x 8 columns of int8 as 8-byte loads (a warp
//   reads 256 contiguous bytes of a row), the NEXT chunk's rows issued
//   before the current chunk's math, so two chunks of weights are in flight;
// - x's 64 x MT slice is staged in shared memory as f32 (double-buffered,
//   the next chunk's values loaded into registers before the math and
//   stored after it: one __syncthreads per chunk);
// - int8 -> f32 by a byte permute and an f32 subtract (0x4B0000xx is
//   2^23 + xx), not the quarter-rate I2F; then MT x 8 FMAs per row with
//   x broadcast from shared memory.
// The 8 warps' partial sums reduce in shared memory (3 rounds, fixed
// order).
// With one split the block applies s and writes y; with more, it writes
// its f32 partial to scratch and w8a16_reduce sums the splits in split
// order and applies s. Both kernels are deterministic, so a captured graph
// and an eager call agree to the bit. The host picks MT (1, 2, 4 or 8; the
// f32 kernel) from M and the splits from shapes only (ops/quant.py
// gemm_split), never from data: no host sync, one ctypes call, capturable.
//
// w8a16_dequant: w[K, N] = (f32(q) * s) rounded to nearest even in the
// output type: `wmat` on the card, bit-identical to `(q.float() * s).to(dt)`.
// ops/quant.linear uses it for M > 8 (prefill and mixed steps) in front of
// torch.matmul, the route the JAX package leaves to XLA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/build.py); loaded
// with ctypes. Each entry returns the cudaError_t of its launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 8;                         // columns a lane
constexpr int kTileN = 32 * kCols;               // columns a block
constexpr int kChunkK = 64;                      // k rows a chunk
constexpr int kRowsPerWarp = kChunkK / kWarps;   // k rows a warp a chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the four int8 values of a word as exact f32, without the I2F unit
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t biased = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + k)) -
           8388736.f;  // 2^23 + 128
}

// 8 int8 weights of row k at columns n0 .. n0 + 7 as two words (zero past N;
// vec: N % 8 == 0 and q 8-byte aligned, so the 8 bytes are one load)
__device__ __forceinline__ void load_row8(const int8_t* __restrict__ q,
                                          size_t off, int n0, int N, bool vec,
                                          uint32_t* w) {
  if (vec && n0 + kCols <= N) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(q + off));
    w[0] = v.x;
    w[1] = v.y;
    return;
  }
  w[0] = w[1] = 0u;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (n0 + c < N)
      w[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(q[off + c]))
                   << (8 * (c & 3));
}

template <int MT, typename XT>
__global__ void __launch_bounds__(kThreads)
    w8a16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, XT* __restrict__ y,
                 float* __restrict__ part, int M, int K, int N, int per,
                 int vec) {
  // x slices of two chunks (f32, [k][row]) and the cross-warp exchange
  __shared__ __align__(16) float xs[2][kChunkK][MT];
  __shared__ __align__(16) float red[kWarps / 2][MT][kTileN];
  constexpr int kXPerThread = (kChunkK * MT + kThreads - 1) / kThreads;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kTileN + lane * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_lo = split * per * kChunkK;
  const int k_hi = min(K, k_lo + per * kChunkK);

  auto load_x = [&](int kc, float* v) {
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int m = i / kChunkK, kk = i % kChunkK;
      const int row = m0 + m, k = kc + kk;
      v[j] = (i < kChunkK * MT && row < M && k < k_hi)
                 ? to_f32(x[static_cast<size_t>(row) * K + k])
                 : 0.f;
    }
  };
  auto store_x = [&](int b, const float* v) {
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < kChunkK * MT) xs[b][i % kChunkK][i / kChunkK] = v[j];
    }
  };
  auto load_w = [&](int kc, uint32_t (*w)[2]) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int k = kc + warp * kRowsPerWarp + r;
      if (k < k_hi && n0 < N)
        load_row8(q, static_cast<size_t>(k) * N + n0, n0, N, vec, w[r]);
      else
        w[r][0] = w[r][1] = 0u;
    }
  };

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  float xv[kXPerThread];
  uint32_t wa[kRowsPerWarp][2], wb[kRowsPerWarp][2];
  load_x(k_lo, xv);
  store_x(0, xv);
  load_w(k_lo, wa);
  __syncthreads();
  int b = 0;
  for (int kc = k_lo; kc < k_hi; kc += kChunkK) {
    const bool more = kc + kChunkK < k_hi;
    if (more) {  // the next chunk's loads fly during this chunk's math
      load_x(kc + kChunkK, xv);
      load_w(kc + kChunkK, wb);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float wf[kCols];
      i8x4_to_f32(wa[r][0], wf);
      i8x4_to_f32(wa[r][1], wf + 4);
      const float* xr = xs[b][warp * kRowsPerWarp + r];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xm = xr[m];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(xm, wf[c], acc[m][c]);
      }
    }
    if (more) store_x(b ^ 1, xv);  // xs[b ^ 1] was last read before the sync
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      wa[r][0] = wb[r][0];
      wa[r][1] = wb[r][1];
    }
    b ^= 1;
  }

  // warps 4..7 hand their sums to 0..3, then 2..3 to 0..1, then 1 to 0
#pragma unroll
  for (int h = kWarps / 2; h >= 1; h >>= 1) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          red[warp - h][m][lane * kCols + c] = acc[m][c];
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[m][c] += red[warp][m][lane * kCols + c];
    }
    __syncthreads();
  }
  if (warp != 0) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    if (row >= M) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int n = n0 + c;
      if (n >= N) break;
      const size_t o = static_cast<size_t>(row) * N + n;
      if (part != nullptr)
        part[static_cast<size_t>(split) * M * N + o] = acc[m][c];
      else
        y[o] = from_f32<XT>(acc[m][c] * s[n]);
    }
  }
}

constexpr int kMmaTileN = 128;                   // columns a block
constexpr int kMmaRows = 8;                      // rows of x a pass (n8)
constexpr int kMmaWarps = 8;                     // warps a block
constexpr int kMmaDepth = 2;                     // chunks of loads in flight
constexpr int kClusterMax = 16;                  // splits a cluster (> 8:
                                                 // non-portable, opted in)

// D += A . B, m16n8k16, bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two exact small-integer f32 (|v| <= 256) as one bf16x2: their top halves
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// one chunk of a warp: its 16 k rows (the lane's 4 rows of 16 bytes, x's 4
// values) through 8 MMAs
__device__ __forceinline__ void mma_chunk(float (*acc)[4], const uint4* w,
                                          uint2 xv) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t word = (j >> 1) == 0   ? w[r].x
                            : (j >> 1) == 1 ? w[r].y
                            : (j >> 1) == 2 ? w[r].z
                                            : w[r].w;
      const uint32_t biased = word ^ 0x80808080u;
      const int byte = 2 * (j & 1);
      f[r][0] = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                            0x7650 + byte)) - 8388736.f;
      f[r][1] = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                            0x7650 + byte + 1)) - 8388736.f;
    }
    // A rows g (column 16g + 2j) and g + 8 (column 16g + 2j + 1); logical
    // k 2t, 2t + 1 = rows 0, 1; 2t + 8, 2t + 9 = rows 2, 3
    mma_bf16(acc[j], pack_bf16x2(f[0][0], f[1][0]),
             pack_bf16x2(f[0][1], f[1][1]), pack_bf16x2(f[2][0], f[3][0]),
             pack_bf16x2(f[2][1], f[3][1]), xv.x, xv.y);
  }
}

// grid (splits, column tiles, passes of 8 rows), launched as clusters of
// the `splits` blocks of one tile and pass; WARPS warps a block (a chunk is
// 16 x WARPS rows of k), DEPTH chunks of loads in flight a warp
template <int WARPS, int DEPTH>
__global__ void __launch_bounds__(WARPS * 32)
    w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ s,
                     __nv_bfloat16* __restrict__ y, int M, int K, int N,
                     int per, int vec16, int xvec) {
  constexpr int kMmaThreads = WARPS * 32;
  constexpr int kMmaChunkK = 16 * WARPS;
  // the other warps hand their 32 sums a lane to warp 0 (padded rows); the
  // block's sum, read by the cluster's rank 0
  __shared__ float red[WARPS - 1][32][33];
  __shared__ float bsum[kMmaRows][kMmaTileN];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tile = blockIdx.y * kMmaTileN;
  const int n_lane = n_tile + 16 * g;                  // the lane's columns
  const int m0 = blockIdx.z * kMmaRows;
  const int row = m0 + g;                              // the lane's x row
  const int k_lo = blockIdx.x * per * kMmaChunkK;
  const int k_hi = min(K, k_lo + per * kMmaChunkK);

  // the lane's 4 weight rows (16 bytes each) and 4 x values of one chunk
  auto load = [&](int kc, uint4* w, uint2& xv) {
    const int kb = kc + 16 * warp + 4 * t;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kb + r;
      const size_t off = static_cast<size_t>(k) * N + n_lane;
      if (k < k_hi && vec16 && n_lane + 16 <= N) {
        w[r] = __ldg(reinterpret_cast<const uint4*>(q + off));
      } else {
        uint32_t b[4] = {0u, 0u, 0u, 0u};
        if (k < k_hi)
          for (int c = 0; c < 16; ++c)
            if (n_lane + c < N)
              b[c >> 2] |= static_cast<uint32_t>(
                               static_cast<uint8_t>(q[off + c]))
                           << (8 * (c & 3));
        w[r] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    const size_t xo = static_cast<size_t>(row) * K + kb;
    if (row < M && xvec && kb + 4 <= k_hi) {
      xv = __ldg(reinterpret_cast<const uint2*>(x + xo));
    } else {
      uint16_t h[4] = {0, 0, 0, 0};
      if (row < M)
        for (int c = 0; c < 4; ++c)
          if (kb + c < k_hi) h[c] = __bfloat16_as_ushort(x[xo + c]);
      xv = make_uint2(h[0] | (static_cast<uint32_t>(h[1]) << 16),
                      h[2] | (static_cast<uint32_t>(h[3]) << 16));
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // DEPTH + 1 chunks in registers: the current one and DEPTH loads in
  // flight (a ring whose indices are compile-time, so it stays in registers)
  uint4 wbuf[DEPTH + 1][4];
  uint2 xbuf[DEPTH + 1];
#pragma unroll
  for (int d = 0; d <= DEPTH; ++d) {
    xbuf[d] = make_uint2(0u, 0u);
#pragma unroll
    for (int r = 0; r < 4; ++r) wbuf[d][r] = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (k_lo + d * kMmaChunkK < k_hi)
      load(k_lo + d * kMmaChunkK, wbuf[d], xbuf[d]);
  for (int kc = k_lo; kc < k_hi; kc += kMmaChunkK) {
    if (kc + DEPTH * kMmaChunkK < k_hi)
      load(kc + DEPTH * kMmaChunkK, wbuf[DEPTH], xbuf[DEPTH]);
    mma_chunk(acc, wbuf[0], xbuf[0]);
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
      for (int r = 0; r < 4; ++r) wbuf[d][r] = wbuf[d + 1][r];
      xbuf[d] = xbuf[d + 1];
    }
  }

  // the block's sum: warps 1.. into warp 0, in warp order
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp - 1][lane][4 * j + i] = acc[j][i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < WARPS - 1; ++w)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += red[w][lane][4 * j + i];
    // C fragment: (row g | g + 8 -> column 16g + 2j | + 1, col 2t | 2t + 1
    // -> row of x 2t | 2t + 1 of the pass)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bsum[2 * t + (i & 1)][16 * g + 2 * j + (i >> 1)] = acc[j][i];
  }
  // the splits' sums meet in rank 0, added in rank order
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int nblk = static_cast<int>(cluster.num_blocks());
    for (int e = threadIdx.x; e < kMmaRows * kMmaTileN; e += kMmaThreads) {
      const int m = e / kMmaTileN, nl = e % kMmaTileN;
      float v = bsum[m][nl];
      for (int r = 1; r < nblk; ++r)
        v += cluster.map_shared_rank(&bsum[0][0], r)[e];
      const int n = n_tile + nl;
      if (n < N && m0 + m < M)
        y[static_cast<size_t>(m0 + m) * N + n] = __float2bfloat16_rn(v * s[n]);
    }
  }
  // no block leaves while rank 0 may still read its shared memory
  cluster.sync();
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
