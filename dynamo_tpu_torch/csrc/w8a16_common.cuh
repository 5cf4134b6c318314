// The W8A16 products' shared parts: the int8 -> float conversions and the
// block bodies of the per-weight kernels of w8a16_gemm.cu, which that
// file's comment describes. w8a16_moe_gemm.cu launches them over the
// experts of one layer (the serving user of mma_tile: the grouped expert
// kernel); w8a16_gemm.cu over one weight (cuda_core_tile for an f32 x;
// mma_tile only as chip_smoke.py's old column, since its grouped decode
// kernel took the bf16 route). Included by both; every definition has
// internal linkage.

#pragma once

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

// one block of the CUDA-core kernel: column tile `tile`, split `split` of
// the K range (`per` chunks a split), rows m0 .. m0 + MT - 1 of x
template <int MT, typename XT>
__device__ __forceinline__ void cuda_core_tile(
    const XT* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, XT* __restrict__ y,
    float* __restrict__ part, int M, int K, int N, int per, int vec,
    int tile, int split, int m0) {
  // x slices of two chunks (f32, [k][row]) and the cross-warp exchange
  __shared__ __align__(16) float xs[2][kChunkK][MT];
  __shared__ __align__(16) float red[kWarps / 2][MT][kTileN];
  constexpr int kXPerThread = (kChunkK * MT + kThreads - 1) / kThreads;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = tile * kTileN + lane * kCols;
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

// one block of the tensor-core kernel: split `split` of the K range (`per`
// chunks a split) of column tile `tile`, rows m0 .. m0 + 7 of x; the
// `splits` blocks of one tile and pass run as one cluster. WARPS warps a
// block (a chunk is 16 x WARPS rows of k), DEPTH chunks of loads in flight
// a warp
template <int WARPS, int DEPTH>
__device__ __forceinline__ void mma_tile(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int M,
    int K, int N, int per, int vec16, int xvec, int tile, int split,
    int m0) {
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
  const int n_tile = tile * kMmaTileN;
  const int n_lane = n_tile + 16 * g;                  // the lane's columns
  const int row = m0 + g;                              // the lane's x row
  const int k_lo = split * per * kMmaChunkK;
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

}  // namespace
