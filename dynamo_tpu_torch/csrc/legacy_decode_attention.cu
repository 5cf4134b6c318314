// Normalised paged decode attention, one block per (row, kv head), whole
// pages per step: the legacy decode kernel, Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels behind `decode_paged_attention_legacy`
// (dynamo_tpu/ops/paged_attention_oracle.py:224):
// - `_decode_kernel` (:37), the direct layout, instantiated here at hd 128;
// - `_decode_kernel_packed` (:116), the lane-packed layout for hd < 128,
//   instantiated here at hd 32 and 64. Lane packing is a TPU layout trick
//   (a [ps, hd] page viewed as [ps / pack, 128] so every DMA is 128-lane
//   aligned); the packed kernel computes the same function as the direct
//   one and also zeroes K and V past the length (:175-185). Hopper has no
//   such tiling rule, so one source serves both, and zeroes both.
// Both compute, for row s, the G = H / Hkv query heads of kv head j over the
// first kv_lens[s] tokens of the row's pages in a per-layer [Hkv, P, ps, hd]
// cache, and write the NORMALISED output acc / l (f32 inside, cast to q's
// type) into out [S, H, hd]. Caches are f32 or bf16 with a q of the same
// type, or int8 (kv_quant="int8") with an f32 or bf16 q and per-row f32
// scales [Hkv, P, ps], folded as the TPU kernels fold them: score =
// (q . k_int8) * s_k before the mask, p * s_v in the accumulator product.
//
// This source is written apart from ragged_decode_attention.cu, with a
// schedule of its own, so that the two agreeing on the card means
// something:
// - whole pages per step, as the TPU kernels walk them: page i + 1 of K and
//   V (and the int8 scales) is copied global -> shared memory with cp.async
//   in the cache's own type while page i is computed (two page buffers,
//   dynamic shared memory: 2 x 2 x ps x hd x size, 128 KB for f32 pages at
//   ps 64, hd 128, over the 48 KB static limit, hence the opt-in). Tokens
//   at or past the length are zero-filled by the copy itself (source size
//   0), values and scales alike, so a recycled tail's NaN or a stale scale
//   never enters the math;
// - scores: warp w scores tokens w, w + 8, ... of the page; each lane holds
//   hd / 32 elements of q for every head in registers, reads the same
//   elements of the token's K row, and the warp sums each head's partial
//   dot with shuffles (the ragged kernel has each lane score a whole token
//   on its own instead);
// - softmax: warp g updates head g's running max and sum over the page and
//   turns the page's scores into probabilities (times s_v for int8);
// - accumulate: each thread owns pairs of adjacent hd lanes of one head and
//   walks the page's V rows, reading two values at a time;
// - the last page is followed by the normalisation acc / l in the kernel.
//
// Bound: the same as the ragged kernel's, the valid K/V bytes (plus scales)
// once over the card's 3.35 TB/s. What keeps it from that bound: S * Hkv
// blocks, one page in flight per block, and scalar f32 math on shared
// memory. It is the oracle and the legacy arm of the decode A/B; it is not
// on the serving path.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int NWARP = NT / 32;
constexpr int G_MAX = 8;  // query heads per kv head (one softmax warp each)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// 16 bytes global -> shared; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void copy4(void* smem, const void* gmem,
                                      int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dynamic shared memory of one block, in bytes: K and V page buffers x 2,
// scale buffers x 2, the page's scores [G_MAX][ps], per-head alpha and l
size_t smem_bytes(size_t elem_size, int hd, int ps) {
  return 4 * (size_t)ps * hd * elem_size + 4 * (size_t)ps * sizeof(float) +
         (size_t)G_MAX * ps * sizeof(float) + 2 * G_MAX * sizeof(float);
}

template <typename TQ, typename TC, int HD>
__global__ void __launch_bounds__(NT) legacy_decode_kernel(
    const TQ* __restrict__ q,            // [S, H, HD]
    const TC* __restrict__ k_cache,      // [Hkv, P, ps, HD]
    const TC* __restrict__ v_cache,
    const float* __restrict__ k_scale,   // [Hkv, P, ps] (int8 only)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_table,  // [S, Pb]
    const int* __restrict__ kv_lens,     // [S], each >= 1
    TQ* __restrict__ out,                // [S, H, HD]
    int H, int Hkv, int P, int ps, int Pb, float scale) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  constexpr int E = HD / 32;  // hd elements per lane in the score dots
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t page_elems = (size_t)ps * HD;
  TC* kbuf = reinterpret_cast<TC*>(smem);               // [2][ps][HD]
  TC* vbuf = kbuf + 2 * page_elems;                     // [2][ps][HD]
  float* skbuf = reinterpret_cast<float*>(vbuf + 2 * page_elems);  // [2][ps]
  float* svbuf = skbuf + 2 * ps;                        // [2][ps]
  float* sc_s = svbuf + 2 * ps;                         // [G_MAX][ps]
  float* alpha_s = sc_s + G_MAX * ps;                   // [G_MAX]
  float* l_s = alpha_s + G_MAX;                         // [G_MAX]

  const int s = blockIdx.x;
  const int j = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = min(max(kv_lens[s], 1), Pb * ps);
  const int n_pages = (len + ps - 1) / ps;
  const int* pt = page_table + (size_t)s * Pb;
  const TC* k_head = k_cache + (size_t)j * P * page_elems;
  const TC* v_head = v_cache + (size_t)j * P * page_elems;

  // q of this kv head's G query heads, elements lane + 32 e, prescaled
  float qr[G_MAX][E];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = g < G ? widen(q[((size_t)s * H + (size_t)j * G + g) * HD +
                                 lane + 32 * e]) * scale
                       : 0.f;
  }

  // page i -> buffer b: K/V rows as 16-byte copies, tokens past len zeroed
  constexpr int VEC = 16 / sizeof(TC);
  constexpr int VPR = HD / VEC;  // 16-byte vectors per token row
  auto copy_page = [&](int i, int b) {
    const int page = pt[i];
    const size_t src0 = (size_t)page * page_elems;
    for (int u = tid; u < ps * VPR; u += NT) {
      const int t = u / VPR;
      const size_t off = (size_t)t * HD + (size_t)(u % VPR) * VEC;
      const int n = i * ps + t < len ? 16 : 0;
      copy16(kbuf + b * page_elems + off, k_head + src0 + off, n);
      copy16(vbuf + b * page_elems + off, v_head + src0 + off, n);
    }
    if constexpr (QUANT) {
      const size_t row0 = ((size_t)j * P + page) * ps;
      for (int t = tid; t < ps; t += NT) {
        const int n = i * ps + t < len ? 4 : 0;
        copy4(skbuf + b * ps + t, k_scale + row0 + t, n);
        copy4(svbuf + b * ps + t, v_scale + row0 + t, n);
      }
    }
    copy_commit();
  };

  // accumulator: unit u = (head g, lanes 2c and 2c + 1)
  constexpr int UNITS_PER_HEAD = HD / 2;
  constexpr int NU = (G_MAX * UNITS_PER_HEAD + NT - 1) / NT;
  float acc[NU][2];
#pragma unroll
  for (int r = 0; r < NU; ++r) acc[r][0] = acc[r][1] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;  // head `warp`'s, in every lane

  copy_page(0, 0);
  for (int i = 0; i < n_pages; ++i) {
    const int b = i & 1;
    copy_wait_all();
    __syncthreads();  // page i landed; buffer b ^ 1 no longer read
    if (i + 1 < n_pages) copy_page(i + 1, b ^ 1);
    const TC* kp = kbuf + b * page_elems;
    const TC* vp = vbuf + b * page_elems;
    const float* skp = skbuf + b * ps;
    const float* svp = svbuf + b * ps;

    // scores of every (head, token) of the page
    for (int t = warp; t < ps; t += NWARP) {
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = widen(kp[(size_t)t * HD + lane + 32 * e]);
      const bool valid = i * ps + t < len;
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {  // warp-uniform
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part += qr[g][e] * kf[e];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(FULL, part, off);
          if (QUANT) part *= skp[t];  // K dequant fold, before the mask
          if (lane == 0) sc_s[g * ps + t] = valid ? part : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax over the page: warp g owns head g
    if (warp < G) {
      float* row = sc_s + warp * ps;
      float mx = NEG_INF;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = expf(row[t] - m_new);
        sum += p;
        row[t] = QUANT ? p * svp[t] : p;  // V dequant fold
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (lane == 0) {
        alpha_s[warp] = alpha;
        l_s[warp] = l_run;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V over the page
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      const int u = tid + r * NT;
      const int g = u / UNITS_PER_HEAD;
      if (g < G) {
        const int d0 = 2 * (u % UNITS_PER_HEAD);
        const float* p = sc_s + g * ps;
        float a0 = acc[r][0] * alpha_s[g], a1 = acc[r][1] * alpha_s[g];
        for (int t = 0; t < ps; ++t) {
          const TC* vrow = vp + (size_t)t * HD + d0;
          a0 += p[t] * widen(vrow[0]);
          a1 += p[t] * widen(vrow[1]);
        }
        acc[r][0] = a0;
        acc[r][1] = a1;
      }
    }
  }
  // the normalisation (l_s holds the final sums; the last page's accumulate
  // step read only sc_s, alpha_s and its own registers since the last sync)
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    const int u = tid + r * NT;
    const int g = u / UNITS_PER_HEAD;
    if (g < G) {
      const int d0 = 2 * (u % UNITS_PER_HEAD);
      const float inv_l = 1.f / l_s[g];
      TQ* o = out + ((size_t)s * H + (size_t)j * G + g) * HD + d0;
      store_out(o, acc[r][0] * inv_l);
      store_out(o + 1, acc[r][1] * inv_l);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *pt, *lens;
  void* out;
  int S, H, Hkv, P, ps, Pb;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int HD>
int launch(const Args& a) {
  const size_t smem = smem_bytes(sizeof(TC), HD, a.ps);
  auto kernel = legacy_decode_kernel<TQ, TC, HD>;
  // the opt-in is per kernel and grows only: set once per larger size, so
  // a steady caller (or a CUDA graph capture) makes no runtime call here
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid(a.S, a.Hkv);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
      static_cast<const TC*>(a.v), a.ks, a.vs, a.pt, a.lens,
      static_cast<TQ*>(a.out), a.H, a.Hkv, a.P, a.ps, a.Pb, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32:
      return launch<TQ, TC, 32>(a);
    case 64:
      return launch<TQ, TC, 64>(a);
    case 128:
      return launch<TQ, TC, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (out has q's type). cache_dtype: 0 =
// float32, 1 = bfloat16 (both equal to q_dtype), 2 = int8 (k_scale and
// v_scale non-null).
extern "C" int legacy_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_lens, void* out, int S, int H, int Hkv, int P, int ps,
    int hd, int Pb, float scale, int q_dtype, int cache_dtype, void* stream) {
  if (S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > G_MAX || ps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = cache_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(kv_lens), out, S, H, Hkv, P, ps, Pb,
               scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0) return dispatch_hd<float, float>(hd, a);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a);
  if (q_dtype == 0 && quant) return dispatch_hd<float, int8_t>(hd, a);
  if (q_dtype == 1 && quant) return dispatch_hd<__nv_bfloat16, int8_t>(hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
