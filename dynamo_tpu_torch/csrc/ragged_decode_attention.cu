// Paged decode attention for one query token per sequence row, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ragged_decode_kernel`
// (dynamo_tpu/ops/paged_attention.py:88, built by `ragged_decode_attention`).
// It computes what that kernel computes: for row s, the first lens[s] tokens
// of the row's pages in cache[layer] ([L, Hkv, P, ps, hd]), attended by the
// G = H / Hkv query heads of each kv head, returned as the UNNORMALISED flash
// state acc [S, H, hd] f32, m [S, H] f32, l [S, H] f32. Consumers pick the
// mode: prefix rows fold the current token with combine_self_attention,
// inclusive rows divide by l (dynamo_tpu_torch/ops/paged_attention.py).
//
// Cache types: f32 or bf16 pages with a q of the same type, or int8 pages
// (kv_quant="int8") with an f32 or bf16 q and one f32 scale per cached row,
// k_scale / v_scale [L, Hkv, P, ps]. The int8 mode is the TPU kernel's scale
// fold (paged_attention.py:195-196, :209): a row's scale is constant over the
// hd contraction, so score = (q . k_int8) * s_k, and V's scale moves into the
// probability operand of the accumulator product, p * s_v, while l sums the
// bare p. No dequantised page is ever formed.
//
// Design (simple and correct first):
// - Grid (S, Hkv): one block per (row, kv head). The TPU kernel put all kv
//   heads of a row in one program because its grid runs in order on one
//   core; on Hopper every (row, head) pair is independent work for an SM.
// - The block loads its own lens[s] and walks the row's page table itself,
//   CH = 32 tokens at a time. A chunk's K and V rows travel global memory ->
//   registers as 16-byte vector loads (4 f32, 8 bf16 or 16 int8 values; a
//   row is hd * size bytes, at least 32, so no load straddles two rows; the
//   next chunk's loads are issued before the current chunk's math, so their
//   latency hides behind it) -> shared memory, widened to f32: 2 x 32 x hd
//   x 4 B = 32 KB at hd = 128, under the 48 KB static limit whatever the
//   cache dtype (a whole f32 page of 64 tokens would need 64 KB and a
//   dynamic-shared-memory opt-in; half-page chunks do not). K rows are
//   padded by one float so the per-lane dot products hit distinct banks.
//   In the int8 mode each lane also loads its token's two scales, through
//   the page table, with the chunk's prefetch: unlike the TPU kernel there
//   is no gather of scale blocks outside the kernel.
// - Tokens at or past lens[s] are never loaded: their K and V, and in the
//   int8 mode their scales, are SELECTED to 0 (recycled page tails may hold
//   NaN, and 0 * NaN is NaN; a stale scale times p = 0 is harmless only if
//   it is finite) and their scores to -1e30. An empty row (lens == 0) walks
//   one fully masked page, as the TPU kernel does: its m stays -1e30 (so
//   combine_self_attention returns exactly the new token's value row) and
//   its l is ps. Lanes past the walked tokens add nothing to l.
// - Online softmax in f32: warp w owns query heads w, w + 4, ...; each lane
//   scores one token of the chunk, and the warp reduces max and sum with
//   shuffles. The accumulator is spread over the block's 128 threads, one
//   register per (head, lane of hd) pair. q is prescaled by hd**-0.5, passed
//   from the wrapper so it is the same f32 constant as the plain version's.
//
// Bound: the kernel must read the valid KV bytes once,
//   sum_s lens[s] * Hkv * (hd * 2 * sizeof(cache dtype) + 2 * 4 if int8)
// per layer, over the card's 3.35 TB/s; its operations (4 * sum_s lens[s] *
// H * hd) are far below the compute roof. The design reads each valid K/V
// row exactly once, straight from the paged cache: there is no gathered
// copy of the KV prefix in device memory (the 2-3x traffic of a
// gather-then-attend decode). What keeps it from that bound: S * Hkv blocks
// (64 at S = 8) fill half the SMs, one chunk is in flight per block, and the
// f32 math reads shared memory twice per multiply-add. Split-KV blocks, a
// cp.async/TMA ring and tensor-core dots are later work.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 128;           // threads per block
constexpr int NWARP = NT / 32;
constexpr int CH = 32;            // tokens per staged chunk: one per lane
constexpr int G_MAX = 8;          // query heads per kv head
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A 16-byte vector of cache elements, widened to f32 exactly: f32 words
// are reinterpreted, each bf16 half-word is the top half of an f32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// int8: each byte of a word, sign-extended, is one value
template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        o[4 * i + b] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// TQ: q's type (float or bf16); TC: the cache's (TQ itself, or int8 with
// per-row scales).
template <typename TQ, typename TC, int HD>
__global__ void __launch_bounds__(NT) ragged_decode_kernel(
    const TQ* __restrict__ q,            // [S, H, HD]
    const TC* __restrict__ k_cache,      // [L, Hkv, P, ps, HD]
    const TC* __restrict__ v_cache,
    const float* __restrict__ k_scale,   // [L, Hkv, P, ps] (int8 only)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_table,  // [S, Pb]
    const int* __restrict__ lens,        // [S]
    float* __restrict__ acc_out,         // [S, H, HD]
    float* __restrict__ m_out,           // [S, H]
    float* __restrict__ l_out,           // [S, H]
    int H, int Hkv, int P, int ps, int Pb, int layer, float scale) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  constexpr int HEADS_PER_WARP = G_MAX / NWARP;
  __shared__ float q_s[G_MAX][HD];
  __shared__ float k_s[CH][HD + 1];
  __shared__ float v_s[CH][HD];
  __shared__ float p_s[G_MAX][CH];
  __shared__ float alpha_s[G_MAX];

  const int s = blockIdx.x;
  const int j = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = to_f32(q[((size_t)s * H + (size_t)j * G + g) * HD + d]) * scale;
  }

  // valid tokens of this row, clamped to what its page table can address
  const int len = min(max(lens[s], 0), Pb * ps);
  const int n_tok = len > 0 ? len : ps;  // an empty row walks one page
  const size_t page_elems = (size_t)ps * HD;
  const size_t head_page0 = ((size_t)layer * Hkv + j) * (size_t)P;
  const TC* k_head = k_cache + head_page0 * page_elems;
  const TC* v_head = v_cache + head_page0 * page_elems;
  const int* pt = page_table + (size_t)s * Pb;

  // K/V rows of one chunk travel global -> registers (16-byte loads, the
  // next chunk's issued before the current chunk's math) -> shared memory
  constexpr int VEC = Vec16<TC>::N;
  constexpr int VPR = HD / VEC;              // vectors per token row
  constexpr int NVEC = CH * VPR;             // vectors per chunk
  constexpr int NV = (NVEC + NT - 1) / NT;   // vectors per thread per chunk
  static_assert(HD % VEC == 0, "a row must split into 16-byte vectors");
  uint4 kr[NV], vr[NV];
  float skr = 0.f, svr = 0.f;  // int8: scales of token t0 + lane
  auto load_chunk = [&](int t0) {
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      const int i = tid + r * NT;
      const int t = t0 + i / VPR;
      kr[r] = make_uint4(0u, 0u, 0u, 0u);  // masked tokens are selected to 0
      vr[r] = make_uint4(0u, 0u, 0u, 0u);
      if (i < NVEC && t < len) {
        const size_t off = (size_t)pt[t / ps] * page_elems +
                           (size_t)(t % ps) * HD + (i % VPR) * VEC;
        kr[r] = *reinterpret_cast<const uint4*>(k_head + off);
        vr[r] = *reinterpret_cast<const uint4*>(v_head + off);
      }
    }
    if constexpr (QUANT) {
      const int t = t0 + lane;
      skr = 0.f;  // scales past lens may be stale: selected to 0 as well
      svr = 0.f;
      if (t < len) {
        const size_t row = (head_page0 + pt[t / ps]) * (size_t)ps + t % ps;
        skr = k_scale[row];
        svr = v_scale[row];
      }
    }
  };

  // accumulator: this thread owns lane d of heads g0, g0 + GSTEP, ...
  constexpr int PAIRS = G_MAX * HD / NT;
  constexpr int GSTEP = NT / HD;
  const int d = tid % HD;
  const int g0 = tid / HD;
  float acc[PAIRS];
#pragma unroll
  for (int r = 0; r < PAIRS; ++r) acc[r] = 0.f;
  float m_w[HEADS_PER_WARP], l_w[HEADS_PER_WARP];
#pragma unroll
  for (int gi = 0; gi < HEADS_PER_WARP; ++gi) {
    m_w[gi] = NEG_INF;
    l_w[gi] = 0.f;
  }

  load_chunk(0);
  for (int t0 = 0; t0 < n_tok; t0 += CH) {
    __syncthreads();  // q_s written / previous chunk fully consumed
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      const int i = tid + r * NT;
      if (i < NVEC) {
        const int c = i / VPR, d0 = (i % VPR) * VEC;
        float kf[VEC], vf[VEC];
        Vec16<TC>::unpack(kr[r], kf);
        Vec16<TC>::unpack(vr[r], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          k_s[c][d0 + e] = kf[e];
          v_s[c][d0 + e] = vf[e];
        }
      }
    }
    const float sk = skr, sv = svr;  // this chunk's scales (int8 mode)
    __syncthreads();
    if (t0 + CH < n_tok) load_chunk(t0 + CH);  // in flight during the math

#pragma unroll
    for (int gi = 0; gi < HEADS_PER_WARP; ++gi) {
      const int g = warp + gi * NWARP;
      if (g < G) {  // warp-uniform
        float sc = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < HD; ++dd) sc += q_s[g][dd] * k_s[lane][dd];
        if (QUANT) sc *= sk;  // K dequant fold, before the mask
        sc = (t0 + lane < len) ? sc : NEG_INF;
        const float m_new = fmaxf(m_w[gi], warp_max(sc));
        const float alpha = expf(m_w[gi] - m_new);
        const float p = (t0 + lane < n_tok) ? expf(sc - m_new) : 0.f;
        l_w[gi] = l_w[gi] * alpha + warp_sum(p);
        m_w[gi] = m_new;
        p_s[g][lane] = QUANT ? p * sv : p;  // V dequant fold
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const int g = g0 + r * GSTEP;
      if (g < G) acc[r] *= alpha_s[g];
    }
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      const float vv = v_s[c][d];
#pragma unroll
      for (int r = 0; r < PAIRS; ++r) {
        const int g = g0 + r * GSTEP;
        if (g < G) acc[r] += p_s[g][c] * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < PAIRS; ++r) {
    const int g = g0 + r * GSTEP;
    if (g < G) acc_out[((size_t)s * H + (size_t)j * G + g) * HD + d] = acc[r];
  }
#pragma unroll
  for (int gi = 0; gi < HEADS_PER_WARP; ++gi) {
    const int g = warp + gi * NWARP;
    if (g < G && lane == 0) {
      m_out[(size_t)s * H + (size_t)j * G + g] = m_w[gi];
      l_out[(size_t)s * H + (size_t)j * G + g] = l_w[gi];
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *pt, *lens;
  float *acc, *m, *l;
  int S, H, Hkv, P, ps, Pb, layer;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int HD>
int launch(const Args& a) {
  dim3 grid(a.S, a.Hkv);
  ragged_decode_kernel<TQ, TC, HD><<<grid, NT, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
      static_cast<const TC*>(a.v), a.ks, a.vs, a.pt, a.lens, a.acc, a.m, a.l,
      a.H, a.Hkv, a.P, a.ps, a.Pb, a.layer, a.scale);
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

// q_dtype: 0 = float32, 1 = bfloat16. cache_dtype: 0 = float32, 1 =
// bfloat16 (both equal to q_dtype), 2 = int8 (k_scale and v_scale non-null).
extern "C" int ragged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lens, void* acc, void* m, void* l, int S, int H, int Hkv,
    int P, int ps, int hd, int Pb, int layer, float scale, int q_dtype,
    int cache_dtype, void* stream) {
  if (S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > G_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = cache_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(lens), static_cast<float*>(acc),
               static_cast<float*>(m), static_cast<float*>(l), S, H, Hkv, P,
               ps, Pb, layer, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0) return dispatch_hd<float, float>(hd, a);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a);
  if (q_dtype == 0 && quant) return dispatch_hd<float, int8_t>(hd, a);
  if (q_dtype == 1 && quant) return dispatch_hd<__nv_bfloat16, int8_t>(hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
