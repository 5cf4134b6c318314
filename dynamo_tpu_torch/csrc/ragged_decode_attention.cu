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
// Design (simple and correct first):
// - Grid (S, Hkv): one block per (row, kv head). The TPU kernel put all kv
//   heads of a row in one program because its grid runs in order on one
//   core; on Hopper every (row, head) pair is independent work for an SM.
// - The block loads its own lens[s] and walks the row's page table itself,
//   CH = 32 tokens at a time. A chunk's K and V rows travel global memory ->
//   registers as 16-byte vector loads (the next chunk's loads are issued
//   before the current chunk's math, so their latency hides behind it) ->
//   shared memory, widened to f32: 2 x 32 x hd x 4 B = 32 KB at hd = 128,
//   under the 48 KB static limit whatever the cache dtype (a whole f32 page
//   of 64 tokens would need 64 KB and a dynamic-shared-memory opt-in;
//   half-page chunks do not). K rows are padded by one float so the
//   per-lane dot products hit distinct banks.
// - Tokens at or past lens[s] are never loaded: their K and V are SELECTED to
//   0 (recycled page tails may hold NaN, and 0 * NaN is NaN) and their scores
//   to -1e30. An empty row (lens == 0) walks one fully masked page, as the
//   TPU kernel does: its m stays -1e30 (so combine_self_attention returns
//   exactly the new token's value row) and its l is ps. Lanes past the
//   walked tokens add nothing to l.
// - Online softmax in f32: warp w owns query heads w, w + 4, ...; each lane
//   scores one token of the chunk, and the warp reduces max and sum with
//   shuffles. The accumulator is spread over the block's 128 threads, one
//   register per (head, lane of hd) pair. q is prescaled by hd**-0.5, passed
//   from the wrapper so it is the same f32 constant as the plain version's.
//
// Bound: the kernel must read the valid KV bytes once,
//   sum_s lens[s] * Hkv * hd * 2 * sizeof(cache dtype)  per layer,
// over the card's 3.35 TB/s; its operations (4 * sum_s lens[s] * H * hd) are
// far below the compute roof. The design reads each valid K/V row exactly
// once, straight from the paged cache: there is no gathered copy of the KV
// prefix in device memory (the 2-3x traffic of a gather-then-attend
// decode). What keeps it from that bound: S * Hkv blocks (64 at S = 8) fill
// half the SMs, one chunk is in flight per block, and the f32 math reads
// shared memory twice per multiply-add. Split-KV blocks, a cp.async/TMA
// ring and tensor-core dots are later work.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

template <typename T, int HD>
__global__ void __launch_bounds__(NT) ragged_decode_kernel(
    const T* __restrict__ q,            // [S, H, HD]
    const T* __restrict__ k_cache,      // [L, Hkv, P, ps, HD]
    const T* __restrict__ v_cache,
    const int* __restrict__ page_table,  // [S, Pb]
    const int* __restrict__ lens,        // [S]
    float* __restrict__ acc_out,         // [S, H, HD]
    float* __restrict__ m_out,           // [S, H]
    float* __restrict__ l_out,           // [S, H]
    int H, int Hkv, int P, int ps, int Pb, int layer, float scale) {
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
  const size_t head_off = ((size_t)layer * Hkv + j) * (size_t)P * page_elems;
  const T* k_head = k_cache + head_off;
  const T* v_head = v_cache + head_off;
  const int* pt = page_table + (size_t)s * Pb;

  // K/V rows of one chunk travel global -> registers (16-byte loads, the
  // next chunk's issued before the current chunk's math) -> shared memory
  constexpr int VEC = Vec16<T>::N;
  constexpr int VPR = HD / VEC;              // vectors per token row
  constexpr int NV = CH * VPR / NT;          // vectors per thread per chunk
  static_assert(CH * VPR % NT == 0, "chunk must split evenly over threads");
  uint4 kr[NV], vr[NV];
  auto load_chunk = [&](int t0) {
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      const int i = tid + r * NT;
      const int t = t0 + i / VPR;
      kr[r] = make_uint4(0u, 0u, 0u, 0u);  // masked tokens are selected to 0
      vr[r] = make_uint4(0u, 0u, 0u, 0u);
      if (t < len) {
        const size_t off = (size_t)pt[t / ps] * page_elems +
                           (size_t)(t % ps) * HD + (i % VPR) * VEC;
        kr[r] = *reinterpret_cast<const uint4*>(k_head + off);
        vr[r] = *reinterpret_cast<const uint4*>(v_head + off);
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
      const int c = i / VPR, d0 = (i % VPR) * VEC;
      float kf[VEC], vf[VEC];
      Vec16<T>::unpack(kr[r], kf);
      Vec16<T>::unpack(vr[r], vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[c][d0 + e] = kf[e];
        v_s[c][d0 + e] = vf[e];
      }
    }
    __syncthreads();
    if (t0 + CH < n_tok) load_chunk(t0 + CH);  // in flight during the math

#pragma unroll
    for (int gi = 0; gi < HEADS_PER_WARP; ++gi) {
      const int g = warp + gi * NWARP;
      if (g < G) {  // warp-uniform
        float sc = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < HD; ++dd) sc += q_s[g][dd] * k_s[lane][dd];
        sc = (t0 + lane < len) ? sc : NEG_INF;
        const float m_new = fmaxf(m_w[gi], warp_max(sc));
        const float alpha = expf(m_w[gi] - m_new);
        const float p = (t0 + lane < n_tok) ? expf(sc - m_new) : 0.f;
        l_w[gi] = l_w[gi] * alpha + warp_sum(p);
        m_w[gi] = m_new;
        p_s[g][lane] = p;
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* lens, float* acc, float* m, float* l, int S, int H,
           int Hkv, int P, int ps, int Pb, int layer, float scale,
           cudaStream_t stream) {
  dim3 grid(S, Hkv);
  ragged_decode_kernel<T, HD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, acc, m, l, H, Hkv, P, ps, Pb, layer,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* pt, const int* lens, float* acc, float* m,
                float* l, int S, int H, int Hkv, int P, int ps, int Pb,
                int layer, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, pt, lens, acc, m, l, S, H, Hkv, P, ps, Pb,
                           layer, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, pt, lens, acc, m, l, S, H, Hkv, P, ps, Pb,
                           layer, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, pt, lens, acc, m, l, S, H, Hkv, P, ps,
                            Pb, layer, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and both caches share it).
extern "C" int ragged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* page_table, const void* lens, void* acc, void* m, void* l,
    int S, int H, int Hkv, int P, int ps, int hd, int Pb, int layer,
    float scale, int dtype, void* stream) {
  if (S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > G_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lens);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_cache, v_cache, pt, ln, a, mm, ll, S, H,
                              Hkv, P, ps, Pb, layer, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, pt, ln, a, mm,
                                      ll, S, H, Hkv, P, ps, Pb, layer, scale,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}
