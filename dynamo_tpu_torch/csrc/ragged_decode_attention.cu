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
// hd contraction, so score = (q . k_int8) * s_k before the mask, and V's
// scale moves into the probability operand of the accumulator product,
// p * s_v, while l sums the bare p. No dequantised page is ever formed.
//
// Semantics: tokens at or past lens[s] count as K = V = 0 (and scales 0)
// with score -1e30; recycled page tails may hold NaN, so they are never
// loaded: the ring's copy zero-fills them. A row walks max(ceil(len / ps), 1)
// whole pages, so an empty row walks one masked page and ends with m = -1e30,
// l = ps and acc = 0, as the TPU kernel's. lens is clamped to Pb * ps.
//
// Bound: the call must read the valid K/V bytes once,
//   sum_s lens[s] * Hkv * 2 * (hd * sizeof(cache type) + 4 if int8),
// over the card's 3.35 TB/s; its operations (4 * sum_s lens[s] * H * hd)
// are far below the tensor-core roof. At the main path's shapes (8 rows of
// 137-632 tokens, llama3-8b heads, bf16) that is 12.6 MB, 0.0038 ms: close
// to the launch latency, so there the schedule's latency is what counts; at
// 8 rows of 1536-2048 tokens it is ~59 MB, ~0.018 ms (int8: ~31 MB).
//
// The earlier schedule (one block per (row, kv head), 64 blocks at 8 rows,
// each walking its row 32 tokens at a time with three __syncthreads, an f32
// widening store and one chunk in flight; f32 dots out of shared memory;
// each lane's two int8 scales loaded through the page table) ran at 19x
// (bf16) and 40x (int8) its bound. This one:
// 1. Split-KV over whole pages (ragged_split_kernel). Grid (splits, Hkv, S):
//    block (i, j, s) attends pages [i * pps, (i + 1) * pps) of row s for the
//    G query heads of kv head j and writes that run's flash state to scratch
//    (or straight to the outputs when there is one split). The host picks
//    pps from shapes only (Pb, S, Hkv, the SM count; ops/paged_attention.py
//    _pages_per_split), never from lens, so the call needs no host sync and
//    stays capturable in a CUDA graph. A block whose first page is at or
//    past the row's walked pages writes the neutral state m = -1e30, l = 0,
//    acc = 0 and exits (never -inf, so the merge never computes -inf - -inf).
// 2. The merge (merge_splits_kernel), one warp per (row, head): m = max m_i,
//    l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m). An empty row's
//    split 0 holds l = ps with m = -1e30 and every other split l = 0, so the
//    merged l is ps exactly. It is a programmatic dependent launch: its
//    blocks start during the split kernel's last wave and wait there for
//    its results, so its launch hides behind the split kernel's tail.
// Inside a split block:
// - An asynchronous ring of NS = 3 stages in dynamic shared memory. A stage
//   is CT tokens of K and V (CT = 64, one page at ps 64, for bf16 and int8;
//   32, half a page, for f32) in the cache's own type, copied with 16-byte
//   cp.async, plus the int8 scales of those tokens (the 256 contiguous bytes
//   of a page's scales travel with it through the same ring, not through
//   the page table per lane). Tokens at or past lens are zero-filled by the
//   copy (source size 0). Two stages stay in flight during the current
//   one's math; one __syncthreads per stage. The split's page ids are loaded
//   into shared memory once, beside lens; when CT divides ps a stage is one
//   page slice and its rows need one page-table read. Rows are padded by 16
//   bytes so the tensor-core operand loads hit 32 distinct banks.
// - One warp per 8 tokens of a stage (8 warps, 4 for f32), each keeping its
//   own online-softmax state (m, l, acc), so a stage needs no cross-warp
//   exchange; the warp states merge once at the end of the block.
// - Scores for a bf16 q: mma.sync.m16n8k16 (bf16 operands, f32 accumulate),
//   the G <= 8 query heads of the kv head as rows 0..G-1 of a 16-row A tile
//   (its fragments in shared memory), the warp's 8 K rows as the B tile.
//   int8 K converts exactly to bf16 (|x| <= 128; by a byte permute and an
//   f32 subtract, not the quarter-rate I2F), so the int8 mode shares the
//   product and its s_k multiplies the f32 score. hd^-0.5 multiplies the
//   f32 score, so q is not rounded a second time. For an f32 q (f32 caches,
//   or int8 with an f32 q) the same lanes compute the same scores as f32
//   dot products on the CUDA cores, from a prescaled f32 copy of q.
// - P.V for a bf16 cache: mma.sync.m16n8k8. The lane's probabilities are its
//   A fragment as they stand (the score tile's C layout), split into a bf16
//   hi part and a bf16 lo part (two products), so P keeps ~16 bits and the
//   f32 state stays within the plain version's tolerance; V's B fragments
//   come from ldmatrix.trans. For an int8 cache or an f32 q, P.V is f32
//   FMAs: lane d owns hd / 32 lanes of every head's accumulator, reading V
//   in the cache's type and the probabilities (times s_v) as broadcasts.
// What still holds it back: at the main path's shapes a block walks 1-2
// stages, so the call is two launches plus a ring fill. At the full context
// the copies with each block's prologue and the merge take most of the
// time, and the math is not fully hidden behind them: the int8 mode spends
// it converting int8 to bf16 and f32 on the CUDA cores. A TMA producer
// warp, a warpgroup product and an int8 P.V on the tensor cores are the
// next steps.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launches, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NS = 3;     // ring stages
constexpr int G_MAX = 8;  // query heads per kv head
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // 227 KB a block may opt in to

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

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte k of a word of int8 values, each biased by 128 (w ^ 0x80808080), as
// an exact f32 without the quarter-rate I2F: 0x4B0000xx is 2^23 + xx
__device__ __forceinline__ float i8_to_f32(unsigned biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + k)) -
         8388736.f;  // 2^23 + 128
}

// N consecutive cache elements from shared memory, widened to f32 exactly
// (f32 words reinterpreted, bf16 as the top half of an f32, int8 sign-
// extended); one load of N * sizeof(T) bytes
template <typename T, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float* o) {
  constexpr int B = N * static_cast<int>(sizeof(T));
  unsigned w[(B + 3) / 4];
  if constexpr (B == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (B == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (B == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    static_assert(B == 1, "1, 2, 4, 8 or 16 bytes");
    w[0] = *p;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (std::is_same<T, float>::value) {
      o[e] = __uint_as_float(w[e]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      o[e] = __uint_as_float((e & 1) ? (w[e / 2] & 0xffff0000u)
                                     : (w[e / 2] << 16));
    } else {
      o[e] = i8_to_f32(w[e / 4] ^ 0x80808080u, e % 4);
    }
  }
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// hd position of the first of the two elements in A/B fragment register h
// (0: k slots 2 tig, 2 tig + 1; 1: slots 2 tig + 8, 2 tig + 9) of k-step
// kk. bf16 K keeps the natural order; int8 K permutes the 16 positions of a
// step so that a lane's four K bytes are one 32-bit shared-memory load.
// q's A fragment takes the same positions, so the dot product is the same.
template <typename T>
__device__ __forceinline__ int k_pos(int kk, int h, int tig) {
  return std::is_same<T, int8_t>::value ? kk * 16 + 4 * tig + 2 * h
                                        : kk * 16 + 8 * h + 2 * tig;
}

// the B fragment (b0, b1) of k-step kk for the K row at kr, as bf16x2;
// int8 values convert to bf16 exactly
template <typename T>
__device__ __forceinline__ void k_frag(const unsigned char* kr, int kk,
                                       int tig, unsigned& b0, unsigned& b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    b0 = *reinterpret_cast<const unsigned*>(kr + 2 * k_pos<T>(kk, 0, tig));
    b1 = *reinterpret_cast<const unsigned*>(kr + 2 * k_pos<T>(kk, 1, tig));
  } else {
    const unsigned w =
        *reinterpret_cast<const unsigned*>(kr + k_pos<T>(kk, 0, tig)) ^
        0x80808080u;
    b0 = bf16x2(i8_to_f32(w, 0), i8_to_f32(w, 1));
    b1 = bf16x2(i8_to_f32(w, 2), i8_to_f32(w, 3));
  }
}

// D = A . B + D, m16n8k16, bf16 operands, f32 accumulate; A rows 8-15 are 0
__device__ __forceinline__ void mma_bf16(float* d, unsigned a0, unsigned a2,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// (d0, d1) += A . B, m16n8k8, bf16 operands, f32 accumulate: A rows 8-15
// are 0, so only the C fragment's row gid (d0, d1) is kept
__device__ __forceinline__ void mma_k8(float& d0, float& d1, unsigned a0,
                                       unsigned b0) {
  float j2, j3;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(j2), "=f"(j3)
      : "r"(a0), "r"(0u), "r"(b0), "f"(d0), "f"(d1), "f"(0.f), "f"(0.f));
}

// four 8x8 bf16 tiles of shared memory, transposed: lane i gives the
// address of row i % 8 of tile i / 8
__device__ __forceinline__ void ldmatrix_t4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Shared memory of one block, in bytes: the ring, the warps' probabilities
// and rescale factors (CUDA-core P.V), q (its A fragments, or its f32 copy)
// and the split's page ids. ops/paged_attention.py _ring_smem_bytes mirrors
// it.
template <typename TQ, typename TC, int HD>
struct Layout {
  static constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  static constexpr bool MMA = std::is_same<TQ, __nv_bfloat16>::value;
  static constexpr int CT = sizeof(TC) == 4 ? 32 : 64;  // tokens per stage
  static constexpr int WT = 8;            // tokens per warp: one mma n-tile
  static constexpr int NWARP = CT / WT;
  static constexpr int NT = 32 * NWARP;   // threads per block
  static constexpr int ROW = HD * static_cast<int>(sizeof(TC)) + 16;
  static constexpr int KV = CT * ROW;  // bytes of K (or V) in a stage
  static constexpr int STAGE = 2 * KV + (QUANT ? 2 * CT * 4 : 0);
  static constexpr int RING = NS * STAGE;
  static constexpr int P_S = NWARP * G_MAX * WT * 4;
  static constexpr int A_S = NWARP * G_MAX * 4;
  // q: its A fragments (bf16 q), or an f32 copy prescaled by hd^-0.5
  static constexpr int Q_S = MMA ? HD / 16 * 2 * 32 * 4 : G_MAX * (HD + 4) * 4;
  static constexpr int FIXED = RING + P_S + A_S + Q_S;
  static_assert(NWARP * G_MAX * (HD + 2) * 4 <= RING,
                "the warp states' merge reuses the ring");
  static_assert(STAGE % 16 == 0 && FIXED % 16 == 0, "16-byte alignment");
  static size_t bytes(int pps) {
    return FIXED + ((static_cast<size_t>(pps) * 4 + 15) / 16) * 16;
  }
};

// TQ: q's type (float or bf16); TC: the cache's (TQ itself, or int8 with
// per-row scales).
template <typename TQ, typename TC, int HD>
__global__ void __launch_bounds__(Layout<TQ, TC, HD>::NT) ragged_split_kernel(
    const TQ* __restrict__ q,            // [S, H, HD]
    const TC* __restrict__ k_cache,      // [L, Hkv, P, ps, HD]
    const TC* __restrict__ v_cache,
    const float* __restrict__ k_scale,   // [L, Hkv, P, ps] (int8 only)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_table,  // [S, Pb]
    const int* __restrict__ lens,        // [S]
    float* __restrict__ acc_out,         // [splits, S, H, HD]
    float* __restrict__ m_out,           // [splits, S, H]
    float* __restrict__ l_out,           // [splits, S, H]
    int S, int H, int Hkv, int P, int ps, int Pb, int pps, int layer,
    float scale) {
  using Lay = Layout<TQ, TC, HD>;
  constexpr bool QUANT = Lay::QUANT, MMA = Lay::MMA;
  constexpr bool PV_MMA = MMA && !QUANT;  // P.V on the tensor cores
  // q's A fragments live in shared memory where the P.V product needs the
  // registers, and in registers otherwise
  constexpr bool Q_REGS = MMA && !PV_MMA;
  constexpr int CT = Lay::CT, WT = Lay::WT, NWARP = Lay::NWARP, NT = Lay::NT;
  constexpr int ROW = Lay::ROW;
  constexpr int DPL = HD / 32;  // accumulator lanes of hd per thread
  constexpr int ESZ = static_cast<int>(sizeof(TC));

  // the merge kernel may launch now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, j = blockIdx.y, s = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const size_t row_out = ((size_t)split * S + s) * H + (size_t)j * G;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* p_s = reinterpret_cast<float*>(smem + Lay::RING);  // [NWARP][G_MAX][WT]
  float* a_s = p_s + NWARP * G_MAX * WT;                    // [NWARP][G_MAX]
  float* q_s = a_s + NWARP * G_MAX;  // [HD/16][2][32] or [G_MAX][HD + 4]
  int* pid_s = reinterpret_cast<int*>(q_s + (Lay::Q_S / 4));  // [pps]

  // the split's page ids (loaded beside lens, not after it) and the row's
  // valid tokens, clamped to what its page table can address; an empty row
  // walks one masked page
  const int p0 = split * pps;
  for (int i = tid; i < min(pps, Pb - p0); i += NT)
    pid_s[i] = page_table[(size_t)s * Pb + p0 + i];
  const int len = min(max(lens[s], 0), Pb * ps);
  const int n_pages = len > 0 ? (len + ps - 1) / ps : 1;
  if (p0 >= n_pages) {  // past the walked pages: the neutral state
    for (int i = tid; i < G * HD; i += NT) acc_out[row_out * HD + i] = 0.f;
    if (tid < G) {
      m_out[row_out + tid] = NEG_INF;
      l_out[row_out + tid] = 0.f;
    }
    return;
  }
  const int p1 = min(p0 + pps, n_pages);
  const int t0 = p0 * ps;           // the split walks tokens [t0, t_end)
  const int t_end = p1 * ps;
  const int t_lim = min(t_end, len);  // and reads [t0, t_lim)
  const int n_chunks = (t_end - t0 + CT - 1) / CT;

  __syncthreads();  // page ids written

  const size_t head_page0 = ((size_t)layer * Hkv + j) * (size_t)P;
  const unsigned char* k_head = reinterpret_cast<const unsigned char*>(
      k_cache + head_page0 * (size_t)ps * HD);
  const unsigned char* v_head = reinterpret_cast<const unsigned char*>(
      v_cache + head_page0 * (size_t)ps * HD);

  // chunk c (tokens t0 + c * CT ...) -> stage c % NS; always one commit
  constexpr int VPR = HD * ESZ / 16;  // 16-byte vectors per token row
  const bool one_page = ps % CT == 0;
  auto load_stage = [&](int c) {
    if (c < n_chunks) {
      unsigned char* kb = ring + (c % NS) * Lay::STAGE;
      unsigned char* vb = kb + Lay::KV;
      const int tc0 = t0 + c * CT;
      // the cache row of token t (-1 past what the split reads); when CT
      // divides ps a stage lies in one page: one page-table read a stage
      const int rel = tc0 - t0;
      const long long row0 =
          one_page ? (long long)pid_s[rel / ps] * ps + rel % ps : 0;
      auto cache_row = [&](int r) -> long long {
        const int t = tc0 + r;
        if (t >= t_lim) return -1;
        return one_page ? row0 + r
                        : (long long)pid_s[(t - t0) / ps] * ps + t % ps;
      };
#pragma unroll 2
      for (int u = tid; u < CT * VPR; u += NT) {
        const int r = u / VPR, x = u % VPR;
        const long long row = cache_row(r);
        const size_t off =
            row < 0 ? 0 : (size_t)row * (HD * ESZ) + (size_t)x * 16;
        copy16(kb + r * ROW + x * 16, k_head + off, row < 0 ? 0 : 16);
        copy16(vb + r * ROW + x * 16, v_head + off, row < 0 ? 0 : 16);
      }
      if constexpr (QUANT) {
        float* skb = reinterpret_cast<float*>(vb + Lay::KV);
        for (int r = tid; r < CT; r += NT) {
          const long long row = cache_row(r);
          const size_t i = head_page0 * ps + (row < 0 ? 0 : (size_t)row);
          copy4(skb + r, k_scale + i, row < 0 ? 0 : 4);
          copy4(skb + CT + r, v_scale + i, row < 0 ? 0 : 4);
        }
      }
    }
    copy_commit();
  };

  // the accumulator. bf16 cache: C fragments of the P.V product, n-tile nt
  // holding head gid at hd lanes 8 nt + 2 tig + i, i = 0, 1. Otherwise
  // lane d owns hd lanes d * DPL .. of every head.
  constexpr int NTL = HD / 8;
  float acc[PV_MMA ? NTL : G_MAX][PV_MMA ? 2 : DPL];
#pragma unroll
  for (int g = 0; g < (PV_MMA ? NTL : G_MAX); ++g)
#pragma unroll
    for (int e = 0; e < (PV_MMA ? 2 : DPL); ++e) acc[g][e] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;  // head gid's, over this warp's tokens
  float* pw = p_s + warp * G_MAX * WT;
  float* aw = a_s + warp * G_MAX;
  const int rb = warp * WT;  // this warp's first row of a stage

#pragma unroll
  for (int c = 0; c < NS - 1; ++c) load_stage(c);

  // q, while the first stages are in flight (the loop's first barrier
  // publishes it)
  const TQ* q_row = q + ((size_t)s * H + (size_t)j * G) * HD;
  // bf16 q: the A fragment registers of k-step kk, (kk, h, lane) -> q_s
  unsigned* qf_s = reinterpret_cast<unsigned*>(q_s);
  if constexpr (MMA) {
    const unsigned short* qh = reinterpret_cast<const unsigned short*>(q_row);
    for (int i = tid; i < HD / 16 * 2 * 32; i += NT) {
      const int kk = i / 64, h = (i / 32) % 2, l = i % 32;
      const int g = l >> 2, d = k_pos<TC>(kk, h, l & 3);
      qf_s[i] = g < G ? (unsigned)qh[g * HD + d] |
                            ((unsigned)qh[g * HD + d + 1] << 16)
                      : 0u;
    }
  } else {
    for (int i = tid; i < G_MAX * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      q_s[g * (HD + 4) + d] =
          g < G ? static_cast<float>(q_row[g * HD + d]) * scale : 0.f;
    }
  }
  unsigned qa[Q_REGS ? HD / 16 : 1][2];
  if constexpr (Q_REGS) {
    __syncthreads();  // qf_s written
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = qf_s[kk * 64 + lane];
      qa[kk][1] = qf_s[kk * 64 + 32 + lane];
    }
  }
  for (int c = 0; c < n_chunks; ++c) {
    copy_wait<NS - 2>();
    __syncthreads();  // stage c landed; stage c - 1 fully consumed
    load_stage(c + NS - 1);
    const unsigned char* kb = ring + (c % NS) * Lay::STAGE;
    const unsigned char* vb = kb + Lay::KV;
    const float* skb = reinterpret_cast<const float*>(vb + Lay::KV);
    const int tc0 = t0 + c * CT;

    // scores of head gid for tokens rb + 2 tig + i (i = 0, 1)
    float sc[2];
    if constexpr (MMA) {
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* kr = kb + (rb + gid) * ROW;  // B column gid
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned b0, b1;
        k_frag<TC>(kr, kk, tig, b0, b1);
        if constexpr (Q_REGS)
          mma_bf16(d4, qa[kk][0], qa[kk][1], b0, b1);
        else
          mma_bf16(d4, qf_s[kk * 64 + lane], qf_s[kk * 64 + 32 + lane], b0,
                   b1);
      }
      sc[0] = d4[0] * scale;
      sc[1] = d4[1] * scale;
    } else {
      const float* qg = q_s + gid * (HD + 4);
      float dot0 = 0.f, dot1 = 0.f;
      if (gid < G) {
        const unsigned char* kr = kb + (rb + 2 * tig) * ROW;
#pragma unroll 2
        for (int d = 0; d < HD; d += 4) {
          float k0[4], k1[4];
          load_vals<TC, 4>(kr + d * ESZ, k0);
          load_vals<TC, 4>(kr + ROW + d * ESZ, k1);
          const float4 qv = *reinterpret_cast<const float4*>(qg + d);
          dot0 += qv.x * k0[0];
          dot0 += qv.y * k0[1];
          dot0 += qv.z * k0[2];
          dot0 += qv.w * k0[3];
          dot1 += qv.x * k1[0];
          dot1 += qv.y * k1[1];
          dot1 += qv.z * k1[2];
          dot1 += qv.w * k1[3];
        }
      }
      sc[0] = dot0;
      sc[1] = dot1;
    }

    // the K dequant fold, the mask, and the warp's online softmax for head
    // gid (the 4 lanes of a fragment row share it)
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rb + 2 * tig + i;
      float x = sc[i];
      if constexpr (QUANT) x *= skb[r];
      sc[i] = tc0 + r < t_lim ? x : NEG_INF;
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f, pv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rb + 2 * tig + i;
      // tokens past the split's walked pages add nothing
      const float p = tc0 + r < t_end && gid < G ? expf(sc[i] - m_new) : 0.f;
      psum += p;
      pv[i] = QUANT ? p * skb[CT + r] : p;  // the V dequant fold
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;

    // acc = acc * alpha + p . V over the warp's tokens
    if constexpr (PV_MMA) {
      // P (head gid, tokens 2 tig, 2 tig + 1) is this lane's A fragment as
      // it stands: split into bf16 hi + lo parts, it keeps ~16 bits
      const unsigned hi = bf16x2(pv[0], pv[1]);
      const unsigned lo = bf16x2(pv[0] - __uint_as_float(hi << 16),
                                 pv[1] - __uint_as_float(hi & 0xffff0000u));
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        acc[nt][0] *= alpha;
        acc[nt][1] *= alpha;
      }
#pragma unroll
      for (int n4 = 0; n4 < NTL; n4 += 4) {
        unsigned b[4];
        ldmatrix_t4(b, vb + (rb + (lane & 7)) * ROW +
                           (n4 + (lane >> 3)) * 8 * ESZ);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          mma_k8(acc[n4 + u][0], acc[n4 + u][1], hi, b[u]);
          mma_k8(acc[n4 + u][0], acc[n4 + u][1], lo, b[u]);
        }
      }
    } else {
      if (gid < G) {
        pw[gid * WT + 2 * tig] = pv[0];
        pw[gid * WT + 2 * tig + 1] = pv[1];
        if (tig == 0) aw[gid] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {
          const float a = aw[g];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] *= a;
        }
      }
#pragma unroll
      for (int t = 0; t < WT; t += 4) {
        float v[4][DPL];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load_vals<TC, DPL>(vb + (rb + t + u) * ROW + lane * DPL * ESZ,
                             v[u]);
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          if (g < G) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(pw + g * WT + t);
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              acc[g][e] += p4.x * v[0][e];
              acc[g][e] += p4.y * v[1][e];
              acc[g][e] += p4.z * v[2][e];
              acc[g][e] += p4.w * v[3][e];
            }
          }
        }
      }
    }
  }

  // the warp states -> the block's (the ring is free again)
  copy_wait<0>();
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(ring);  // [NWARP][G_MAX][HD]
  float* wm = wacc + NWARP * G_MAX * HD;         // [NWARP][G_MAX]
  float* wl = wm + NWARP * G_MAX;
  if constexpr (PV_MMA) {
    if (gid < G) {
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wacc[(warp * G_MAX + gid) * HD + nt * 8 + 2 * tig + i] = acc[nt][i];
    }
  } else {
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          wacc[(warp * G_MAX + g) * HD + lane * DPL + e] = acc[g][e];
      }
    }
  }
  if (tig == 0 && gid < G) {
    wm[warp * G_MAX + gid] = m_run;
    wl[warp * G_MAX + gid] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float m = wm[g];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) m = fmaxf(m, wm[w * G_MAX + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float f = expf(wm[w * G_MAX + g] - m);
      l += wl[w * G_MAX + g] * f;
      a += wacc[(w * G_MAX + g) * HD + d] * f;
    }
    acc_out[(row_out + g) * HD + d] = a;
    if (d == 0) {
      m_out[row_out + g] = m;
      l_out[row_out + g] = l;
    }
  }
}

// the splits' states [splits, S * H, (HD)] -> the rows' [S * H, (HD)]: one
// warp per (row, head), lane d owning hd / 32 lanes of acc. A programmatic
// dependent of the split kernel: it waits here for that grid's results.
template <int HD>
__global__ void __launch_bounds__(128) merge_splits_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ acc,
    float* __restrict__ m, float* __restrict__ l, int splits, int SH) {
  constexpr int DPL = HD / 32;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= SH) return;
  float mx = NEG_INF;
  for (int k = lane; k < splits; k += 32)
    mx = fmaxf(mx, part_m[(size_t)k * SH + row]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  float ls = 0.f, as[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) as[e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < splits; ++k) {
    const size_t i = (size_t)k * SH + row;
    const float f = expf(part_m[i] - mx);
    ls += part_l[i] * f;
    const float* pa = part_acc + i * HD + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) as[e] += pa[e] * f;
  }
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[(size_t)row * HD + lane * DPL + e] = as[e];
  if (lane == 0) {
    m[row] = mx;
    l[row] = ls;
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *pt, *lens;
  float *acc, *m, *l, *pacc, *pm, *pl;
  int S, H, Hkv, P, ps, Pb, pps, layer;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int HD>
int launch(const Args& a) {
  const size_t smem = Layout<TQ, TC, HD>::bytes(a.pps);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ragged_split_kernel<TQ, TC, HD>;
  // the opt-in is per kernel and grows only: set once per larger size, so
  // a steady caller (or a CUDA graph capture) makes no runtime call here
  static size_t opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const int splits = (a.Pb + a.pps - 1) / a.pps;
  const bool merge = splits > 1;
  dim3 grid(splits, a.Hkv, a.S);
  kernel<<<grid, Layout<TQ, TC, HD>::NT, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
      static_cast<const TC*>(a.v), a.ks, a.vs, a.pt, a.lens,
      merge ? a.pacc : a.acc, merge ? a.pm : a.m, merge ? a.pl : a.l, a.S,
      a.H, a.Hkv, a.P, a.ps, a.Pb, a.pps, a.layer, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.S * a.H + 3) / 4);
  cfg.blockDim = dim3(128);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t merr = cudaLaunchKernelEx(
      &cfg, merge_splits_kernel<HD>, static_cast<const float*>(a.pacc),
      static_cast<const float*>(a.pm), static_cast<const float*>(a.pl), a.acc,
      a.m, a.l, splits, a.S * a.H);
  if (merr != cudaSuccess) return static_cast<int>(merr);
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
// part_acc [splits, S, H, hd], part_m / part_l [splits, S, H] with splits =
// ceil(Pb / pages_per_split): scratch for the split states, unused (may be
// null) when splits is 1.
extern "C" int ragged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lens, void* acc, void* m, void* l, void* part_acc,
    void* part_m, void* part_l, int S, int H, int Hkv, int P, int ps, int hd,
    int Pb, int pages_per_split, int layer, float scale, int q_dtype,
    int cache_dtype, void* stream) {
  if (S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > G_MAX || ps <= 0 || Pb <= 0 ||
      pages_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = cache_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pages_per_split < Pb && (!part_acc || !part_m || !part_l))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(lens), static_cast<float*>(acc),
               static_cast<float*>(m), static_cast<float*>(l),
               static_cast<float*>(part_acc), static_cast<float*>(part_m),
               static_cast<float*>(part_l), S, H, Hkv, P, ps, Pb,
               pages_per_split, layer, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0) return dispatch_hd<float, float>(hd, a);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a);
  if (q_dtype == 0 && quant) return dispatch_hd<float, int8_t>(hd, a);
  if (q_dtype == 1 && quant) return dispatch_hd<__nv_bfloat16, int8_t>(hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
