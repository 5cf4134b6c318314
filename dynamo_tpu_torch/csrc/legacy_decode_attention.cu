// Normalised paged decode attention, the legacy decode kernel, Hopper
// (sm_90a): a row's pages spread over a thread-block cluster, the blocks'
// partial states merged in distributed shared memory inside the one launch.
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
// cache (kv_lens clamped to [1, Pb * ps]), and write the NORMALISED output
// acc / l (f32 inside, cast to q's type) into out [S, H, hd]. Caches are f32
// or bf16 with a q of the same type, or int8 (kv_quant="int8") with an f32
// or bf16 q and per-row f32 scales [Hkv, P, ps], folded as the TPU kernels
// fold them: score = (q . k_int8) * s_k before the mask, p * s_v in the
// accumulator product, l summed over the bare p.
//
// Bound: the valid K/V bytes (plus their scales for int8) read once over the
// card's 3.35 TB/s; the operations (4 * sum(len) * H * hd) are far below the
// CUDA cores' and the tensor cores' roofs. At the decode A/B's shapes (8 rows
// of 33-254 tokens, 8 kv heads, f32) that is ~12 MB, ~3.7 us at hd 128.
//
// The schedule (the earlier one had S * Hkv blocks, each walking its row's
// pages one after another with one page in flight and three barriers a
// page):
// 1. Parallelism over pages, merged in one launch. The grid is (C, Hkv, S),
//    launched as clusters of C = min(Pb, 8) blocks along the page axis (C
//    from shapes only, ops/paged_attention_oracle.py _cluster_size). Block r
//    of a cluster walks pages r, r + C, r + 2C, ... of its row with an online
//    softmax, then leaves its partial state (m, l, acc[G][hd], unnormalised)
//    as it merges its warps' states: each block owns a 1/C share of the
//    G x hd outputs and gathers their C partials (acc, and (m, l) of every
//    head); every block stores its partial straight into the owners' shared
//    memory through distributed shared memory (stores, no round trip).
//    After one cluster barrier each block computes its outputs from what it
//    gathered, out = sum_c acc_c e^(m_c - M) / sum_c l_c e^(m_c - M),
//    M = max_c m_c, and leaves: nothing reads another block's shared memory
//    past that barrier. A barrier arrive at the top, waited on before the
//    first remote store, makes sure every block of the cluster has started.
//    No scratch in device memory, no second kernel. A block whose pages all
//    lie past the length copies nothing and publishes m = -1e30, l = 0,
//    acc = 0; it still takes part in the barriers. Every m is finite, so
//    the merge never forms -inf - -inf, and rank 0 always holds token 0.
// 2. Bulk asynchronous copies. A stage is CT tokens of one page: ps, halved
//    while a stage's K + V exceed 32 KB (f32 at hd 128: 32-token half
//    pages), so two stages of f32 pages at hd 128 take 64 KB and 3 blocks
//    fit an SM. Thread 0 copies a stage with cp.async.bulk (K rows, V rows,
//    int8 scale rows: three or four contiguous slices), completion on the
//    stage's "full" mbarrier; two stages are in flight. The first stages'
//    page ids load beside the row's length, not after it. Only the valid rows
//    of the boundary page are copied; rows at or past the length, and the
//    boundary page's scales (copied whole: a bulk copy moves multiples of
//    16 bytes), are selected to 0 in registers before any product, so a
//    recycled tail's NaN or a stale NaN/inf scale never reaches a multiply.
//    Each warp arrives on the stage's "empty" mbarrier when done with it;
//    thread 0 waits there before reusing the buffer. There is no
//    __syncthreads inside the page walk.
// 3. Warp-local math on 8-token groups: 4 warps; group n of the block's
//    walk goes to warp n % 4; each warp keeps its own online-softmax state.
//    A kernel carries GP head slots, 4 when the GQA group fits (fewer
//    registers, a shorter butterfly) and 8 otherwise.
//    - Scores, f32 q (f32 caches, or int8 with an f32 q): lane l holds
//      hd / 32 elements of q for the GP head slots and of each of the
//      group's 8 K rows; its 8 GP partial dots reduce in one butterfly
//      (reduce-scatter: 5 steps of 4 GP, 2 GP, ... shuffles) that leaves
//      lane l with whole scores: head l / 4, tokens 2 (l % 4) and
//      2 (l % 4) + 1 for 8 slots; head l / 8, token l % 8 for 4 (instead
//      of 5 dependent shuffles per (token, head)).
//    - Scores, bf16 q (bf16 caches, or int8 with a bf16 q): mma.sync
//      m16n8k16 bf16 with f32 accumulation, the G <= 8 heads as rows of the
//      A tile (rows 8-15 zero), the 8 K rows as the B tile's columns; a
//      lane's B fragments come from 16-byte shared loads, so the k order is
//      permuted (q's fragments use the same permutation). int8 converts to
//      bf16 exactly. The C fragment has the 8-slot butterfly's layout.
//    - Softmax: every warp updates its own (m, l) of each head from its
//      group (2 or 3 shuffles each for the max and the sum).
//    - P.V on the CUDA cores in f32 for every cache type: lane l owns hd
//      lanes l * hd / 32 ... of all G heads; it loads each V row's slice
//      once into registers and applies it to every head's probability
//      (read as float4 broadcasts from the warp's shared buffer). A bulk
//      copy cannot pad rows, so a V tile transposed for mma.sync would read
//      at a 2^k-byte row stride with 8-way bank conflicts; these 4-16 byte
//      slice loads have none.
// 4. The warps' states merge in shared memory into the block's partial,
//    which goes straight to the owners (1.).
//
// What holds it back: at the decode A/B's shapes (one page a block) a call
// is a chain of latencies, not a stream: the launch, the read of the row's
// length and page ids that the copies depend on, one HBM round trip under
// full load, then the math of the last stages and the merge, which no copy
// hides. 8 warps a block (all groups of both stages at once) measured
// slower, as did 16 KB and 8 KB stages with 4 and 8 in flight.
//
// Independence from ragged_decode_attention.cu (the second-schedule oracle
// depends on it): that kernel splits rows over blocks that write partial
// states to device-memory scratch, merged by a second kernel launched as a
// programmatic dependent, fed by a cp.async ring with zero-filled tails and
// lane-per-token f32 scores. This one shares no source with it and none of
// those choices.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller; it reads no device
// data on the host and can be captured in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 4;          // warps a block
constexpr int NT = 32 * NW;    // threads a block
constexpr int NS = 2;          // stages in flight
constexpr int G_MAX = 8;       // query heads per kv head
constexpr int GT = 8;          // tokens a warp group
constexpr int C_MAX = 8;       // blocks a cluster (the portable maximum)
constexpr int STAGE_CAP = 32768;       // bytes of K + V a stage
constexpr size_t SMEM_MAX = 232448;    // 227 KB a block may opt in to
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Tokens a stage: the page, halved while its K + V exceed STAGE_CAP and it
// stays a multiple of 8 tokens. ops/paged_attention_oracle.py
// _stage_tokens mirrors it.
__host__ __device__ inline int stage_tokens(int ps, int row_bytes) {
  int ct = ps;
  while (2 * ct * row_bytes > STAGE_CAP && ct % 16 == 0) ct /= 2;
  return ct;
}

// Byte offsets of a block's dynamic shared memory: the stage barriers, the
// ring (reused for the warps' states after the walk), the partials the
// block gathers from the cluster, the warps' probabilities and rescale
// factors, the warps' (m, l), the block's page ids.
// ops/paged_attention_oracle.py _smem_bytes mirrors it.
struct Layout {
  int stage, ring, part, pw, pa, wml, pid, bytes;
  __host__ __device__ Layout(int hd, int esz, bool quant, int ct, int n_pid) {
    const int rb = hd * esz;
    stage = 2 * ct * rb + (quant ? 2 * ct * 4 : 0);
    ring = 128;
    const int ring_bytes = NS * stage > NW * G_MAX * hd * 4
                               ? NS * stage
                               : NW * G_MAX * hd * 4;
    part = ring + ring_bytes;
    pw = part + (G_MAX * hd / NT + C_MAX - 1) * NT * 4 + 2 * C_MAX * G_MAX * 4;
    pa = pw + NW * G_MAX * GT * 4;
    wml = pa + NW * G_MAX * 4;
    pid = wml + 2 * NW * G_MAX * 4;
    bytes = pid + (n_pid * 4 + 15) / 16 * 16;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_LOOP;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// B bytes (4, 8 or 16) of shared memory as 32-bit words; B = 1 or 2 as the
// low bits of one word
template <int B>
__device__ __forceinline__ void load_words(const unsigned char* p,
                                           unsigned* w) {
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
}

// an int8 held in byte k of w, as an exact f32: the byte with its sign bit
// flipped is the mantissa of 2^23 + (x + 128)
__device__ __forceinline__ float int8_at(unsigned w, int k) {
  const unsigned b = ((w >> (8 * k)) & 0xffu) ^ 0x80u;
  return __uint_as_float(0x4B000000u | b) - 8388736.f;  // 2^23 + 128
}

// N consecutive cache values of type T in shared memory, widened to f32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const unsigned char* p, float* o) {
  constexpr int B = N * static_cast<int>(sizeof(T));
  unsigned w[(B + 3) / 4];
  load_words<B>(p, w);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (std::is_same<T, float>::value)
      o[e] = __uint_as_float(w[e]);
    else if constexpr (std::is_same<T, __nv_bfloat16>::value)
      o[e] = __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
    else
      o[e] = int8_at(w[e / 4], e % 4);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// d[0..3] += A . B, m16n8k16, bf16 in, f32 accumulate, A rows 8-15 zero
__device__ __forceinline__ void mma16816(float* d, unsigned a0, unsigned a2,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// One butterfly step of the scores' reduce-scatter: N values a lane ->
// N / 2, each now summed over lane pairs `o` apart; the lane with bit `o`
// set keeps the upper half
template <int N>
__device__ __forceinline__ void fold(float* v, int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, o);
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// TQ: q's type (float or bf16); TC: the cache's (TQ itself, or int8 with
// per-row scales).
// (NT, 1): without it ptxas spilled a few bytes in some instantiations at
// 72-145 registers; at most 168 registers a thread still fit 2 blocks an SM
template <typename TQ, typename TC, int HD, int GP>
__global__ void __launch_bounds__(NT, 1) legacy_cluster_kernel(
    const TQ* __restrict__ q,            // [S, H, HD]
    const TC* __restrict__ k_cache,      // [Hkv, P, ps, HD]
    const TC* __restrict__ v_cache,
    const float* __restrict__ k_scale,   // [Hkv, P, ps] (int8 only)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_table,  // [S, Pb]
    const int* __restrict__ kv_lens,     // [S]
    TQ* __restrict__ out,                // [S, H, HD]
    int H, int Hkv, int P, int ps, int Pb, int ct, int C, float scale) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  constexpr bool SC_MMA = std::is_same<TQ, __nv_bfloat16>::value;
  // A lane's scores: GP (4 or 8 >= G) head slots x 8 tokens reduce to NV
  // of them. mma.sync's C fragment, and the f32 butterfly over 8 heads:
  // head lane / 4, tokens 2 (lane % 4) + i, i < 2. The f32 butterfly over 4
  // heads: head lane / 8, token lane % 8.
  constexpr bool R4 = !SC_MMA && GP == 4;
  constexpr int NV = R4 ? 1 : 2;
  constexpr int ESZ = static_cast<int>(sizeof(TC));
  constexpr int RB = HD * ESZ;     // bytes a cache row
  constexpr int DPL = HD / 32;     // hd lanes a thread (f32 scores, P.V)
  // mma scores: a lane's 16-byte (8 for 32-byte rows) slices of a K row
  constexpr int LB = RB / 4 < 16 ? RB / 4 : 16;
  constexpr int NLD = RB / (4 * LB);  // slices a lane a row
  constexpr int VPL = LB / ESZ;       // values a slice
  constexpr int KSL = VPL / 4;        // mma k-steps a slice

  cg::cluster_group cluster = cg::this_cluster();
  const int r = blockIdx.x;  // rank in the cluster: pages r, r + C, ...
  const int kvh = blockIdx.y, s = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int head = R4 ? lane >> 3 : gid;        // the lane's score slots
  const int tok0 = R4 ? lane & 7 : 2 * tig;

  const int n_pid = (Pb + C - 1) / C;
  const Layout lay(HD, ESZ, QUANT, ct, n_pid);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [NS]
  uint64_t* empty = full + NS;                          // [NS]
  unsigned char* ring = smem + lay.ring;
  // the partials this block gathers: acc [(OUT + C_MAX - 1) NT], (m, l)
  // [C_MAX][G_MAX] each
  constexpr int OUT = G_MAX * HD / NT;  // outputs a thread, at most (C = 1)
  float* gacc = reinterpret_cast<float*>(smem + lay.part);
  float* gm = gacc + (OUT + C_MAX - 1) * NT;
  float* gl = gm + C_MAX * G_MAX;
  float* pw = reinterpret_cast<float*>(smem + lay.pw) + warp * G_MAX * GT;
  float* pa = reinterpret_cast<float*>(smem + lay.pa) + warp * G_MAX;
  float* wm = reinterpret_cast<float*>(smem + lay.wml);  // [NW][G_MAX]
  float* wl = wm + NW * G_MAX;                            // [NW][G_MAX]
  int* pid_s = reinterpret_cast<int*>(smem + lay.pid);    // [n_pid]

  // this block's pages and stages: every page but the row's last is full,
  // so the stages with tokens below len are a prefix of the block's walk.
  // The page ids of the first stages load beside len, not after it
  const int spp = ps / ct;  // stages a page
  const int* pt = page_table + (size_t)s * Pb;
  int first_pages[NS];
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const int i = r + (c / spp) * C;
    first_pages[c] = tid == 0 && i < Pb ? pt[i] : 0;
  }
  const int len = min(max(kv_lens[s], 1), Pb * ps);
  const int n_pages = (len + ps - 1) / ps;
  const int np_r = n_pages > r ? (n_pages - 1 - r) / C + 1 : 0;
  int n_st = 0;
  if (np_r > 0) {
    const bool last = (n_pages - 1 - r) % C == 0;
    const int tail = len - (n_pages - 1) * ps;  // tokens of the last page
    n_st = (np_r - (last ? 1 : 0)) * spp + (last ? (tail + ct - 1) / ct : 0);
  }
  const unsigned char* k_head = reinterpret_cast<const unsigned char*>(
      k_cache + (size_t)kvh * P * ps * HD);
  const unsigned char* v_head = reinterpret_cast<const unsigned char*>(
      v_cache + (size_t)kvh * P * ps * HD);

  // stage c: tokens [t0, t0 + ct) of the row, page slot c / spp of the block
  auto stage_t0 = [&](int c) {
    return (r + (c / spp) * C) * ps + (c % spp) * ct;
  };
  auto issue = [&](int c, int page) {  // thread 0 only
    const int slot = c % NS;
    unsigned char* kb = ring + slot * lay.stage;
    unsigned char* vb = kb + ct * RB;
    const int nv = min(ct, len - stage_t0(c));
    const size_t row0 = (size_t)page * ps + (size_t)(c % spp) * ct;
    bar_expect(&full[slot], 2u * nv * RB + (QUANT ? 8u * ct : 0u));
    bulk_copy(kb, k_head + row0 * RB, nv * RB, &full[slot]);
    bulk_copy(vb, v_head + row0 * RB, nv * RB, &full[slot]);
    if constexpr (QUANT) {
      float* skb = reinterpret_cast<float*>(vb + ct * RB);
      const size_t srow = (size_t)kvh * P * ps + row0;
      bulk_copy(skb, k_scale + srow, ct * 4, &full[slot]);
      bulk_copy(skb + ct, v_scale + srow, ct * 4, &full[slot]);
    }
  };

  if (tid == 0) {
    for (int b = 0; b < NS; ++b) {
      bar_init(&full[b], 1);
      bar_init(&empty[b], NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int c = 0; c < NS; ++c)
      if (c < n_st) issue(c, first_pages[c]);
  }
  for (int i = tid; i < np_r; i += NT) pid_s[i] = pt[r + i * C];

  // q, while the first stages fly. bf16 q: the A fragments of the score
  // product in the K slices' k order; f32 q: hd lanes lane * DPL ... of
  // every head, prescaled by hd^-0.5
  const size_t q_row = (size_t)s * H + (size_t)kvh * G;
  unsigned qa[SC_MMA ? HD / 16 : 1][2];
  float qf[SC_MMA ? 1 : GP][DPL];
  if constexpr (SC_MMA) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int d0 = (kk / KSL) * 4 * VPL + tig * VPL + 4 * (kk % KSL);
      uint2 x = make_uint2(0u, 0u);
      if (gid < G)
        x = *reinterpret_cast<const uint2*>(q + (q_row + gid) * HD + d0);
      qa[kk][0] = x.x;
      qa[kk][1] = x.y;
    }
  } else {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        qf[g][e] = g < G ? static_cast<float>(
                               q[(q_row + g) * HD + lane * DPL + e]) * scale
                         : 0.f;
  }
  __syncthreads();  // barriers initialised, page ids written
  // this block has started; the matching wait comes before the first
  // write into another block's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;  // `head`'s, over this warp's tokens
  const int n_grp = ct / GT;  // groups a stage; the walk's group n goes to
                              // warp n % NW

  for (int c = 0; c < n_st; ++c) {
    const int slot = c % NS;
    if (tid == 0 && c >= 1 && c + NS - 1 < n_st) {
      // the buffer of stage c - 1 takes stage c + NS - 1 once every warp
      // is done with it
      bar_wait(&empty[(c - 1) % NS], ((c - 1) / NS) & 1);
      issue(c + NS - 1, pid_s[(c + NS - 1) / spp]);
    }
    __syncwarp();
    bar_wait(&full[slot], (c / NS) & 1);
    const unsigned char* kb = ring + slot * lay.stage;
    const unsigned char* vb = kb + ct * RB;
    const float* skb = reinterpret_cast<const float*>(vb + ct * RB);
    const float* svb = skb + ct;
    const int nv = min(ct, len - stage_t0(c));  // valid rows of the stage

    const int gi0 = ((warp - c * n_grp) % NW + NW) % NW;
    for (int gi = gi0; gi < n_grp && gi * GT < nv; gi += NW) {
      const int r0 = gi * GT;
      // the scores of `head`, tokens r0 + tok0 + i (i < NV)
      float sc[NV];
      if constexpr (SC_MMA) {
        float d4[4] = {0.f, 0.f, 0.f, 0.f};
        const unsigned char* kr = kb + (r0 + gid) * RB + tig * LB;
        const bool ok = r0 + gid < nv;
#pragma unroll
        for (int jl = 0; jl < NLD; ++jl) {
          unsigned w[LB / 4];
          load_words<LB>(kr + jl * 4 * LB, w);
#pragma unroll
          for (int x = 0; x < LB / 4; ++x) w[x] = ok ? w[x] : 0u;
#pragma unroll
          for (int u = 0; u < KSL; ++u) {
            unsigned b0, b1;
            if constexpr (QUANT) {
              b0 = pack_bf16(int8_at(w[u], 0), int8_at(w[u], 1));
              b1 = pack_bf16(int8_at(w[u], 2), int8_at(w[u], 3));
            } else {
              b0 = w[2 * u];
              b1 = w[2 * u + 1];
            }
            const int kk = jl * KSL + u;
            mma16816(d4, qa[kk][0], qa[kk][1], b0, b1);
          }
        }
        sc[0] = d4[0] * scale;
        sc[NV - 1] = d4[NV - 1] * scale;
      } else {
        float v[GP * GT];  // partial dots, [head][token]
#pragma unroll
        for (int t = 0; t < GT; ++t) {
          float kv[DPL];
          load_f32<TC, DPL>(kb + (r0 + t) * RB + lane * DPL * ESZ, kv);
          const bool ok = r0 + t < nv;
#pragma unroll
          for (int e = 0; e < DPL; ++e) kv[e] = ok ? kv[e] : 0.f;
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            float d = 0.f;
            if (g < G) {
#pragma unroll
              for (int e = 0; e < DPL; ++e) d += qf[g][e] * kv[e];
            }
            v[g * GT + t] = d;
          }
        }
        fold<GP * GT>(v, lane, 16);
        fold<GP * GT / 2>(v, lane, 8);
        fold<GP * GT / 4>(v, lane, 4);
        fold<GP * GT / 8>(v, lane, 2);
        fold<GP * GT / 16>(v, lane, 1);
#pragma unroll
        for (int i = 0; i < NV; ++i) sc[i] = v[i];
      }

      // the K dequant fold, the mask, and the warp's online softmax
      float mx = NEG_INF;
      bool ok[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int row = r0 + tok0 + i;
        ok[i] = row < nv;
        float x = sc[i];
        if constexpr (QUANT) x *= ok[i] ? skb[row] : 0.f;
        sc[i] = ok[i] ? x : NEG_INF;
        mx = fmaxf(mx, sc[i]);
      }
      // the lanes of a head: 4 (2 tokens each) or 8 (1 token each)
#pragma unroll
      for (int o = 1; o < GT / NV; o *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float psum = 0.f, pv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float p = ok[i] && head < G ? expf(sc[i] - m_new) : 0.f;
        psum += p;
        if constexpr (QUANT)  // the V dequant fold
          pv[i] = p * (ok[i] ? svb[r0 + tok0 + i] : 0.f);
        else
          pv[i] = p;
      }
#pragma unroll
      for (int o = 1; o < GT / NV; o *= 2)
        psum += __shfl_xor_sync(FULL, psum, o);
      l_run = l_run * alpha + psum;
      m_run = m_new;

      // acc = acc * alpha + p . V over the group
#pragma unroll
      for (int i = 0; i < NV; ++i) pw[head * GT + tok0 + i] = pv[i];
      if (tok0 == 0) pa[head] = alpha;
      __syncwarp();
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {
          const float a = pa[g];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] *= a;
        }
      }
#pragma unroll
      for (int t = 0; t < GT; t += 4) {
        float vv[4][DPL];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          load_f32<TC, DPL>(vb + (r0 + t + u) * RB + lane * DPL * ESZ, vv[u]);
          const bool vok = r0 + t + u < nv;
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[u][e] = vok ? vv[u][e] : 0.f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < G) {
            const float4 p4 = *reinterpret_cast<const float4*>(pw + g * GT + t);
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              acc[g][e] += p4.x * vv[0][e];
              acc[g][e] += p4.y * vv[1][e];
              acc[g][e] += p4.z * vv[2][e];
              acc[g][e] += p4.w * vv[3][e];
            }
          }
        }
      }
      __syncwarp();  // pw and pa are rewritten by the next group
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
  }

  // the warps' states -> the block's partial (the ring is free now),
  // pushed straight into the shared memory of the block that owns each
  // output: output i = q NT + t (chunk q) belongs to rank q % C, which
  // gathers the C partials of it at [(q / C) C + rank][t]; every block
  // also gives every owner its (m, l)
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(ring);  // [NW][G_MAX][HD]
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        wacc[(warp * G_MAX + g) * HD + lane * DPL + e] = acc[g][e];
    }
  }
  if (tok0 == 0) {
    wm[warp * G_MAX + head] = m_run;
    wl[warp * G_MAX + head] = l_run;
  }
  __syncthreads();
  // every block of the cluster has started (the arrive at the top), so its
  // shared memory may be written
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float m = wm[g];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, wm[w * G_MAX + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w * G_MAX + g] - m);
      l += wl[w * G_MAX + g] * f;
      a += wacc[(w * G_MAX + g) * HD + d] * f;
    }
    const int q = i / NT;
    cluster.map_shared_rank(gacc, q % C)[(q / C * C + r) * NT + tid] = a;
    if (d == 0) {
      for (int c = 0; c < C; ++c) {
        cluster.map_shared_rank(gm, c)[r * G_MAX + g] = m;
        cluster.map_shared_rank(gl, c)[r * G_MAX + g] = l;
      }
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // this block's outputs from its gathered partials: out = sum_c acc_c
  // e^(m_c - M) / sum_c l_c e^(m_c - M). Nothing reads another block's
  // shared memory past the barrier, so blocks leave as they finish.
  TQ* o_row = out + q_row * HD;
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    const int i = (r + C * k) * NT + tid;
    if (i < G * HD) {
      const int g = i / HD;
      float m = NEG_INF;
#pragma unroll
      for (int c = 0; c < C_MAX; ++c)
        if (c < C) m = fmaxf(m, gm[c * G_MAX + g]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int c = 0; c < C_MAX; ++c) {
        if (c < C) {
          const float f = expf(gm[c * G_MAX + g] - m);
          l += gl[c * G_MAX + g] * f;
          a += gacc[(k * C + c) * NT + tid] * f;
        }
      }
      store_out(o_row + i, __fdividef(a, l));  // l >= 1: no slow path
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

template <typename TQ, typename TC, int HD, int GP>
int launch(const Args& a) {
  constexpr int ESZ = static_cast<int>(sizeof(TC));
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  const int ct = stage_tokens(a.ps, HD * ESZ);
  const int C = a.Pb < C_MAX ? a.Pb : C_MAX;
  const Layout lay(HD, ESZ, QUANT, ct, (a.Pb + C - 1) / C);
  if (static_cast<size_t>(lay.bytes) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = legacy_cluster_kernel<TQ, TC, HD, GP>;
  // the opt-in is per kernel and grows only: set once per larger size, so
  // a steady caller (or a CUDA graph capture) makes no runtime call here
  static int opted_in = 0;
  if (lay.bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = lay.bytes;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.Hkv, a.S);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
      static_cast<const TC*>(a.v), a.ks, a.vs, a.pt, a.lens,
      static_cast<TQ*>(a.out), a.H, a.Hkv, a.P, a.ps, a.Pb, ct, C, a.scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// GP: the head slots a kernel carries, 4 when the GQA group fits (fewer
// registers, a shorter butterfly), else 8
template <typename TQ, typename TC, int GP>
int dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32:
      return launch<TQ, TC, 32, GP>(a);
    case 64:
      return launch<TQ, TC, 64, GP>(a);
    case 128:
      return launch<TQ, TC, 128, GP>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ, typename TC>
int dispatch(int hd, const Args& a) {
  return a.H / a.Hkv <= 4 ? dispatch_hd<TQ, TC, 4>(hd, a)
                          : dispatch_hd<TQ, TC, 8>(hd, a);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (out has q's type). cache_dtype: 0 =
// float32, 1 = bfloat16 (both equal to q_dtype), 2 = int8 (k_scale and
// v_scale non-null). ps must be a multiple of 8.
extern "C" int legacy_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_lens, void* out, int S, int H, int Hkv, int P, int ps,
    int hd, int Pb, float scale, int q_dtype, int cache_dtype, void* stream) {
  if (S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > G_MAX || ps <= 0 || ps % GT ||
      Pb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = cache_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(kv_lens), out, S, H, Hkv, P, ps, Pb,
               scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0) return dispatch<float, float>(hd, a);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(hd, a);
  if (q_dtype == 0 && quant) return dispatch<float, int8_t>(hd, a);
  if (q_dtype == 1 && quant) return dispatch<__nv_bfloat16, int8_t>(hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
