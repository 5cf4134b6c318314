// The W8A16 product past the decode rows, on Hopper's tensor cores
// (sm_90a): y[g] = x[g] @ (f32(q[g]) * s[g]) for G groups in one launch.
//
// Not the port of a Pallas kernel. The JAX package computes this product
// as one XLA op: `wmat`'s dequantize is "a fused temporary"
// (dynamo_tpu/ops/quant.py:70-77) under the matmul, and under the expert
// einsums of dynamo_tpu/ops/moe.py:77-82. The port's route for it was the
// dequantize entry of w8a16_gemm.cu followed by torch.matmul
// (ops/quant.linear past GEMV_MAX_M rows, and ops/quant.grouped_linear one
// expert at a time past GROUPED_MAX_M): it reads the int8 weight, writes
// it as bf16 and reads that back, and runs E + E launches a grouped call.
// This kernel replaces both call sites with one launch that widens the
// int8 weight in shared memory and never writes it out.
//
// Function. x [G, M, K] bf16, q [G, K, N] int8 (the JAX layout: each k row
// contiguous along N), s [G, N] f32, active [G] int32 on the device (or
// none: every group active), y [G, M, N] bf16. The sum over K is f32 in the
// tensor cores; s multiplies each output column once, after the sum (the
// decode kernel's contract), and y is rounded to bf16 once. A group with
// active[g] == 0 loads nothing and writes exact zeros: the MoE combine
// multiplies an unrouted row by a zero weight, and 0 x NaN from an
// unwritten tile would poison the sum. G = 1 is the dense call. Any M >= 1;
// ragged M, N and K edges are masked (TMA fills the rows and columns past
// the tensor with zeros; the epilogue stores only inside it). TMA needs
// 16-byte row strides, so N % 16 == 0 and K % 8 == 0 (ops/quant.py raises
// on anything else; every model in the registry qualifies).
//
// Bound, per active group: bytes = K N (int8 weight) + 4 N (scales) +
// 2 M K (x) + 2 M N (y), over 3.35 TB/s, against 2 M K N operations over
// 989 TFLOP/s (bf16 dense). The line between the two sits near M = 300
// rows: llama3-8b's w_gate (4096 x 14336) at M = 512 is 60.1 GFLOP,
// 0.0608 ms, while its bytes take 0.023 ms; Mixtral's experts at 256 rows
// each are compute-bound too (a 512-token chunk's 768 expert products:
// 23.1 TFLOP, 23.3 ms). At M = 16 the weight bytes bound it (w_gate
// 0.0176 ms). So the design keeps the tensor cores fed: wgmma, with every
// load in flight ahead of it. What holds it below that bound is the
// pipeline: the loads into shared memory (x is read again for every column
// tile), the widening (a shared-memory round trip for each weight byte)
// and the products overlap only in part (root PERF.md §6).
//
// Design: a persistent, warp-specialised block per SM, 288 threads:
// - warp 8, the producer: one lane walks the block's units and issues the
//   TMA loads of each k-block (x's [tile rows, 64] bf16 tile, 128B-
//   swizzled, the K-major layout wgmma reads as A; q's [64, 128] int8
//   tile, 128B-swizzled so the widening reads it without bank conflicts)
//   into a ring of Tiling::kStages stages, each with a full and an empty
//   mbarrier;
// - warps 0-7, two consumer warpgroups. While the tensor cores run one
//   k-block's wgmma.m64n128k16 (bf16, f32 accumulators in registers,
//   issued asynchronously), the same warps widen the next k-block's int8
//   tile, one 8-row k group a warp, exactly to bf16 (|q| <= 127: a byte
//   permute and an f32 subtract; the top half of the exact f32 is the
//   bf16) into the other of two B tiles, laid out as the 128B-swizzled
//   N-major (MN-major) operand that wgmma reads as B with its transpose
//   bit: atoms of 64 columns x 8 k rows (1024 bytes), the 8 k-row groups
//   of one atom column 1024 bytes apart (SBO), the two atom columns 8192
//   bytes apart (LBO). Two consumer barriers a k-block hand the B tiles
//   over. wgmma's transpose exists for 16-bit operands only, so the weight
//   is widened before wgmma sees it (design (a), SS: each weight byte
//   costs a shared-memory round trip; the register-A swap-AB form is not
//   built). Warpgroup w runs the 64-row slabs w and 2 + w of the tile, four
//   instructions a slab a k-block, one k-block's group left in flight; a
//   warpgroup whose first slab lies past M issues no wgmma (it still
//   widens its share and keeps the barriers). The epilogue scales each
//   column by s, rounds to bf16 and stores from registers, while the
//   producer already loads the block's next unit.
// Why the consumers widen: in dedicated warps the widening was the limit
// on the card (taking it out sped the kernel up most), while the
// consumers idle during their asynchronous wgmma. A two-CTA cluster that
// multicast the shared x tile gained nothing: each SM still receives
// every byte, and the traffic out of the L2 was not the limit.
// Tiles are 128 columns by 128 rows of x up to M = 128 (one slab a
// warpgroup, a 7-stage ring) and 256 rows past it (two slabs, a 4-stage
// ring): a taller tile widens each weight tile once for twice the rows and
// moves 20 KB of x and q a 128 x 128 block of output in place of 24. The
// host picks the tile from M and the rest from shapes only
// (ops/quant.py large_m_config: no host sync, capturable in a CUDA
// graph). Units are (group, column tile, split, row tile), the row tile
// fastest, so blocks that run together share a weight tile through the
// L2; block b takes units b, b + grid, ... When the tiles leave more than
// half the SMs idle (wk and wv of a prefill step), K is split so that
// about one unit runs an SM; the splits' f32 sums go to a scratch, and a
// second kernel adds them in split order, scales and rounds. Shared
// memory: 7 x (16 KB x + 8 KB q) or 4 x (32 KB + 8 KB), + 2 x 16 KB B +
// barriers: 205,936 or 197,696 bytes with the alignment slack, within the
// 227 KB a block may use. Deterministic: each output is one ordered sum,
// so a captured graph and an eager call agree to the bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/build.py); loaded
// with ctypes. The tensor maps are encoded on the host for each call
// (cuTensorMapEncodeTiled, looked up in the libcuda the CUDA runtime has
// loaded, so the library links none) and passed by value as
// __grid_constant__ parameters. The entry returns the cudaError_t of its
// launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kConsumers = 2;        // warpgroups running wgmma
constexpr int kBN = 128;             // columns a tile
constexpr int kBK = 64;              // k a stage: 128 bytes of bf16 x
constexpr int kBBuffers = 2;         // widened weight tiles: the one wgmma
                                     // reads and the one being written
// the consumer warpgroups, then the producer warp: 288 threads leave 224
// registers a thread (one block an SM), room for a consumer's 128
// accumulators
constexpr int kThreads = kConsumers * 128 + 32;
// each consumer warp widens one 8-row k group of a 64 x 128 q tile
static_assert(4 * kConsumers == kBK / 8 && kBN == 128,
              "one k-row group a consumer warp, two 64-column atoms");
constexpr int kAcc = kBN / 2;        // f32 accumulators a thread a slab
constexpr int kQBytes = kBK * kBN;                // 8192
constexpr int kBBytes = kBK * kBN * 2;            // 16384
constexpr int kAtomBytes = 1024;                  // 8 rows x 128 bytes
constexpr int kBAtomCol = kBK / 8 * kAtomBytes;   // 8192: one atom column

// the two tilings, chosen by the host from M (ops/quant.py
// large_m_config): SLABS 64-row slabs a consumer warpgroup, so a tile
// holds 128 (SLABS 1) or 256 rows of x (SLABS 2: each weight tile is
// widened once for twice the rows, and x and q cost 20 KB a 128 x 128
// block of output in place of 24); the ring as deep as shared memory
// allows
template <int SLABS>
struct Tiling {
  static constexpr int kBM = 64 * SLABS * kConsumers;
  static constexpr int kStages = SLABS == 1 ? 7 : 4;
  static constexpr int kABytes = kBM * kBK * 2;   // 16384 or 32768
  static constexpr int kSmemBytes = kStages * (kABytes + kQBytes) +
                                    kBBuffers * kBBytes + 8 * 2 * kStages +
                                    1024;
  static_assert(kSmemBytes <= 232448, "a block's shared memory on Hopper");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
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

// arrive where pred holds: a predicated instruction, not a branch, so the
// consumers' path around wgmma stays convergent
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 state;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}

// wait until the barrier's phase with this parity has completed (the
// loop stays inside one asm block, so the compiler sees no divergent path)
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma instructions
template <int SLABS>
__device__ __forceinline__ void fence_acc(float (&d)[SLABS][kAcc]) {
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      asm volatile("" : "+f"(d[sl][i])::"memory");
}

// D[64, 128] += A[64, 16] (K-major) . B[16, 128] (N-major: transposed)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  const int scale_d = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// four int8 (one word, n ascending) as two bf16x2 words, exactly: biased to
// 0..255, placed under 2^23 as an f32, 2^23 + 128 subtracted; the exact f32
// has at most 8 significant bits, so its top half is the bf16
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t b = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650 + k)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// one unit of work: an output tile of group g (the tiling's rows x 128
// columns), over k-blocks kb0 .. kb1 - 1 (split `split` of the K range)
struct Unit {
  int g, m0, n0, split, kb0, kb1;
};

// unit u in the scheduler's order: the row tile fastest, then the split,
// then the column tile, then the group
__device__ __forceinline__ Unit unit_at(int u, int bm, int tiles_m,
                                        int tiles_n, int splits, int per,
                                        int nk) {
  Unit r;
  r.m0 = (u % tiles_m) * bm;
  int rest = u / tiles_m;
  r.split = rest % splits;
  rest /= splits;
  r.n0 = (rest % tiles_n) * kBN;
  r.g = rest / tiles_n;
  r.kb0 = r.split * per;
  r.kb1 = min(nk, r.kb0 + per);
  return r;
}

// read once by every role for each unit, and made warp-uniform, so the
// branches around wgmma are provably convergent
__device__ __forceinline__ bool group_active(const int* active, int g) {
  const int a = active == nullptr ? 1 : __ldg(active + g);
  return __shfl_sync(0xffffffffu, a, 0) != 0;
}

// the consumer warpgroups' own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
}

// consumer warp cw's share of widening one k-block: k-row group cw (8 rows
// x 128 bytes, 128B-swizzled by TMA) of the int8 q tile into the bf16
// N-major tile b. Lane (r, c) takes row r, 16-byte chunks c and c + 4 (n
// 16 c .. and 64 + 16 c ..: atoms 0 and 1); 8 lanes of a phase read and
// write 8 rows, each at another swizzled chunk, so no bank conflicts. The
// proxy fence makes the writes visible to wgmma (the async proxy).
__device__ __forceinline__ void widen_group(const uint8_t* q, uint8_t* b,
                                            int cw, int lane) {
  const int r = lane & 7;
  const int c = lane >> 3;
  const uint8_t* qrow = q + (cw * 8 + r) * 128;
  uint8_t* brow = b + cw * kAtomBytes + r * 128;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int cc = c + 4 * half;
    const uint4 v = *reinterpret_cast<const uint4*>(qrow + ((cc ^ r) << 4));
    uint4 o0, o1;
    widen4(v.x, o0.x, o0.y);
    widen4(v.y, o0.z, o0.w);
    widen4(v.z, o1.x, o1.y);
    widen4(v.w, o1.z, o1.w);
    uint8_t* row = brow + half * kBAtomCol;
    *reinterpret_cast<uint4*>(row + (((2 * c) ^ r) << 4)) = o0;
    *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ r) << 4)) = o1;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int SLABS>
__global__ void __launch_bounds__(kThreads, 1)
    w8a16_large_m_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_q,
                         const float* __restrict__ s,
                         const int* __restrict__ active,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ part, int G, int M, int K,
                         int N, int splits, int per) {
  constexpr int kBM = Tiling<SLABS>::kBM;
  constexpr int kStages = Tiling<SLABS>::kStages;
  constexpr int kABytes = Tiling<SLABS>::kABytes;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128B swizzle repeats every 8 rows of 128 bytes
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t a_smem = base;
  const uint32_t q_smem = a_smem + kStages * kABytes;
  const uint32_t b_smem = q_smem + kStages * kQBytes;
  const uint32_t bar0 = b_smem + kBBuffers * kBBytes;
  const uint8_t* q_gen = gbase + kStages * kABytes;
  uint8_t* b_gen = gbase + kStages * (kABytes + kQBytes);
  auto full_t = [&](int i) { return bar0 + 8u * i; };
  auto empty_t = [&](int i) { return bar0 + 8u * (kStages + i); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full_t(i), 1);                 // the producer's arrive
      mbar_init(empty_t(i), 4 * kConsumers);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int nk = (K + kBK - 1) / kBK;
  const int units = G * tiles_m * tiles_n * splits;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (warp == 4 * kConsumers) {
    // -- producer -----------------------------------------------------------
    if (lane != 0) return;
    uint32_t it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_at(u, kBM, tiles_m, tiles_n, splits, per, nk);
      if (!(active == nullptr || __ldg(active + w.g) != 0)) continue;
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int st = it % kStages;
        mbar_wait(empty_t(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_t(st), kABytes + kQBytes);
        tma_load_3d(a_smem + st * kABytes, &map_x, full_t(st), kb * kBK,
                    w.m0, w.g);
        tma_load_3d(q_smem + st * kQBytes, &map_q, full_t(st), w.n0,
                    kb * kBK, w.g);
      }
    }
    return;
  }

  // -- consumers: widen the next k-block while this one's wgmma runs --------
  // warpgroup wg holds slabs sl = 0 .. SLABS - 1, rows 64 (kConsumers sl +
  // wg) .. + 63 of the tile: interleaved, so both warpgroups hold rows of a
  // tile of 65 .. 128 rows. Consumer warp `warp` widens k-row group `warp`
  // of each q tile into B buffer it % 2; two consumer barriers a k-block:
  // both warpgroups' previous wgmma done (its B buffer free), and the next
  // B tile complete.
  const int wg = warp >> 2;
  const int wr = 16 * (warp & 3) + (lane >> 2);  // row in a 64-row slab
  const int wc = 2 * (lane & 3);                 // column in an n8 block
  uint32_t it = 0;
  float acc[SLABS][kAcc];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_at(u, kBM, tiles_m, tiles_n, splits, per, nk);
    const bool act = group_active(active, w.g);
    // whether this warpgroup's first slab holds rows inside M (warp-
    // uniform, so the branches around wgmma stay convergent); a live
    // warpgroup runs every slab, the rows past M are TMA's zeros
    const bool live = w.m0 + 64 * wg < M;
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[sl][i] = 0.f;
    if (act) {
      fence_acc(acc);
      mbar_wait(full_t(it % kStages), (it / kStages) & 1);
      widen_group(q_gen + (it % kStages) * kQBytes,
                  b_gen + (it & 1) * kBBytes, warp, lane);
      consumers_sync();
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int st = it % kStages;
        if (live) {
          const uint32_t a = a_smem + st * kABytes;
          const uint32_t b = b_smem + (it & 1) * kBBytes;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks) {
            const uint64_t db = sw128_desc(b + 2 * kAtomBytes * ks,
                                           kBAtomCol, kAtomBytes);
#pragma unroll
            for (int sl = 0; sl < SLABS; ++sl)
              wgmma_m64n128k16(
                  acc[sl],
                  sw128_desc(a + (kConsumers * sl + wg) * (64 * 128) +
                                 32 * ks,
                             16, kAtomBytes),
                  db);
          }
          wgmma_commit();
          // the previous k-block's products are done
          wgmma_wait<1>();
        }
        // its x and q tiles go back to the producer
        mbar_arrive_if(empty_t((it - 1) % kStages), lane == 0 && kb > w.kb0);
        if (kb + 1 < w.kb1) {
          // both warpgroups are past the previous wgmma: its B buffer is
          // the next one's
          consumers_sync();
          const int nst = (it + 1) % kStages;
          mbar_wait(full_t(nst), ((it + 1) / kStages) & 1);
          widen_group(q_gen + nst * kQBytes,
                      b_gen + ((it + 1) & 1) * kBBytes, warp, lane);
          consumers_sync();
        }
      }
      if (live) wgmma_wait<0>();
      mbar_arrive_if(empty_t((it - 1) % kStages), lane == 0);
      fence_acc(acc);
    }
    if (splits > 1 && !act) continue;   // the reduce writes its zeros
    const float* sg = s + static_cast<size_t>(w.g) * N;
    __nv_bfloat16* yg = y + static_cast<size_t>(w.g) * M * N;
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
      const int row0 = w.m0 + 64 * (kConsumers * sl + wg) + wr;
      if (row0 >= M) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = w.n0 + 8 * j + wc;
        if (col >= N) continue;   // N % 16 == 0: col + 1 < N as well
        if (splits > 1) {
          // the split's f32 sums, unscaled; w8a16_large_m_reduce adds the
          // splits in order and scales
          float* pg = part + (static_cast<size_t>(w.split) * G + w.g) * M * N;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row >= M) continue;
            *reinterpret_cast<float2*>(pg + static_cast<size_t>(row) * N +
                                       col) =
                make_float2(acc[sl][4 * j + 2 * h],
                            acc[sl][4 * j + 2 * h + 1]);
          }
          continue;
        }
        // scale, round once, store (zeros for an inactive group)
        const float s0 = act ? __ldg(sg + col) : 0.f;
        const float s1 = act ? __ldg(sg + col + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              yg + static_cast<size_t>(row) * N + col) =
              __floats2bfloat162_rn(acc[sl][4 * j + 2 * h] * s0,
                                    acc[sl][4 * j + 2 * h + 1] * s1);
        }
      }
    }
  }
}

// y = (the splits' partial sums, added in split order) * s, rounded once;
// exact zeros for an inactive group. Four columns a thread (N % 16 == 0).
__global__ void __launch_bounds__(256)
    w8a16_large_m_reduce(const float* __restrict__ part,
                         const float* __restrict__ s,
                         const int* __restrict__ active,
                         __nv_bfloat16* __restrict__ y, int G, int M, int N,
                         int splits) {
  const size_t total = static_cast<size_t>(G) * M * N;
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  const int g = static_cast<int>(i / (static_cast<size_t>(M) * N));
  const int n = static_cast<int>(i % N);
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (active == nullptr || __ldg(active + g) != 0) {
    for (int sp = 0; sp < splits; ++sp) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          part + static_cast<size_t>(sp) * total + i));
      a[0] += v.x;
      a[1] += v.y;
      a[2] += v.z;
      a[3] += v.w;
    }
    const float4 sc = __ldg(reinterpret_cast<const float4*>(
        s + static_cast<size_t>(g) * N + n));
    a[0] *= sc.x;
    a[1] *= sc.y;
    a[2] *= sc.z;
    a[3] *= sc.w;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + i);
  out[0] = __floats2bfloat162_rn(a[0], a[1]);
  out[1] = __floats2bfloat162_rn(a[2], a[3]);
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

// a 3-D map [d2][d1][d0] (d0 contiguous) read in boxes {b0, b1, 1}
bool encode(CUtensorMap* map, EncodeTiled fn, CUtensorMapDataType type,
            int esize, const void* ptr, int d0, int d1, int d2, int b0,
            int b1) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(d0) * esize,
      static_cast<cuuint64_t>(d0) * d1 * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


template <int SLABS>
cudaError_t launch(EncodeTiled fn, const void* x, const void* q,
                   const float* s, const int* active, __nv_bfloat16* y,
                   float* part, int G, int M, int K, int N, int splits,
                   int per, int grid, cudaStream_t st) {
  CUtensorMap map_x, map_q;
  if (!encode(&map_x, fn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, G,
              kBK, Tiling<SLABS>::kBM) ||
      !encode(&map_q, fn, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K, G, 128,
              kBK))
    return cudaErrorInvalidValue;
  static bool opted_in = false;   // one shared-memory opt-in a tiling
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a16_large_m_kernel<SLABS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tiling<SLABS>::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  w8a16_large_m_kernel<SLABS>
      <<<grid, kThreads, Tiling<SLABS>::kSmemBytes, st>>>(
          map_x, map_q, s, active, y, part, G, M, K, N, splits, per);
  return cudaGetLastError();
}

}  // namespace

// x [G, M, K] bf16, q [G, K, N] int8, s [G, N] f32, active [G] int32 or
// null (every group active), y [G, M, N] bf16; tile_m: rows of x a tile,
// 128 or 256; part: f32 [splits, G, M, N] scratch when splits > 1 (else
// ignored); per: k-blocks of 64 a split; grid: blocks, at most the units
// (ops/quant.py large_m_config). N % 16 == 0, K % 8 == 0 and 16-byte
// aligned x, q and s (TMA's rule, the reduce's float4 loads); anything else
// is refused.
extern "C" int w8a16_large_m(const void* x, const void* q, const void* s,
                             const void* active, void* y, void* part, int G,
                             int M, int K, int N, int tile_m, int splits,
                             int per, int grid, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  const int nk = (K + kBK - 1) / kBK;
  const long long units = static_cast<long long>(G) *
                          ((M + tile_m - 1) / tile_m) *
                          ((N + kBN - 1) / kBN) * splits;
  if (K <= 0 || N % 16 != 0 || K % 8 != 0 ||
      (tile_m != Tiling<1>::kBM && tile_m != Tiling<2>::kBM) ||
      splits <= 0 || per <= 0 ||
      static_cast<long long>(splits - 1) * per >= nk ||
      static_cast<long long>(splits) * per < nk || grid <= 0 ||
      grid > units || (splits > 1 && part == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  const int* ap = static_cast<const int*>(active);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  float* pp = static_cast<float*>(part);
  const cudaError_t err =
      tile_m == Tiling<1>::kBM
          ? launch<1>(fn, x, q, sp, ap, yp, pp, G, M, K, N, splits, per,
                      grid, st)
          : launch<2>(fn, x, q, sp, ap, yp, pp, G, M, K, N, splits, per,
                      grid, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(G) * M * N / 4;
  w8a16_large_m_reduce<<<static_cast<unsigned>((quads + 255) / 256), 256, 0,
                         st>>>(pp, sp, ap, yp, G, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}
