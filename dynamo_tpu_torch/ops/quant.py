"""Weight-only int8 quantization for serving, and the W8A16 product.

Port of dynamo_tpu/ops/quant.py. Scheme: symmetric per output channel.
For a stacked weight [..., d_in, d_out] the scale is s[..., 1, d_out] =
max(max|w| / 127, 1e-12) over the contraction axis (-2), in f32, and
q = clip(round(w / s), -127, 127) as int8 (round half to even, as
`jnp.round`), so `quantize_int8` is bit-identical to the JAX function.
The seven projections of every layer (wq, wk, wv, wo, w_gate, w_up,
w_down) and lm_head are quantized; norms and the embedding (a gather) stay
in the model dtype. A quantized leaf is {"q": int8, "s": f32}, the JAX
tree's layout, so `models/llama.params_from_jax` carries it across as is.

Every matmul site calls `linear(x, w)`, or `linear_group(x, ws)` for the
products that share one x (wq | wk | wv, w_gate | w_up):
- plain weights: `x @ w`, one product a weight;
- quantized weights on CPU tensors: `x @ wmat(w, x.dtype)` a weight, the
  plain version (JAX's `wmat` followed by the matmul);
- quantized weights on CUDA tensors, chosen by the rows M of x:
  a bf16 x at M <= GEMV_MAX_M (the decode step's slots) launches the
  grouped W8A16 decode kernel (csrc/w8a16_gemm.cu `w8a16_group`) once for
  the whole group, which dequantizes inside the product; an f32 x there
  (only the card-side f32 parity runs) launches that file's CUDA-core
  kernel once a weight; a bf16 x past that (prefill and mixed steps)
  launches the tensor-core W8A16 kernel (csrc/w8a16_large_m.cu: TMA ring,
  int8 widened in shared memory, wgmma) once a weight; an f32 x past that
  launches the dequantize entry of w8a16_gemm.cu into an f32 scratch and
  hands the product to `torch.matmul`, since a bf16 tensor-core product
  cannot hold f32's accuracy.
There is no try/except and no quiet fallback: a CUDA tensor launches a
kernel or raises.

The expert products of a mixture-of-experts layer (ops/moe.py) call
`grouped_linear(x, w, active)` on the capacity buffer x [E, M, K] and one
layer's expert slice w ([E, K, N], or {"q": [E, K, N], "s": [E, 1, N]}):
- a plain weight: one batched `torch.matmul` over the experts;
- a quantized weight on CPU tensors: the grouped kernel's plain version
  (`wmat` per expert + matmul, zeros where active[e] == 0);
- on CUDA tensors, M <= GROUPED_MAX_M (decode: B * C rows an expert with
  C = 1) launches the grouped W8A16 kernel (csrc/w8a16_moe_gemm.cu), which
  reads only the experts some row was routed to; a bf16 x past that
  (prefill and mixed steps) launches the tensor-core kernel once over all
  E experts, which skips the inactive ones and writes their zeros; an f32
  x past that dequantizes each expert with the dequantize entry and hands
  its rows to `torch.matmul`.

Why a kernel: XLA fuses the dequantize into the matmul's operand pipeline
and PyTorch does not. An eager `(q.float() * s).to(bf16)` then
`torch.matmul` at decode would read the int8 weight, write it as bf16 and
read that back (~2.5x the bytes of plain bf16). The kernel reads each
weight byte once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict

import torch

QUANT_MODES = ("", "int8")

# the layer projections quantized (the byte carriers), as in the JAX package;
# on MoE models w_gate / w_up / w_down are the stacked expert tensors
# [L, E, d_in, d_out], quantized by the same rule (scales [L, E, 1, d_out],
# per layer, expert and output channel); the router stays in the model dtype
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# rows up to which a CUDA product runs the W8A16 decode kernels: a decode
# step's M = slots (EngineConfig.max_slots, 8 by default; the
# disaggregated decode worker's 16), all of them in one pass of the
# grouped kernel. Past it a bf16 x takes the tensor-core kernel
# (w8a16_large_m.cu). Placed from the card's times at M = 8, 9, 16, 32 and
# 64 (chip_smoke.py phase 2d, PERF.md §6): at 16 rows the grouped kernel
# takes 0.0308 ms at w_gate against 0.0458 for the tensor-core kernel
# (w_gate / w_up / w_down carry ~81% of a layer's weight bytes) and ties
# it at wk (0.0095 / 0.0096); at 32 the tensor-core kernel is faster, and
# the grouped kernel takes at most 16 rows.
GEMV_MAX_M = 16

# launches of the W8A16 decode kernels (the grouped bf16 kernel and the
# per-weight entry) and of the dequantize entry since import (or since a
# caller reset them), counted as ops/paged_attention.py counts its kernel: a
# call made while its stream is being captured into a CUDA graph launches
# nothing and counts in the *_CAPTURED counter instead; the graph's owner
# (engine/window_graph.py) adds the captured calls on every replay
KERNEL_LAUNCHES = 0
CAPTURED_CALLS = 0
DEQUANT_LAUNCHES = 0
DEQUANT_CAPTURED = 0
MOE_LAUNCHES = 0
MOE_CAPTURED = 0
LARGE_M_LAUNCHES = 0
LARGE_M_CAPTURED = 0

# rows of one expert's capacity buffer up to which a CUDA expert product runs
# the grouped kernel: B * C at decode, where C = 1, for up to 16 slots (the
# disaggregated decode worker's max_slots) in passes of 8 rows. A prefill or
# mixed step's buffer holds C = T * k / E * capacity_factor rows per batch
# row and, past this, takes the dequantize + matmul route.
GROUPED_MAX_M = 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the per-weight entry's tiles (csrc/w8a16_gemm.cu `w8a16_gemm`). Its
# register-ring tensor-core kernel (bf16 x; on no route since the grouped
# kernel, kept as the old column of chip_smoke's times): 128 columns and 8
# warps a block, 128 rows of k a chunk, its splits over K one thread-block
# cluster (at most 16), aiming at ~1.5 blocks per SM with at least 4 chunks
# a split. The CUDA-core kernel (f32 x): 256 columns, 64 rows, ~2 blocks
# per SM, splits added in a second pass.
_MMA_TILE_N, _MMA_CHUNK_K = 128, 128
_MMA_MAX_SPLITS, _MMA_MIN_CHUNKS = 16, 4
_MMA_BLOCKS_PER_SM = 1.5
_F32_TILE_N, _F32_CHUNK_K, _F32_BLOCKS_PER_SM = 256, 64, 2
# rows of x a block pass: the f32 kernel's instantiations (a bf16 x always
# takes 8, the MMA's n8)
_ROWS = (1, 2, 4, 8)
# the grouped decode kernel's tiles (csrc/w8a16_gemm.cu `w8a16_group`; the
# two must agree): 128 columns (one 128-byte TMA box row) by 64 k rows a
# ring stage, up to 3 weights a launch, at most 8 splits over K (one
# cluster, the portable limit) of at least 4 stages each. Three blocks fit
# an SM (shared memory: 4 stages of a q and an x box, and the partial
# sums). A split grid aims at 1.7 blocks an SM, a grid of whole tiles at
# most 2 (PERF.md §6: a block streams at most ~12 GB/s, so more resident
# blocks stream faster, while cluster grids of 240 blocks or more at 132
# SMs ran up to 1.5x slower, the clusters not all placed at once)
GROUP_MAX_W = 3
_GRP_TILE_N, _GRP_CHUNK_K = 128, 64
_GRP_MAX_SPLITS, _GRP_MIN_CHUNKS = 8, 4
_GRP_SPLIT_BLOCKS_PER_SM, _GRP_TILE_BLOCKS_PER_SM = 1.7, 2
# its dynamic shared memory a block (kGrpSmemBytes): the ring (a q box of
# 64 x 128 bytes and an x box of 16 x 64 bf16 a stage), the four consumer
# warps' partial sums (32 lanes x 65 f32), the ring's barriers and the
# 1024-byte alignment slack
_GRP_STAGES = 4
GROUP_SMEM_BYTES = (_GRP_STAGES * (_GRP_CHUNK_K * _GRP_TILE_N + 16 * _GRP_CHUNK_K
                                   * 2) + 4 * 32 * 65 * 4
                    + 2 * 8 * _GRP_STAGES + 1024)
# the tensor-core kernel's tiles (csrc/w8a16_large_m.cu; the two must
# agree): 128 columns and 64 k a stage; 128 rows of x up to M = 128, else
# 256 (each weight tile widened once for twice the rows)
_LM_TILE_N, _LM_TILE_K = 128, 64
_LM_MIN_KBLOCKS = 4             # k-blocks of 64 a split over K, at least


def validate_mode(mode: str) -> str:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r} (supported: int8)")
    return mode


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


_QUANT_BLOCK = 1 << 26   # elements of one quantize_int8 block (256 MiB f32)


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., d_in, d_out] weight -> {"q": int8 same shape, "s": f32
    [..., 1, d_out]}, in f32 math on w's device. A stacked weight
    ([L, d_in, d_out]) is quantized one leading slice at a time, so the f32
    temporaries are one layer's, not the stack's (llama3-8b's w_gate stack
    is 7.5 GB in f32). Each slice's values are those of the whole-tensor
    formula: the scale reduces over axis -2 only. For the same reason a
    large matrix (lm_head: 4096 x 128256) is quantized in blocks of
    columns, so its f32 temporaries are a block's."""
    if w.dim() > 2 or w.numel() > _QUANT_BLOCK:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.float32,
                        device=w.device)
        if w.dim() > 2:
            parts = [(i, w[i]) for i in range(w.shape[0])]
        else:
            cols = max(_QUANT_BLOCK // w.shape[0], 1)
            parts = [((slice(None), slice(a, a + cols)), w[:, a:a + cols])
                     for a in range(0, w.shape[1], cols)]
        for at, part in parts:
            got = quantize_int8(part)
            q[at].copy_(got["q"])
            s[at].copy_(got["s"])
        return {"q": q, "s": s}
    wf = w.float()
    # divided by a tensor on w's device, not by a Python scalar: CUDA takes
    # a CPU scalar divisor as a multiply by its reciprocal, one bit off the
    # quotient the CPU and the JAX package compute
    div = torch.tensor(127.0, device=w.device)
    s = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / div, min=1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the dense projection leaves (and lm_head) of a Llama
    parameter tree; other leaves are shared, not copied."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        layers[k] = quantize_int8(layers[k])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_int8(params["lm_head"])
    return out


def wmat(w, dt: torch.dtype) -> torch.Tensor:
    """Materialize a (possibly quantized) weight for a matmul in dtype dt:
    `(q.float() * s).to(dt)`, the JAX package's `wmat`. Plain weights pass
    through."""
    if is_quantized(w):
        return (w["q"].float() * w["s"]).to(dt)
    return w


def _check_args(x, q, s):
    """What the CUDA entries take: x [M, K] contiguous f32/bf16 (or None
    for the dequantize entry), q [K, N] contiguous int8, s [1, N] or [N]
    contiguous f32, all on one device."""
    dev = q.device
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise TypeError(f"q must be a contiguous 2-D int8 tensor, got "
                        f"{q.dtype} {tuple(q.shape)}")
    k, n = q.shape
    if (s.dtype != torch.float32 or s.numel() != n or not s.is_contiguous()
            or s.device != dev):
        raise TypeError(f"s must be contiguous f32 with {n} values on {dev}, "
                        f"got {s.dtype} {tuple(s.shape)} on {s.device}")
    if x is None:
        return
    if x.device != dev:
        raise ValueError(f"x is on {x.device}, q on {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != k or not x.is_contiguous():
        raise ValueError(f"x must be contiguous [M, {k}], got "
                         f"{tuple(x.shape)}")
    if x.shape[0] < 1:
        raise ValueError("x needs at least one row")


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' C entry points, built and loaded on first use."""
    from dynamo_tpu_torch.ops import build
    lib = build.load("w8a16_gemm")
    lib.w8a16_gemm.restype = ctypes.c_int
    lib.w8a16_gemm.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
    lib.w8a16_dequant.restype = ctypes.c_int
    lib.w8a16_dequant.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p])
    lib.w8a16_group.restype = ctypes.c_int
    lib.w8a16_group.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                                + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _moe_lib():
    """The grouped kernel's C entry point, built and loaded on first use."""
    from dynamo_tpu_torch.ops import build
    lib = build.load("w8a16_moe_gemm")
    lib.w8a16_moe_gemm.restype = ctypes.c_int
    lib.w8a16_moe_gemm.argtypes = ([ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _large_m_lib():
    """The tensor-core kernel's C entry point, built and loaded on first
    use."""
    from dynamo_tpu_torch.ops import build
    lib = build.load("w8a16_large_m")
    lib.w8a16_large_m.restype = ctypes.c_int
    lib.w8a16_large_m.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                  + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def rows_per_pass(m: int, dtype=torch.float32) -> int:
    """Rows of x one block pass holds: for an f32 x the kernel's MT
    instantiation, the smallest of 1, 2, 4, 8 covering m, else 8 with m / 8
    passes; for a bf16 x always 8."""
    if dtype == torch.bfloat16:
        return _ROWS[-1]
    return next((r for r in _ROWS if r >= m), _ROWS[-1])


def _split(chunks: int, want: int, most: int) -> tuple:
    """(splits, chunks a split) covering `chunks` with about `want` splits
    (at most `most`), every split holding at least one chunk."""
    splits = max(1, min(chunks, want, most))
    per = -(-chunks // splits)
    return -(-chunks // per), per


def gemm_config(m: int, k: int, n: int, sm_count: int,
                dtype=torch.bfloat16, groups: int = 1) -> tuple:
    """The kernel's grid over K from shapes only (so a call needs no host
    sync and can be captured): (splits, chunks a split). Their sums are
    added in split order, inside their cluster (bf16 x) or in a second pass
    (f32 x). `groups`: the grouped kernel's experts, each with its own
    tiles (all counted: which are active is known only on the device)."""
    tiles_m = -(-m // rows_per_pass(m, dtype)) * groups
    if dtype == torch.float32:
        tiles = -(-n // _F32_TILE_N) * tiles_m
        want = -(-_F32_BLOCKS_PER_SM * sm_count // tiles)
        return _split(-(-k // _F32_CHUNK_K), want, 1 << 16)
    chunks = -(-k // _MMA_CHUNK_K)
    tiles = -(-n // _MMA_TILE_N) * tiles_m
    want = min(round(_MMA_BLOCKS_PER_SM * sm_count / tiles),
               chunks // _MMA_MIN_CHUNKS)
    return _split(chunks, want, _MMA_MAX_SPLITS)


def _launch_gemm(x, q, s, splits: int, per: int) -> torch.Tensor:
    """One launch of the C entry point with the given grid over K."""
    global KERNEL_LAUNCHES, CAPTURED_CALLS
    m, k = x.shape
    n = q.shape[1]
    dev = x.device
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    # the f32 kernel's split partials (the bf16 one adds them in a cluster)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 and x.dtype == torch.float32 else None)
    err = _lib().w8a16_gemm(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), m, k, n, splits, per,
        rows_per_pass(m, x.dtype), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_gemm launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED_CALLS += 1
    else:
        KERNEL_LAUNCHES += 1
    return y


def w8a16_gemm(x: torch.Tensor, q: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """y[M, N] = x[M, K] @ (f32(q[K, N]) * s[N]) with f32 accumulation, in
    x's dtype: the W8A16 kernel on PyTorch's current stream (no sync; an
    f32 x's split partials in a scratch from the caching allocator)."""
    _check_args(x, q, s)
    m, k = x.shape
    dev = x.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _launch_gemm(x, q, s, *gemm_config(
        m, k, q.shape[1], _sm_count(index), x.dtype))


def group_config(k: int, ns, sm_count: int) -> tuple:
    """The grouped decode kernel's grid from shapes only (no host sync, so
    a call can be captured): (splits over K, chunks of 64 rows a split,
    column tiles a block, blocks). The weights' column tiles of 128 form
    one column space of T tiles. With T at or past the split grid's aim
    (1.7 blocks an SM), one split, and each block walks the same number of
    tiles (the last ones one fewer), as few as keep at most 2 blocks an SM.
    With fewer tiles, each tile's K is split into as many equal parts as
    keep T x splits within that aim (at most 8, one cluster, each at least
    4 chunks); the splits' sums are added in rank order inside their
    cluster."""
    tiles = sum(-(-n // _GRP_TILE_N) for n in ns)
    chunks = -(-k // _GRP_CHUNK_K)
    aim = int(_GRP_SPLIT_BLOCKS_PER_SM * sm_count)
    if tiles >= aim:
        per_block = -(-tiles // (_GRP_TILE_BLOCKS_PER_SM * sm_count))
        return 1, chunks, per_block, -(-tiles // per_block)
    want = min(aim // tiles, chunks // _GRP_MIN_CHUNKS)
    splits, per = _split(chunks, want, _GRP_MAX_SPLITS)
    return splits, per, 1, tiles


def group_units(k: int, ns, splits: int, per: int, per_block: int,
                blocks: int) -> list:
    """The grouped kernel's work in its blocks' order (csrc/w8a16_gemm.cu
    `w8a16_group_kernel`), from shapes only: for block (split, b), the
    (weight, first column, first k row, end k row) of each tile it walks:
    tiles b, b + blocks, ... (at most per_block), each over the split's K
    range of `per` chunks of 64 rows."""
    starts = [0]
    for n in ns:
        starts.append(starts[-1] + -(-n // _GRP_TILE_N))
    units = []
    for split in range(splits):
        k_lo = split * per * _GRP_CHUNK_K
        k_hi = min(k, k_lo + per * _GRP_CHUNK_K)
        for b in range(blocks):
            for t in range(b, min(starts[-1], b + per_block * blocks),
                           blocks):
                w = max(i for i in range(len(ns)) if starts[i] <= t)
                units.append((w, (t - starts[w]) * _GRP_TILE_N, k_lo, k_hi))
    return units


def _check_group(x, qs, ss):
    """What the grouped entry takes: 1 to GROUP_MAX_W weights of one K,
    each as `_check_args` takes it, and a bf16 x of 1 to 16 rows."""
    if not 1 <= len(qs) == len(ss) <= GROUP_MAX_W:
        raise ValueError(f"the grouped W8A16 kernel takes 1 to "
                         f"{GROUP_MAX_W} weights, got {len(qs)}")
    for q, s in zip(qs, ss):
        _check_args(x, q, s)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the grouped W8A16 kernel takes a bfloat16 x, got "
                        f"{x.dtype}")
    if x.shape[0] > 16:
        raise ValueError(f"the grouped W8A16 kernel takes at most 16 rows, "
                         f"got {x.shape[0]}")


def w8a16_group(x: torch.Tensor, qs, ss) -> list:
    """[x @ (f32(q_i) * s_i) for each weight] with f32 accumulation, bf16
    outputs [M, N_i]: the grouped decode kernel, one launch on PyTorch's
    current stream for up to GROUP_MAX_W weights that share x (no sync;
    the grid from shapes only, `group_config`)."""
    global KERNEL_LAUNCHES, CAPTURED_CALLS
    _check_group(x, qs, ss)
    m, k = x.shape
    ns = [q.shape[1] for q in qs]
    dev = x.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    splits, per, per_block, _ = group_config(k, ns, _sm_count(index))
    ys = [torch.empty((m, n), dtype=torch.bfloat16, device=dev) for n in ns]
    pad = GROUP_MAX_W - len(qs)
    err = _lib().w8a16_group(
        x.data_ptr(), *[q.data_ptr() for q in qs], *[None] * pad,
        *[s.data_ptr() for s in ss], *[None] * pad,
        *[y.data_ptr() for y in ys], *[None] * pad, *ns, *[0] * pad,
        len(qs), m, k, splits, per, per_block,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_group launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED_CALLS += 1
    else:
        KERNEL_LAUNCHES += 1
    return ys


def dequantize(w: Dict[str, torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """`wmat(w, dt)` on the card: the dequantize entry writes
    (f32(q) * s) rounded to dt (round to nearest even, as `.to(dt)`) into a
    fresh [K, N] tensor; bit-identical to the plain version."""
    global DEQUANT_LAUNCHES, DEQUANT_CAPTURED
    q, s = w["q"], w["s"]
    _check_args(None, q, s)
    if dt not in _DTYPE_CODE:
        raise TypeError(f"dequantize writes float32 or bfloat16, got {dt}")
    k, n = q.shape
    out = torch.empty((k, n), dtype=dt, device=q.device)
    err = _lib().w8a16_dequant(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), k, n, _DTYPE_CODE[dt],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_dequant launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        DEQUANT_CAPTURED += 1
    else:
        DEQUANT_LAUNCHES += 1
    return out


def _check_grouped(x, q, s, active):
    """What the grouped entry takes: x [E, M, K] contiguous f32/bf16, q
    [E, K, N] contiguous int8, s contiguous f32 with E * N values ([E, 1, N]
    or [E, N]), active [E] contiguous int32, all on one device."""
    dev = q.device
    if q.dtype != torch.int8 or q.dim() != 3 or not q.is_contiguous():
        raise TypeError(f"q must be a contiguous [E, K, N] int8 tensor, got "
                        f"{q.dtype} {tuple(q.shape)}")
    e, k, n = q.shape
    if (s.dtype != torch.float32 or s.numel() != e * n
            or not s.is_contiguous() or s.device != dev):
        raise TypeError(f"s must be contiguous f32 with {e} x {n} values on "
                        f"{dev}, got {s.dtype} {tuple(s.shape)} on "
                        f"{s.device}")
    if (active.dtype != torch.int32 or tuple(active.shape) != (e,)
            or not active.is_contiguous() or active.device != dev):
        raise TypeError(f"active must be a contiguous [{e}] int32 tensor on "
                        f"{dev}, got {active.dtype} {tuple(active.shape)}")
    if x.device != dev:
        raise ValueError(f"x is on {x.device}, q on {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if (x.dim() != 3 or x.shape[0] != e or x.shape[2] != k
            or not x.is_contiguous() or x.shape[1] < 1):
        raise ValueError(f"x must be contiguous [{e}, M >= 1, {k}], got "
                         f"{tuple(x.shape)}")


def grouped_w8a16_plain(x, q, s, active) -> torch.Tensor:
    """The grouped kernel's plain version: `wmat` per expert and a matmul,
    exact zeros for every expert with active[e] == 0."""
    y = torch.matmul(x, wmat({"q": q, "s": s.reshape(q.shape[0], 1, -1)},
                             x.dtype))
    return torch.where((active > 0).view(-1, 1, 1), y,
                       torch.zeros((), dtype=y.dtype, device=y.device))


def grouped_w8a16(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ (f32(q[e]) * s[e]) with f32 accumulation, in x's dtype,
    for the experts with active[e] > 0 and zeros for the others: the grouped
    kernel on PyTorch's current stream for CUDA tensors (no sync: `active`
    is read on the device), its plain version for CPU tensors."""
    global MOE_LAUNCHES, MOE_CAPTURED
    if not x.is_cuda:
        if q.is_cuda:
            raise ValueError("x is on the CPU but the weight is on CUDA")
        return grouped_w8a16_plain(x, q, s, active)
    _check_grouped(x, q, s, active)
    e, m, k = x.shape
    n = q.shape[2]
    dev = x.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if x.dtype == torch.bfloat16:
        splits, per = gemm_config(m, k, n, _sm_count(index), x.dtype,
                                  groups=e)
    else:
        splits, per = 1, -(-k // _F32_CHUNK_K)
    y = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    err = _moe_lib().w8a16_moe_gemm(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), active.data_ptr(),
        y.data_ptr(), e, m, k, n, splits, per, rows_per_pass(m, x.dtype),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_moe_gemm launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        MOE_CAPTURED += 1
    else:
        MOE_LAUNCHES += 1
    return y


def large_m_tile_m(m: int) -> int:
    """Rows of x a tile of the tensor-core kernel: 128 up to M = 128, else
    256 (fewer widenings of each weight tile and fewer bytes of x and q
    per output; at M <= 128 the second slab would only hold TMA's
    zeros)."""
    return 128 if m <= 128 else 256


def large_m_units(groups: int, m: int, k: int, n: int, tile_m: int,
                  splits: int, per: int) -> list:
    """The kernel's units of work in its scheduler's order (csrc/
    w8a16_large_m.cu `unit_at`), from shapes only: (group, row tile,
    column tile, first k-block, end k-block) with the row tile fastest
    (blocks that run together share a weight tile through the L2), then
    the split over K, then the column tile, then the group."""
    tm = -(-m // tile_m)
    tn = -(-n // _LM_TILE_N)
    nk = -(-k // _LM_TILE_K)
    units = []
    for u in range(groups * tm * tn * splits):
        rest = u // tm
        split = rest % splits
        rest //= splits
        kb0 = split * per
        units.append((rest // tn, u % tm, rest % tn, kb0,
                      min(nk, kb0 + per)))
    return units


def large_m_config(groups: int, m: int, k: int, n: int,
                   sm_count: int) -> tuple:
    """(tile rows, splits, k-blocks a split, blocks) of the tensor-core
    kernel, from shapes only (no host sync; capturable). Fewer output
    tiles than half the SMs (wk and wv of a prefill step, any narrow
    product at a few hundred rows) split K so that about one unit runs per
    SM, each split at least _LM_MIN_KBLOCKS k-blocks; their f32 sums meet
    in a scratch the reduce kernel adds in split order. The persistent
    grid is one block an SM (a block's shared memory leaves room for no
    second one), never more than the units; block b walks units b,
    b + grid, b + 2 grid, ..."""
    tile_m = large_m_tile_m(m)
    tiles = groups * -(-m // tile_m) * -(-n // _LM_TILE_N)
    nk = -(-k // _LM_TILE_K)
    splits, per = 1, nk
    if 2 * tiles < sm_count:
        per = max(_LM_MIN_KBLOCKS, -(-nk // (sm_count // tiles)))
        splits = -(-nk // per)
        per = -(-nk // splits)
    return tile_m, splits, per, max(1, min(tiles * splits, sm_count))


def _check_large_m(x, q, s, active):
    """What the tensor-core entry takes: x [G, M, K] contiguous bf16 with
    M >= 1, q [G, K, N] contiguous int8 with N % 16 == 0 and K % 8 == 0
    (TMA's 16-byte row strides), s contiguous f32 with G * N values, x, q
    and s 16-byte aligned, active None or a contiguous [G] int32 tensor,
    all on one device."""
    dev = q.device
    if q.dtype != torch.int8 or q.dim() != 3 or not q.is_contiguous():
        raise TypeError(f"q must be a contiguous [G, K, N] int8 tensor, got "
                        f"{q.dtype} {tuple(q.shape)}")
    g, k, n = q.shape
    if n % 16 or k % 8:
        raise ValueError(f"the tensor-core W8A16 kernel needs N % 16 == 0 "
                         f"and K % 8 == 0 (TMA row strides), got K={k}, "
                         f"N={n}")
    if (s.dtype != torch.float32 or s.numel() != g * n
            or not s.is_contiguous() or s.device != dev):
        raise TypeError(f"s must be contiguous f32 with {g} x {n} values on "
                        f"{dev}, got {s.dtype} {tuple(s.shape)} on "
                        f"{s.device}")
    if active is not None and (
            active.dtype != torch.int32 or tuple(active.shape) != (g,)
            or not active.is_contiguous() or active.device != dev):
        raise TypeError(f"active must be a contiguous [{g}] int32 tensor on "
                        f"{dev}, got {active.dtype} {tuple(active.shape)}")
    if x.device != dev:
        raise ValueError(f"x is on {x.device}, q on {dev}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core W8A16 kernel takes a bfloat16 x, "
                        f"got {x.dtype}")
    if (x.dim() != 3 or x.shape[0] != g or x.shape[2] != k
            or not x.is_contiguous() or x.shape[1] < 1):
        raise ValueError(f"x must be contiguous [{g}, M >= 1, {k}], got "
                         f"{tuple(x.shape)}")
    if x.data_ptr() % 16 or q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("x, q and s must be 16-byte aligned (TMA, the "
                         "reduce's vector loads)")


def large_m_gemm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 active=None) -> torch.Tensor:
    """y[g] = x[g] @ (f32(q[g]) * s[g]), f32 accumulation, bf16 y, for the
    groups with active[g] > 0 (every group when active is None) and zeros
    for the others. Dense: x [M, K], q [K, N], s [1, N] or [N] -> [M, N];
    grouped: x [G, M, K], q [G, K, N], s [G, 1, N] or [G, N] -> [G, M, N].
    The tensor-core kernel on PyTorch's current stream for CUDA tensors (no
    sync: `active` is read on the device; the grid comes from shapes only),
    its plain version (`grouped_w8a16_plain`) for CPU tensors."""
    global LARGE_M_LAUNCHES, LARGE_M_CAPTURED
    dense = q.dim() == 2
    xg, qg = (x.unsqueeze(0), q.unsqueeze(0)) if dense else (x, q)
    if not x.is_cuda:
        if q.is_cuda:
            raise ValueError("x is on the CPU but the weight is on CUDA")
        act = (torch.ones((qg.shape[0],), dtype=torch.int32)
               if active is None else active)
        y = grouped_w8a16_plain(xg, qg, s, act)
        return y[0] if dense else y
    _check_large_m(xg, qg, s, active)
    g, m, k = xg.shape
    n = qg.shape[2]
    dev = x.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    tile_m, splits, per, grid = large_m_config(g, m, k, n,
                                               _sm_count(index))
    y = torch.empty((g, m, n), dtype=torch.bfloat16, device=dev)
    part = (torch.empty((splits, g, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    err = _large_m_lib().w8a16_large_m(
        xg.data_ptr(), qg.data_ptr(), s.data_ptr(),
        None if active is None else active.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), g, m, k, n, tile_m,
        splits, per, grid, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_large_m launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        LARGE_M_CAPTURED += 1
    else:
        LARGE_M_LAUNCHES += 1
    return y[0] if dense else y


def grouped_linear(x: torch.Tensor, w, active: torch.Tensor) -> torch.Tensor:
    """x [E, M, K] @ w expert by expert: w plain [E, K, N] or quantized
    {"q": [E, K, N] int8, "s": [E, 1, N] f32}; active [E] int32, the rows
    routed to each expert (see the module docstring for the routes)."""
    if not is_quantized(w):
        return torch.matmul(x, w)
    if not x.is_cuda or x.shape[1] <= GROUPED_MAX_M:
        return grouped_w8a16(x, w["q"], w["s"], active)
    if x.dtype == torch.bfloat16:
        return large_m_gemm(x.contiguous(), w["q"], w["s"], active)
    y = torch.empty(x.shape[:2] + (w["q"].shape[2],), dtype=x.dtype,
                    device=x.device)
    for i in range(x.shape[0]):
        torch.matmul(x[i], dequantize({"q": w["q"][i], "s": w["s"][i]},
                                      x.dtype), out=y[i])
    return y


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w, w plain [K, N] or quantized {"q": [K, N] int8, "s":
    [1, N] f32}: the one call every single-weight matmul site makes (see
    the module docstring for the routes)."""
    if not is_quantized(w):
        return x @ w
    if not x.is_cuda:
        if w["q"].is_cuda:
            raise ValueError("x is on the CPU but the weight is on CUDA")
        return x @ wmat(w, x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] <= GEMV_MAX_M and x2.dtype == torch.bfloat16:
        y = w8a16_group(x2, [w["q"]], [w["s"]])[0]
    elif x2.shape[0] <= GEMV_MAX_M:
        y = w8a16_gemm(x2, w["q"], w["s"])
    elif x2.dtype == torch.bfloat16:
        y = large_m_gemm(x2, w["q"], w["s"])
    else:
        y = x2 @ dequantize(w, x.dtype)
    return y.reshape(*lead, y.shape[-1])


def linear_group(x: torch.Tensor, ws) -> list:
    """[linear(x, w) for w in ws] for products that share x: on CUDA
    tensors with quantized weights and a bf16 x of at most GEMV_MAX_M rows,
    one launch of the grouped decode kernel for all of them (up to
    GROUP_MAX_W); every other case is `linear` a weight (see the module
    docstring for the routes)."""
    if (x.is_cuda and x.dtype == torch.bfloat16
            and 1 < len(ws) <= GROUP_MAX_W
            and all(is_quantized(w) for w in ws)
            and x.numel() // x.shape[-1] <= GEMV_MAX_M):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        ys = w8a16_group(x2, [w["q"] for w in ws], [w["s"] for w in ws])
        return [y.reshape(*lead, y.shape[-1]) for y in ys]
    return [linear(x, w) for w in ws]
