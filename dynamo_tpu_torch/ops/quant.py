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

Every matmul site calls `linear(x, w)`:
- a plain weight: `x @ w`;
- a quantized weight on CPU tensors: `x @ wmat(w, x.dtype)`, the plain
  version (JAX's `wmat` followed by the matmul);
- a quantized weight on CUDA tensors, chosen by the rows M of x:
  M <= GEMV_MAX_M (the decode step's slots) launches the hand-written
  W8A16 kernel (csrc/w8a16_gemm.cu), which dequantizes inside the product;
  larger M (prefill and mixed steps) launches the same source's dequantize
  entry into a bf16 / f32 scratch and hands the product to `torch.matmul`,
  as the JAX package leaves that product to XLA.
There is no try/except and no quiet fallback: a CUDA tensor launches a
kernel or raises.

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

# the layer projections quantized (the byte carriers), as in the JAX package
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# rows up to which a CUDA product runs the W8A16 kernel: the decode step's
# M = slots (EngineConfig.max_slots, 8 by default). Prefill and mixed steps
# (M >= the smallest prefill bucket, 16) take the dequantize + matmul route;
# chip_smoke.py times both routes at M = 16 and 512.
GEMV_MAX_M = 8

# launches of the W8A16 GEMM kernel and of the dequantize entry since import
# (or since a caller reset them), counted as ops/paged_attention.py counts
# its kernel: a call made while its stream is being captured into a CUDA
# graph launches nothing and counts in the *_CAPTURED counter instead; the
# graph's owner (engine/window_graph.py) adds the captured calls on every
# replay
KERNEL_LAUNCHES = 0
CAPTURED_CALLS = 0
DEQUANT_LAUNCHES = 0
DEQUANT_CAPTURED = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' tiles (csrc/w8a16_gemm.cu). The tensor-core kernel (bf16 x):
# 128 columns and 8 warps a block, 128 rows of k a chunk, its splits over K
# one thread-block cluster (at most 16), aiming at ~1.5 blocks per SM (two
# fit by registers, so the grid stays within one wave) with at least 4
# chunks a split. The CUDA-core kernel (f32 x): 256 columns, 64
# rows, ~2 blocks per SM, splits added in a second pass.
_MMA_TILE_N, _MMA_CHUNK_K = 128, 128
_MMA_MAX_SPLITS, _MMA_MIN_CHUNKS = 16, 4
_MMA_BLOCKS_PER_SM = 1.5
_F32_TILE_N, _F32_CHUNK_K, _F32_BLOCKS_PER_SM = 256, 64, 2
# rows of x a block pass: the f32 kernel's instantiations (a bf16 x always
# takes 8, the MMA's n8)
_ROWS = (1, 2, 4, 8)


def validate_mode(mode: str) -> str:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r} (supported: int8)")
    return mode


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., d_in, d_out] weight -> {"q": int8 same shape, "s": f32
    [..., 1, d_out]}, in f32 math on w's device. A stacked weight
    ([L, d_in, d_out]) is quantized one leading slice at a time, so the f32
    temporaries are one layer's, not the stack's (llama3-8b's w_gate stack
    is 7.5 GB in f32). Each slice's values are those of the whole-tensor
    formula: the scale reduces over axis -2 only."""
    if w.dim() > 2:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            part = quantize_int8(w[i])
            q[i].copy_(part["q"])
            s[i].copy_(part["s"])
        return {"q": q, "s": s}
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
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
                dtype=torch.bfloat16) -> tuple:
    """The kernel's grid over K from shapes only (so a call needs no host
    sync and can be captured): (splits, chunks a split). Their sums are
    added in split order, inside their cluster (bf16 x) or in a second pass
    (f32 x)."""
    tiles_m = -(-m // rows_per_pass(m, dtype))
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


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w, w plain [K, N] or quantized {"q": [K, N] int8, "s":
    [1, N] f32}: the one call every matmul site makes (see the module
    docstring for the routes)."""
    if not is_quantized(w):
        return x @ w
    if not x.is_cuda:
        if w["q"].is_cuda:
            raise ValueError("x is on the CPU but the weight is on CUDA")
        return x @ wmat(w, x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] <= GEMV_MAX_M:
        y = w8a16_gemm(x2, w["q"], w["s"])
    else:
        y = x2 @ dequantize(w, x.dtype)
    return y.reshape(*lead, y.shape[-1])
