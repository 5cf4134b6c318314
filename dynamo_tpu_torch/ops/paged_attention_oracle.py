"""The legacy decode kernel: normalised paged decode attention, a row's
pages spread over a thread-block cluster.

Port of dynamo_tpu/ops/paged_attention_oracle.py. The JAX package keeps two
frozen Pallas kernels there behind `decode_paged_attention_legacy`:
`_decode_kernel` (direct layout, hd >= 128) and `_decode_kernel_packed`
(lane-packed layout, hd < 128). Packing is a TPU tiling trick and computes
the same function, so both become ONE CUDA kernel for Hopper
(dynamo_tpu_torch/csrc/legacy_decode_attention.cu), bound with ctypes and
instantiated at hd 128 (the direct kernel's geometry) and hd 32/64 (the
packed kernel's). Beside it lives its plain PyTorch version; the wrapper
takes it only for CPU tensors, and for CUDA tensors launches the kernel or
raises.

The schedule: one launch of (C, Hkv, S) blocks in clusters of C =
min(Pb, 8) blocks along the page axis (`_cluster_size`, from shapes only).
Block r of a cluster walks pages r, r + C, ... of its row through a
two-stage ring of bulk asynchronous copies (`_stage_tokens` tokens a stage)
and keeps a partial flash state in shared memory; the cluster merges the C
partials through distributed shared memory and writes the normalised
output. `_cluster_partials_plain` and `_cluster_merge_plain` restate that
schedule in PyTorch for the tests.

It is written apart from the ragged kernel (ops/paged_attention.py: split
blocks with device-memory scratch, a second merge kernel, a cp.async ring)
with a schedule of its own, so it serves as a second-schedule oracle: the
two agreeing on the same inputs is evidence for both. It also runs the
legacy arm of the decode A/B (dynamo_tpu_torch/bench.py:run_decode_kernel_ab).
Nothing on the serving path calls it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dynamo_tpu_torch.ops.paged_attention import (
    _DTYPE_CODE, NEG_INF, _check_scales, _ptr,
)

# the legacy kernel's geometries (legacy_decode_attention.cu), as the TPU
# kernels it replaces serve them: hd 32 and 64 (packed) and 128, GQA groups
# of at most 8
_KERNEL_HEAD_DIMS = (32, 64, 128)
_G_MAX = 8

# launches of the CUDA kernel since import (or since a caller reset it)
KERNEL_LAUNCHES = 0

# shared memory a block of the card may take (Hopper: 227 KB)
_SMEM_MAX = 232448
# the kernel's constants (legacy_decode_attention.cu)
_NW = 4              # warps a block
_NS = 2              # stages in flight
_GT = 8              # tokens a warp group
_CLUSTER_MAX = 8     # blocks a cluster, the portable maximum
_STAGE_CAP = 32768   # bytes of K + V a stage


def _cluster_size(pb: int) -> int:
    """Blocks of a row's cluster: one per page up to the portable 8, from
    the page-table width alone (never from lens, so no host sync)."""
    return min(pb, _CLUSTER_MAX)


def _stage_tokens(ps: int, hd: int, elem_size: int) -> int:
    """Tokens of one ring stage: the page, halved while its K + V exceed
    32 KB and it stays a multiple of 8 tokens (stage_tokens in the .cu)."""
    ct = ps
    while 2 * ct * hd * elem_size > _STAGE_CAP and ct % 16 == 0:
        ct //= 2
    return ct


def _smem_bytes(elem_size: int, hd: int, ps: int, pb: int) -> int:
    """A block's dynamic shared memory (the .cu's Layout): 128 bytes of
    stage barriers; the ring of two stages of K and V rows (+ the int8
    scale rows), at least the warps' f32 states it is reused for; the
    partials the block gathers from its cluster (acc for its outputs from
    every block, at most G_MAX * hd / 128 + 7 chunks of 128 f32; (m, l) of
    every block and head); the warps' probabilities, rescale factors and
    (m, l); the block's page ids. A
    launch that asks for more than the card has fails with a CUDA error."""
    quant = elem_size == 1
    ct = _stage_tokens(ps, hd, elem_size)
    stage = 2 * ct * hd * elem_size + (2 * ct * 4 if quant else 0)
    ring = max(_NS * stage, _NW * _G_MAX * hd * 4)
    nt = 32 * _NW
    gather = ((_G_MAX * hd // nt + _CLUSTER_MAX - 1) * nt * 4
              + 2 * _CLUSTER_MAX * _G_MAX * 4)
    fixed = (128 + ring + gather + _NW * _G_MAX * _GT * 4
             + _NW * _G_MAX * 4 + 2 * _NW * _G_MAX * 4)
    n_pid = -(-pb // _cluster_size(pb))
    return fixed + -(-n_pid * 4 // 16) * 16


def _legacy_plain(q, k_cache, v_cache, page_table, kv_lens, k_scale=None,
                  v_scale=None):
    """The plain PyTorch version of the kernel: a page gather, then a
    masked softmax in f32 normalised by its sum, cast to q's dtype.

    kv_lens are clamped to [1, Pb*ps]. Tokens at or past the length have K,
    V (and, for an int8 cache, their scales) selected to zero and scores
    -1e30; an int8 cache folds its scales into the scores before the mask
    and into the probabilities of the output product, as the TPU kernels
    do (oracle.py:94-103)."""
    s, h, hd = q.shape
    hkv, _, ps, _ = k_cache.shape
    g = h // hkv
    pb = page_table.shape[1]
    ids = page_table.reshape(-1).long()

    def gather(cache):                                 # [S, Hkv, T, ...]
        return cache.index_select(1, ids).reshape(
            hkv, s, pb * ps, *cache.shape[3:]).transpose(0, 1).float()

    lens = torch.clamp(kv_lens.long(), 1, pb * ps)
    valid = torch.arange(pb * ps, device=q.device)[None, :] < lens[:, None]
    zero = torch.zeros((), device=q.device)
    k = torch.where(valid[:, None, :, None], gather(k_cache), zero)
    v = torch.where(valid[:, None, :, None], gather(v_cache), zero)
    qf = q.float().reshape(s, hkv, g, hd) * (hd ** -0.5)
    sc = torch.einsum("skgd,sktd->skgt", qf, k)
    if k_scale is not None:
        sk = torch.where(valid[:, None, :], gather(k_scale), zero)
        sv = torch.where(valid[:, None, :], gather(v_scale), zero)
        sc = sc * sk[:, :, None, :]                    # K dequant fold
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if k_scale is not None:
        p = p * sv[:, :, None, :]                      # V dequant fold
    out = torch.einsum("skgt,sktd->skgd", p, v) / l
    return out.reshape(s, h, hd).to(q.dtype)


def _cluster_partials_plain(q, k_cache, v_cache, page_table, kv_lens,
                            k_scale=None, v_scale=None):
    """The kernel's per-block partials in PyTorch: block r of a row's
    cluster attends pages r, r + C, ... (C = _cluster_size(Pb)) over the
    tokens below the clamped length, with the int8 folds. Every page but
    the row's last is full, so those tokens are a prefix of the block's
    pages. A block with none holds m = -1e30, l = 0, acc = 0. Returns f32
    acc [C, S, H, hd], m and l [C, S, H, 1] for `_cluster_merge_plain`."""
    s, h, hd = q.shape
    hkv, _, ps, _ = k_cache.shape
    g = h // hkv
    pb = page_table.shape[1]
    c = _cluster_size(pb)
    lens = torch.clamp(kv_lens.long(), 1, pb * ps)
    zero = torch.zeros((), device=q.device)
    qf = q.float().reshape(s, hkv, g, hd) * (hd ** -0.5)
    parts = []
    for r in range(c):
        sub = page_table[:, r::c]
        first = torch.arange(r, pb, c, device=q.device) * ps   # [n]
        # valid tokens of each of the block's pages, then their sum
        n_sub = torch.clamp(lens[:, None] - first[None, :], 0, ps).sum(1)
        ids = sub.reshape(-1).long()
        n = sub.shape[1]

        def gather(cache):                         # [S, Hkv, n * ps, ...]
            return cache.index_select(1, ids).reshape(
                hkv, s, n * ps, *cache.shape[3:]).transpose(0, 1).float()

        valid = torch.arange(n * ps, device=q.device)[None, :] \
            < n_sub[:, None]                        # [S, n * ps]
        k = torch.where(valid[:, None, :, None], gather(k_cache), zero)
        v = torch.where(valid[:, None, :, None], gather(v_cache), zero)
        sc = torch.einsum("skgd,sktd->skgt", qf, k)
        if k_scale is not None:
            sk = torch.where(valid[:, None, :], gather(k_scale), zero)
            sv = torch.where(valid[:, None, :], gather(v_scale), zero)
            sc = sc * sk[:, :, None, :]                # K dequant fold
        sc = torch.where(valid[:, None, None, :], sc,
                         torch.full((), NEG_INF, device=q.device))
        m = sc.amax(-1, keepdim=True)                 # -1e30 on idle blocks
        p = torch.where(valid[:, None, None, :], torch.exp(sc - m), zero)
        l = p.sum(-1, keepdim=True)
        if k_scale is not None:
            p = p * sv[:, :, None, :]                  # V dequant fold
        acc = torch.einsum("skgt,sktd->skgd", p, v)
        parts.append((acc.reshape(s, h, hd), m.reshape(s, h, 1),
                      l.reshape(s, h, 1)))
    return tuple(torch.stack(t) for t in zip(*parts))


def _cluster_merge_plain(acc, m, l, dtype):
    """The cluster's merge: M = max m_c, then sum_c acc_c e^(m_c - M) /
    sum_c l_c e^(m_c - M), summed in rank order, cast to `dtype`. Rank 0
    always holds token 0, so the sum of l is at least 1 and every m is
    finite."""
    mx = m.amax(0)
    f = torch.exp(m - mx)                              # [C, S, H, 1]
    out = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for c in range(acc.shape[0]):
        out = out + acc[c] * f[c]
        den = den + l[c] * f[c]
    return (out / den).to(dtype)


def _check_kernel_args(q, k_cache, v_cache, page_table, kv_lens,
                       k_scale=None, v_scale=None):
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("page_table", page_table), ("kv_lens", kv_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32/bfloat16 q, got {q.dtype}")
    if k_scale is None and v_scale is None and (
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype):
        raise TypeError(f"cache dtype {k_cache.dtype}/{v_cache.dtype} != "
                        f"q dtype {q.dtype}")
    _check_scales(k_cache, v_cache, k_scale, v_scale)
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("page_table and kv_lens must be int32")
    s, h, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"caches must be [Hkv, P, ps, hd], got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    hkv, _, ps, khd = k_cache.shape
    if khd != hd or hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (cache {khd}) not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if h % hkv or h // hkv > _G_MAX:
        raise ValueError(f"num_heads {h} / num_kv_heads {hkv}: need a GQA "
                         f"group of at most {_G_MAX}")
    if page_table.dim() != 2 or page_table.shape[0] != s \
            or kv_lens.shape != (s,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / kv_lens "
                         f"{tuple(kv_lens.shape)} do not match {s} rows")
    if ps % _GT:
        raise ValueError(f"page size {ps} is not a multiple of {_GT} tokens")
    pb = page_table.shape[1]
    if pb < 1:
        raise ValueError("page_table needs at least one page per row")
    smem = _smem_bytes(k_cache.element_size(), hd, ps, pb)
    if smem > _SMEM_MAX:
        raise ValueError(f"page size {ps} at hd {hd} needs {smem} bytes of "
                         f"shared memory, over the card's {_SMEM_MAX}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and loaded on first use."""
    from dynamo_tpu_torch.ops import build
    fn = build.load("legacy_decode_attention").legacy_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


def _legacy_kernel(q, k_cache, v_cache, page_table, kv_lens, k_scale=None,
                   v_scale=None):
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global KERNEL_LAUNCHES
    _check_kernel_args(q, k_cache, v_cache, page_table, kv_lens, k_scale,
                       v_scale)
    fn = _kernel_fn()
    s, h, hd = q.shape
    hkv, p, ps, _ = k_cache.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
             kv_lens.data_ptr(), out.data_ptr(), s, h, hkv, p, ps, hd,
             page_table.shape[1], hd ** -0.5, _DTYPE_CODE[q.dtype],
             _DTYPE_CODE[k_cache.dtype], stream)
    if err != 0:
        raise RuntimeError(f"legacy_decode_attention launch failed: CUDA "
                           f"error {err}")
    KERNEL_LAUNCHES += 1
    return out


def decode_paged_attention_legacy(
    q: torch.Tensor,           # [S, H, hd] — one query token per sequence
    k_cache: torch.Tensor,     # [Hkv, P, ps, hd]
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [S, Pb] int32
    kv_lens: torch.Tensor,     # [S] int32 (>= 1 per active slot)
    k_scale: torch.Tensor = None,  # [Hkv, P, ps] f32 (int8 cache)
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """The legacy decode attention: [S, H, hd] in q's dtype, NORMALISED,
    each row over the first kv_lens[s] tokens of its pages (kv_lens
    clamped to at least 1). The CUDA kernel for CUDA tensors, its plain
    version for CPU tensors. The kernel clamps kv_lens itself, so a CUDA
    call is the one launch."""
    if q.is_cuda:
        return _legacy_kernel(q, k_cache, v_cache, page_table,
                              kv_lens.to(torch.int32), k_scale, v_scale)
    kv_lens = torch.clamp(kv_lens, min=1).to(torch.int32)
    if any(t is not None and t.is_cuda for t in
           (k_cache, v_cache, page_table, kv_lens, k_scale, v_scale)):
        raise ValueError("q is on the CPU but the cache or tables are on "
                         "CUDA")
    return _legacy_plain(q, k_cache, v_cache, page_table, kv_lens, k_scale,
                         v_scale)
