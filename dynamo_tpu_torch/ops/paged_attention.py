"""Decode attention over the paged KV cache: ONE ragged kernel.

Port of dynamo_tpu/ops/paged_attention.py. The Pallas TPU kernel
`_ragged_decode_kernel` becomes a CUDA C++ kernel for Hopper
(dynamo_tpu_torch/csrc/ragged_decode_attention.cu), bound with ctypes.
Beside it lives its plain PyTorch version (a page gather plus the masked
flash state in f32): the wrapper takes it only for CPU tensors, which is
how the CPU tests run; for CUDA tensors it launches the kernel or raises.

The kernel is split-KV over whole pages: one block per (run of pages, kv
head, row) writes a partial flash state (a kv head whose GQA group is
larger than 8 takes ceil(G / 8) blocks, each for 8 of its query heads and
each reading its pages: head dims 32, 64, 96, 128 and 256, groups up to
16), and a second small kernel merges
each row's partials (both launched by the one C call). The host picks the
run length from shapes only (`_pages_per_split`), never from lens, so a call
needs no host sync and can be captured in a CUDA graph. `_ragged_split_plain`
and `_merge_splits_plain` restate the split rules in PyTorch for the tests.

The kernel returns the UNNORMALISED flash state (acc, m, l) of each row over
the first lens[s] tokens of its pages; consumers pick the mode:

- prefix rows (`decode_paged_attention_prefix`): `lens` counts valid kv
  BEFORE the current token; fold the token itself with
  `combine_self_attention` (the deferred-write decode hot path);
- inclusive rows (`decode_paged_attention`): `lens` INCLUDES the current
  token (already written into the pages); normalise by l.

Layout contract, as in the JAX package: caches are [L, Hkv, P, ps, hd], so
one (layer, head, page) slice is a contiguous [ps, hd] block. The layer is a
Python int (the port's layer loop is a Python loop), so no per-layer slice
is ever copied.

int8 caches (kv_quant="int8", ops/kv_quant.py) come with per-row f32 scales
k_scale / v_scale, [L, Hkv, P, ps] for the whole stack ([Hkv, P, ps] for the
inclusive per-layer view). The scales fold into the scores (score * s_k,
before the mask) and the probabilities (p * s_v, inside the accumulator
product), as in the TPU kernel; l sums the bare probabilities.
"""
from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30

# launches of the CUDA kernel since import (or since a caller reset it);
# chip_smoke.py reads it to prove the main path went through the kernel. A
# call made while its stream is being captured into a CUDA graph launches
# nothing and counts in CAPTURED_CALLS instead; the graph's owner
# (engine/window_graph.py) adds the calls it captured to KERNEL_LAUNCHES on
# every replay
KERNEL_LAUNCHES = 0
CAPTURED_CALLS = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KERNEL_HEAD_DIMS = (32, 64, 96, 128, 256)
# the largest GQA group the kernel takes, and the query heads one block
# serves: a kv head's group of more than _G_BLOCK heads is split over
# ceil(G / _G_BLOCK) blocks, each reading the kv head's pages
_G_MAX = 16
_G_BLOCK = 8


def kernel_geometry_reason(head_dim: int, group: int):
    """Why the kernel cannot take a model's head dim or GQA group, or None
    when it can (the decode path's resolution, models/llama.decode_path)."""
    if head_dim not in _KERNEL_HEAD_DIMS:
        return (f"head_dim {head_dim}: the ragged kernel takes head dims "
                f"{_KERNEL_HEAD_DIMS}")
    if group > _G_MAX:
        return (f"GQA group {group}: the ragged kernel takes groups of at "
                f"most {_G_MAX}")
    return None


def _ragged_plain(q, k_cache, v_cache, layer: int, page_table, lens,
                  k_scale=None, v_scale=None):
    """The plain PyTorch version of the kernel: same outputs, computed by a
    page gather and a masked flash state in f32.

    Mirrors the TPU kernel's semantics exactly: it walks
    max(ceil(lens/ps), 1) whole pages per row, tokens past lens[s] have K
    and V (and, for an int8 cache, their scales) SELECTED to zero (recycled
    page tails may hold NaN) and scores -1e30, so an empty row ends with
    m = -1e30, l = ps and acc = 0. An int8 cache folds its scales into the
    scores (before the mask) and the probabilities of the accumulator
    product."""
    s, h, hd = q.shape
    _, hkv, _, ps, _ = k_cache.shape
    g = h // hkv
    pb = page_table.shape[1]
    ids = page_table.reshape(-1).long()
    k = k_cache[layer].index_select(1, ids).reshape(hkv, s, pb * ps, hd)
    v = v_cache[layer].index_select(1, ids).reshape(hkv, s, pb * ps, hd)
    k = k.permute(1, 0, 2, 3).float()                  # [S, Hkv, T, hd]
    v = v.permute(1, 0, 2, 3).float()
    pos = torch.arange(pb * ps, device=q.device)
    lens = lens.long()
    valid = pos[None, :] < lens[:, None]               # [S, T]
    n_pages = torch.clamp((lens + ps - 1) // ps, min=1)
    walked = pos[None, :] < (n_pages * ps)[:, None]    # pages the kernel reads
    vmask = valid[:, None, :, None]
    zero = torch.zeros((), device=q.device)
    k = torch.where(vmask, k, zero)
    v = torch.where(vmask, v, zero)
    qf = q.float().reshape(s, hkv, g, hd) * (hd ** -0.5)
    sc = torch.einsum("skgd,sktd->skgt", qf, k)
    if k_scale is not None:
        def gathered(scale):                           # [S, Hkv, 1, T]
            sg = scale[layer].index_select(1, ids).reshape(hkv, s, pb * ps)
            return torch.where(valid[:, None, :], sg.permute(1, 0, 2),
                               zero)[:, :, None, :]
        sk, sv = gathered(k_scale), gathered(v_scale)
        sc = sc * sk                                   # K dequant fold
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    m = torch.where(walked[:, None, None, :], sc,
                    torch.full((), float("-inf"), device=q.device)).amax(-1)
    p = torch.where(walked[:, None, None, :], torch.exp(sc - m[..., None]),
                    zero)
    l = p.sum(-1)
    pv = p * sv if k_scale is not None else p          # V dequant fold
    acc = torch.einsum("skgt,sktd->skgd", pv, v)
    return (acc.reshape(s, h, hd), m.reshape(s, h, 1), l.reshape(s, h, 1))


def _ragged_split_plain(q, k_cache, v_cache, layer: int, page_table, lens,
                        pages_per_split: int, k_scale=None, v_scale=None):
    """The kernel's split rules in PyTorch: split i attends pages
    [i * pps, (i + 1) * pps) of each row's table. A split whose first page
    is at or past the row's walked pages (max(ceil(len / ps), 1)) holds the
    neutral state m = -1e30, l = 0, acc = 0; an empty row's split 0 walks
    its one masked page. Returns [splits, S, H, hd] / [splits, S, H, 1]
    states for `_merge_splits_plain`."""
    pb = page_table.shape[1]
    ps = k_cache.shape[3]
    lens = torch.clamp(lens.long(), 0, pb * ps)
    n_pages = torch.clamp((lens + ps - 1) // ps, min=1)
    parts = []
    for p0 in range(0, pb, pages_per_split):
        sub = page_table[:, p0:p0 + pages_per_split].contiguous()
        sub_lens = torch.clamp(lens - p0 * ps, 0, sub.shape[1] * ps)
        acc, m, l = _ragged_plain(q, k_cache, v_cache, layer, sub,
                                  sub_lens.to(torch.int32), k_scale, v_scale)
        live = (p0 < n_pages)[:, None, None]
        parts.append((torch.where(live, acc, 0.0),
                      torch.where(live, m, NEG_INF),
                      torch.where(live, l, 0.0)))
    return tuple(torch.stack(t) for t in zip(*parts))


def _merge_splits_plain(acc, m, l):
    """The merge kernel's function: m = max m_i, l = sum l_i e^(m_i - m),
    acc = sum acc_i e^(m_i - m), summed in split order as the kernel does."""
    mx = m.amax(0)
    out_acc = torch.zeros_like(acc[0])
    out_l = torch.zeros_like(l[0])
    for i in range(acc.shape[0]):
        f = torch.exp(m[i] - mx)
        out_l = out_l + l[i] * f
        out_acc = out_acc + acc[i] * f
    return out_acc, mx, out_l


# blocks the host aims to put on the card per call: two waves of two
# resident blocks per SM (a bf16 block's ring is ~100 KB of shared memory)
_BLOCKS_PER_SM = 4


def _pages_per_split(s: int, hkv: int, pb: int, sm_count: int) -> int:
    """Pages one split block walks, from shapes only (never from lens, so
    the call needs no host sync): enough splits of each row's Pb pages that
    S * hkv * splits reaches ~_BLOCKS_PER_SM blocks per SM, each split at
    least one page (`hkv`: the blocks along the head axis, kv heads times
    their head blocks). The grid's splits = ceil(Pb / result) cover every
    page."""
    want = -(-_BLOCKS_PER_SM * sm_count // max(s * hkv, 1))
    splits = max(1, min(pb, want))
    return -(-pb // splits)


_RING_STAGES = 3
_SMEM_MAX = 232448          # 227 KB: the most a block may opt in to


def _ring_smem_bytes(q_dtype, cache_dtype, hd: int, pps: int) -> int:
    """Dynamic shared memory of one split block (the kernel's Layout):
    NS stages of K and V rows padded by 16 bytes (+ int8 scales), the
    warps' probabilities and rescale factors, an f32 copy of q when q is
    f32, and the split's page ids."""
    esz = torch.empty((), dtype=cache_dtype).element_size()
    ct = 32 if esz == 4 else 64          # tokens a stage
    nwarp = ct // 8                      # 8 tokens a warp
    stage = 2 * ct * (hd * esz + 16) + (2 * ct * 4 if esz == 1 else 0)
    q_s = (hd * 16 if q_dtype == torch.bfloat16      # q's A fragments
           else _G_BLOCK * (hd + 4) * 4)             # prescaled f32 q
    fixed = (_RING_STAGES * stage + nwarp * _G_BLOCK * 8 * 4
             + nwarp * _G_BLOCK * 4 + q_s)
    return fixed + -(-pps * 4 // 16) * 16


def _check_scales(k_cache, v_cache, k_scale, v_scale):
    """Caches and scales a CUDA kernel takes: model-dtype caches without
    scales, or int8 caches with contiguous f32 scales of their shape minus
    hd, on the caches' device."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    quant = k_cache.dtype == torch.int8 or v_cache.dtype == torch.int8
    if k_scale is None:
        if quant:
            raise TypeError("an int8 cache needs its k_scale/v_scale")
        return
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError(f"scales go with int8 caches, got "
                        f"{k_cache.dtype}/{v_cache.dtype}")
    want = tuple(k_cache.shape[:-1])
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != cache "
                             f"shape minus hd {want}")
        if t.device != k_cache.device:
            raise ValueError(f"{name} is on {t.device}, the cache on "
                             f"{k_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel_args(q, k_cache, v_cache, layer, page_table, lens,
                       k_scale=None, v_scale=None):
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("page_table", page_table), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32/bfloat16 q, got {q.dtype}")
    if k_scale is None and v_scale is None and (
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype):
        raise TypeError(f"cache dtype {k_cache.dtype}/{v_cache.dtype} != "
                        f"q dtype {q.dtype}")
    _check_scales(k_cache, v_cache, k_scale, v_scale)
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("page_table and lens must be int32")
    s, h, hd = q.shape
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(f"caches must be [L, Hkv, P, ps, hd], got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    nl, hkv, _, _, khd = k_cache.shape
    if khd != hd or hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (cache {khd}) not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if h % hkv or h // hkv > _G_MAX:
        raise ValueError(f"num_heads {h} / num_kv_heads {hkv}: need a GQA "
                         f"group of at most {_G_MAX}")
    if not 0 <= layer < nl:
        raise ValueError(f"layer {layer} outside [0, {nl})")
    if page_table.dim() != 2 or page_table.shape[0] != s \
            or lens.shape != (s,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lens "
                         f"{tuple(lens.shape)} do not match {s} rows")
    pb = page_table.shape[1]
    if pb < 1:
        raise ValueError("page_table needs at least one page per row")
    smem = _ring_smem_bytes(q.dtype, k_cache.dtype, hd, pb)
    if smem > _SMEM_MAX:
        raise ValueError(f"a split block would need {smem} bytes of shared "
                         f"memory, over the {_SMEM_MAX} a block may use")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and loaded on first use."""
    from dynamo_tpu_torch.ops import build
    fn = build.load("ragged_decode_attention").ragged_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _ptr(t):
    """A tensor's device address for ctypes; None (a null pointer) for an
    absent optional tensor."""
    return None if t is None else t.data_ptr()


def _ragged_kernel(q, k_cache, v_cache, layer: int, page_table, lens,
                   k_scale=None, v_scale=None):
    """Launch the split kernel and, when a row has more than one split, the
    merge kernel on PyTorch's current stream (no sync); one call."""
    global KERNEL_LAUNCHES, CAPTURED_CALLS
    _check_kernel_args(q, k_cache, v_cache, layer, page_table, lens,
                       k_scale, v_scale)
    fn = _kernel_fn()
    s, h, hd = q.shape
    _, hkv, p, ps, _ = k_cache.shape
    pb = page_table.shape[1]
    dev = q.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    # blocks along the head axis: one per kv head and block of its group
    heads = hkv * -(-(h // hkv) // _G_BLOCK)
    pps = _pages_per_split(s, heads, pb, _sm_count(index))
    splits = -(-pb // pps)
    acc = torch.empty((s, h, hd), dtype=torch.float32, device=dev)
    m = torch.empty((s, h, 1), dtype=torch.float32, device=dev)
    l = torch.empty((s, h, 1), dtype=torch.float32, device=dev)
    part = (None, None, None)
    if splits > 1:             # scratch for the split states
        part = (torch.empty((splits, s, h, hd), dtype=torch.float32,
                            device=dev),
                torch.empty((splits, s, h), dtype=torch.float32, device=dev),
                torch.empty((splits, s, h), dtype=torch.float32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
             lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             *(_ptr(t) for t in part), s, h, hkv, p, ps, hd, pb, pps, layer,
             hd ** -0.5, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
             stream)
    if err != 0:
        raise RuntimeError(f"ragged_decode_attention launch failed: CUDA "
                           f"error {err}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED_CALLS += 1
    else:
        KERNEL_LAUNCHES += 1
    return acc, m, l


def ragged_decode_attention(
    q: torch.Tensor,           # [S, H, hd] — one query token per sequence
    k_cache: torch.Tensor,     # [L, Hkv, P, ps, hd] (whole stack)
    v_cache: torch.Tensor,
    layer: int,                # which layer's pages to read
    page_table: torch.Tensor,  # [S, Pb] int32
    lens: torch.Tensor,        # [S] int32 — valid tokens in row s's pages
    k_scale: torch.Tensor = None,  # [L, Hkv, P, ps] f32 (int8 cache)
    v_scale: torch.Tensor = None,
):
    """THE dispatcher: the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors. Returns the unnormalised flash state (acc [S,H,hd] f32,
    m [S,H,1], l [S,H,1]) of each row over the first lens[s] tokens of its
    pages."""
    if q.is_cuda:
        return _ragged_kernel(q, k_cache, v_cache, int(layer), page_table,
                              lens, k_scale, v_scale)
    if any(t is not None and t.is_cuda for t in
           (k_cache, v_cache, page_table, lens, k_scale, v_scale)):
        raise ValueError("q is on the CPU but the cache or tables are on "
                         "CUDA")
    return _ragged_plain(q, k_cache, v_cache, int(layer), page_table, lens,
                         k_scale, v_scale)


def decode_paged_attention_prefix(q, k_cache, v_cache, layer: int,
                                  page_table, prefix_lens, k_scale=None,
                                  v_scale=None):
    """Prefix-mode view of the ragged kernel: lens counts valid kv BEFORE
    the current token, so the engine can defer all cache writes to one
    scatter per step. Returns the unnormalised state (acc, m, l); fold the
    current token via combine_self_attention."""
    return ragged_decode_attention(q, k_cache, v_cache, layer, page_table,
                                   prefix_lens, k_scale, v_scale)


def combine_self_attention(q, k_new, v_new, acc, m, l):
    """Fold the current token's kv into the prefix flash state.

    q [S, H, hd]; k_new/v_new [S, Hkv, hd]; acc [S, H, hd] f32
    UNNORMALISED; m/l [S, H, 1]. Returns normalised attention [S, H, hd] in
    q.dtype. Safe for empty prefixes (m = -1e30): the result is exactly the
    new token's value row."""
    s, h, hd = q.shape
    hkv = k_new.shape[1]
    # each kv head serves h // hkv consecutive q heads (a view + copy: no
    # host-side size computation, so the fold can run in a captured graph)
    kn = k_new[:, :, None].expand(s, hkv, h // hkv, hd).reshape(s, h, hd)
    vn = v_new[:, :, None].expand(s, hkv, h // hkv, hd).reshape(s, h, hd)
    kn, vn = kn.float(), vn.float()                      # [S, H, hd]
    s_self = (q.float() * kn).sum(-1, keepdim=True) * (hd ** -0.5)
    m2 = torch.maximum(m, s_self)
    a = torch.exp(m - m2)
    b = torch.exp(s_self - m2)
    out = (acc * a + vn * b) / (l * a + b)
    return out.to(q.dtype)


def block_attention(q, k_blk, v_blk, k_cache, v_cache, layer: int,
                    page_table, prefix_lens, k_scale=None, v_scale=None):
    """Causal attention of a block of T consecutive tokens a row over its
    cached prefix and itself: a speculative verify's [last token, drafts]
    block.

    q [S, T, H, hd]; k_blk / v_blk [S, T, Hkv, hd], the block's own rows as
    the cache stores them; prefix_lens [S], the valid kv BEFORE the block
    (block token j sits at position prefix_lens + j). Every block token is
    one row of the ragged kernel in prefix mode (S x T rows over their
    row's pages: no page gather), and the block's causal part (token i
    attends tokens j <= i) is folded into that flash state in f32, as
    combine_self_attention folds one token. The same function as
    ops/attention.paged_attention over positions [0, prefix_lens + j] in
    another summation order. Returns [S, T, H, hd] in q.dtype; no host
    read, so a verify can be captured in a graph."""
    s, t, h, hd = q.shape
    hkv = k_blk.shape[2]
    g = h // hkv
    acc, m, l = decode_paged_attention_prefix(
        q.reshape(s * t, h, hd).contiguous(), k_cache, v_cache, layer,
        page_table.repeat_interleave(t, dim=0),
        prefix_lens.repeat_interleave(t).to(torch.int32), k_scale, v_scale)
    qf = q.float().reshape(s, t, hkv, g, hd) * (hd ** -0.5)
    sc = torch.einsum("sikgd,sjkd->sikgj", qf, k_blk.float())
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    sc = torch.where(causal[None, :, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    sc = sc.reshape(s * t, h, t)
    # every block token attends itself, so the joint max is finite even
    # where the prefix is empty (m = -1e30 there)
    m2 = torch.maximum(m, sc.amax(-1, keepdim=True))
    a = torch.exp(m - m2)
    p = torch.exp(sc - m2)                                 # [S * T, H, T]
    pv = torch.einsum("sikgj,sjkd->sikgd", p.reshape(s, t, hkv, g, t),
                      v_blk.float()).reshape(s * t, h, hd)
    out = (acc * a + pv) / (l * a + p.sum(-1, keepdim=True))
    return out.reshape(s, t, h, hd).to(q.dtype)


def decode_paged_attention(q, k_cache, v_cache, page_table, kv_lens,
                           k_scale=None, v_scale=None):
    """Inclusive-mode view of the ragged kernel: [S, H, hd] attention of
    each decode token over its pages, kv_lens INCLUDING the current token.
    The per-layer [Hkv, P, ps, hd] cache (and [Hkv, P, ps] scales) ride as
    `[None]` views with layer 0; padding rows (kv_len 0) are clamped to 1
    so 1/l stays finite (their output is ignored)."""
    kv_lens = torch.clamp(kv_lens, min=1).to(torch.int32)
    acc, _, l = ragged_decode_attention(
        q, k_cache[None], v_cache[None], 0, page_table, kv_lens,
        None if k_scale is None else k_scale[None],
        None if v_scale is None else v_scale[None])
    return (acc / l).to(q.dtype)
