"""Attention over a paged KV cache: prefill, mixed steps and the gather
decode.

Port of dynamo_tpu/ops/attention.py: `gather_pages`, `paged_attention`
(prefill / mixed rows, and single-token rows on the gather path: gather the
pages, then masked attention in f32), the gather decode's two forms,
`decode_attention_split` (a window's read-only base + its in-window buffer
+ the current token's self-term, one joint softmax) and
`decode_attention_deferred` (the pages gathered every step + the
self-term), `write_kv_pages` and its int8 twin `write_kv_pages_quant`
(ops/kv_quant.py), and `scatter_new_kv`, the decode's one scatter of
every layer's new rows (the engine's window and a draft model's
proposals). None of these is a Pallas kernel in the JAX package, so
they are plain torch ops here; the ragged decode kernel is
ops/paged_attention.py.

Gemma-2's knobs run through every path here, as in JAX: `softcap` (scores
pass through tanh(s / cap) * cap after the scale, before the masks),
`window` (a sliding width: keys with q_pos - k_pos >= window are masked; a
Python int, global layers carry the 1 << 30 sentinel) and `q_scale` (the
query scale, query_pre_attn_scalar ** -0.5; 0 selects head_dim ** -0.5).
Scores are f32 as JAX's `preferred_element_type=jnp.float32`: in the
decode paths a layer's K and V stay in the model dtype and each product is
a batched matmul with f32 accumulation and an f32 result (`_mm_f32`; bf16
products are exact in f32), so no widened copy of a layer's base is made;
the probabilities enter the P.V product as a bf16 high and low part (~16
bits, as the ragged kernel keeps them).

Caches are [Hkv, P, ps, hd] per layer, as in the JAX package; int8 caches
carry [Hkv, P, ps] f32 scales beside them.

Dropped writes: JAX scatters with mode="drop" at out-of-range indices. torch
has no dropping scatter, and filtering the rows on the device would stall
the host on every layer. Instead the engine allocates one page more than it
ever hands out (see models/llama.init_cache): rows with write index < 0 are
written into that last, scratch page, which no page table references.
"""
from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.ops.kv_quant import (
    gather_dequant, is_quantized_cache, quantize_rows,
)

NEG_INF = -1e30


def _scale(hd: int, q_scale: float) -> float:
    return q_scale if q_scale else hd ** -0.5


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh soft-cap (Gemma-2); identity when cap == 0."""
    if not cap:
        return scores
    return torch.tanh(scores / cap) * cap


def _neg_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, device=x.device)


def gather_pages(cache: torch.Tensor, page_table: torch.Tensor):
    """[Hkv, P, ps, hd] gathered by [B, Pb] -> [Hkv, B, Pb*ps, hd]."""
    b, pb = page_table.shape
    hkv, _, ps, hd = cache.shape
    gathered = cache.index_select(1, page_table.reshape(-1).long())
    return gathered.reshape(hkv, b, pb * ps, hd)


def paged_attention(
    q: torch.Tensor,            # [B, Tq, H, hd]
    k_cache: torch.Tensor,      # [Hkv, P, ps, hd]
    v_cache: torch.Tensor,      # [Hkv, P, ps, hd]
    page_table: torch.Tensor,   # [B, Pb] int32
    kv_lens: torch.Tensor,      # [B] int32 — valid kv length per sequence
    q_positions: torch.Tensor,  # [B, Tq] int32 — absolute query positions
    k_scale: torch.Tensor = None,  # [Hkv, P, ps] f32 — int8 cache
    v_scale: torch.Tensor = None,
    softcap: float = 0.0,
    window: Optional[int] = None,  # sliding width (None: full attention)
    q_scale: float = 0.0,
) -> torch.Tensor:
    """Causal attention of q against the paged KV prefix. Returns
    [B, Tq, H, hd] in q.dtype. An int8 cache is dequantized to q.dtype
    right after the page gather, as in the JAX package."""
    b, tq, h, hd = q.shape
    hkv = k_cache.shape[0]
    g = h // hkv
    if k_scale is not None:
        k = gather_dequant(k_cache, k_scale, page_table, q.dtype)
        v = gather_dequant(v_cache, v_scale, page_table, q.dtype)
    else:
        k = gather_pages(k_cache, page_table)   # [Hkv, B, Lk, hd]
        v = gather_pages(v_cache, page_table)
    lk = k.shape[2]
    qg = q.reshape(b, tq, hkv, g, hd)
    scores = torch.einsum("btkgd,kbsd->bkgts", qg.float(), k.float())
    scores = _softcap(scores * _scale(hd, q_scale), softcap)
    kv_pos = torch.arange(lk, device=q.device)[None, :]          # [1, Lk]
    qpos = q_positions.long()[:, :, None]                          # [B,Tq,1]
    causal = kv_pos[:, None, :] <= qpos                            # [B,Tq,Lk]
    valid = kv_pos < kv_lens.long()[:, None]                       # [B, Lk]
    mask = causal & valid[:, None, :]
    if window is not None:
        # keep keys inside (q_pos - window, q_pos]
        mask = mask & (qpos - kv_pos[:, None, :] < window)
    scores = torch.where(mask[:, None, None, :, :], scores, _neg_inf(q))
    probs = torch.softmax(scores, dim=-1)
    # rows past kv_lens are whatever the recycled page last held — zero
    # them so a stale non-finite value can't ride 0 * NaN through the
    # masked probabilities (the mask already zeroes their probs; IEEE
    # multiplication does not). Masked-out K is safe: the where on scores
    # discards it before the softmax.
    v = torch.where(valid[None, :, :, None], v.float(),
                    torch.zeros((), device=q.device))
    out = torch.einsum("bkgts,kbsd->btkgd", probs, v)
    return out.reshape(b, tq, h, hd).to(q.dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with f32 products and sums and an f32 result. bf16
    operands stay bf16 on the card (cuBLAS accumulates them in f32 and
    writes f32: `out_dtype`), so no widened copy of a layer's K or V is
    ever made; bf16 products are exact in f32. The CPU widens them (its
    bmm has no out_dtype)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _heads_major(qg: torch.Tensor) -> torch.Tensor:
    """q [B, Hkv, G, hd] -> [Hkv * B, G, hd], the batch order of the
    [Hkv, B, S, hd] K/V views (one small copy)."""
    b, k, g, hd = qg.shape
    return qg.transpose(0, 1).reshape(k * b, g, hd)


def _masked_scores(q_kb, k, sc: float, softcap: float, mask):
    """Scores [Hkv * B, G, S] of q_kb [Hkv * B, G, hd] against k [Hkv, B,
    S, hd], in f32, scaled, soft-capped, and -1e30 where mask [B, S] is
    False."""
    hkv, b, n, hd = k.shape
    s = _mm_f32(q_kb, k.reshape(hkv * b, n, hd).transpose(1, 2))
    s = _softcap(s * sc, softcap)
    full = mask[None].expand(hkv, b, n).reshape(hkv * b, 1, n)
    return torch.where(full, s, _neg_inf(s))


def _masked_values(v, mask):
    """v [Hkv, B, S, hd] with the rows where mask [B, S] is False zeroed
    (a copy in v's dtype): a stale non-finite row past the valid length
    can't ride 0 * NaN through the masked probabilities."""
    return torch.where(mask[None, :, :, None], v, torch.zeros((), dtype=v.dtype,
                                                              device=v.device))


def _p_dot_v(p, v):
    """sum_s p[kb, g, s] v[kb, s, d] -> [Hkv * B, G, hd] f32, for p f32
    [Hkv * B, G, S] and v [Hkv, B, S, hd]. bf16 values take p as a bf16
    high part plus a bf16 low part (~16 bits of p, as the ragged kernel
    keeps them) stacked into one product, so V is read once; JAX rounds p
    to the values' dtype (`p.astype(v.dtype)`), the same in f32."""
    hkv, b, n, hd = v.shape
    v3 = v.reshape(hkv * b, n, hd)
    if v.dtype == torch.float32:
        return torch.bmm(p, v3)
    hi = p.to(v.dtype)
    lo = (p - hi.float()).to(v.dtype)
    g = p.shape[1]
    out = _mm_f32(torch.cat([hi, lo], 1), v3)
    return out[:, :g] + out[:, g:]


def _self_term(qg, k_new, sc: float, softcap: float):
    """The current token's score [B, Hkv, G] (k_new [B, Hkv, hd])."""
    return _softcap(torch.einsum("bkgd,bkd->bkg", qg.float(),
                                 k_new.float()) * sc, softcap)


def _finish(num_kb, p_self, v_new, denom, b: int, dtype):
    """(sum of p v over the groups [Hkv * B, G, hd] + the self-term) /
    denom, as [B, H, hd] in `dtype`."""
    hkv, g, hd = v_new.shape[1], num_kb.shape[1], num_kb.shape[2]
    out = num_kb.reshape(hkv, b, g, hd).transpose(0, 1)
    out = out + p_self[..., None] * v_new.float()[:, :, None, :]
    out = out / denom[..., None]
    return out.reshape(b, hkv * g, hd).to(dtype)


def decode_attention_split(
    q: torch.Tensor,          # [B, H, hd] — one query token per sequence
    k_base: torch.Tensor,     # [Hkv, B, Lb, hd] — read-only pre-window KV
    v_base: torch.Tensor,
    k_win: torch.Tensor,      # [Hkv, B, Nw, hd] — in-window KV buffer
    v_win: torch.Tensor,
    k_new: torch.Tensor,      # [B, Hkv, hd] — this step's kv (self-term)
    v_new: torch.Tensor,
    base_lens: torch.Tensor,  # [B] int — valid kv at WINDOW start
    win_lens: torch.Tensor,   # [B] int — tokens written in-window so far
    softcap: float = 0.0,
    window: Optional[int] = None,
    q_scale: float = 0.0,
) -> torch.Tensor:
    """Decode attention over a base-plus-window split KV view
    (dynamo_tpu/ops/attention.py:115-195).

    The window decode gathers each slot's valid prefix pages once a window
    into a read-only base buffer (positions [0, base_lens)) and keeps the
    in-window tokens in a small [.., Nw, ..] buffer at the step index
    (absolute position base_lens + j). The three score groups — base,
    window, the current token's self-term — merge in one joint softmax,
    exact because decode is causal. Sliding-window masks use the same
    absolute coordinates: the query sits at base_lens + win_lens, base keys
    at their index, window keys at base_lens + j. The base's V rows past
    base_lens must be zero (the engine's window zeroes them as it gathers
    the base, once a window, sparing a masked copy of the base every
    step; JAX masks them here): a stale non-finite value there would ride
    0 * NaN through the masked probabilities. Its K rows and the window's
    rows past their lengths may hold anything. Returns [B, H, hd] in
    q.dtype."""
    b, h, hd = q.shape
    hkv = k_base.shape[0]
    g = h // hkv
    lb, nw = k_base.shape[2], k_win.shape[2]
    sc = _scale(hd, q_scale)
    qg = q.reshape(b, hkv, g, hd)
    q_kb = _heads_major(qg)
    base_lens, win_lens = base_lens.long(), win_lens.long()
    base_pos = torch.arange(lb, device=q.device)[None, :]
    base_mask = base_pos < base_lens[:, None]
    win_pos = torch.arange(nw, device=q.device)[None, :]
    win_mask = win_pos < win_lens[:, None]
    v_win = _masked_values(v_win, win_mask)
    if window is not None:
        q_pos = (base_lens + win_lens)[:, None]              # [B, 1]
        base_mask = base_mask & (q_pos - base_pos < window)
        # q_pos - (base_lens + j) = win_lens - j
        win_mask = win_mask & (win_lens[:, None] - win_pos < window)
    sb = _masked_scores(q_kb, k_base, sc, softcap, base_mask)
    sw = _masked_scores(q_kb, k_win, sc, softcap, win_mask)
    s_self = _self_term(qg, k_new, sc, softcap)              # [B, Hkv, G]
    # joint softmax across the three groups; s_self is never masked, so the
    # max is finite even for an empty base and window (padding slots)
    m_kb = torch.maximum(sb.amax(-1), sw.amax(-1))           # [Hkv * B, G]
    m = torch.maximum(m_kb.reshape(hkv, b, g).transpose(0, 1), s_self)
    m_col = m.transpose(0, 1).reshape(hkv * b, g, 1)
    pb = torch.exp(sb - m_col)
    pw = torch.exp(sw - m_col)
    p_self = torch.exp(s_self - m)
    denom = (pb.sum(-1) + pw.sum(-1)).reshape(hkv, b, g).transpose(0, 1)
    denom = denom + p_self
    num = _p_dot_v(pb, v_base) + _p_dot_v(pw, v_win)
    return _finish(num, p_self, v_new, denom, b, q.dtype)


def decode_attention_deferred(
    q: torch.Tensor,            # [B, H, hd] — one query token per sequence
    k_cache: torch.Tensor,      # [Hkv, P, ps, hd]
    v_cache: torch.Tensor,
    k_new: torch.Tensor,        # [B, Hkv, hd] — this step's kv (NOT cached)
    v_new: torch.Tensor,
    page_table: torch.Tensor,   # [B, Pb] int32
    prefix_lens: torch.Tensor,  # [B] int — valid kv BEFORE this token
    softcap: float = 0.0,
    window: Optional[int] = None,
    q_scale: float = 0.0,
    k_scale: torch.Tensor = None,  # [Hkv, P, ps] f32 — int8 cache
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """Decode attention with the current token's kv as an explicit
    self-term (dynamo_tpu/ops/attention.py:197-262): the cache stays
    read-only during the step, the caller scatters every layer's new rows
    once. The pages are gathered every call; an int8 cache is dequantized
    to q.dtype right after the gather. Returns [B, H, hd] in q.dtype."""
    b, h, hd = q.shape
    hkv = k_cache.shape[0]
    g = h // hkv
    if k_scale is not None:
        k = gather_dequant(k_cache, k_scale, page_table, q.dtype)
        v = gather_dequant(v_cache, v_scale, page_table, q.dtype)
    else:
        k = gather_pages(k_cache, page_table)   # [Hkv, B, Lk, hd]
        v = gather_pages(v_cache, page_table)
    lk = k.shape[2]
    sc = _scale(hd, q_scale)
    qg = q.reshape(b, hkv, g, hd)
    prefix_lens = prefix_lens.long()
    kv_pos = torch.arange(lk, device=q.device)[None, :]
    valid = kv_pos < prefix_lens[:, None]
    v = _masked_values(v, valid)
    if window is not None:
        # the query's absolute position is prefix_lens
        valid = valid & (prefix_lens[:, None] - kv_pos < window)
    scores = _masked_scores(_heads_major(qg), k, sc, softcap, valid)
    s_self = _self_term(qg, k_new, sc, softcap)              # [B, Hkv, G]
    m = torch.maximum(scores.amax(-1).reshape(hkv, b, g).transpose(0, 1),
                      s_self)
    p = torch.exp(scores - m.transpose(0, 1).reshape(hkv * b, g, 1))
    p_self = torch.exp(s_self - m)
    denom = p.sum(-1).reshape(hkv, b, g).transpose(0, 1) + p_self
    return _finish(_p_dot_v(p, v), p_self, v_new, denom, b, q.dtype)


def write_slots(write_idx: torch.Tensor, p: int, ps: int) -> torch.Tensor:
    """Flat token slots of a write; skipped rows (index < 0) go to the
    scratch page, the cache's last."""
    idx = write_idx.reshape(-1).long()
    scratch = (p - 1) * ps + torch.arange(idx.shape[0], device=idx.device) % ps
    return torch.where(idx >= 0, idx, scratch)


def write_kv_pages(
    k_cache: torch.Tensor,    # [Hkv, P, ps, hd], updated IN PLACE
    v_cache: torch.Tensor,
    k_new: torch.Tensor,      # [B, Tq, Hkv, hd]
    v_new: torch.Tensor,
    write_idx: torch.Tensor,  # [B, Tq] int32 flat indices into P*ps; <0 = skip
):
    """Scatter new KV entries into the paged cache at flat token slots.
    Skipped rows land in the cache's last page (the scratch page), never
    in a page a sequence owns. Returns the (same) caches."""
    hkv, p, ps, hd = k_cache.shape
    flat_k = k_cache.view(hkv, p * ps, hd)
    flat_v = v_cache.view(hkv, p * ps, hd)
    idx = write_slots(write_idx, p, ps)
    kn = k_new.reshape(-1, hkv, hd).transpose(0, 1).to(flat_k.dtype)
    vn = v_new.reshape(-1, hkv, hd).transpose(0, 1).to(flat_v.dtype)
    flat_k.index_copy_(1, idx, kn)
    flat_v.index_copy_(1, idx, vn)
    return k_cache, v_cache


def scatter_new_kv(cache, k_news, v_news, write_idx):
    """One in-place scatter of all layers' new kv rows (deferred write).

    cache {k, v[, k_scale, v_scale]}: [L, Hkv, P, ps, hd] (+ [L, Hkv, P,
    ps] scales); k_news/v_news [L, S, Hkv, hd] full-precision rows;
    write_idx [S] flat token slots (<0 = dropped: those rows land in the
    cache's last page, the scratch page no page table references). On an
    int8 cache the rows quantize here and the int8 values and f32 scales
    scatter together."""
    l, hkv, p, ps, hd = cache["k"].shape  # dynalint: kv-codec (shape only)
    idx = write_slots(write_idx, p, ps)
    for key, new in (("k", k_news), ("v", v_news)):
        flat = cache[key].view(l, hkv, p * ps, hd)
        if is_quantized_cache(cache):
            new, scale = quantize_rows(new)   # [L,S,Hkv,hd] / [L,S,Hkv]
            cache[f"{key}_scale"].view(l, hkv, p * ps).index_copy_(
                2, idx, scale.permute(0, 2, 1))
        flat.index_copy_(2, idx, new.permute(0, 2, 1, 3).to(flat.dtype))
    return cache


def write_kv_pages_quant(
    k_cache: torch.Tensor,    # [Hkv, P, ps, hd] int8, updated IN PLACE
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,    # [Hkv, P, ps] f32 per-row scales, IN PLACE
    v_scale: torch.Tensor,
    k_new: torch.Tensor,      # [B, Tq, Hkv, hd] full-precision new rows
    v_new: torch.Tensor,
    write_idx: torch.Tensor,  # [B, Tq] int32 flat indices into P*ps; <0 = skip
):
    """Capture-time KV quantization: each new row quantizes against its own
    max and its int8 values and f32 scale land at the same flat token slot.
    Skipped rows, values and scales alike, land in the scratch page. Returns
    the (same) caches and scales."""
    hkv, p, ps, hd = k_cache.shape
    idx = write_slots(write_idx, p, ps)
    for cache, scale, new in ((k_cache, k_scale, k_new),
                              (v_cache, v_scale, v_new)):
        q, s = quantize_rows(new)          # [B, Tq, Hkv, hd] / [B, Tq, Hkv]
        cache.view(hkv, p * ps, hd).index_copy_(
            1, idx, q.reshape(-1, hkv, hd).transpose(0, 1))
        scale.view(hkv, p * ps).index_copy_(
            1, idx, s.reshape(-1, hkv).transpose(0, 1))
    return k_cache, v_cache, k_scale, v_scale
