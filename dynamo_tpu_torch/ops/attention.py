"""Attention over a paged KV cache (prefill and mixed steps).

Port of the parts of dynamo_tpu/ops/attention.py on the slice's path:
`gather_pages`, `paged_attention` (prefill / mixed rows: gather the pages,
then masked attention in f32), `write_kv_pages` and its int8 twin
`write_kv_pages_quant` (ops/kv_quant.py). None of these is a Pallas kernel
in the JAX package, so they are plain torch ops here; decode goes through
the hand-written kernel (ops/paged_attention.py).

Caches are [Hkv, P, ps, hd] per layer, as in the JAX package; int8 caches
carry [Hkv, P, ps] f32 scales beside them.

Dropped writes: JAX scatters with mode="drop" at out-of-range indices. torch
has no dropping scatter, and filtering the rows on the device would stall
the host on every layer. Instead the engine allocates one page more than it
ever hands out (see models/llama.init_cache): rows with write index < 0 are
written into that last, scratch page, which no page table references.
"""
from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kv_quant import gather_dequant, quantize_rows

NEG_INF = -1e30


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
    scores = scores * (hd ** -0.5)
    kv_pos = torch.arange(lk, device=q.device)[None, :]          # [1, Lk]
    causal = kv_pos[:, None, :] <= q_positions.long()[:, :, None]  # [B,Tq,Lk]
    valid = kv_pos < kv_lens.long()[:, None]                       # [B, Lk]
    mask = causal & valid[:, None, :]
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, device=q.device))
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
