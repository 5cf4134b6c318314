"""KV-cache int8 page codec: quantize at capture, dequantize at the read.

Port of dynamo_tpu/ops/kv_quant.py. With ``kv_quant="int8"`` the paged cache
stores K/V as int8 with one f32 scale per row: each written (layer, kv head,
token) vector of head_dim values quantizes against its own max,
``s = max|x| / 127`` and ``q = round(x / s)`` in [-127, 127]. The scale
array mirrors the cache layout minus the head_dim axis (``[L, Hkv, P, ps]``
beside ``[L, Hkv, P, ps, hd]``), so page ids index values and scales alike.
Per-row scales are written once, by the same scatter as the values: a
per-page max would have to rewrite the scales of rows already written.

Where quantized bytes become values:
- the gather path (ops/attention.py): dequantized right after the page
  gather, before any score math;
- the ragged decode kernel (ops/paged_attention.py and its CUDA source):
  int8 pages are read as they are and the scales fold into the scores and
  probabilities, ``(q . k_int8) * s_k == q . (k_int8 * s_k)`` because a
  row's scale is constant over the contraction;
- the legacy decode kernel (ops/paged_attention_oracle.py), the same fold.

Rounding is half-to-even (`torch.round`, like `jnp.round`) and the per-row
max runs in f32 whatever the input dtype, so `quantize_rows` gives the JAX
package's bytes and scales on the same f32 input.
"""
from __future__ import annotations

from typing import Dict

import torch

KV_QMAX = 127.0
# scale floor: an all-zero row (blank page, padding) quantizes to q = 0,
# s = floor and dequantizes to exactly 0
KV_SCALE_EPS = 1e-12


def validate_mode(mode: str) -> str:
    if mode not in ("", "int8"):
        raise ValueError(f"unknown kv_quant mode {mode!r} "
                         "(supported: '', 'int8')")
    return mode


def is_quantized_cache(cache: Dict[str, torch.Tensor]) -> bool:
    """Whether a cache dict carries the int8 + scales representation."""
    return "k_scale" in cache


def cache_keys(quant: bool) -> tuple:
    """Cache-dict keys in canonical order (values first, then scales)."""
    return ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")


def page_bytes(num_layers: int, num_kv_heads: int, page_size: int,
               head_dim: int, dtype_itemsize: int, quant: bool) -> int:
    """Bytes one KV page occupies in device memory (K + V, plus the scales
    when quantized): the engine's `kv_page_bytes` metric."""
    rows = num_layers * num_kv_heads * page_size
    if quant:
        return rows * head_dim * 2 + rows * 4 * 2   # int8 k/v + f32 scales
    return rows * head_dim * dtype_itemsize * 2


def quantize_rows(x: torch.Tensor) -> tuple:
    """x [..., hd] -> (q int8 [..., hd], s f32 [...]): symmetric per row.

    The per-row max runs in f32 whatever x's dtype, so bf16 inputs quantize
    against their true magnitude, not a rounded one."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(-1) / KV_QMAX, min=KV_SCALE_EPS)
    q = torch.clamp(torch.round(xf / s[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), s


def dequantize_rows(q: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """(q int8 [..., hd], s f32 [...]) -> values [..., hd] in `dtype`."""
    return (q.float() * s[..., None]).to(dtype)


def gather_dequant(cache: torch.Tensor, scale: torch.Tensor,
                   page_table: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Paged gather + dequantize: [Hkv, P, ps, hd] int8 + [Hkv, P, ps] f32
    gathered by [B, Pb] -> [Hkv, B, Pb*ps, hd] in `dtype`, the quantized
    twin of ops/attention.gather_pages."""
    b, pb = page_table.shape
    hkv, _, ps, hd = cache.shape
    ids = page_table.reshape(-1).long()
    g = cache.index_select(1, ids).reshape(hkv, b, pb * ps, hd)
    sg = scale.index_select(1, ids).reshape(hkv, b, pb * ps)
    return dequantize_rows(g, sg, dtype)
