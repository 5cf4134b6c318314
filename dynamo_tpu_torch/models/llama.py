"""Llama-family decoder in PyTorch (dense models).

Port of dynamo_tpu/models/llama.py. Parameters are a plain dict of tensors
stacked over layers, with the JAX package's names and layouts ("wq" is
[L, D, H*hd], ...), so `params_from_jax` is a dtype/device move and the
layer `lax.scan` becomes a Python loop over layer slices. Every projection
and the head go through `ops/quant.linear`: a plain weight is one
`torch.matmul` (the JAX package leaves it to XLA); with `cfg.quant ==
"int8"` the seven projections and lm_head are {"q": int8 [L, d_in, d_out],
"s": f32 [L, 1, d_out]} leaves, the JAX quantized tree's layout, and on the
card a decode step's products run the W8A16 kernel. Norms, RoPE and the
gate activation run in f32 as there.

The KV cache is {"k", "v"}: [L, Hkv, P, ps, hd] and is updated IN PLACE
(the JAX functions return updated copies). With `cfg.kv_quant == "int8"`
it is {"k", "v", "k_scale", "v_scale"}: int8 values and one f32 scale per
row, [L, Hkv, P, ps] (ops/kv_quant.py); rows quantize as they are written
and the attention paths read the int8 pages with their scales. Its last
page is a scratch page that no page table references: writes with index
< 0 land there (ops/attention.write_kv_pages{,_quant}), so `init_cache`
callers ask for one page more than the allocator hands out.

Decode attention always goes through the ragged decode kernel
(ops/paged_attention.py): `decode_forward` in prefix mode plus
`combine_self_attention`, `forward` with Tq == 1 in inclusive mode. On CPU
tensors the kernel's wrapper runs its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import ModelConfig, check_supported
from dynamo_tpu_torch.ops.attention import (
    paged_attention, write_kv_pages, write_kv_pages_quant,
)
from dynamo_tpu_torch.ops.kv_quant import is_quantized_cache, validate_mode
from dynamo_tpu_torch.ops.paged_attention import (
    combine_self_attention, decode_paged_attention,
    decode_paged_attention_prefix,
)
from dynamo_tpu_torch.ops.quant import (
    QUANT_KEYS, is_quantized, linear, quantize_int8,
)
from dynamo_tpu_torch.ops.quant import validate_mode as validate_quant

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


@dataclasses.dataclass
class AttnMetadata:
    """Everything the paged forward pass needs besides tokens (bucketed to
    static shapes by the scheduler)."""

    positions: torch.Tensor    # [B, Tq] int32 absolute positions
    page_table: torch.Tensor   # [B, Pb] int32
    kv_lens: torch.Tensor      # [B] int32 (valid kv length AFTER this step)
    write_idx: torch.Tensor    # [B, Tq] int32 flat slot indices (<0 = pad)


# -- init ---------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, hd = cfg.hidden_size, cfg.head_dim
    h, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    return {"attn_norm": (d,), "wq": (d, h * hd), "wk": (d, hkv * hd),
            "wv": (d, hkv * hd), "wo": (h * hd, d), "mlp_norm": (d,),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def init_params(cfg: ModelConfig, device="cuda", seed: int = 0) -> Params:
    """Random-init parameters (stacked over layers), drawn in the model
    dtype directly on `device` from an explicit torch.Generator, so no f32
    copy of the weights ever exists. Dense weights are N(0, 1/fan_in) and
    norms ones, the JAX package's recipe; the values differ from its
    jax.random draws (tests hand both packages the same weights through
    `params_from_jax`). With cfg.quant == "int8" the same draws are
    quantized one layer slice at a time on `device` (ops/quant.py), so the
    tree equals `quantize_params` of the unquantized one."""
    check_supported(cfg)
    quant = validate_quant(cfg.quant)
    dt = torch_dtype(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return w.mul_(fan_in ** -0.5)

    n = cfg.num_layers
    layers = {}
    for key, shape in _layer_shapes(cfg).items():
        if len(shape) == 1:
            layers[key] = torch.ones((n,) + shape, dtype=dt, device=device)
        else:
            layers[key] = dense((n,) + shape, shape[0])
        if quant and key in QUANT_KEYS:
            layers[key] = quantize_int8(layers[key])
    params: Params = {
        "embed": dense((cfg.vocab_size, cfg.hidden_size), cfg.hidden_size),
        "layers": layers,
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dt,
                                 device=device),
    }
    if not cfg.tie_word_embeddings:
        head = dense((cfg.hidden_size, cfg.vocab_size), cfg.hidden_size)
        params["lm_head"] = quantize_int8(head) if quant else head
    return params


def params_from_jax(tree: Params, cfg: ModelConfig, device="cpu") -> Params:
    """The weight bridge: the JAX package's stacked-over-layers parameter
    pytree (`dynamo_tpu/models/llama.py:init_params` layout), given as
    numpy arrays, -> the port's parameters on `device` in the model dtype.
    Layouts are identical; only dtype and device change. A quantized JAX
    tree's {"q": int8, "s": f32} leaves cross exactly, as torch int8 and
    f32."""
    check_supported(cfg)
    dt = torch_dtype(cfg)

    def conv(a):
        if is_quantized(a):
            return {"q": torch.from_numpy(np.array(a["q"], dtype=np.int8)).to(
                        device),
                    "s": torch.from_numpy(np.array(a["s"], dtype=np.float32)
                                          ).to(device)}
        # numpy has no bfloat16: widen through f32 (exact), cast on device
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dt)

    layers = tree["layers"]
    missing = [k for k in _LAYER_KEYS if k not in layers]
    if missing:
        raise ValueError(f"not a dense Llama parameter tree: missing "
                         f"{missing}")
    out: Params = {
        "embed": conv(tree["embed"]),
        "layers": {k: conv(layers[k]) for k in _LAYER_KEYS},
        "final_norm": conv(tree["final_norm"]),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = conv(tree["lm_head"])
    return out


def init_cache(cfg: ModelConfig, num_pages: int, page_size: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed {"k", "v"} caches [L, Hkv, num_pages, ps, hd], in the model
    dtype, or int8 with zeroed f32 {"k_scale", "v_scale"} [L, Hkv,
    num_pages, ps] when cfg.kv_quant == "int8". The last page is the
    scratch page for dropped writes: callers hand out at most num_pages - 1
    pages."""
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size,
             cfg.head_dim)
    if validate_mode(cfg.kv_quant):
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# -- forward ------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, T, H, hd]; positions: [B, T]."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=x.device) / hd
    freqs = 1.0 / (theta ** exps)                               # [hd/2]
    angles = positions[..., None].float() * freqs               # [B, T, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _layer_w(lp: Params, key: str, l: int):
    """Layer l's slice of a stacked weight, plain or quantized."""
    w = lp[key]
    if is_quantized(w):
        return {"q": w["q"][l], "s": w["s"][l]}
    return w[l]


def _dense_mlp(x: torch.Tensor, lp: Params, l: int) -> torch.Tensor:
    gate = linear(x, _layer_w(lp, "w_gate", l))
    up = linear(x, _layer_w(lp, "w_up", l))
    act = F.silu(gate.float()).to(gate.dtype) * up
    return linear(act, _layer_w(lp, "w_down", l))


def _qkv(x: torch.Tensor, lp: Params, l: int, cfg: ModelConfig,
         positions: torch.Tensor):
    """Attention-norm + q/k/v projections + RoPE for layer l:
    q [B, T, H, hd], k/v [B, T, Hkv, hd]."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, lp["attn_norm"][l], cfg.rms_norm_eps)
    q = linear(xn, _layer_w(lp, "wq", l)).reshape(b, t, h, hd)
    k = linear(xn, _layer_w(lp, "wk", l)).reshape(b, t, hkv, hd)
    v = linear(xn, _layer_w(lp, "wv", l)).reshape(b, t, hkv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _block_tail(x, attn, lp: Params, l: int, cfg: ModelConfig):
    """Output projection + residual + MLP + residual for layer l."""
    b, t = x.shape[:2]
    x = x + linear(attn.reshape(b, t, -1), _layer_w(lp, "wo", l))
    xn = rms_norm(x, lp["mlp_norm"][l], cfg.rms_norm_eps)
    return x + _dense_mlp(xn, lp, l)


def _lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor):
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = (params["embed"].T if cfg.tie_word_embeddings
            else params["lm_head"])
    return linear(x, head).float()


def decode_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B] int — one token per sequence
    cache: Dict[str, torch.Tensor],
    page_table: torch.Tensor,    # [B, Pb] int32
    prefix_lens: torch.Tensor,   # [B] int32 — valid kv BEFORE this token
    positions: torch.Tensor,     # [B] — absolute position of this token
) -> tuple:
    """Deferred-write decode step: the KV cache is READ-ONLY.

    Returns (last_logits [B, V] f32, k_new [L, B, Hkv, hd],
    v_new [L, B, Hkv, hd]); the caller scatters the new kv rows into the
    cache in one update per step. Attention is the ragged kernel in prefix
    mode over the cached prefix plus an explicit self-term for the current
    token (combine_self_attention), exact because decode is causal."""
    lp = params["layers"]
    # ids validated at admission (engine._validate_prompt); decode feeds
    # only sampled ids  # dynalint: disable-next-line=R1
    x = params["embed"][tokens.long()][:, None]          # [B, 1, D]
    pos = positions[:, None]
    # int8 caches hand the kernel the whole scale stacks; it folds them
    # into its scores and probabilities
    ks, vs = cache.get("k_scale"), cache.get("v_scale")
    k_news, v_news = [], []
    for l in range(cfg.num_layers):
        q, k, v = _qkv(x, lp, l, cfg, pos)
        k_new, v_new = k[:, 0], v[:, 0]                  # [B, Hkv, hd]
        # dynalint: kv-codec — the kernel reads int8 pages with their scales
        acc, m, lsum = decode_paged_attention_prefix(
            q[:, 0].contiguous(), cache["k"], cache["v"], l, page_table,
            prefix_lens, ks, vs)
        attn = combine_self_attention(q[:, 0], k_new, v_new, acc, m, lsum)
        x = _block_tail(x, attn[:, None], lp, l, cfg)
        k_news.append(k_new)
        v_news.append(v_new)
    logits = _lm_head(params, cfg, x)[:, 0]
    return logits, torch.stack(k_news), torch.stack(v_news)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,            # [B, Tq] int
    cache: Dict[str, torch.Tensor],  # {"k","v"[,"k_scale","v_scale"]}
    meta: AttnMetadata,
    last_idx: Optional[torch.Tensor] = None,  # [B]: logits of one column
) -> tuple:
    """One paged forward step; writes this step's kv into the cache in
    place. Returns (logits, cache): logits [B, Tq, V] f32, or [B, V] for
    column last_idx[b] of each row when last_idx is given (the engine's
    step samples one position per row, and the full [B, Tq, V] block of a
    128k vocabulary is gigabytes)."""
    b, tq = tokens.shape
    lp = params["layers"]
    # admission validated the ids  # dynalint: disable-next-line=R1
    x = params["embed"][tokens.long()]                   # [B, Tq, D]
    quant = is_quantized_cache(cache)
    for l in range(cfg.num_layers):
        q, k, v = _qkv(x, lp, l, cfg, meta.positions)
        # dynalint: kv-codec — per-layer views; the write and attention
        # helpers below quantize / dequantize when scales ride along
        kc, vc = cache["k"][l], cache["v"][l]
        if quant:
            # capture-time quantization: each row against its own max
            # dynalint: kv-codec — the scale rows of this layer's pages
            ksc, vsc = cache["k_scale"][l], cache["v_scale"][l]
            write_kv_pages_quant(kc, vc, ksc, vsc, k, v, meta.write_idx)
        else:
            ksc = vsc = None
            write_kv_pages(kc, vc, k, v, meta.write_idx)
        if tq == 1:
            attn = decode_paged_attention(
                q[:, 0].contiguous(), kc, vc, meta.page_table,
                meta.kv_lens, ksc, vsc)[:, None]
        else:
            attn = paged_attention(q, kc, vc, meta.page_table, meta.kv_lens,
                                   meta.positions, ksc, vsc)
        x = _block_tail(x, attn, lp, l, cfg)
    if last_idx is not None:
        x = x[torch.arange(b, device=x.device), last_idx.long()][:, None]
        return _lm_head(params, cfg, x)[:, 0], cache
    return _lm_head(params, cfg, x), cache
