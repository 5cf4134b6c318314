"""Llama-family decoder in PyTorch (dense and mixture-of-experts models).

Port of dynamo_tpu/models/llama.py. Parameters are a plain dict of tensors
stacked over layers, with the JAX package's names and layouts ("wq" is
[L, D, H*hd], ...), so `params_from_jax` is a dtype/device move and the
layer `lax.scan` becomes a Python loop over layer slices. Every projection
and the head go through `ops/quant.linear`, the products that share an
input (wq | wk | wv, w_gate | w_up) through `ops/quant.linear_group`: a
plain weight is one `torch.matmul` (the JAX package leaves it to XLA);
with `cfg.quant == "int8"` the seven projections and lm_head are {"q":
int8 [L, d_in, d_out], "s": f32 [L, 1, d_out]} leaves, the JAX quantized
tree's layout, and on the card a decode step's products run the grouped
W8A16 kernel, one launch a group. Norms, RoPE and the gate activation run
in f32 as there.

The architecture knobs of checkpoint families follow the JAX lines dtype
for dtype: q/k/v bias added after the projections (`attn_bias`, leaves
wq_b / wk_b / wv_b [L, H*hd] / [L, Hkv*hd]), the gate activation SiLU or
tanh-GELU (`mlp_act`), the embedding scale rounded to the activations'
dtype (`embed_scale`), (1 + w) norms in f32 (`norm_plus_one`), the Gemma-2
post-attention / post-MLP norms (`post_norms`, leaves post_attn_norm /
post_mlp_norm [L, D]) and the tanh soft-cap on the f32 logits
(`final_softcap`).

MoE models (`cfg.num_experts > 0`, Mixtral-style) carry a router [L, D, E]
in the model dtype and stacked expert weights w_gate / w_up [L, E, D, F],
w_down [L, E, F, D] (int8 with scales [L, E, 1, F] / [L, E, 1, D] under
quant="int8"). The MLP of each layer is then `ops/moe.moe_dispatch_mlp`
(moe_impl="dispatch", the serving default: top-k routing into a fixed
expert capacity; on the card a decode step's expert products run the
grouped W8A16 kernel) or `_moe_mlp` (moe_impl="dense": every expert on
every token, the exact oracle). `valid` masks padding out of the routing,
and with_aux returns the dispatch's summed (dropped, routed) pair counts.

A multimodal model (`cfg.vision`) carries the ViT tower's tree under
"vision" (models/vision.py; never quantized), and `forward` mixes its
projected patch embeds into the token embeds at the image positions
(`input_embeds` / `embeds_mask`, JAX :521-539).

The KV cache is {"k", "v"}: [L, Hkv, P, ps, hd] and is updated IN PLACE
(the JAX functions return updated copies). With `cfg.kv_quant == "int8"`
it is {"k", "v", "k_scale", "v_scale"}: int8 values and one f32 scale per
row, [L, Hkv, P, ps] (ops/kv_quant.py); rows quantize as they are written
and the attention paths read the int8 pages with their scales. Its last
page is a scratch page that no page table references: writes with index
< 0 land there (ops/attention.write_kv_pages{,_quant}), so `init_cache`
callers ask for one page more than the allocator hands out.

Decode attention takes the path `decode_path` resolves from the config
(the port's `_decode_kernel_mode`, after dynamo_tpu/models/llama.py:45-83
and dynamo_tpu/engine/engine.py:108-133): "ragged", the ragged decode
kernel (ops/paged_attention.py; `decode_forward` in prefix mode plus
`combine_self_attention`, `forward` with Tq == 1 in inclusive mode, a
speculative verify's block through `block_attention`; on CPU tensors the
kernel's wrapper runs its plain version), or "gather", the
plain gather attention of ops/attention.py that carries Gemma-2's attention
soft-cap, sliding windows and query scale (`decode_forward` with a window's
base + buffer, `decode_attention_split`, or without, the per-step
`decode_attention_deferred`; `forward` through `paged_attention`). Callers
that resolved the path once (the engine) pass it as `path`.

Tensor parallelism (JAX :161-238, `param_shardings` and the cache specs):
a rank holds the Megatron shard of a dense bf16 / f32 tree that
`param_specs` names leaf by leaf as JAX does (q, k and v columns and their
biases split by heads, `wo` and `w_down` rows, `w_gate` and `w_up`
columns, `lm_head` by vocab unless the embeddings are tied; norms and
`embed` replicated), cut by `shard_params` (or drawn so by `init_params`,
or bridged so by `params_from_jax`, given a mesh), and runs the model on
its own heads under `rank_config` (the head and FFN counts of one rank;
`init_cache` of it is the rank's cache, its kv heads). Where tp divides
neither way into the kv heads but is a multiple of them, each rank holds
the one kv head its q heads read (the JAX tree splits those columns
evenly, and XLA regathers them). `forward` and `decode_forward` take the
rank's `comm` (parallel/comm.TpComm): an all-reduce of the attention output
after `wo` and of the MLP output after `w_down` (the psums XLA inserts;
with more than one rank the partial products summed in f32 and rounded
once), and the vocab shards of the logits gathered on every rank,
bit-equal.
Without a comm the functions run the whole model as before.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import ModelConfig, check_supported
from dynamo_tpu_torch.ops.attention import (
    decode_attention_deferred, decode_attention_split, paged_attention,
    write_kv_pages, write_kv_pages_quant,
)
from dynamo_tpu_torch.ops.kv_quant import (
    dequantize_rows, is_quantized_cache, quantize_rows, validate_mode,
)
from dynamo_tpu_torch.ops.moe import moe_dispatch_mlp, top_k
from dynamo_tpu_torch.ops.paged_attention import (
    block_attention, combine_self_attention, decode_paged_attention,
    decode_paged_attention_prefix, kernel_geometry_reason,
)
from dynamo_tpu_torch.ops.quant import (
    QUANT_KEYS, grouped_linear, is_quantized, linear, linear_group,
    quantize_int8,
)
from dynamo_tpu_torch.ops.quant import validate_mode as validate_quant

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
# the vision tower's generator seed is this XOR the model seed
_VISION_SEED = 0x5649
_BIAS_KEYS = (("wq_b", "wq"), ("wk_b", "wk"), ("wv_b", "wv"))


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def decode_path(cfg: ModelConfig) -> tuple:
    """Resolve the decode attention path: ("ragged" | "gather", reason).

    "off" is the gather window. Attention soft-caps, sliding windows and
    query scales live only in the gather paths (the TPU kernel has no hook
    for them, and neither has its CUDA port), and so does a head dim or GQA
    group the ragged kernel cannot take; those resolve to the gather window
    with the reason named (the engine logs it once, at build). Otherwise
    "auto", "on"
    and "interpret" are the ragged kernel (on CPU tensors its plain
    version). The same on every device, so a CPU run takes the path the
    card takes.

    This departs from JAX on purpose: its "auto" is the gather window
    everywhere, on a TPU v5e measurement (dynamo_tpu/models/llama.py:
    56-64); the port's "auto" keeps the hand-written kernel wherever it
    serves the config (ROADMAP.md §C)."""
    mode = cfg.decode_kernel
    if mode == "off":
        return "gather", "decode_kernel='off'"
    knobs = [name for name in ("attn_softcap", "sliding_window",
                               "query_scale") if getattr(cfg, name)]
    reason = None
    if knobs:
        reason = (f"{', '.join(knobs)} set: the ragged kernel has no hook "
                  f"for attention soft-caps, sliding windows or query "
                  f"scales")
    else:
        reason = kernel_geometry_reason(cfg.head_dim, cfg.q_per_kv)
    if reason is not None:
        return "gather", reason
    return "ragged", f"decode_kernel={mode!r}"


@dataclasses.dataclass
class AttnMetadata:
    """Everything the paged forward pass needs besides tokens (bucketed to
    static shapes by the scheduler)."""

    positions: torch.Tensor    # [B, Tq] int32 absolute positions
    page_table: torch.Tensor   # [B, Pb] int32
    kv_lens: torch.Tensor      # [B] int32 (valid kv length AFTER this step)
    write_idx: torch.Tensor    # [B, Tq] int32 flat slot indices (<0 = pad)
    # [B] int32 valid kv BEFORE a block of consecutive tokens (a speculative
    # verify's), or None: on the ragged path such a block attends its
    # prefix through the kernel and itself causally (block_attention)
    prefix_lens: Optional[torch.Tensor] = None


# -- init ---------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Each layer leaf's shape per layer: an MoE model's router [D, E] and
    expert stacks [E, d_in, d_out] in place of the dense MLP's."""
    d, hd = cfg.hidden_size, cfg.head_dim
    h, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    shapes = {"attn_norm": (d,), "wq": (d, h * hd), "wk": (d, hkv * hd),
              "wv": (d, hkv * hd), "wo": (h * hd, d), "mlp_norm": (d,),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    if cfg.post_norms:
        shapes.update(post_attn_norm=(d,), post_mlp_norm=(d,))
    if cfg.attn_bias:
        shapes.update({key: (shapes[w][1],) for key, w in _BIAS_KEYS})
    if cfg.is_moe:
        e = cfg.num_experts
        shapes["router"] = (d, e)
        for key in _EXPERT_KEYS:
            shapes[key] = (e,) + shapes[key]
    return shapes


def init_params(cfg: ModelConfig, device="cuda", seed: int = 0,
                mesh=None) -> Params:
    """Random-init parameters (stacked over layers), drawn in the model
    dtype directly on `device` from an explicit torch.Generator, so no f32
    copy of the weights ever exists. Dense weights are N(0, 1/fan_in) and
    norms ones, the JAX package's recipe; the values differ from its
    jax.random draws (tests hand both packages the same weights through
    `params_from_jax`). With cfg.quant == "int8" the same draws are
    quantized one layer slice at a time on `device` (ops/quant.py), so the
    tree equals `quantize_params` of the unquantized one. An MoE model's
    expert stacks are drawn (and quantized) one (layer, expert) slice at a
    time into their stack, in both modes, so no model-dtype stack of them
    ever exists beside the int8 one (Mixtral's is 30.1 GB in bf16). Norm
    weights are ones and q/k/v biases zeros, as in JAX.

    With a `mesh` (parallel/mesh.Mesh) of tp > 1 the tree is its rank's
    shard (`shard_params`) of the same draws: every leaf is drawn whole,
    in the unsharded order, and cut at once, so the values do not depend
    on tp (the JAX engine draws unsharded and then places the tree,
    dynamo_tpu/engine/engine.py:263-299) and a rank holds one whole leaf at
    most beside its shards."""
    check_supported(cfg)
    rank, tp = (mesh.rank, mesh.tp) if mesh is not None else (0, 1)
    check_tp(cfg, tp)
    specs = param_specs(cfg) if tp > 1 else None

    def cut(key, leaf, spec):
        return shard_leaf(key, leaf, spec, cfg, rank, tp) if specs else leaf

    quant = validate_quant(cfg.quant)
    dt = torch_dtype(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return w.mul_(fan_in ** -0.5)

    def expert_stack(shape):
        """[n, E, d_in, d_out], drawn slice by slice (quantized as drawn)."""
        full = (n,) + shape
        if quant:
            stack = {"q": torch.empty(full, dtype=torch.int8, device=device),
                     "s": torch.empty(full[:-2] + (1, full[-1]),
                                      dtype=torch.float32, device=device)}
        else:
            stack = torch.empty(full, dtype=dt, device=device)
        for i in range(n):
            for j in range(shape[0]):
                w = dense(shape[1:], shape[1])
                if not quant:
                    stack[i, j].copy_(w)
                    continue
                part = quantize_int8(w)
                stack["q"][i, j].copy_(part["q"])
                stack["s"][i, j].copy_(part["s"])
        return stack

    n = cfg.num_layers
    layers = {}
    for key, shape in _layer_shapes(cfg).items():
        if len(shape) == 1:
            fill = torch.zeros if key.endswith("_b") else torch.ones
            layers[key] = fill((n,) + shape, dtype=dt, device=device)
        elif len(shape) == 3:
            layers[key] = expert_stack(shape)
            continue
        else:
            layers[key] = dense((n,) + shape, shape[0])
        if specs:
            layers[key] = cut(key, layers[key], specs["layers"][key])
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
        if specs:
            head = cut("lm_head", head, specs["lm_head"])
        params["lm_head"] = quantize_int8(head) if quant else head
    if cfg.vision is not None:
        from dynamo_tpu_torch.models import vision
        # the tower (never quantized, as in JAX) draws from a generator of
        # its own, seeded from `seed`, after the text draws: a text model's
        # weights are the same with or without a tower
        vgen = torch.Generator(device=device).manual_seed(
            _VISION_SEED ^ seed)
        params["vision"] = vision.init_params(cfg, device, vgen)
    return params


# -- tensor parallelism ---------------------------------------------------------

def param_specs(cfg: ModelConfig) -> Params:
    """The JAX package's `param_shardings` of a dense text model as tuples
    of mesh axis names, one entry a dimension (None = not split): the
    PartitionSpecs `shard_params` cuts by."""
    rep2, cols, rows = (None, None), (None, None, "tp"), (None, "tp", None)
    layers = {"attn_norm": rep2, "wq": cols, "wk": cols, "wv": cols,
              "wo": rows, "mlp_norm": rep2, "w_gate": cols, "w_up": cols,
              "w_down": rows}
    if cfg.post_norms:
        layers.update(post_attn_norm=rep2, post_mlp_norm=rep2)
    if cfg.attn_bias:
        layers.update({key: (None, "tp") for key, _ in _BIAS_KEYS})
    out: Params = {"embed": (None, None), "layers": layers,
                   "final_norm": (None,)}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = (None, "tp")
    return out


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Refuse a model that cannot be cut into `tp` Megatron shards: the
    slice's tp serves dense text models in bf16 or f32, with whole q heads
    on every rank, and kv heads split evenly or (tp a multiple of them)
    one a rank; the FFN width splits evenly."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    for what, on in (("an MoE model", cfg.is_moe),
                     ("int8 weights", bool(cfg.quant)),
                     ("a vision tower", cfg.vision is not None)):
        if on and tp > 1:
            raise NotImplementedError(
                f"model {cfg.name!r}: {what} is not served at tp > 1 (tp="
                f"{tp}) by this port yet")
    h, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    if h % tp:
        raise ValueError(f"model {cfg.name!r}: num_heads={h} is not "
                         f"divisible by tp={tp}")
    if hkv % tp and tp % hkv:
        raise ValueError(f"model {cfg.name!r}: tp={tp} neither divides nor "
                         f"is a multiple of num_kv_heads={hkv}")
    if f % tp:
        raise ValueError(f"model {cfg.name!r}: intermediate_size={f} is not "
                         f"divisible by tp={tp}")


def kv_heads_of(cfg: ModelConfig, rank: int, tp: int) -> tuple:
    """(first kv head, count) that rank holds: Hkv / tp of them, or the
    one kv head its q heads read when tp is a multiple of Hkv."""
    hkv = cfg.num_kv_heads
    if hkv % tp == 0:
        return rank * (hkv // tp), hkv // tp
    return rank * hkv // tp, 1


def rank_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The model as one rank runs it: its q heads, kv heads and FFN width
    (the vocab stays whole: the logits are gathered)."""
    check_tp(cfg, tp)
    if tp == 1:
        return cfg
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=kv_heads_of(cfg, 0, tp)[1],
        intermediate_size=cfg.intermediate_size // tp)


def _split_range(key: str, n: int, cfg: ModelConfig, rank: int,
                 tp: int) -> tuple:
    """[start, end) of rank's part of a split dimension of length n."""
    if key in ("wk", "wv", "wk_b", "wv_b"):
        first, count = kv_heads_of(cfg, rank, tp)
        return first * cfg.head_dim, (first + count) * cfg.head_dim
    if key == "lm_head":
        from dynamo_tpu_torch.parallel.comm import vocab_range
        return vocab_range(n, rank, tp)
    step = n // tp
    return rank * step, (rank + 1) * step


def shard_leaf(key: str, leaf, spec: tuple, cfg: ModelConfig, rank: int,
               tp: int, device=None):
    """Rank's part of one leaf (a torch tensor or a numpy array) under its
    spec, as a tensor of its own (no view of the whole leaf's storage), on
    `device` when given."""
    if "tp" in spec and tp > 1:
        dim = spec.index("tp")
        a, b = _split_range(key, leaf.shape[dim], cfg, rank, tp)
        idx = (slice(None),) * dim + (slice(a, b),)
        leaf = leaf[idx]
        leaf = (leaf.clone() if isinstance(leaf, torch.Tensor)
                else np.ascontiguousarray(leaf))
    if device is not None and isinstance(leaf, torch.Tensor):
        leaf = leaf.to(device)
    return leaf


def shard_params(params: Params, cfg: ModelConfig, rank: int, tp: int,
                 device=None) -> Params:
    """Rank's Megatron shard of a whole tree (torch tensors or numpy
    arrays, the JAX layout), leaf by leaf (`param_specs`)."""
    check_tp(cfg, tp)
    specs = param_specs(cfg)
    out: Params = {"layers": {
        k: shard_leaf(k, params["layers"][k], specs["layers"][k], cfg, rank,
                      tp, device) for k in specs["layers"]}}
    for k, spec in specs.items():
        if k != "layers":
            out[k] = shard_leaf(k, params[k], spec, cfg, rank, tp, device)
    return out


def params_from_jax(tree: Params, cfg: ModelConfig, device="cpu",
                    mesh=None) -> Params:
    """The weight bridge: the JAX package's stacked-over-layers parameter
    pytree (`dynamo_tpu/models/llama.py:init_params` layout), given as
    numpy arrays, -> the port's parameters on `device` in the model dtype.
    Layouts are identical; only dtype and device change. A quantized JAX
    tree's {"q": int8, "s": f32} leaves cross exactly, as torch int8 and
    f32. An MoE tree carries its router (in the model dtype) and its expert
    stacks; a tree whose experts do not match the config (a router on a
    dense config, none on an MoE one, another expert count) is refused.
    With a `mesh` of tp > 1 the result is its rank's shard
    (`shard_params`), cut from the numpy leaves before they move."""
    check_supported(cfg)
    dt = torch_dtype(cfg)
    rank, tp = (mesh.rank, mesh.tp) if mesh is not None else (0, 1)
    check_tp(cfg, tp)
    specs = param_specs(cfg) if tp > 1 else None

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
    shapes = _layer_shapes(cfg)
    kind = "an MoE" if cfg.is_moe else "a dense"
    missing = [k for k in shapes if k not in layers]
    if missing:
        raise ValueError(f"not {kind} Llama parameter tree for "
                         f"{cfg.name!r}: missing {missing}")
    if "router" in layers and not cfg.is_moe:
        raise ValueError(f"the tree has a router (an MoE tree) but "
                         f"{cfg.name!r} is a dense config")
    for k, shape in shapes.items():
        leaf = layers[k]
        got = tuple(np.shape(leaf["q"] if is_quantized(leaf) else leaf))[1:]
        if len(shape) > 1 and got != shape:
            raise ValueError(f"layer leaf {k!r} has per-layer shape {got}; "
                             f"{cfg.name!r} ({kind} config, "
                             f"{cfg.num_experts} experts) needs {shape}")
    if specs:
        tree = shard_params({k: tree[k] for k in specs}, cfg, rank, tp)
        layers = tree["layers"]
    out: Params = {
        "embed": conv(tree["embed"]),
        "layers": {k: conv(layers[k]) for k in shapes},
        "final_norm": conv(tree["final_norm"]),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = conv(tree["lm_head"])
    if cfg.vision is not None:
        from dynamo_tpu_torch.models import vision
        if "vision" not in tree:
            raise ValueError(f"{cfg.name!r} has a vision tower but the tree "
                             f"carries no 'vision' subtree")
        shapes = vision.param_shapes(cfg)

        def move(sub, want):
            if isinstance(want, dict):
                return {k: move(sub[k], w) for k, w in want.items()}
            if tuple(np.shape(sub)) != want:
                raise ValueError(f"vision leaf of shape {np.shape(sub)}; "
                                 f"{cfg.name!r} needs {want}")
            return conv(sub)
        out["vision"] = move(tree["vision"], shapes)
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

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if plus_one:
        # Gemma stores the weight as a delta from 1 and applies it in f32
        # before the downcast (HF GemmaRMSNorm)
        return (xf * scale * (1.0 + w.float())).to(x.dtype)
    return (xf * scale).to(x.dtype) * w


def _norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig):
    return rms_norm(x, w, cfg.rms_norm_eps, cfg.norm_plus_one)


def mlp_activation(gate: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """GLU gate activation in f32: SiLU (llama) or tanh-GELU (Gemma)."""
    gf = gate.float()
    if cfg.mlp_act == "gelu_tanh":
        # jax.nn.gelu(approximate=True), term for term
        a = gf * (0.5 * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (gf + 0.044715 * gf ** 3))))
    else:
        a = F.silu(gf)
    return a.to(gate.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (on the host), as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def scale_embeds(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gemma multiplies embedding outputs by sqrt(hidden), the scale first
    rounded to x's dtype as JAX does (bf16 sqrt(d) is not f32 sqrt(d))."""
    if cfg.embed_scale:
        return x * _rounded(cfg.embed_scale, x.dtype)
    return x


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


def _dense_mlp(x: torch.Tensor, lp: Params, l: int,
               cfg: ModelConfig, comm=None) -> torch.Tensor:
    """The gated MLP; under a tp `comm` its row-sharded w_down product
    summed over the ranks (TpComm.reduce_product)."""
    gate, up = linear_group(x, [_layer_w(lp, "w_gate", l),
                                _layer_w(lp, "w_up", l)])
    act = mlp_activation(gate, cfg) * up
    if comm is not None:
        return comm.reduce_product(act, _layer_w(lp, "w_down", l))
    return linear(act, _layer_w(lp, "w_down", l))


def _moe_mlp(x: torch.Tensor, lp: Params, l: int,
             cfg: ModelConfig) -> torch.Tensor:
    """Dense-compute MoE (JAX `_moe_mlp`): top-k routing, every expert
    evaluated on every token, the outputs combined with the routing weights
    (zero for the experts not chosen) in f32. Exact, E / k times the
    dispatch's FLOPs: the oracle of `moe_impl="dense"`."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = x.float() @ lp["router"][l].float()            # [B, T, E]
    weights, idx = top_k(logits, k)
    weights = torch.softmax(weights, dim=-1)
    combine = (weights[..., None] * F.one_hot(idx, e).float()).sum(-2)
    xe = x.reshape(1, b * t, d).expand(e, b * t, d).contiguous()
    every = torch.full((e,), b * t, dtype=torch.int32, device=x.device)
    gate = grouped_linear(xe, _layer_w(lp, "w_gate", l), every)
    up = grouped_linear(xe, _layer_w(lp, "w_up", l), every)
    act = mlp_activation(gate, cfg) * up
    down = grouped_linear(act, _layer_w(lp, "w_down", l), every)
    out = (down.float().view(e, b, t, d)
           * combine.permute(2, 0, 1)[..., None]).sum(0)
    return out.to(x.dtype)


def _mlp(x: torch.Tensor, lp: Params, l: int, cfg: ModelConfig, valid,
         comm=None):
    """Layer l's MLP: (output, (dropped, routed) or None). The counts come
    from the MoE dispatch only. A tp `comm` serves dense models only."""
    if not cfg.is_moe:
        return _dense_mlp(x, lp, l, cfg, comm), None
    if cfg.moe_impl == "dense":
        return _moe_mlp(x, lp, l, cfg), None
    layer = {key: _layer_w(lp, key, l) for key in ("router",) + _EXPERT_KEYS}
    return moe_dispatch_mlp(x, layer, cfg, cfg.moe_capacity_factor,
                            return_dropped=True, valid=valid)


def _qkv(x: torch.Tensor, lp: Params, l: int, cfg: ModelConfig,
         positions: torch.Tensor):
    """Attention-norm + q/k/v projections + RoPE for layer l:
    q [B, T, H, hd], k/v [B, T, Hkv, hd]."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = _norm(x, lp["attn_norm"][l], cfg)
    q, k, v = linear_group(xn, [_layer_w(lp, key, l)
                                for key in ("wq", "wk", "wv")])
    if cfg.attn_bias:
        q, k, v = (y + lp[key][l] for y, (key, _) in zip((q, k, v),
                                                          _BIAS_KEYS))
    q = q.reshape(b, t, h, hd)
    k = k.reshape(b, t, hkv, hd)
    v = v.reshape(b, t, hkv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _block_tail(x, attn, lp: Params, l: int, cfg: ModelConfig, valid=None,
                comm=None):
    """Output projection + residual + MLP + residual for layer l; returns
    (x, the MoE dispatch's (dropped, routed) or None). Under a tp `comm`
    the row-sharded products (wo, w_down) are summed over the ranks before
    the post-norms and the residuals (the psums of JAX's sharded program;
    TpComm.reduce_product)."""
    b, t = x.shape[:2]
    attn = attn.reshape(b, t, -1)
    if comm is not None:
        attn_out = comm.reduce_product(attn, _layer_w(lp, "wo", l))
    else:
        attn_out = linear(attn, _layer_w(lp, "wo", l))
    if cfg.post_norms:
        attn_out = _norm(attn_out, lp["post_attn_norm"][l], cfg)
    x = x + attn_out
    xn = _norm(x, lp["mlp_norm"][l], cfg)
    mlp, drops = _mlp(xn, lp, l, cfg, valid, comm)
    if cfg.post_norms:
        mlp = _norm(mlp, lp["post_mlp_norm"][l], cfg)
    return x + mlp, drops


def _moe_aux(drops: list) -> dict:
    """The layers' (dropped, routed) counts summed, as the JAX package
    returns them under with_aux; {} without an MoE dispatch."""
    if not drops:
        return {}
    return {"moe_dropped": torch.stack([d for d, _ in drops]).sum(),
            "moe_routed": torch.stack([r for _, r in drops]).sum()}


def _lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor, comm=None):
    """f32 logits over the whole vocab. Under a tp `comm` an untied head
    holds this rank's vocab slice, gathered on every rank (a tied head is
    the replicated embedding: every rank computes the whole vocab)."""
    x = _norm(x, params["final_norm"], cfg)
    head = (params["embed"].T if cfg.tie_word_embeddings
            else params["lm_head"])
    logits = linear(x, head).float()
    if comm is not None and not cfg.tie_word_embeddings:
        logits = comm.gather_vocab(logits, cfg.vocab_size)
    if cfg.final_softcap:
        return torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _resolved(cfg: ModelConfig, path: Optional[str]) -> str:
    """The caller's resolved decode path, or the config's; a ragged path
    for a config whose decode the kernel cannot serve is refused rather
    than served without its knobs."""
    if path is None:
        return decode_path(cfg)[0]
    if path not in ("ragged", "gather"):
        raise ValueError(f"unknown decode path {path!r}")
    if path == "ragged" and decode_path(cfg)[0] != "ragged":
        raise ValueError(f"model {cfg.name!r} cannot decode through the "
                         f"ragged kernel: {decode_path(cfg)[1]}")
    return path


def decode_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B] int — one token per sequence
    cache: Dict[str, torch.Tensor],
    page_table: torch.Tensor,    # [B, Pb] int32
    prefix_lens: torch.Tensor,   # [B] int32 — valid kv BEFORE this token
    positions: torch.Tensor,     # [B] — absolute position of this token
    valid: Optional[torch.Tensor] = None,  # [B] bool, real (non-pad) slots
    with_aux: bool = False,
    window: Optional[tuple] = None,  # the gather window's split KV view
    path: Optional[str] = None,      # "ragged" | "gather" (decode_path)
    comm=None,                       # the rank's TpComm under tp
) -> tuple:
    """Deferred-write decode step: the KV cache is READ-ONLY.

    Returns (last_logits [B, V] f32, k_new [L, B, Hkv, hd],
    v_new [L, B, Hkv, hd]), plus the aux dict with with_aux (the MoE
    dispatch's summed counts); the caller scatters the new kv rows into the
    cache in one update per step. Attention over the cached prefix plus an
    explicit self-term for the current token, exact because decode is
    causal, takes one of three branches (JAX :328-441):

    - `window` = (k_base, v_base [L, Hkv, B, Lb, hd], k_win, v_win [L, Hkv,
      B, Nw, hd], base_lens [B], win_lens [B]): the gather window's split
      view, `decode_attention_split` (the caller gathered each slot's valid
      prefix once a window, its V rows past base_lens zeroed, and keeps
      this window's rows in the buffer);
    - path "ragged": the ragged kernel in prefix mode plus
      `combine_self_attention`;
    - path "gather" without a window: `decode_attention_deferred`, the
      pages gathered every step (an int8 cache dequantized after the
      gather).

    The gather branches pass each layer's window (`layer_windows`), the
    attention soft-cap and the query scale. An MoE dispatch routes only the
    `valid` rows."""
    path = _resolved(cfg, path)
    lp = params["layers"]
    # ids validated at admission (engine._validate_prompt); decode feeds
    # only sampled ids  # dynalint: disable-next-line=R1
    x = scale_embeds(params["embed"][tokens.long()], cfg)[:, None]
    pos = positions[:, None]
    # int8 caches hand the kernel the whole scale stacks; it folds them
    # into its scores and probabilities
    ks, vs = cache.get("k_scale"), cache.get("v_scale")
    lw = cfg.layer_windows()
    knobs = dict(softcap=cfg.attn_softcap, q_scale=cfg.query_scale)
    token_valid = None if valid is None else valid[:, None]
    k_news, v_news, drops = [], [], []
    for l in range(cfg.num_layers):
        wnd = None if lw is None else lw[l]
        q, k, v = _qkv(x, lp, l, cfg, pos)
        k_new, v_new = k[:, 0], v[:, 0]                  # [B, Hkv, hd]
        if window is not None:
            kb, vb, kw, vw, base_lens, win_lens = window
            attn = decode_attention_split(
                q[:, 0], kb[l], vb[l], kw[l], vw[l], k_new, v_new,
                base_lens, win_lens, window=wnd, **knobs)
        elif path == "ragged":
            # the kernel reads int8 pages with their scales
            # dynalint: kv-codec
            acc, m, lsum = decode_paged_attention_prefix(
                q[:, 0].contiguous(), cache["k"], cache["v"], l, page_table,
                prefix_lens, ks, vs)
            attn = combine_self_attention(q[:, 0], k_new, v_new, acc, m,
                                          lsum)
        else:
            # per-layer views; the gather dequantizes an int8 layer's
            # pages with their scale rows  # dynalint: kv-codec
            attn = decode_attention_deferred(
                q[:, 0], cache["k"][l], cache["v"][l], k_new, v_new,
                page_table, prefix_lens, window=wnd,
                k_scale=None if ks is None else ks[l],
                v_scale=None if vs is None else vs[l], **knobs)
        x, d = _block_tail(x, attn[:, None], lp, l, cfg, token_valid, comm)
        k_news.append(k_new)
        v_news.append(v_new)
        if d is not None:
            drops.append(d)
    logits = _lm_head(params, cfg, x, comm)[:, 0]
    out = (logits, torch.stack(k_news), torch.stack(v_news))
    return out + (_moe_aux(drops),) if with_aux else out


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,            # [B, Tq] int
    cache: Dict[str, torch.Tensor],  # {"k","v"[,"k_scale","v_scale"]}
    meta: AttnMetadata,
    last_idx: Optional[torch.Tensor] = None,  # [B]: logits of one column
    with_aux: bool = False,
    path: Optional[str] = None,      # "ragged" | "gather" (decode_path)
    input_embeds: Optional[torch.Tensor] = None,  # [B, Tq, D]
    embeds_mask: Optional[torch.Tensor] = None,   # [B, Tq] bool
    comm=None,                       # the rank's TpComm under tp
) -> tuple:
    """One paged forward step; writes this step's kv into the cache in
    place. Returns (logits, cache), plus the aux dict with with_aux (the
    MoE dispatch's summed counts): logits [B, Tq, V] f32, or [B, V] for
    column last_idx[b] of each row when last_idx is given (the engine's
    step samples one position per row, and the full [B, Tq, V] block of a
    128k vocabulary is gigabytes). A single-token step (Tq == 1) on the
    ragged path runs the kernel in inclusive mode; every other step runs
    `paged_attention` with the layer's window, the attention soft-cap and
    the query scale (JAX :536-610). A block of consecutive tokens with
    `meta.prefix_lens` (a speculative verify) on the ragged path attends
    through the kernel instead (`block_attention`: its prefix in prefix
    mode, the block causally; the block's rows as the cache stores them,
    so an int8 cache's rows are quantized first). An MoE dispatch routes
    only the real positions (write_idx >= 0).

    A multimodal step (JAX :521-536) passes `input_embeds` with
    `embeds_mask`: masked positions take those rows (the vision tower's
    projected patch embeds), cast to the model dtype, the others their
    token embeds; the ids at masked positions are the scheduler's content
    salts, never looked up. `input_embeds` alone replaces every token
    embed. The embedding scale applies to whatever enters the first layer
    (HF Gemma scales inputs_embeds too)."""
    b, tq = tokens.shape
    ragged = _resolved(cfg, path) == "ragged"
    use_kernel = tq == 1 and ragged
    use_block = tq > 1 and ragged and meta.prefix_lens is not None
    lp = params["layers"]
    if input_embeds is None:
        # admission validated the ids  # dynalint: disable-next-line=R1
        x = params["embed"][tokens.long()]
    elif embeds_mask is not None:
        # salted span positions read row 0, which the where drops (JAX's
        # take fills NaN there and drops it the same way); admission
        # validated the text ids
        ids = torch.where(embeds_mask, 0, tokens).long()
        x = torch.where(embeds_mask[..., None],
                        input_embeds.to(torch_dtype(cfg)),
                        # dynalint: disable-next-line=R1
                        params["embed"][ids])
    else:
        x = input_embeds.to(torch_dtype(cfg))
    x = scale_embeds(x, cfg)  # [B, Tq, D]
    quant = is_quantized_cache(cache)
    lw = cfg.layer_windows()
    # real (non-padding) positions: padding slots carry write_idx < 0
    token_valid = meta.write_idx >= 0
    drops = []
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
        if use_kernel:
            attn = decode_paged_attention(
                q[:, 0].contiguous(), kc, vc, meta.page_table,
                meta.kv_lens, ksc, vsc)[:, None]
        elif use_block:
            kb, vb = k, v
            if quant:
                kb, vb = (dequantize_rows(*quantize_rows(t), t.dtype)
                          for t in (k, v))
            # the kernel reads int8 pages with their scales
            # dynalint: kv-codec
            attn = block_attention(
                q, kb, vb, cache["k"], cache["v"], l, meta.page_table,
                meta.prefix_lens, cache.get("k_scale"), cache.get("v_scale"))
        else:
            attn = paged_attention(
                q, kc, vc, meta.page_table, meta.kv_lens, meta.positions,
                ksc, vsc, softcap=cfg.attn_softcap,
                window=None if lw is None else lw[l],
                q_scale=cfg.query_scale)
        x, d = _block_tail(x, attn, lp, l, cfg, token_valid, comm)
        if d is not None:
            drops.append(d)
    if last_idx is not None:
        x = x[torch.arange(b, device=x.device), last_idx.long()][:, None]
        logits = _lm_head(params, cfg, x, comm)[:, 0]
    else:
        logits = _lm_head(params, cfg, x, comm)
    return (logits, cache, _moe_aux(drops)) if with_aux else (logits, cache)
