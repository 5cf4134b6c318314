"""HF checkpoint loading: config.json -> ModelConfig, safetensors -> params.

Copied from dynamo_tpu/models/loader.py: `ARCHES`, `config_from_hf` (with
its refusals of rope scaling and of unknown Gemma-2 layer patterns, and the
sliding-window cap of the serving length), `load_params_from_hf` and
`load_model_dir`, with the JAX name mapping kept exactly (the transposes,
Phi-3's fused qkv_proj and gate_up_proj, Gemma-2's norm roles, the Mixtral
experts, tied embeddings). As in JAX, config.json's `dtype` /
`torch_dtype` is not read: a checkpoint is served in the config's bfloat16
default, and a caller that wants another dtype passes it
(`load_model_dir(dtype=)`, `run.py --dtype`).

The port depends on torch and numpy only, so the safetensors reader is
written here (`SafetensorsFile`): an 8-byte little-endian header length,
the JSON header (`__metadata__` skipped), each tensor's `data_offsets`
relative to the end of the header; dtypes F32, F16, BF16, I8, U8, I32 and
I64, any other refused by name. Every `*.safetensors` of a directory is
read, in sorted order, as JAX globs them.

Loading never holds the checkpoint twice. Each tensor's bytes are mapped
with mmap and taken with `torch.frombuffer` (no host copy, no widening);
`StackLoader` copies it to the device in its stored dtype and casts and
transposes it there, straight into a preallocated stacked [L, d_in, d_out]
leaf, so the device never holds an unstacked copy beside the stack. The
mapping goes with the host tensor, so the process's resident memory grows
by about one tensor, not the file (a kernel that counts mapped file pages
as resident, as a sandboxed one may, sees the same bound). With
`cfg.quant == "int8"` each layer slice is quantized on the device as it
arrives (ops/quant.quantize_int8, as `init_params` does), so no
model-dtype stack exists beside the int8 one and the tree equals
`quantize_params` of the unquantized tree byte for byte.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, Optional

import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.ops.quant import QUANT_KEYS, quantize_int8

ARCHES = {
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "llama",
    "Qwen2ForCausalLM": "qwen2",
    "MixtralForCausalLM": "mixtral",
    "GemmaForCausalLM": "gemma",
    "Gemma2ForCausalLM": "gemma2",
    "Phi3ForCausalLM": "phi3",
}

ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
             "BF16": torch.bfloat16, "I8": torch.int8, "U8": torch.uint8,
             "I32": torch.int32, "I64": torch.int64}


def config_from_hf(hf: Dict[str, Any], name: str = "") -> ModelConfig:
    """Map an HF config.json dict onto our ModelConfig."""
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if arch not in ARCHES:
        raise ValueError(f"unsupported architecture {arch!r} "
                         f"(supported: {sorted(ARCHES)})")
    family = ARCHES[arch]
    heads = hf["num_attention_heads"]
    moe = family == "mixtral"
    gemma = family in ("gemma", "gemma2")
    gemma2 = family == "gemma2"
    act = hf.get("hidden_activation") or hf.get("hidden_act") or "silu"
    if hf.get("rope_scaling"):
        # e.g. phi-3 128k "longrope", llama-3.1 "llama3" scaling: plain
        # rope_theta would give wrong logits past the original context
        kind = (hf["rope_scaling"].get("rope_type")
                or hf["rope_scaling"].get("type") or "?")
        raise ValueError(
            f"rope_scaling={kind!r} is not supported; use a checkpoint "
            f"without rope scaling (e.g. the base-context variant)")
    max_len = int(hf.get("max_position_embeddings", 2048))
    sliding = 0
    sliding_pattern = "alternate"
    if gemma2 and hf.get("sliding_window"):
        # per-layer sliding / global alternation, served by the gather
        # decode (models/llama.decode_path)
        sliding = int(hf["sliding_window"])
        types = hf.get("layer_types")
        if types is not None and all(t == "sliding_attention"
                                     for t in types):
            sliding_pattern = "all"
        elif types is not None and types != [
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(hf["num_hidden_layers"])]:
            raise ValueError(
                "unsupported gemma2 layer_types pattern (only the "
                "alternating default or all-sliding are modeled)")
    # Qwen2 configs carry sliding_window but disable it by default
    elif hf.get("sliding_window") and hf.get("use_sliding_window", True):
        # full attention equals sliding-window attention while the context
        # fits inside the window: cap the serving length there
        max_len = min(max_len, int(hf["sliding_window"]))
    return ModelConfig(
        name=name or hf.get("model_type", family),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        max_model_len=max_len,
        # GemmaConfig ties embeddings by default and often omits the key
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", gemma)),
        attn_bias=(family == "qwen2") or bool(hf.get("attention_bias",
                                                     False)),
        embed_scale=float(hf["hidden_size"]) ** 0.5 if gemma else 0.0,
        norm_plus_one=gemma,
        mlp_act="gelu_tanh" if act in ("gelu_pytorch_tanh", "gelu_tanh",
                                       "gelu") else "silu",
        post_norms=gemma2,
        attn_softcap=float(hf.get("attn_logit_softcapping") or 0.0)
        if gemma2 else 0.0,
        final_softcap=float(hf.get("final_logit_softcapping") or 0.0)
        if gemma2 else 0.0,
        query_scale=float(hf.get("query_pre_attn_scalar", 0)) ** -0.5
        if gemma2 and hf.get("query_pre_attn_scalar") else 0.0,
        sliding_window=sliding,
        sliding_pattern=sliding_pattern,
        num_experts=int(hf.get("num_local_experts", 0)) if moe else 0,
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 2)),
    )


# -- safetensors --------------------------------------------------------------

class SafetensorsFile:
    """One .safetensors file; `tensor(name)` is a CPU tensor over a mapping
    of that tensor's bytes alone (no copy). The mapping is private and
    never written, and it is unmapped when the tensor is freed, so the
    process holds one tensor's pages at a time, never the file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        size = os.fstat(self._f.fileno()).st_size
        head = self._f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header length {n} past the end of "
                             f"the file")
        header = json.loads(self._f.read(n))
        header.pop("__metadata__", None)
        self._base = 8 + n
        self.entries: Dict[str, tuple] = {}
        for name, e in header.items():
            if e["dtype"] not in ST_DTYPES:
                raise ValueError(
                    f"{path}: tensor {name!r} has unsupported safetensors "
                    f"dtype {e['dtype']}; supported: "
                    f"{', '.join(ST_DTYPES)}")
            dt = ST_DTYPES[e["dtype"]]
            begin, end = e["data_offsets"]
            count = 1
            for d in e["shape"]:
                count *= d
            if end - begin != count * dt.itemsize \
                    or self._base + end > size:
                raise ValueError(f"{path}: tensor {name!r} spans bytes "
                                 f"[{begin}, {end}), not {count} x "
                                 f"{e['dtype']} inside the file")
            self.entries[name] = (dt, tuple(e["shape"]), begin, count)

    def keys(self):
        return self.entries.keys()

    def tensor(self, name: str) -> torch.Tensor:
        dt, shape, begin, count = self.entries[name]
        if count == 0:
            return torch.empty(shape, dtype=dt)
        offset = self._base + begin
        start = offset // mmap.ALLOCATIONGRANULARITY \
            * mmap.ALLOCATIONGRANULARITY
        mm = mmap.mmap(self._f.fileno(), offset + count * dt.itemsize - start,
                       access=mmap.ACCESS_COPY, offset=start)
        # the tensor keeps the mapping alive; freeing it unmaps it
        return torch.frombuffer(mm, dtype=dt, count=count,
                                offset=offset - start).reshape(shape)


def read_safetensors_dir(path: str) -> Dict[str, tuple]:
    """{tensor name: (file, name)} over every *.safetensors in `path`, in
    sorted order (a later file's name wins, as the JAX dict update)."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    index: Dict[str, tuple] = {}
    for f in files:
        st = SafetensorsFile(f)
        for key in st.keys():
            index[key] = (st, key)
    return index


# -- stacking on the device ---------------------------------------------------

class StackLoader:
    """Builds the stacked-layer params of models/llama.py on `device`, one
    source tensor at a time: `fetch(name)` gives a CPU tensor in its stored
    dtype, which is copied to the device as it is, then cast (to `dtype`)
    and transposed there into its slice of a preallocated stack. Leaves
    named in `quant_keys` are int8 {"q", "s"} stacks, each slice quantized
    on the device from its `dtype` values."""

    def __init__(self, fetch: Callable[[str], torch.Tensor], dtype,
                 device, quant_keys=()):
        self.fetch = fetch
        self.dtype = dtype
        self.device = torch.device(device)
        self.quant_keys = set(quant_keys)

    def get(self, name: str) -> torch.Tensor:
        """The tensor on the device, in its stored dtype."""
        return self.fetch(name).to(self.device)

    def stack(self, key: str, n, part: Callable):
        """Leaf `key` [*n, ...]: part(*idx) gives the device tensor for the
        slice idx (any dtype, possibly a transposed view). `n` is the
        leading shape (an int or a tuple)."""
        return self.stacks((key,), n, lambda *idx: (part(*idx),))[0]

    def stacks(self, keys: tuple, n, parts: Callable) -> list:
        """Leaves `keys`, filled together: parts(*idx) gives one device
        tensor a key for the slice idx, so slices of one fused source
        tensor (Phi-3's qkv_proj, gate_up_proj) take one fetch."""
        lead = (n,) if isinstance(n, int) else tuple(n)
        outs = None
        for idx in _indices(lead):
            ws = parts(*idx)
            if outs is None:
                outs = [self._alloc(k, lead + tuple(w.shape))
                        for k, w in zip(keys, ws)]
            for out, w in zip(outs, ws):
                self._put(out, idx, w)
        return outs

    def one(self, key: str, w: torch.Tensor):
        """An unstacked leaf (embed, final_norm, lm_head)."""
        out = self._alloc(key, tuple(w.shape))
        self._put(out, (), w)
        return out

    def _alloc(self, key, shape):
        if key in self.quant_keys:
            return {"q": torch.empty(shape, dtype=torch.int8,
                                     device=self.device),
                    "s": torch.empty(shape[:-2] + (1, shape[-1]),
                                     dtype=torch.float32, device=self.device)}
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def _put(self, out, idx, w):
        if isinstance(out, dict):
            part = quantize_int8(w.to(self.dtype))
            out["q"][idx].copy_(part["q"])
            out["s"][idx].copy_(part["s"])
        else:
            out[idx].copy_(w)


def _indices(lead: tuple):
    if not lead:
        yield ()
        return
    for i in range(lead[0]):
        for rest in _indices(lead[1:]):
            yield (i,) + rest


def quant_keys_for(cfg: ModelConfig) -> tuple:
    """The leaves a loader stores as int8 under cfg.quant == "int8"."""
    if cfg.quant != "int8":
        return ()
    return QUANT_KEYS + ("lm_head",)


def load_params_from_hf(path: str, cfg: ModelConfig, dtype: str = "",
                        device="cpu") -> Dict[str, Any]:
    """Read an HF-style dir into our stacked-layer params on `device`.

    Tensor name mapping (HF stores projections as [out, in]; ours are
    [in, out], hence the transposes):
      model.embed_tokens.weight          -> embed
      model.layers.{i}.input_layernorm   -> attn_norm[i]
      .self_attn.{q,k,v}_proj.weight(.T) -> wq/wk/wv[i] (+ .bias -> w*_b)
      .self_attn.o_proj.weight.T         -> wo[i]
      .post_attention_layernorm          -> mlp_norm[i]
      .mlp.{gate,up,down}_proj.weight.T  -> w_gate/w_up/w_down[i]
      .block_sparse_moe.gate.weight.T    -> router[i]        (Mixtral)
      .block_sparse_moe.experts.{e}.w{1,3,2}.T -> w_gate/up/down[i,e]
      model.norm.weight                  -> final_norm
      lm_head.weight.T                   -> lm_head (absent when tied)
    """
    from dynamo_tpu_torch.models.llama import _DTYPES
    index = read_safetensors_dir(path)

    def fetch(name):
        if name not in index:
            raise KeyError(f"{path}: no tensor {name!r}")
        st, key = index[name]
        return st.tensor(key)

    ld = StackLoader(fetch, _DTYPES[dtype or cfg.dtype], device,
                     quant_keys_for(cfg))
    n = cfg.num_layers
    t = lambda name: ld.get(name).T  # noqa: E731  (transposed projection)
    w = ld.get
    qo, ko = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    fused_qkv = "model.layers.0.self_attn.qkv_proj.weight" in index  # Phi-3

    def qkv(i):
        if fused_qkv:  # split Phi-3's fused [q|k|v, in] rows, then transpose
            full = w(f"model.layers.{i}.self_attn.qkv_proj.weight")
            return (full[:qo].T, full[qo:qo + ko].T,
                    full[qo + ko:qo + 2 * ko].T)
        return tuple(t(f"model.layers.{i}.self_attn.{p}_proj.weight")
                     for p in "qkv")

    wq, wk, wv = ld.stacks(("wq", "wk", "wv"), n, qkv)
    layers: Dict[str, Any] = {
        "attn_norm": ld.stack("attn_norm", n, lambda i: w(
            f"model.layers.{i}.input_layernorm.weight")),
        "wq": wq,
        "wk": wk,
        "wv": wv,
        "wo": ld.stack("wo", n, lambda i: t(
            f"model.layers.{i}.self_attn.o_proj.weight")),
        # in llama-family checkpoints post_attention_layernorm is the
        # PRE-MLP norm; in gemma2 (post_norms) it is a true post-attention
        # norm and pre_feedforward_layernorm takes the pre-MLP role
        "mlp_norm": ld.stack("mlp_norm", n, lambda i: w(
            f"model.layers.{i}.pre_feedforward_layernorm.weight"
            if cfg.post_norms else
            f"model.layers.{i}.post_attention_layernorm.weight")),
    }
    if cfg.post_norms:
        layers["post_attn_norm"] = ld.stack("post_attn_norm", n, lambda i: w(
            f"model.layers.{i}.post_attention_layernorm.weight"))
        layers["post_mlp_norm"] = ld.stack("post_mlp_norm", n, lambda i: w(
            f"model.layers.{i}.post_feedforward_layernorm.weight"))
    if cfg.attn_bias:
        for ours, theirs in (("wq_b", "q_proj"), ("wk_b", "k_proj"),
                             ("wv_b", "v_proj")):
            layers[ours] = ld.stack(ours, n, lambda i, p=theirs: w(
                f"model.layers.{i}.self_attn.{p}.bias"))
    if cfg.is_moe:
        moe = "model.layers.{}.block_sparse_moe"
        layers["router"] = ld.stack("router", n, lambda i: t(
            moe.format(i) + ".gate.weight"))
        for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                             ("w_down", "w2")):
            layers[ours] = ld.stack(
                ours, (n, cfg.num_experts), lambda i, e, p=theirs: t(
                    moe.format(i) + f".experts.{e}.{p}.weight"))
    elif "model.layers.0.mlp.gate_up_proj.weight" in index:  # Phi-3 GLU
        f = cfg.intermediate_size

        def gate_up(i):
            full = w(f"model.layers.{i}.mlp.gate_up_proj.weight")
            return full[:f].T, full[f:2 * f].T

        layers["w_gate"], layers["w_up"] = ld.stacks(("w_gate", "w_up"), n,
                                                     gate_up)
        layers["w_down"] = ld.stack("w_down", n, lambda i: t(
            f"model.layers.{i}.mlp.down_proj.weight"))
    else:
        for key, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                            ("w_down", "down_proj")):
            layers[key] = ld.stack(key, n, lambda i, p=theirs: t(
                f"model.layers.{i}.mlp.{p}.weight"))

    params: Dict[str, Any] = {
        "embed": ld.one("embed", w("model.embed_tokens.weight")),
        "layers": layers,
        "final_norm": ld.one("final_norm", w("model.norm.weight")),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = ld.one("lm_head", t("lm_head.weight"))
    return params


def load_model_dir(path: str, dtype: str = "", device="cpu",
                   quant: str = "") -> tuple:
    """(ModelConfig, params) from one HF-style directory; `dtype` and
    `quant` override the config's."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = config_from_hf(hf, name=os.path.basename(path.rstrip("/")))
    if dtype or quant:
        cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype,
                                  quant=quant or cfg.quant)
    return cfg, load_params_from_hf(path, cfg, device=device)


def checkpoint_kind(path: Optional[str]) -> str:
    """"gguf" for a .gguf file, "hf" for a directory with safetensors,
    "" otherwise (a registry model: random weights)."""
    if not path:
        return ""
    if path.endswith(".gguf") and os.path.isfile(path):
        return "gguf"
    if os.path.isdir(path) and glob.glob(os.path.join(path,
                                                      "*.safetensors")):
        return "hf"
    return ""
