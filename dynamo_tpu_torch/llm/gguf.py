"""GGUF model sourcing: metadata, tokenizer, and tensor loading.

Copied from dynamo_tpu/llm/gguf.py:

- `GGUFFile` parses the v2/v3 container (header, typed metadata KVs with
  nested arrays, tensor infos) and maps the file; `tensor(name)`
  dequantizes F32 / F16 / BF16 / Q8_0 / Q4_0 / Q4_K / Q6_K to float32 with
  numpy, the JAX code unchanged; other ggml types raise with the type
  named.
- `config_from_gguf` maps `<arch>.*` metadata keys onto ModelConfig.
- `load_params_from_gguf` maps llama.cpp tensor names (token_embd, blk.N.*,
  output_norm, output) onto the stacked-layer params of models/llama.py,
  straight into torch tensors on the target device one layer at a time
  (models/loader.StackLoader); under cfg.quant == "int8" each layer slice
  is quantized on the device as it arrives.
- `GGUFTokenizer` rebuilds the tokenizer from the embedded vocab,
  dispatching on `tokenizer.ggml.model`: "gpt2" vocabs get the byte-level
  BPE of llm/bpe.py (the JAX package builds the same one with
  `tokenizers`) with the pre-tokenizer split selected by
  `tokenizer.ggml.pre`; "llama" vocabs the score-driven SentencePiece
  bigram-merge encode with <0xXX> byte fallback, through the native C++
  encoder (native/spm.py, built with g++ at first use) and in Python when
  it does not build.

GGUF is little-endian; v3 adds no layout changes we depend on.
"""
from __future__ import annotations

import mmap
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.llm.tokenizer import BaseTokenizer

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, \
    _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_SCALARS = {
    _T_U8: ("<B", 1), _T_I8: ("<b", 1), _T_U16: ("<H", 2), _T_I16: ("<h", 2),
    _T_U32: ("<I", 4), _T_I32: ("<i", 4), _T_F32: ("<f", 4),
    _T_BOOL: ("<?", 1), _T_U64: ("<Q", 8), _T_I64: ("<q", 8),
    _T_F64: ("<d", 8),
}

# ggml tensor types we materialize (id -> (name, bytes per block, block len))
GGML_F32, GGML_F16, GGML_Q8_0, GGML_BF16 = 0, 1, 8, 30
GGML_Q4_0, GGML_Q4_K, GGML_Q6_K = 2, 12, 14
_GGML_NAMES = {
    0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0", 7: "Q5_1",
    8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K", 12: "Q4_K", 13: "Q5_K",
    14: "Q6_K", 15: "Q8_K", 30: "BF16",
}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str, size: int):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return v

    def u32(self) -> int:
        return self.read("<I", 4)

    def u64(self) -> int:
        return self.read("<Q", 8)

    def string(self) -> str:
        n = self.u64()
        s = self.buf[self.pos:self.pos + n]
        self.pos += n
        return bytes(s).decode("utf-8", errors="replace")

    def value(self, vtype: int):
        if vtype in _SCALARS:
            return self.read(*_SCALARS[vtype])
        if vtype == _T_STR:
            return self.string()
        if vtype == _T_ARR:
            etype = self.u32()
            count = self.u64()
            return [self.value(etype) for _ in range(count)]
        raise ValueError(f"unknown gguf metadata type {vtype}")


class TensorInfo:
    def __init__(self, name: str, dims: List[int], ggml_type: int,
                 offset: int):
        self.name = name
        self.dims = dims          # ne order: dims[0] varies fastest
        self.ggml_type = ggml_type
        self.offset = offset      # relative to the data section

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


class GGUFFile:
    """Parsed GGUF container with lazy tensor materialization."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        r = _Reader(self._mm)
        if self._mm[:4] != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        r.pos = 4
        self.version = r.u32()
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version "
                             f"{self.version}")
        n_tensors = r.u64()
        n_kv = r.u64()
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.string()
            vtype = r.u32()
            self.metadata[key] = r.value(vtype)
        self.tensors: Dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = r.string()
            n_dims = r.u32()
            dims = [r.u64() for _ in range(n_dims)]
            ggml_type = r.u32()
            offset = r.u64()
            self.tensors[name] = TensorInfo(name, dims, ggml_type, offset)
        align = int(self.metadata.get("general.alignment", 32))
        self.data_start = (r.pos + align - 1) // align * align

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def tensor(self, name: str) -> np.ndarray:
        """Materialize one tensor as float32 numpy, shape dims[::-1]
        (row-major: ne[0] is the fastest-varying GGML dimension)."""
        info = self.tensors.get(name)
        if info is None:
            raise KeyError(f"{self.path}: no tensor {name!r}")
        start = self.data_start + info.offset
        n = info.n_elements
        shape = tuple(reversed(info.dims))
        t = info.ggml_type
        if t == GGML_F32:
            arr = np.frombuffer(self._mm, np.float32, n, start)
        elif t == GGML_F16:
            arr = np.frombuffer(self._mm, np.float16, n, start)
        elif t == GGML_BF16:
            raw = np.frombuffer(self._mm, np.uint16, n, start)
            arr = (raw.astype(np.uint32) << 16).view(np.float32)
        elif t == GGML_Q8_0:
            # blocks of 32: f16 scale + 32 x i8
            nb = n // 32
            raw = np.frombuffer(self._mm, np.uint8, nb * 34, start)
            blocks = raw.reshape(nb, 34)
            scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
            qs = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
            arr = qs * scales  # [nb, 32] broadcast over the block
        elif t == GGML_Q4_0:
            # blocks of 32: f16 scale + 16 bytes of nibbles; value i comes
            # from the low nibble of qs[i], value i+16 from the high one,
            # both biased by -8
            nb = n // 32
            raw = np.frombuffer(self._mm, np.uint8, nb * 18, start)
            blocks = raw.reshape(nb, 18)
            d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
            qs = blocks[:, 2:]
            lo = (qs & 0x0F).astype(np.float32) - 8.0
            hi = (qs >> 4).astype(np.float32) - 8.0
            arr = np.concatenate([lo, hi], axis=1) * d
        elif t == GGML_Q4_K:
            arr = _dequant_q4_k(self._mm, n, start)
        elif t == GGML_Q6_K:
            arr = _dequant_q6_k(self._mm, n, start)
        else:
            raise ValueError(
                f"{self.path}: tensor {name!r} has unsupported ggml type "
                f"{_GGML_NAMES.get(t, t)}; supported: F32, F16, BF16, "
                f"Q8_0, Q4_0, Q4_K, Q6_K")
        # always copy out of the mmap: returned arrays must not pin the
        # file mapping open (close() would raise BufferError)
        return np.array(arr, np.float32, copy=True).reshape(shape)


def _dequant_q4_k(mm, n: int, start: int) -> np.ndarray:
    """Q4_K: 256-value super-blocks of 144 bytes — f16 d + f16 dmin +
    12 bytes of packed 6-bit (scale, min) pairs for 8 sub-blocks of 32 +
    128 nibble bytes. value = d*sc*q - dmin*m (llama.cpp
    dequantize_row_q4_K layout, re-derived vectorized)."""
    nb = n // 256
    raw = np.frombuffer(mm, np.uint8, nb * 144, start).reshape(nb, 144)
    d = raw[:, 0:2].copy().view(np.float16).astype(np.float32)      # [nb,1]
    dmin = raw[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc_raw = raw[:, 4:16].astype(np.uint16)                          # [nb,12]
    qs = raw[:, 16:]                                                 # [nb,128]
    # 6-bit unpack (get_scale_min_k4): sub-blocks 0-3 live in bytes j /
    # j+4 directly; 4-7 recombine nibbles of byte j+4 with the top two
    # bits of bytes j-4 / j
    sc = np.empty((nb, 8), np.float32)
    mn = np.empty((nb, 8), np.float32)
    for j in range(4):
        sc[:, j] = (sc_raw[:, j] & 63).astype(np.float32)
        mn[:, j] = (sc_raw[:, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, j] = ((sc_raw[:, j + 4] & 0x0F)
                    | ((sc_raw[:, j - 4] >> 6) << 4)).astype(np.float32)
        mn[:, j] = ((sc_raw[:, j + 4] >> 4)
                    | ((sc_raw[:, j] >> 6) << 4)).astype(np.float32)
    # nibble expansion: each 32-byte strip q yields 64 values — low
    # nibbles feed sub-block 2k, high nibbles sub-block 2k+1
    strips = qs.reshape(nb, 4, 32)
    lo = (strips & 0x0F).astype(np.float32)       # [nb, 4, 32]
    hi = (strips >> 4).astype(np.float32)
    vals = np.empty((nb, 8, 32), np.float32)
    vals[:, 0::2] = lo
    vals[:, 1::2] = hi
    out = d[:, None] * sc[:, :, None] * vals - dmin[:, None] * mn[:, :, None]
    return out.reshape(nb, 256)


def _dequant_q6_k(mm, n: int, start: int) -> np.ndarray:
    """Q6_K: 256-value super-blocks of 210 bytes — 128 low-nibble bytes,
    64 high-2-bit bytes, 16 int8 scales, f16 d; q = 6-bit value - 32,
    value = d * scale[sub] * q (llama.cpp dequantize_row_q6_K layout)."""
    nb = n // 256
    raw = np.frombuffer(mm, np.uint8, nb * 210, start).reshape(nb, 210)
    ql = raw[:, :128].reshape(nb, 2, 64)       # two 128-value halves
    qh = raw[:, 128:192].reshape(nb, 2, 32)
    sc = raw[:, 192:208].copy().view(np.int8).astype(np.float32)  # [nb,16]
    d = raw[:, 208:210].copy().view(np.float16).astype(np.float32)
    vals = np.empty((nb, 2, 128), np.float32)
    for half in range(2):
        l_lo = ql[:, half, :32]    # ql[l]
        l_hi = ql[:, half, 32:]    # ql[l+32]
        h = qh[:, half]            # qh[l]
        q1 = (l_lo & 0x0F) | (((h >> 0) & 3) << 4)
        q2 = (l_hi & 0x0F) | (((h >> 2) & 3) << 4)
        q3 = (l_lo >> 4) | (((h >> 4) & 3) << 4)
        q4 = (l_hi >> 4) | (((h >> 6) & 3) << 4)
        vals[:, half, 0:32] = q1
        vals[:, half, 32:64] = q2
        vals[:, half, 64:96] = q3
        vals[:, half, 96:128] = q4
    vals -= 32.0
    # scale index: within each 128-half, value l*32+i uses scale half*8 +
    # l*2 + i//16 (8 scales per half, one per 16 values)
    scales = sc.reshape(nb, 2, 8)
    out = vals.reshape(nb, 2, 8, 16) * scales[:, :, :, None] * d[:, :, None,
                                                                 None]
    return out.reshape(nb, 256)


# -- config -------------------------------------------------------------------

def config_from_gguf(g: GGUFFile, name: str = ""):
    """Map `<arch>.*` GGUF metadata onto ModelConfig."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    md = g.metadata
    arch = md.get("general.architecture", "llama")
    if arch not in ("llama", "mistral", "qwen2", "gemma"):
        raise ValueError(f"unsupported gguf architecture {arch!r}")
    p = arch  # key prefix

    def key(suffix, default=None):
        return md.get(f"{p}.{suffix}", default)

    # a truncated or foreign gguf names the file and the missing key
    required = ("attention.head_count", "embedding_length",
                "feed_forward_length", "block_count")
    missing = [f"{p}.{s}" for s in required if key(s) is None]
    if missing:
        raise ValueError(
            f"{g.path}: missing required gguf metadata "
            f"key{'s' if len(missing) > 1 else ''} {', '.join(missing)}")

    heads = int(key("attention.head_count"))
    d = int(key("embedding_length"))
    vocab = int(key("vocab_size",
                    len(md.get("tokenizer.ggml.tokens", [])) or 0))
    return ModelConfig(
        name=name or md.get("general.name", arch),
        vocab_size=vocab,
        hidden_size=d,
        intermediate_size=int(key("feed_forward_length")),
        num_layers=int(key("block_count")),
        num_heads=heads,
        num_kv_heads=int(key("attention.head_count_kv", heads)),
        head_dim=int(key("attention.key_length", d // heads)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
        max_model_len=int(key("context_length", 2048)),
        attn_bias=arch == "qwen2",
        # Gemma deltas: llama.cpp converters bake the +1 into the stored
        # norm weights (undone at load, see norm_w below) and scale
        # embeddings by sqrt(d) at graph build
        embed_scale=float(d) ** 0.5 if arch == "gemma" else 0.0,
        norm_plus_one=arch == "gemma",
        mlp_act="gelu_tanh" if arch == "gemma" else "silu",
        tie_word_embeddings="output.weight" not in g.tensors,
        # MoE (Mixtral-class ggufs keep arch "llama" + expert_count)
        num_experts=int(key("expert_count", 0) or 0),
        num_experts_per_tok=int(key("expert_used_count", 2) or 2),
    )


def load_params_from_gguf(g: GGUFFile, cfg, dtype: str = "",
                          device="cpu") -> Dict[str, Any]:
    """llama.cpp tensor names -> our stacked params (models/llama.py) on
    `device`.

    GGUF stores projections [out, in] like HF (after the ne -> numpy shape
    reversal), so the same transposes as models/loader.py apply. Each
    tensor is dequantized to f32 on the host (one at a time), copied to the
    device and cast there into its slice of the stack; int8 leaves
    (cfg.quant) quantize each layer slice on the device, so the transient
    full-precision footprint is one layer's projection."""
    from dynamo_tpu_torch.models.llama import _DTYPES
    from dynamo_tpu_torch.models.loader import StackLoader, quant_keys_for
    ld = StackLoader(lambda name: torch.from_numpy(g.tensor(name)),
                     _DTYPES[dtype or cfg.dtype], device, quant_keys_for(cfg))
    n = cfg.num_layers

    def t(name):
        return ld.get(name).T

    def norm_w(name):
        # llama.cpp's Gemma converter bakes the +1 into every *norm.weight
        # at conversion time; our runtime re-adds it (rms_norm plus_one),
        # so undo the bake here to keep one convention across HF and GGUF
        if cfg.norm_plus_one:
            return ld.get(name) - 1.0
        return ld.get(name)

    last: Dict[str, Any] = {}

    def t3(name):
        # fused expert tensor [E, A, B] (ne-reversed) -> ours [E, B, A];
        # fetched (dequantized) once for all of a layer's experts
        if name not in last:
            last.clear()
            last[name] = ld.get(name).transpose(1, 2)
        return last[name]

    def put(key, fmt, fn):
        layers[key] = ld.stack(key, n, lambda i: fn(fmt.format(i)))

    layers: Dict[str, Any] = {}
    put("attn_norm", "blk.{}.attn_norm.weight", norm_w)
    put("wq", "blk.{}.attn_q.weight", t)
    put("wk", "blk.{}.attn_k.weight", t)
    put("wv", "blk.{}.attn_v.weight", t)
    put("wo", "blk.{}.attn_output.weight", t)
    put("mlp_norm", "blk.{}.ffn_norm.weight", norm_w)
    if cfg.is_moe:
        # Mixtral-class: llama.cpp fuses experts into one tensor per
        # projection (blk.N.ffn_{gate,up,down}_exps.weight, [E, out, in]
        # after the ne reversal) + the routing gate ffn_gate_inp
        missing = [m for m in ("ffn_gate_inp", "ffn_gate_exps",
                               "ffn_up_exps", "ffn_down_exps")
                   if f"blk.0.{m}.weight" not in g.tensors]
        if missing:
            raise ValueError(
                f"{g.path}: MoE gguf ({cfg.num_experts} experts) missing "
                f"fused expert tensors {missing}; only the fused "
                f"blk.N.ffn_*_exps layout (current llama.cpp converters) "
                f"is supported — not the old per-expert "
                f"blk.N.ffn_gate.{{e}} split")
        put("router", "blk.{}.ffn_gate_inp.weight", t)
        for key, name in (("w_gate", "ffn_gate_exps"), ("w_up", "ffn_up_exps"),
                          ("w_down", "ffn_down_exps")):
            # one layer's [E, in, out] quantizes per expert, as the JAX
            # per-layer [E, in, out] quantization reduces over in
            layers[key] = ld.stack(key, (n, cfg.num_experts),
                                   lambda i, e, m=name: t3(
                                       f"blk.{i}.{m}.weight")[e])
    else:
        put("w_gate", "blk.{}.ffn_gate.weight", t)
        put("w_up", "blk.{}.ffn_up.weight", t)
        put("w_down", "blk.{}.ffn_down.weight", t)
    if cfg.attn_bias:
        put("wq_b", "blk.{}.attn_q.bias", ld.get)
        put("wk_b", "blk.{}.attn_k.bias", ld.get)
        put("wv_b", "blk.{}.attn_v.bias", ld.get)
    params: Dict[str, Any] = {
        "embed": ld.one("embed", ld.get("token_embd.weight")),
        "layers": layers,
        "final_norm": ld.one("final_norm", norm_w("output_norm.weight")),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = ld.one("lm_head", t("output.weight"))
    return params


# -- tokenizer ----------------------------------------------------------------

# llama.cpp pre-tokenizer regex table (tokenizer.ggml.pre -> split pattern);
# these are the published patterns the matching HF tokenizer.json files
# carry. Unlisted names fall back to ByteLevel's builtin GPT-2 pattern.
_PRE_PATTERNS: Dict[str, str] = {
    "llama-bpe": (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
        r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"),
    "llama3": (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
        r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"),
    "qwen2": (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
        r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"),
}

_TOKEN_TYPE_CONTROL = 3  # llama.cpp LLAMA_TOKEN_TYPE_CONTROL


def _spm_prepare(text: str, space: str, add_prefix: bool) -> str:
    """The SPM pre-transform (space marker + optional leading marker)."""
    s = text.replace(" ", space)
    if add_prefix and not s.startswith(space):
        s = space + s
    return s


def _spm_encode(text: str, ids: Dict[str, int], scores: List[float],
                byte_ids: Dict[int, int], unk: int, space: str,
                add_prefix: bool) -> List[int]:
    """SentencePiece BPE: greedy bigram merging by token score.

    The llama.cpp SPM tokenizer repeatedly merges the adjacent symbol
    pair whose concatenation is a vocab token with the highest score
    (ties: leftmost), starting from single characters; leftover unmatched
    characters fall back to <0xXX> byte tokens, then unk. Implemented
    with a heap over a linked list of live pieces (stale entries skipped
    on pop), so long prompts stay O(n log n)."""
    import heapq

    s = _spm_prepare(text, space, add_prefix)
    piece: List[str] = list(s)
    n = len(piece)
    if n == 0:
        return []
    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    alive = [True] * n
    heap: list = []

    def push(i: int) -> None:
        j = nxt[i]
        if i < 0 or j < 0:
            return
        merged = piece[i] + piece[j]
        tid = ids.get(merged)
        if tid is not None:
            heapq.heappush(heap, (-scores[tid], i, merged))

    for i in range(n - 1):
        push(i)
    while heap:
        _, i, merged = heapq.heappop(heap)
        if not alive[i]:
            continue
        j = nxt[i]
        if j < 0 or piece[i] + piece[j] != merged:
            continue  # stale entry: a neighbor already merged away
        piece[i] = merged
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[j] >= 0:
            prv[nxt[j]] = i
        if prv[i] >= 0:
            push(prv[i])
        push(i)
    out: List[int] = []
    idx = 0
    while idx != -1:
        tid = ids.get(piece[idx])
        if tid is not None:
            out.append(tid)
        else:
            # unmatched single char: byte fallback, else unk — NEVER drop
            # silently (the model would answer a different prompt)
            got = False
            for b in piece[idx].encode("utf-8"):
                bid = byte_ids.get(b)
                if bid is not None:
                    out.append(bid)
                    got = True
            if not got:
                out.append(unk)
        idx = nxt[idx]
    return out


class GGUFTokenizer(BaseTokenizer):
    """Tokenizer rebuilt from GGUF-embedded vocab, dispatching on
    `tokenizer.ggml.model`:

    - "gpt2" (llama-3, qwen2, ...): a byte-level BPE (llm/bpe.py) from
      tokenizer.ggml.tokens + tokenizer.ggml.merges, with the
      pre-tokenizer split pattern selected by tokenizer.ggml.pre and
      control tokens registered as atomic specials;
    - "llama" (SentencePiece): score-driven bigram-merge encode
      (tokenizer.ggml.scores), "▁" space marker, <0xXX> byte fallback;
    - anything else: an error naming the model string.
    """

    SPACE = "▁"  # ▁

    def __init__(self, g: GGUFFile):
        md = g.metadata
        self.tokens: List[str] = list(md.get("tokenizer.ggml.tokens", []))
        if not self.tokens:
            raise ValueError("gguf has no tokenizer.ggml.tokens")
        self.model: str = md.get("tokenizer.ggml.model", "llama")
        if self.model not in ("llama", "gpt2"):
            raise ValueError(
                f"unsupported tokenizer.ggml.model {self.model!r}; "
                "supported: 'llama' (SentencePiece), 'gpt2' (byte-level "
                "BPE)")
        bos = md.get("tokenizer.ggml.bos_token_id")
        self.bos_token_id: Optional[int] = (
            int(bos) if bos is not None else None)
        eos = md.get("tokenizer.ggml.eos_token_id")
        self.eos_token_ids = [int(eos)] if eos is not None else []
        self._ids: Dict[str, int] = {}
        for i, tok in enumerate(self.tokens):
            self._ids.setdefault(tok, i)
        unk = md.get("tokenizer.ggml.unknown_token_id")
        self.unk_token_id = int(unk) if unk is not None else (
            self._ids.get("<unk>", 0))
        if self.model == "gpt2":
            self._bpe = self._build_bpe(md)
            self._native = None
        else:
            self._bpe = None
            self._byte_ids: Dict[int, int] = {}
            for i, tok in enumerate(self.tokens):
                if len(tok) == 6 and tok.startswith("<0x") \
                        and tok.endswith(">"):
                    self._byte_ids[int(tok[3:5], 16)] = i
            raw_scores = md.get("tokenizer.ggml.scores")
            if raw_scores is not None and len(raw_scores) == len(self.tokens):
                self._scores = [float(x) for x in raw_scores]
            else:
                # score-less SPM vocab (hand-built files): every merge ties,
                # so merging proceeds leftmost-first
                self._scores = [0.0] * len(self.tokens)
            self._add_prefix = bool(
                md.get("tokenizer.ggml.add_space_prefix", True))
            # the native C++ encoder when the toolchain builds it (exact
            # parity with _spm_encode); None -> the Python path below, with
            # the failure counted and logged by native.load
            from dynamo_tpu_torch.native.spm import make_encoder
            self._native = make_encoder(self.tokens, self._scores,
                                        self._byte_ids, self.unk_token_id)

    def _build_bpe(self, md: Dict[str, Any]):
        """tokens + merges -> a byte-level BPE, the tokenizer.json the JAX
        package builds in memory with `tokenizers`."""
        from dynamo_tpu_torch.llm.bpe import BPETokenizer
        merges_raw = md.get("tokenizer.ggml.merges")
        if not merges_raw:
            raise ValueError(
                "gpt2-model gguf has no tokenizer.ggml.merges; cannot "
                "build a faithful BPE encoder")
        pre = md.get("tokenizer.ggml.pre", "")
        byte_level = {"type": "ByteLevel", "add_prefix_space": False}
        pat = _PRE_PATTERNS.get(pre)
        pre_tok = byte_level if pat is None else {
            "type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": pat},
                 "behavior": "Isolated", "invert": False},
                dict(byte_level, use_regex=False)]}
        types = md.get("tokenizer.ggml.token_type") or []
        specials = [{"id": self._ids[tok], "content": tok, "special": True,
                     "normalized": False, "lstrip": False, "rstrip": False,
                     "single_word": False}
                    for tok, ty in zip(self.tokens, types)
                    if ty == _TOKEN_TYPE_CONTROL]
        return BPETokenizer({
            "model": {"type": "BPE", "vocab": dict(self._ids),
                      "merges": [m.split(" ", 1) for m in merges_raw],
                      # llama-3-style tokenizers keep whole-vocab hits
                      "ignore_merges": pre in ("llama-bpe", "llama3")},
            "pre_tokenizer": pre_tok,
            "decoder": {"type": "ByteLevel"},
            "added_tokens": specials})

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def encode(self, text: str) -> List[int]:
        if self._bpe is not None:
            return self._bpe.encode(text)
        if self._native is not None:
            return self._native.encode(
                _spm_prepare(text, self.SPACE, self._add_prefix))
        return _spm_encode(text, self._ids, self._scores, self._byte_ids,
                           self.unk_token_id, self.SPACE, self._add_prefix)

    def decode(self, ids) -> str:
        if self._bpe is not None:
            return self._bpe.decode([int(i) for i in ids])
        parts: List[str] = []
        pending: List[int] = []

        def flush():
            if pending:
                parts.append(bytes(pending).decode("utf-8",
                                                   errors="replace"))
                pending.clear()

        byte_rev = {v: k for k, v in self._byte_ids.items()}
        for tid in ids:
            tid = int(tid)
            if tid in byte_rev:
                pending.append(byte_rev[tid])
                continue
            flush()
            if 0 <= tid < len(self.tokens):
                parts.append(self.tokens[tid])
        flush()
        # one global pass so space markers survive byte-fallback round
        # trips too (a "▁" encoded as raw utf-8 bytes must still decode
        # back to a space)
        text = "".join(parts).replace(self.SPACE, " ")
        return text[1:] if text.startswith(" ") else text


def load_gguf(path: str, dtype: str = "", device="cpu") -> Tuple[
        Any, Dict[str, Any], GGUFTokenizer]:
    """One-call GGUF sourcing: (ModelConfig, params, tokenizer)."""
    g = GGUFFile(path)
    cfg = config_from_gguf(g)
    params = load_params_from_gguf(g, cfg, dtype=dtype, device=device)
    tok = GGUFTokenizer(g)
    return cfg, params, tok
