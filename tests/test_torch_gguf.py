"""The port's GGUF sourcing (dynamo_tpu_torch/llm/gguf.py) against the JAX
package's (dynamo_tpu/llm/gguf.py) on the same files, written with the
in-test GGUF writer of tests/test_gguf.py: every tensor type's
dequantization bit-equal (F32, F16, BF16, Q8_0, Q4_0, Q4_K, Q6_K), the
config flags, the loaded leaves (dense, Gemma's baked +1, MoE's fused
experts; f32, bf16 and int8) bit-equal, the SentencePiece and gpt2
tokenizers id for id, engines token-identical in f32 (greedy,
seeded-sampled, int8 weights greedy), the card, the entry point, and the
error messages.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu.llm import gguf as jg
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.llm import gguf as tg
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
from test_gguf import (
    D, HEADS, HD, KV, L, F, _byte_level_vocab_and_merges, _f16, _f32, _q8_0,
    _spm_scores, _vocab, make_tiny_gguf, make_tiny_moe_gguf, write_gguf,
)

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _open(path):
    return jg.GGUFFile(path), tg.GGUFFile(path)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not ("q" in v and "s" in v):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype != torch.int8 else x.numpy()
    x = np.asarray(x)
    return x if x.dtype == np.int8 else x.astype(np.float32)


def _assert_trees_equal(tp, jp):
    ft, fj = _flat(tp), _flat(jp)
    assert ft.keys() == fj.keys()
    for k in fj:
        if isinstance(fj[k], dict):
            for part in ("q", "s"):
                np.testing.assert_array_equal(_np(ft[k][part]),
                                              _np(fj[k][part]), err_msg=k)
        else:
            np.testing.assert_array_equal(_np(ft[k]), _np(fj[k]), err_msg=k)


def _quant_block(gtype, block_bytes, nblocks, rng):
    """Random block bytes with finite f16 scales (tests/test_gguf.py)."""
    raw = rng.randint(0, 256, nblocks * block_bytes, dtype=np.uint8)
    for base in range(0, len(raw), block_bytes):
        off = base + (208 if gtype == 14 else 0)
        raw[off:off + 2] = np.frombuffer(
            np.float16(rng.uniform(-2, 2)).tobytes(), np.uint8)
        if gtype == 12:
            raw[base + 2:base + 4] = np.frombuffer(
                np.float16(rng.uniform(0, 1)).tobytes(), np.uint8)
    return raw.tobytes()


def test_every_tensor_type_bit_equal(tmp_path):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 256) * 0.3).astype(np.float32)
    bf16 = (x.view(np.uint32) >> 16).astype(np.uint16)
    tensors = {
        "f32": _f32(x), "f16": _f16(x), "q8_0": _q8_0(x),
        "bf16": (30, x, bf16.tobytes()),
        "q4_0": (2, np.zeros((2, 32)), _quant_block(2, 18, 2, rng)),
        "q4_k": (12, np.zeros((2, 256)), _quant_block(12, 144, 2, rng)),
        "q6_k": (14, np.zeros((2, 256)), _quant_block(14, 210, 2, rng)),
    }
    path = str(tmp_path / "types.gguf")
    write_gguf(path, {"general.architecture": (8, "llama")}, tensors)
    j, t = _open(path)
    assert (t.version, t.data_start, t.metadata) == (j.version,
                                                     j.data_start, j.metadata)
    for name in tensors:
        got, want = t.tensor(name), j.tensor(name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    j.close()
    t.close()


def _gemma_gguf(path):
    rng = np.random.RandomState(5)
    toks = _vocab()
    d, f = 64, 128

    def r(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)
    tensors = {"token_embd.weight": _f32(r(len(toks), d)),
               "output_norm.weight": _f32(1.0 + r(d))}
    for i in range(2):
        tensors.update({
            f"blk.{i}.attn_norm.weight": _f32(1.0 + r(d)),
            f"blk.{i}.attn_q.weight": _q8_0(r(4 * 32, d)),
            f"blk.{i}.attn_k.weight": _f32(r(32, d)),
            f"blk.{i}.attn_v.weight": _f32(r(32, d)),
            f"blk.{i}.attn_output.weight": _f16(r(d, 4 * 32)),
            f"blk.{i}.ffn_norm.weight": _f32(1.0 + r(d)),
            f"blk.{i}.ffn_gate.weight": _f32(r(f, d)),
            f"blk.{i}.ffn_up.weight": _f32(r(f, d)),
            f"blk.{i}.ffn_down.weight": _f32(r(d, f)),
        })
    write_gguf(path, {
        "general.architecture": (8, "gemma"),
        "gemma.embedding_length": (4, d),
        "gemma.block_count": (4, 2),
        "gemma.feed_forward_length": (4, f),
        "gemma.attention.head_count": (4, 4),
        "gemma.attention.head_count_kv": (4, 1),
        "gemma.attention.key_length": (4, 32),
        "gemma.attention.layer_norm_rms_epsilon": (6, 1e-6),
        "gemma.context_length": (4, 256),
        "tokenizer.ggml.model": (8, "llama"),
        "tokenizer.ggml.tokens": (9, (8, toks)),
        "tokenizer.ggml.scores": (9, (6, _spm_scores(toks))),
    }, tensors)


def _qwen2_gguf(path):
    rng = np.random.RandomState(6)
    toks = _vocab()

    def r(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)
    tensors = {"token_embd.weight": _f32(r(len(toks), D)),
               "output_norm.weight": _f32(np.ones(D, np.float32)),
               "output.weight": _f32(r(len(toks), D))}
    for i in range(L):
        tensors.update({
            f"blk.{i}.attn_norm.weight": _f32(np.ones(D, np.float32)),
            f"blk.{i}.attn_q.weight": _f32(r(HEADS * HD, D)),
            f"blk.{i}.attn_q.bias": _f32(r(HEADS * HD)),
            f"blk.{i}.attn_k.weight": _f32(r(KV * HD, D)),
            f"blk.{i}.attn_k.bias": _f32(r(KV * HD)),
            f"blk.{i}.attn_v.weight": _f32(r(KV * HD, D)),
            f"blk.{i}.attn_v.bias": _f32(r(KV * HD)),
            f"blk.{i}.attn_output.weight": _f32(r(D, HEADS * HD)),
            f"blk.{i}.ffn_norm.weight": _f32(np.ones(D, np.float32)),
            f"blk.{i}.ffn_gate.weight": _f32(r(F, D)),
            f"blk.{i}.ffn_up.weight": _f32(r(F, D)),
            f"blk.{i}.ffn_down.weight": _f32(r(D, F)),
        })
    toks = _vocab()
    write_gguf(path, {
        "general.architecture": (8, "qwen2"),
        "qwen2.embedding_length": (4, D),
        "qwen2.block_count": (4, L),
        "qwen2.feed_forward_length": (4, F),
        "qwen2.attention.head_count": (4, HEADS),
        "qwen2.attention.head_count_kv": (4, KV),
        "qwen2.context_length": (4, 256),
        "tokenizer.ggml.model": (8, "llama"),
        "tokenizer.ggml.tokens": (9, (8, toks)),
        "tokenizer.ggml.scores": (9, (6, _spm_scores(toks))),
    }, tensors)


WRITERS = {"llama": make_tiny_gguf, "moe": make_tiny_moe_gguf,
           "gemma": _gemma_gguf, "qwen2": _qwen2_gguf}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("gguf")
    out = {}
    for name, write in WRITERS.items():
        out[name] = str(root / f"{name}.gguf")
        write(out[name])
    return out


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_config_flags_match_jax(files, name):
    j, t = _open(files[name])
    jc, tc = jg.config_from_gguf(j), tg.config_from_gguf(t)
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert td == jd
    j.close()
    t.close()


@pytest.mark.parametrize("dtype,quant", [("float32", ""), ("bfloat16", ""),
                                         ("bfloat16", "int8")])
@pytest.mark.parametrize("name", sorted(WRITERS))
def test_leaves_bit_equal_to_jax(files, name, dtype, quant):
    j, t = _open(files[name])
    jc = dataclasses.replace(jg.config_from_gguf(j), dtype=dtype,
                             quant=quant)
    tc = dataclasses.replace(tg.config_from_gguf(t), dtype=dtype,
                             quant=quant)
    _assert_trees_equal(tg.load_params_from_gguf(t, tc),
                        jg.load_params_from_gguf(j, jc))
    j.close()
    t.close()


def test_spm_tokenizer_id_for_id(files):
    j, t = _open(files["llama"])
    jt, tt = jg.GGUFTokenizer(j), tg.GGUFTokenizer(t)
    assert (tt.vocab_size, tt.eos_token_ids, tt.bos_token_id) == (
        jt.vocab_size, jt.eos_token_ids, jt.bos_token_id)
    for text in ("hello world", "the world", "hello zebra!", "", " ",
                 "  hello   world  ", "héllo wörld 😀", "▁hello",
                 "thethe hellohello\nworld\t!"):
        ids = jt.encode(text)
        assert tt.encode(text) == ids, text
        assert tt.decode(ids) == jt.decode(ids), text
    for ids in ([1, 2, 999999, 300], list(range(0, 300, 7))):
        assert tt.decode(ids) == jt.decode(ids)


def test_gpt2_tokenizer_id_for_id(tmp_path):
    toks, merges = _byte_level_vocab_and_merges()
    special = "<|eot|>"
    toks.append(special)
    types = [1] * (len(toks) - 1) + [3]
    for pre in ("llama-bpe", "qwen2", "other"):
        path = str(tmp_path / f"{pre}.gguf")
        write_gguf(path, {
            "general.architecture": (8, "llama"),
            "tokenizer.ggml.model": (8, "gpt2"),
            "tokenizer.ggml.pre": (8, pre),
            "tokenizer.ggml.tokens": (9, (8, toks)),
            "tokenizer.ggml.merges": (9, (8, merges)),
            "tokenizer.ggml.token_type": (9, (5, types)),
            "tokenizer.ggml.eos_token_id": (4, len(toks) - 1),
        }, {})
        j, t = _open(path)
        jt, tt = jg.GGUFTokenizer(j), tg.GGUFTokenizer(t)
        for text in ("hello world", "hello   world!", "I'm 12345 ok",
                     "héllo wörld", "line\nbreak  x", f"hello{special}x",
                     "HELLO World's 2024\r\n\r\n  end"):
            ids = jt.encode(text)
            assert tt.encode(text) == ids, (pre, text)
            assert tt.decode(ids) == jt.decode(ids), (pre, text)


@pytest.mark.parametrize("case,match", [
    ("q2_k", "Q2_K"), ("bert", "bert"), ("missing_keys",
                                         "llama.attention.head_count"),
    ("no_experts", "fused expert tensors"), ("arch", "falcon"),
    ("no_merges", "merges"),
])
def test_error_messages_match_jax(tmp_path, files, case, match):
    path = str(tmp_path / f"{case}.gguf")
    if case == "q2_k":
        write_gguf(path, {"general.architecture": (8, "llama")},
                   {"w": (10, np.zeros((1, 256), np.float32),
                          b"\x00" * 84)})
        run = lambda m, g: m.GGUFFile(path).tensor("w")  # noqa: E731
    elif case == "bert":
        write_gguf(path, {"general.architecture": (8, "llama"),
                          "tokenizer.ggml.model": (8, "bert"),
                          "tokenizer.ggml.tokens": (9, (8, ["a", "b"]))}, {})
        run = lambda m, g: m.GGUFTokenizer(m.GGUFFile(path))  # noqa: E731
    elif case == "no_merges":
        write_gguf(path, {"general.architecture": (8, "llama"),
                          "tokenizer.ggml.model": (8, "gpt2"),
                          "tokenizer.ggml.tokens": (9, (8, ["a", "b"]))}, {})
        run = lambda m, g: m.GGUFTokenizer(m.GGUFFile(path))  # noqa: E731
    elif case in ("missing_keys", "arch"):
        write_gguf(path, {"general.architecture": (
            8, "llama" if case == "missing_keys" else "falcon"),
            "llama.embedding_length": (4, 32)}, {})
        run = lambda m, g: m.config_from_gguf(  # noqa: E731
            m.GGUFFile(path))
    else:
        def run(m, g):
            f = m.GGUFFile(files["llama"])
            cfg = dataclasses.replace(m.config_from_gguf(f), num_experts=4)
            return m.load_params_from_gguf(f, cfg)
    with pytest.raises(ValueError, match=match) as want:
        run(jg, None)
    with pytest.raises(ValueError, match=match) as got:
        run(tg, None)
    assert str(got.value) == str(want.value)


def test_model_card_from_gguf(files):
    jc, tc = JCard.from_gguf(files["llama"]), TCard.from_gguf(files["llama"])
    for key in ("name", "model_type", "tokenizer_kind", "chat_template",
                "context_length", "eos_token_ids", "bos_token_id",
                "model_path"):
        assert getattr(tc, key) == getattr(jc, key), key
    assert tc.model_config().hidden_size == D
    tok = tc.load_tokenizer()
    assert tok.decode(tok.encode("the world")) == "the world"


ENGINE_KW = dict(page_size=8, num_pages=32, max_slots=2,
                 max_prefill_chunk=16, prefill_buckets=(8, 16),
                 max_model_len=128)


def _drive(eng, request_cls, params_cls, reqs):
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


@pytest.mark.parametrize("name,mode", [
    ("llama", "greedy"), ("llama", "sampled"), ("llama", "int8_greedy"),
    ("moe", "greedy"), ("moe", "int8_greedy"), ("qwen2", "greedy"),
    ("gemma", "greedy")])
def test_engine_streams_match_jax(files, name, mode):
    j, t = _open(files[name])
    quant = "int8" if mode.startswith("int8") else ""
    jc = dataclasses.replace(jg.config_from_gguf(j), dtype="float32",
                             max_model_len=128, quant=quant,
                             decode_kernel="off")
    tc = dataclasses.replace(tg.config_from_gguf(t), dtype="float32",
                             max_model_len=128, quant=quant)
    jeng = JNativeEngine(jc, JEngineConfig(**ENGINE_KW),
                         params=jg.load_params_from_gguf(j, jc))
    teng = TNativeEngine(tc, TEngineConfig(**ENGINE_KW),
                         params=tg.load_params_from_gguf(t, tc),
                         device="cpu")
    kw = (dict(max_tokens=8, temperature=0.9, top_k=30, seed=5)
          if mode == "sampled" else dict(max_tokens=8, ignore_eos=True))
    reqs = [("a", list(range(5, 17)), kw),
            ("b", list(range(40, 71)), dict(kw, seed=9) if "seed" in kw
             else kw)]
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    assert _drive(teng, TRequest, TSamplingParams, reqs) == want
    j.close()
    t.close()


def test_run_launcher_serves_gguf_file_with_quant(files):
    """`python -m dynamo_tpu_torch.run in=stdin out=native model.gguf
    --quant int8 --device cpu`: card from the file's metadata, int8
    quantization at load, one completion out."""
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", "in=stdin",
         "out=native", files["llama"], "--quant", "int8", "--device", "cpu",
         "--num-pages", "32", "--max-slots", "2", "--max-tokens", "8"],
        input="hello there", capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() != ""
