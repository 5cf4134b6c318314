"""Checkpoint sourcing in the port (dynamo_tpu_torch/models/loader.py,
llm/model_card.py, llm/preprocessor.py, run.py) against the JAX package
on the same files, written here with transformers and `tokenizers`.

- config_from_hf: every field as JAX's (the port also reads the model
  dtype from config.json), and the same refusals;
- load_params_from_hf: every leaf bit-equal to the JAX loader's (compared
  as f32) for llama, tied llama, qwen2, mixtral, gemma, gemma2 and phi3,
  from an f32 checkpoint at f32
  and at bf16 and from a bf16 checkpoint at bf16, sharded or not; with
  quant="int8" byte-equal to quantize_params of the bf16 tree;
- forward logits in f32 within 1e-5 of JAX and 2e-4 of transformers (the
  JAX package's own tolerance, tests/test_hf_loader.py);
- the hand-written safetensors reader equal to `safe_open` on
  hypothesis-drawn shapes and dtypes;
- engines on the same directory token-identical to the JAX engine in f32
  (greedy, seeded-sampled, int8 weights greedy; Gemma-2 through the gather
  window, its sliding window crossed), chat templates rendered
  as JAX renders them, `run.py in=batch` as a process equal to the JAX
  `run.py` on the same directory, and a served stream equal to
  transformers.generate (tools/real_ckpt_e2e.py's checkpoint).
"""
import copy
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.loader import config_from_hf as jconfig_from_hf
from dynamo_tpu.models.loader import load_params_from_hf as jload_params
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.config import check_supported
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.ops.quant import quantize_params

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
TOL_JAX = 1e-5
TOL_HF = 2e-4   # tests/test_hf_loader.py's tolerance against transformers

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)


def _family(name):
    import transformers as tf
    if name == "llama":
        return tf.LlamaForCausalLM(tf.LlamaConfig(
            **SMALL, rope_theta=10000.0, tie_word_embeddings=False))
    if name == "llama_tied":
        return tf.LlamaForCausalLM(tf.LlamaConfig(
            **dict(SMALL, num_key_value_heads=4), tie_word_embeddings=True))
    if name == "qwen2":
        return tf.Qwen2ForCausalLM(tf.Qwen2Config(
            **SMALL, tie_word_embeddings=False))
    if name == "mixtral":
        return tf.MixtralForCausalLM(tf.MixtralConfig(
            **dict(SMALL, intermediate_size=96), num_local_experts=4,
            num_experts_per_tok=2, tie_word_embeddings=False))
    if name == "gemma":
        return tf.GemmaForCausalLM(tf.GemmaConfig(
            **SMALL, head_dim=24, rope_theta=10000.0))
    if name == "gemma2":
        return tf.Gemma2ForCausalLM(tf.Gemma2Config(
            **dict(SMALL, num_hidden_layers=4), head_dim=16,
            rope_theta=10000.0, query_pre_attn_scalar=32, sliding_window=6,
            attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
            attn_implementation="eager"))
    if name == "phi3":
        return tf.Phi3ForCausalLM(tf.Phi3Config(
            **SMALL, rope_theta=10000.0, tie_word_embeddings=False,
            pad_token_id=0))
    raise KeyError(name)


FAMILIES = ("llama", "llama_tied", "qwen2", "mixtral", "gemma", "gemma2",
            "phi3")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{(family, stored dtype): (directory, the transformers model)}."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name in FAMILIES:
        torch.manual_seed(0)
        model = _family(name).eval()
        path = root / f"{name}_f32"
        model.save_pretrained(path, safe_serialization=True)
        out[(name, "float32")] = (str(path), model)
        path = root / f"{name}_bf16"
        copy.deepcopy(model).to(torch.bfloat16).save_pretrained(
            path, safe_serialization=True)
        out[(name, "bfloat16")] = (str(path), model)
        path = root / f"{name}_f16"
        copy.deepcopy(model).to(torch.float16).save_pretrained(
            path, safe_serialization=True)
        out[(name, "float16")] = (str(path), model)
    return out


def _hf(path):
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not ("q" in v and "s" in v):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _configs_equal(tcfg, jcfg):
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert t == j


@pytest.mark.parametrize("name", FAMILIES)
def test_config_from_hf_matches_jax(checkpoints, name):
    """The whole config equals JAX's, dtype included: a checkpoint is
    served in bfloat16 whatever config.json's dtype says."""
    for stored in ("float32", "bfloat16", "float16"):
        hf = _hf(checkpoints[(name, stored)][0])
        assert (hf.get("dtype") or hf.get("torch_dtype")) == stored
        tcfg = tloader.config_from_hf(hf, "m")
        _configs_equal(tcfg, jconfig_from_hf(hf, "m"))
        assert tcfg.dtype == "bfloat16"


@pytest.mark.parametrize("stored,dtype", [("float32", "float32"),
                                          ("float32", "bfloat16"),
                                          ("bfloat16", "bfloat16"),
                                          ("float16", "bfloat16")])
@pytest.mark.parametrize("name", FAMILIES)
def test_leaves_bit_equal_to_jax(checkpoints, name, stored, dtype):
    path = checkpoints[(name, stored)][0]
    hf = _hf(path)
    jp = jload_params(path, jconfig_from_hf(hf), dtype)
    tp = tloader.load_params_from_hf(path, tloader.config_from_hf(hf), dtype)
    fj, ft = _flat(jp), _flat(tp)
    assert fj.keys() == ft.keys()
    for k in fj:
        assert ft[k].dtype == tllama._DTYPES[dtype], k
        np.testing.assert_array_equal(_f32(ft[k]), _f32(fj[k]), err_msg=k)


def test_sharded_directory(checkpoints, tmp_path):
    """A checkpoint saved in shards (with model.safetensors.index.json)
    reads every shard in sorted order; leaves as JAX's."""
    _, model = checkpoints[("mixtral", "float32")]
    path = tmp_path / "sharded"
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size="100KB")
    assert len(list(path.glob("*.safetensors"))) > 2
    hf = _hf(path)
    jp = jload_params(str(path), jconfig_from_hf(hf), "float32")
    tp = tloader.load_params_from_hf(str(path), tloader.config_from_hf(hf),
                                     "float32")
    fj, ft = _flat(jp), _flat(tp)
    for k in fj:
        np.testing.assert_array_equal(_f32(ft[k]), _f32(fj[k]), err_msg=k)


@pytest.mark.parametrize("name", ["llama", "mixtral", "llama_tied"])
def test_int8_load_equals_quantize_params(checkpoints, name):
    """--quant int8 quantizes each layer slice as it loads: byte-equal to
    quantize_params of the bf16 tree."""
    path = checkpoints[(name, "bfloat16")][0]
    cfg, tp = tloader.load_model_dir(path, quant="int8")
    assert cfg.quant == "int8"
    _, ref = tloader.load_model_dir(path)
    fq, fr = _flat(tp), _flat(quantize_params(ref))
    assert fq.keys() == fr.keys()
    for k in fr:
        if isinstance(fr[k], dict):
            assert torch.equal(fq[k]["q"], fr[k]["q"]), k
            assert torch.equal(fq[k]["s"], fr[k]["s"]), k
        else:
            assert torch.equal(fq[k], fr[k]), k


def _meta_j(t):
    return jllama.AttnMetadata(
        positions=jnp.arange(t, dtype=jnp.int32)[None],
        page_table=jnp.arange(2, dtype=jnp.int32)[None],
        kv_lens=jnp.asarray([t], jnp.int32),
        write_idx=jnp.arange(t, dtype=jnp.int32)[None])


def _meta_t(t):
    return tllama.AttnMetadata(
        positions=torch.arange(t, dtype=torch.int32)[None],
        page_table=torch.arange(2, dtype=torch.int32)[None],
        kv_lens=torch.tensor([t], dtype=torch.int32),
        write_idx=torch.arange(t, dtype=torch.int32)[None])


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits(checkpoints, name):
    path, model = checkpoints[(name, "float32")]
    hf = _hf(path)
    jcfg = dataclasses.replace(jconfig_from_hf(hf), dtype="float32")
    tcfg = dataclasses.replace(tloader.config_from_hf(hf), dtype="float32")
    if tcfg.is_moe:   # the exact oracle on both sides, as JAX's test does
        jcfg = dataclasses.replace(jcfg, moe_impl="dense")
        tcfg = dataclasses.replace(tcfg, moe_impl="dense")
    jp = jload_params(path, jcfg)
    tp = tloader.load_params_from_hf(path, tcfg)
    ids = np.random.default_rng(0).integers(1, 128, 12).astype(np.int32)
    jlog, _ = jllama.forward(jp, jcfg, jnp.asarray(ids)[None],
                             jllama.init_cache(jcfg, 2, 8), _meta_j(12))
    tlog, _ = tllama.forward(tp, tcfg, torch.from_numpy(ids)[None],
                             tllama.init_cache(tcfg, 3, 8, "cpu"),
                             _meta_t(12))
    np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog[0]),
                               rtol=TOL_JAX, atol=TOL_JAX)
    with torch.no_grad():
        hf_log = model(torch.from_numpy(ids.astype(np.int64))[None]).logits
    np.testing.assert_allclose(tlog[0].numpy(), hf_log[0].numpy(),
                               rtol=TOL_HF, atol=TOL_HF)


def test_gemma2_serving_refused_by_name(checkpoints):
    """Gemma-2, once refused by name, is served: its config resolves the
    decode to the gather window with its knobs named, and an engine on the
    checkpoint streams token-identical to the JAX engine at its default
    decode_kernel="auto" (the gather window too), greedy, with prompts and
    windows that cross the 6-token sliding window."""
    path = checkpoints[("gemma2", "float32")][0]
    hf = _hf(path)
    cfg = tloader.config_from_hf(hf)
    assert cfg.post_norms and cfg.final_softcap == 30.0
    assert cfg.sliding_pattern == "alternate"
    check_supported(cfg, "cuda")
    assert tllama.decode_path(cfg) == (
        "gather", "attn_softcap, sliding_window, query_scale set: the "
        "ragged kernel has no hook for attention soft-caps, sliding "
        "windows or query scales")
    jcfg = dataclasses.replace(jconfig_from_hf(hf), dtype="float32")
    tcfg = dataclasses.replace(cfg, dtype="float32")
    jeng = JNativeEngine(jcfg, JEngineConfig(**ENGINE_KW),
                         params=jload_params(path, jcfg))
    teng = TNativeEngine(tcfg, TEngineConfig(**ENGINE_KW),
                         params=tloader.load_params_from_hf(path, tcfg),
                         device="cpu")
    reqs = REQS["greedy"]
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    assert _drive(teng, TRequest, TSamplingParams, reqs) == want
    assert all(len(v) > 3 for v in want.values())
    assert teng.metrics().decode_path == "gather"


@pytest.mark.parametrize("patch,match", [
    ({"rope_scaling": {"rope_type": "llama3", "factor": 8.0}},
     "rope_scaling='llama3'"),
    ({"architectures": ["GPT2LMHeadModel"]}, "unsupported architecture"),
])
def test_config_refusals_match_jax(checkpoints, patch, match):
    hf = dict(_hf(checkpoints[("llama", "float32")][0]), **patch)
    with pytest.raises(ValueError, match=match) as want:
        jconfig_from_hf(hf)
    with pytest.raises(ValueError, match=match) as got:
        tloader.config_from_hf(hf)
    assert str(got.value) == str(want.value)


def test_config_gemma2_layer_pattern_and_sliding_cap(checkpoints):
    hf = _hf(checkpoints[("gemma2", "float32")][0])
    bad = dict(hf, layer_types=["full_attention"] * 4)
    for fn in (jconfig_from_hf, tloader.config_from_hf):
        with pytest.raises(ValueError, match="layer_types"):
            fn(bad)
    allsl = dict(hf, layer_types=["sliding_attention"] * 4)
    _configs_equal(tloader.config_from_hf(allsl), jconfig_from_hf(allsl))
    mistral = dict(_hf(checkpoints[("llama", "float32")][0]),
                   architectures=["MistralForCausalLM"], sliding_window=48)
    assert tloader.config_from_hf(mistral).max_model_len == 48
    _configs_equal(tloader.config_from_hf(mistral),
                   jconfig_from_hf(mistral))
    qwen = dict(_hf(checkpoints[("qwen2", "float32")][0]),
                sliding_window=48, use_sliding_window=False)
    assert tloader.config_from_hf(qwen).max_model_len == 128


def test_missing_tensor_named(checkpoints, tmp_path):
    from safetensors.torch import load_file, save_file
    src = checkpoints[("llama", "float32")][0]
    dst = tmp_path / "cut"
    dst.mkdir()
    (dst / "config.json").write_text(json.dumps(_hf(src)))
    tensors = load_file(os.path.join(src, "model.safetensors"))
    tensors.pop("model.layers.1.mlp.up_proj.weight")
    save_file(tensors, str(dst / "model.safetensors"))
    with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj.weight"):
        tloader.load_model_dir(str(dst))


# -- the safetensors reader ---------------------------------------------------

ST_TORCH = {"F32": torch.float32, "F16": torch.float16,
            "BF16": torch.bfloat16, "I8": torch.int8, "U8": torch.uint8,
            "I32": torch.int32, "I64": torch.int64}
TENSORS = st.lists(st.tuples(
    st.sampled_from(sorted(ST_TORCH)),
    st.lists(st.integers(0, 5), min_size=0, max_size=3)),
    min_size=1, max_size=6)


@settings(max_examples=40, deadline=None)
@given(specs=TENSORS, shards=st.integers(1, 3), seed=st.integers(0, 99))
def test_safetensors_reader_equals_safe_open(specs, shards, seed):
    from safetensors import safe_open
    from safetensors.torch import save_file
    gen = torch.Generator().manual_seed(seed)
    with tempfile.TemporaryDirectory() as d:
        want = {}
        for i, (code, shape) in enumerate(specs):
            dt = ST_TORCH[code]
            if dt.is_floating_point:
                t = torch.randn(shape, generator=gen).to(dt)
            else:
                t = torch.randint(-100 if dt != torch.uint8 else 0, 100,
                                  shape, generator=gen).to(dt)
            want[f"t{i}"] = t
        names = sorted(want)
        for s in range(shards):
            part = {k: want[k] for k in names[s::shards]}
            if part:
                save_file(part, os.path.join(d, f"m-{s}.safetensors"),
                          metadata={"format": "pt"})
        got = tloader.read_safetensors_dir(d)
        assert sorted(got) == names
        for name in names:
            st_file, key = got[name]
            mine = st_file.tensor(key)
            f = os.path.join(d, os.path.basename(st_file.path))
            with safe_open(f, framework="pt") as ref:
                theirs = ref.get_tensor(key)
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
            assert torch.equal(mine.view(-1).view(torch.uint8)
                               if mine.numel() else mine,
                               theirs.view(-1).view(torch.uint8)
                               if theirs.numel() else theirs)


@pytest.mark.parametrize("dt,code", [(torch.float64, "F64"),
                                     (torch.bool, "BOOL")])
def test_safetensors_unsupported_dtype_named(tmp_path, dt, code):
    from safetensors.torch import save_file
    save_file({"x": torch.zeros(3, dtype=dt)}, str(tmp_path / "a.safetensors"))
    with pytest.raises(ValueError, match=f"dtype {code}"):
        tloader.read_safetensors_dir(str(tmp_path))


# -- engines on the same directory --------------------------------------------

ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
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


REQS = {
    "greedy": [("g1", list(range(10, 30)), dict(max_tokens=10)),
               ("g2", list(range(50, 90)), dict(max_tokens=7))],
    "sampled": [("s1", list(range(40, 61)), dict(
        max_tokens=10, temperature=0.8, top_k=20, seed=7)),
        ("s2", list(range(3, 20)), dict(max_tokens=9, temperature=1.1,
                                        top_p=0.9, seed=3))],
}


@pytest.mark.parametrize("name", ["llama", "qwen2"])
@pytest.mark.parametrize("mode", ["greedy", "sampled", "int8_greedy"])
def test_engine_streams_match_jax(checkpoints, name, mode):
    """f32 greedy, seeded-sampled and int8-weight greedy (int8 x sampled
    is a reference fault, ROADMAP §C)."""
    path = checkpoints[(name, "float32")][0]
    hf = dict(_hf(path), max_position_embeddings=128)
    quant = "int8" if mode.startswith("int8") else ""
    jcfg = dataclasses.replace(jconfig_from_hf(hf), dtype="float32",
                               decode_kernel="off", quant=quant)
    tcfg = dataclasses.replace(tloader.config_from_hf(hf), dtype="float32",
                               quant=quant)
    jeng = JNativeEngine(jcfg, JEngineConfig(**ENGINE_KW),
                         params=jload_params(path, jcfg))
    teng = TNativeEngine(tcfg, TEngineConfig(**ENGINE_KW),
                         params=tloader.load_params_from_hf(path, tcfg),
                         device="cpu")
    reqs = REQS["sampled" if mode == "sampled" else "greedy"]
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    assert _drive(teng, TRequest, TSamplingParams, reqs) == want
    assert all(len(v) > 3 for v in want.values())


# -- cards, chat templates, the entry point -----------------------------------

LLAMA3_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{ message['content'] | trim }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}")
CHATML_TEMPLATE = (
    "{% for message in messages %}<|im_start|>{{ message.role }}\n"
    "{{ message.content }}<|im_end|>\n{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
GEMMA_TEMPLATE = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}"
    "{{ raise_exception('System role not supported') }}{% endif %}"
    "{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}"
    "{% set role = 'model' if message['role'] == 'assistant' "
    "else message['role'] %}"
    "<start_of_turn>{{ role }}\n{{ message['content'] | trim }}"
    "<end_of_turn>\n{% endfor %}"
    "{% if add_generation_prompt %}<start_of_turn>model\n{% endif %}")
TEMPLATES = {"llama3": LLAMA3_TEMPLATE, "chatml": CHATML_TEMPLATE,
             "gemma": GEMMA_TEMPLATE}
TEMPLATE_SPECIALS = ["<|start_header_id|>", "<|end_header_id|>",
                     "<|eot_id|>", "<|im_start|>", "<|im_end|>",
                     "<start_of_turn>", "<end_of_turn>", "</s>"]


def _tokenizer_json(path, vocab_size=240):
    from tokenizers import (
        Regex, Tokenizer, decoders, models, pre_tokenizers, trainers,
    )
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(
            r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
            r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"),
            behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        ["the quick brown fox jumps over the lazy dog", "hello world",
         "serve the checkpoint, keep the streams identical"] * 10,
        trainers.BpeTrainer(vocab_size=vocab_size - len(TEMPLATE_SPECIALS),
                            special_tokens=TEMPLATE_SPECIALS,
                            initial_alphabet=pre_tokenizers.ByteLevel
                            .alphabet(), show_progress=False))
    tok.save(str(path))
    return tok.get_vocab_size()


def _write_chat_dir(root, template, dtype="float32", init=0.02, seed=1):
    """A tiny llama checkpoint with a byte-level tokenizer and a chat
    template: transformers weights, `tokenizers` tokenizer.json."""
    from transformers import LlamaConfig, LlamaForCausalLM
    root.mkdir(parents=True, exist_ok=True)
    vocab = _tokenizer_json(root / "tokenizer.json")
    torch.manual_seed(seed)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0,
        initializer_range=init, eos_token_id=7, bos_token_id=None))
    model.to(getattr(torch, dtype)).save_pretrained(root,
                                                    safe_serialization=True)
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": template}))
    return str(root)


CHATS = [
    [{"role": "user", "content": "hello world"}],
    [{"role": "system", "content": "be brief"},
     {"role": "user", "content": "  the quick\nbrown fox  "},
     {"role": "assistant", "content": "jumps"},
     {"role": "user", "content": "över the lazy dög 😀"}],
    [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}],
]


@pytest.mark.parametrize("kind", sorted(TEMPLATES))
def test_chat_templates_render_as_jax(tmp_path, kind):
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
    from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
    from dynamo_tpu.protocols.openai import ChatCompletionRequest as JChat
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor as TPre
    from dynamo_tpu_torch.protocols.openai import (
        ChatCompletionRequest as TChat,
    )
    path = _write_chat_dir(tmp_path / kind, TEMPLATES[kind])
    jcard, tcard = JCard.from_hf_dir(path), TCard.from_hf_dir(path)
    assert tcard.chat_template == jcard.chat_template == TEMPLATES[kind]
    assert (tcard.eos_token_ids, tcard.bos_token_id, tcard.context_length,
            tcard.tokenizer_kind, tcard.model_type) == (
        jcard.eos_token_ids, jcard.bos_token_id, jcard.context_length,
        jcard.tokenizer_kind, jcard.model_type)
    jpre, tpre = JPre(jcard), TPre(tcard)
    ann = {"ext": {"annotations": ["formatted_prompt", "token_ids"]}}
    for msgs in CHATS:
        body = dict(model="m", messages=msgs, max_tokens=5, **ann)
        try:
            jout = jpre.preprocess_chat(JChat(**body), "r")
        except ValueError as e:   # raise_exception in the template
            with pytest.raises(ValueError, match=str(e)):
                tpre.preprocess_chat(TChat(**body), "r")
            continue
        tout = tpre.preprocess_chat(TChat(**body), "r")
        assert tout[0].token_ids == jout[0].token_ids
        assert [a.to_json() if hasattr(a, "to_json") else a
                for a in (x.data for x in tout[1])] == [
            x.data for x in jout[1]]
        assert tout[0].eos_token_ids == jout[0].eos_token_ids


def test_card_crosses_the_model_registry(tmp_path):
    """A checkpoint card as an `in=endpoint` worker registers it
    (frontend/discovery.register_model: the card's dict in JSON) comes
    back with the same checksum, template and tokenizer."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
    path = _write_chat_dir(tmp_path / "ckpt", CHATML_TEMPLATE)
    card = TCard.from_hf_dir(path)
    back = TCard.from_dict(json.loads(json.dumps({"card": card.to_dict()}))
                           ["card"])
    assert back.mdcsum == card.mdcsum
    assert (back.hf_config, back.model_path, back.chat_template) == (
        card.hf_config, card.model_path, card.chat_template)
    assert back.model_config() == card.model_config()
    text = "serve the checkpoint <|im_end|> keep the streams identical"
    assert back.load_tokenizer().encode(text) == \
        card.load_tokenizer().encode(text)


def _batch(module, path, prompts, extra, tmp_path):
    f = tmp_path / f"{module}.jsonl"
    f.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in prompts))
    out = subprocess.run(
        [sys.executable, "-m", f"{module}.run", f"in=batch:{f}",
         "out=native", path, "--max-tokens", "8", "--num-pages", "64",
         "--max-slots", "4", *extra],
        capture_output=True, text=True, timeout=420, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]


@pytest.mark.parametrize("stored", ["bfloat16", "float16"])
def test_run_batch_process_matches_jax_run(tmp_path, stored):
    """`run.py in=batch:FILE out=native <dir>` of both packages as
    processes on one checkpoint stored in `stored` (both packages serve a
    checkpoint in bf16, whatever config.json's dtype says): the same
    outputs. The weights are drawn wider than transformers' default
    (initializer_range 0.5) so that greedy picks are decisive in bf16,
    where XLA and torch round their sums differently."""
    path = _write_chat_dir(tmp_path / "ckpt", LLAMA3_TEMPLATE, stored,
                           init=0.5)
    prompts = ["hello world", "the quick brown fox", "dög 😀 keep it"]
    want = _batch("dynamo_tpu", path, prompts, (), tmp_path)
    got = _batch("dynamo_tpu_torch", path, prompts, ("--device", "cpu"),
                 tmp_path)
    keys = ("prompt", "text", "finish_reason")
    assert [{k: r[k] for k in keys} for r in got] == [
        {k: r[k] for k in keys} for r in want]
    assert len(got) == 3 and all(r["text"] for r in got)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_served_stream_equals_transformers_generate(tmp_path):
    """tools/real_ckpt_e2e.py's checkpoint (a trained tiny Llama, an f32
    config) served by `python -m dynamo_tpu_torch.run in=http:PORT
    out=native <dir> --device cpu`: the streamed greedy completion equals
    transformers.generate on the same files."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import real_ckpt_e2e as e2e
    finally:
        sys.path.remove(str(REPO / "tools"))
    path = str(tmp_path / "real")
    e2e.build_checkpoint(path)
    want = e2e.oracle_continuation(path)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=http:{port}",
         "out=native", path, "--device", "cpu", "--num-pages", "64",
         "--max-slots", "4"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 240
        while True:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "run.py exited early"
            if line.startswith("READY"):
                model = line.split("model=")[1].strip()
                break
            assert time.monotonic() < deadline
        body = json.dumps({"model": model, "prompt": e2e.PROMPT,
                           "stream": True, "max_tokens": e2e.MAX_NEW,
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        text = []
        with urllib.request.urlopen(req, timeout=120) as resp:
            for raw in resp:
                raw = raw.decode().strip()
                if not raw.startswith("data:"):
                    continue
                payload = raw[5:].strip()
                if payload == "[DONE]":
                    break
                text.append(json.loads(payload)["choices"][0].get("text",
                                                                   ""))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert "".join(text) == want and want.strip()
