"""Gemma-2 serving in the port (dynamo_tpu_torch) against the JAX package,
on the same numpy-seeded weights, in float32.

A tiny Gemma-2 config (post norms, the final and the attention soft-cap,
the query scale, a sliding window on alternating or all layers) through:

- `forward` (a prefill chunk, then a single-token step) and
  `decode_forward` in both gather forms (the per-token deferred gather,
  and the window's split view of a base and an in-window buffer whose rows
  past their lengths hold NaN, the base's V zeros) against the JAX
  functions, within rtol = atol = 1e-5 (f32 on both sides, sums in other
  orders);
- engines: the port at its default decode_kernel="auto", which resolves
  to the gather window for these knobs, against the JAX engine at its
  default (the gather window), greedy and seeded-sampled in f32 and greedy
  with int8 KV pages, with prompts and windows that cross the sliding
  window: token-identical;
- `run.py in=batch` of both packages as processes on one tiny Gemma-2
  checkpoint directory with a tokenizer and Gemma's chat template, served
  in bf16 as both packages serve a checkpoint: the same texts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

TOL = 1e-5
P, PS = 12, 8
GEMMA2 = dict(dtype="float32", max_model_len=256, vocab_size=192,
              hidden_size=64, intermediate_size=96, num_layers=3,
              num_heads=4, num_kv_heads=2, head_dim=16,
              embed_scale=64 ** 0.5, norm_plus_one=True,
              mlp_act="gelu_tanh", tie_word_embeddings=True,
              post_norms=True, final_softcap=3.0, attn_softcap=5.0,
              query_scale=32 ** -0.5, sliding_window=6)


def _configs(pattern="alternate"):
    return (JModelConfig(**GEMMA2, sliding_pattern=pattern),
            TModelConfig(**GEMMA2, sliding_pattern=pattern))


def _params(jcfg, tcfg, seed=0):
    """JAX init with the norms redrawn around their init, so every knob
    moves the output: (JAX tree, port tree) of the same values."""
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    layers = {k: (rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
                  if k.endswith("norm") else v)
              for k, v in tree["layers"].items()}
    tree = dict(tree, layers=layers, final_norm=rng.uniform(
        -0.5, 0.5, tree["final_norm"].shape).astype(np.float32))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tllama.params_from_jax(tree, tcfg, "cpu"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _meta(tokens, start, pages):
    n = len(tokens)
    pos = np.arange(start, start + n, dtype=np.int32)[None]
    pt = np.asarray([pages], np.int32)
    widx = np.asarray([[pages[p // PS] * PS + p % PS for p in pos[0]]],
                      np.int32)
    lens = np.asarray([start + n], np.int32)
    return (jllama.AttnMetadata(jnp.asarray(pos), jnp.asarray(pt),
                                jnp.asarray(lens), jnp.asarray(widx)),
            tllama.AttnMetadata(torch.from_numpy(pos), torch.from_numpy(pt),
                                torch.from_numpy(lens),
                                torch.from_numpy(widx)))


@pytest.mark.parametrize("pattern", ["alternate", "all"])
def test_forward_and_decode_match_jax(pattern):
    """A 19-token prompt (past the 6-token window) through forward, its
    last token through forward at Tq == 1 and through the deferred-gather
    decode step: logits and new kv rows within 1e-5 of JAX."""
    jcfg, tcfg = _configs(pattern)
    jp, tp = _params(jcfg, tcfg)
    assert tllama.decode_path(tcfg)[0] == "gather"
    jcache = jllama.init_cache(jcfg, P, PS)
    tcache = tllama.init_cache(tcfg, P + 1, PS, "cpu")
    prompt = np.random.default_rng(1).integers(
        1, GEMMA2["vocab_size"], 20).astype(np.int32)
    pages = [3, 5, 9]
    jm, tm = _meta(prompt[:-1], 0, pages)
    jlog, jcache = jllama.forward(jp, jcfg, jnp.asarray(prompt[:-1])[None],
                                  jcache, jm)
    tlog, tcache = tllama.forward(tp, tcfg, torch.from_numpy(
        prompt[:-1].copy())[None], tcache, tm)
    _close(tlog[0], jlog[0])
    for key in ("k", "v"):
        _close(tcache[key][:, :, :P], jcache[key])
    jm, tm = _meta(prompt[-1:], len(prompt) - 1, pages)
    jl1, _ = jllama.forward(jp, jcfg, jnp.asarray(prompt[-1:])[None],
                            dict(jcache), jm)
    tl1, _ = tllama.forward(tp, tcfg, torch.from_numpy(
        prompt[-1:].copy())[None], {k: v.clone() for k, v in
                                    tcache.items()}, tm)
    _close(tl1[0], jl1[0])
    tok = np.asarray([prompt[-1], 0], np.int32)
    pt = np.asarray([pages, [0, 0, 0]], np.int32)
    prefix = np.asarray([len(prompt) - 1, 0], np.int32)
    jout = jllama.decode_forward(
        jp, jcfg, jnp.asarray(tok), jcache, jnp.asarray(pt),
        jnp.asarray(prefix), jnp.asarray(prefix))
    tout = tllama.decode_forward(
        tp, tcfg, torch.from_numpy(tok), tcache, torch.from_numpy(pt),
        torch.from_numpy(prefix), torch.from_numpy(prefix), path="gather")
    for got, want in zip(tout, jout[:3]):
        _close(got, want)
    _close(tout[0][0], tl1[0, 0])


@pytest.mark.parametrize("pattern", ["alternate", "all"])
def test_decode_forward_window_matches_jax(pattern):
    """The split view: a base of 16 rows and a 4-row window buffer per slot
    (NaN past their lengths, the base's V zeros there, as the engine's
    base gather leaves them), three slots at different base / window
    lengths, one empty."""
    jcfg, tcfg = _configs(pattern)
    jp, tp = _params(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(5)
    L, hkv, hd, s, lb, nw = 3, 2, 16, 3, 16, 4
    kb, vb = (rng.normal(size=(L, hkv, s, lb, hd)).astype(np.float32)
              for _ in range(2))
    kw, vw = (rng.normal(size=(L, hkv, s, nw, hd)).astype(np.float32)
              for _ in range(2))
    base_lens = np.asarray([14, 5, 0], np.int32)
    win_lens = np.asarray([3, 1, 0], np.int32)
    for buf, lens, stale in ((kb, base_lens, np.nan), (vb, base_lens, 0.0),
                             (kw, win_lens, np.nan), (vw, win_lens, np.nan)):
        for i, n in enumerate(lens):
            buf[:, :, i, n:] = stale
    tok = np.asarray([7, 19, 0], np.int32)
    pos = base_lens + win_lens
    pt = np.zeros((s, 2), np.int32)
    window = (kb, vb, kw, vw, base_lens, win_lens)
    jout = jllama.decode_forward(
        jp, jcfg, jnp.asarray(tok), jllama.init_cache(jcfg, P, PS),
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(pos),
        window=tuple(jnp.asarray(a) for a in window))
    tout = tllama.decode_forward(
        tp, tcfg, torch.from_numpy(tok),
        tllama.init_cache(tcfg, P + 1, PS, "cpu"), torch.from_numpy(pt),
        torch.from_numpy(pos), torch.from_numpy(pos),
        window=tuple(torch.from_numpy(a) for a in window), path="gather")
    for got, want in zip(tout, jout[:3]):
        assert np.isfinite(got.numpy()).all()
        _close(got, want)


ENGINE_KW = dict(page_size=8, num_pages=48, max_slots=4,
                 max_prefill_chunk=16, prefill_buckets=(8, 16),
                 max_model_len=256)
REQS = [("a", list(range(10, 33)), dict(max_tokens=14)),
        ("b", list(range(50, 61)), dict(max_tokens=19)),
        ("c", list(range(3, 40)), dict(max_tokens=9))]
SAMPLED = [(rid, p, dict(kw, temperature=0.9, top_k=30, seed=5 + i))
           for i, (rid, p, kw) in enumerate(REQS)]


def _drive(eng, request_cls, params_cls, reqs):
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


@pytest.mark.parametrize("case", ["greedy", "sampled", "int8-greedy"])
def test_engine_streams_match_jax(case):
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    ekw = dict(ENGINE_KW, kv_quant="int8" if case == "int8-greedy" else "")
    jeng = JNativeEngine(jcfg, JEngineConfig(**ekw), params=jp)
    teng = TNativeEngine(tcfg, TEngineConfig(**ekw), params=tp, device="cpu")
    assert (teng.decode_path, teng.pregather) == ("gather", True)
    assert "sliding_window" in teng.decode_path_reason
    reqs = SAMPLED if case == "sampled" else REQS
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    assert _drive(teng, TRequest, TSamplingParams, reqs) == want
    assert all(len(v) >= 9 for v in want.values())
    m = teng.metrics()
    assert m.decode_windows > 0 and m.decode_kernel_tag.startswith("gather")


def test_run_batch_process_matches_jax_run(tmp_path):
    """`run.py in=batch:FILE out=native <dir>` of both packages on a tiny
    Gemma-2 checkpoint (4 layers, a 6-token window, both soft-caps, the
    query scale) with a byte-level tokenizer and Gemma's chat template:
    the same texts. Weights drawn wide (initializer_range 0.5) so greedy
    picks are decisive in bf16, where XLA and torch round their sums
    differently."""
    import json

    from test_torch_loader import GEMMA_TEMPLATE, _batch, _tokenizer_json
    from transformers import Gemma2Config, Gemma2ForCausalLM
    root = tmp_path / "gemma2"
    root.mkdir()
    vocab = _tokenizer_json(root / "tokenizer.json")
    torch.manual_seed(1)
    model = Gemma2ForCausalLM(Gemma2Config(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, rope_theta=10000.0,
        query_pre_attn_scalar=32, sliding_window=6,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        initializer_range=0.5, eos_token_id=7, bos_token_id=None,
        pad_token_id=0))
    model.save_pretrained(root, safe_serialization=True)
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": GEMMA_TEMPLATE}))
    prompts = ["hello world, the quick brown fox", "the lazy dog",
               "serve the checkpoint, keep the streams identical"]
    want = _batch("dynamo_tpu", str(root), prompts, (), tmp_path)
    got = _batch("dynamo_tpu_torch", str(root), prompts, ("--device", "cpu"),
                 tmp_path)
    keys = ("prompt", "text", "finish_reason")
    assert [{k: r[k] for k in keys} for r in got] == [
        {k: r[k] for k in keys} for r in want]
    assert len(got) == 3 and all(r["text"] for r in got)
