"""The gather decode (dynamo_tpu_torch/ops/attention.py, the engine's
gather window) against the JAX package's, on the same numpy-seeded inputs.

- `paged_attention`, `decode_attention_split` and
  `decode_attention_deferred` with every combination of the attention
  soft-cap, a sliding window and a query scale, on f32 and int8 pages,
  against the JAX functions within rtol = atol = 1e-5 (f32 on both sides,
  sums in other orders).
- `layer_windows` for both sliding patterns.
- The decode path each config resolves to (models/llama.decode_path), with
  its named reason.
- Engine streams with the port's gather window (decode_kernel="off")
  against the JAX engine at its default decode_kernel="auto" (its gather
  window too): greedy and seeded-sampled in f32, greedy with int8 pages
  (both windows keep in-window rows in full precision and quantize them
  at the window's end), and tiny-moe greedy; token-identical. The port's
  per-token deferred gather (`pregather = False`) gives the window's
  streams too. Seeded sampling on int8 pages is left out: the JAX
  package's own seeded int8 test fails (ROADMAP.md §C).
"""
import dataclasses

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
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)

TOL = 1e-5
B, H, HKV, HD, P, PS, PB = 3, 4, 2, 16, 12, 4, 3
KNOBS = [dict(softcap=sc, window=w, q_scale=qs)
         for sc in (0.0, 2.0) for w in (None, 3) for qs in (0.0, 0.4)]


def _knob_id(k):
    return f"cap{k['softcap']}-win{k['window']}-qs{k['q_scale']}"


def _cache(rng, quant: bool):
    """(numpy k, v, k_scale, v_scale): f32 pages, or int8 pages with
    positive f32 row scales."""
    shape = (HKV, P, PS, HD)
    if not quant:
        return (rng.normal(size=shape).astype(np.float32),
                rng.normal(size=shape).astype(np.float32), None, None)
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32),
            rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32))


def _pair(a):
    """(jax array, torch tensor) of a numpy array, or (None, None)."""
    if a is None:
        return None, None
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _window(k):
    w = k["window"]
    return dict(k, window=None if w is None else jnp.int32(w)), k


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("knobs", KNOBS, ids=_knob_id)
def test_paged_attention_knobs(knobs, quant):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, 4, H, HD)).astype(np.float32)
    k, v, ks, vs = _cache(rng, quant)
    pt = rng.permutation(P)[:B * PB].reshape(B, PB).astype(np.int32)
    lens = np.array([12, 7, 0], np.int32)
    qpos = np.stack([np.arange(8, 12), np.arange(3, 7),
                     np.zeros(4, int)]).astype(np.int32)
    jk, tk = _window(knobs)
    (jq, tq), (jkc, tkc), (jvc, tvc) = _pair(q), _pair(k), _pair(v)
    (jks, tks), (jvs, tvs) = _pair(ks), _pair(vs)
    want = jatt.paged_attention(jq, jkc, jvc, jnp.asarray(pt),
                                jnp.asarray(lens), jnp.asarray(qpos),
                                k_scale=jks, v_scale=jvs, **jk)
    got = tatt.paged_attention(tq, tkc, tvc, torch.from_numpy(pt),
                               torch.from_numpy(lens), torch.from_numpy(qpos),
                               tks, tvs, **tk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("knobs", KNOBS, ids=_knob_id)
def test_decode_attention_deferred_knobs(knobs, quant):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    k, v, ks, vs = _cache(rng, quant)
    kn = rng.normal(size=(B, HKV, HD)).astype(np.float32)
    vn = rng.normal(size=(B, HKV, HD)).astype(np.float32)
    pt = rng.permutation(P)[:B * PB].reshape(B, PB).astype(np.int32)
    prefix = np.array([11, 0, 5], np.int32)
    jk, tk = _window(knobs)
    (jq, tq), (jkc, tkc), (jvc, tvc) = _pair(q), _pair(k), _pair(v)
    (jks, tks), (jvs, tvs) = _pair(ks), _pair(vs)
    (jkn, tkn), (jvn, tvn) = _pair(kn), _pair(vn)
    want = jatt.decode_attention_deferred(
        jq, jkc, jvc, jkn, jvn, jnp.asarray(pt), jnp.asarray(prefix),
        k_scale=jks, v_scale=jvs, **jk)
    got = tatt.decode_attention_deferred(
        tq, tkc, tvc, tkn, tvn, torch.from_numpy(pt),
        torch.from_numpy(prefix), k_scale=tks, v_scale=tvs, **tk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("knobs", KNOBS, ids=_knob_id)
def test_decode_attention_split_knobs(knobs):
    """Base + window buffer + self-term; the base's K rows and the window's
    rows past their lengths hold NaN (recycled pages, last window's
    leftovers), the base's V rows there zeros (the engine's base gather
    zeroes them: test_gather_base_zeroes_stale_values)."""
    rng = np.random.default_rng(3)
    lb, nw = 10, 4
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    kb, vb = (rng.normal(size=(HKV, B, lb, HD)).astype(np.float32)
              for _ in range(2))
    kw, vw = (rng.normal(size=(HKV, B, nw, HD)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(B, HKV, HD)).astype(np.float32)
              for _ in range(2))
    base_lens = np.array([10, 3, 0], np.int32)
    win_lens = np.array([2, 4, 0], np.int32)
    for buf, lens, stale in ((kb, base_lens, np.nan), (vb, base_lens, 0.0),
                             (kw, win_lens, np.nan), (vw, win_lens, np.nan)):
        for i, n in enumerate(lens):
            buf[:, i, n:] = stale
    jk, tk = _window(knobs)
    args = [_pair(a) for a in (q, kb, vb, kw, vw, kn, vn, base_lens,
                               win_lens)]
    want = jatt.decode_attention_split(*(a[0] for a in args), **jk)
    got = tatt.decode_attention_split(*(a[1] for a in args), **tk)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("pattern", ["alternate", "all"])
def test_layer_windows(pattern):
    for window in (0, 4096):
        kw = dict(num_layers=5, sliding_window=window,
                  sliding_pattern=pattern)
        assert (TModelConfig(**kw).layer_windows()
                == JModelConfig(**kw).layer_windows())
    assert TModelConfig(**kw).layer_windows() == (
        [4096] * 5 if pattern == "all" else [4096, 1 << 30] * 2 + [4096])


@pytest.mark.parametrize("cfg,path,reason", [
    (dict(), "ragged", "decode_kernel='auto'"),
    (dict(decode_kernel="on"), "ragged", "decode_kernel='on'"),
    (dict(decode_kernel="interpret"), "ragged", "decode_kernel='interpret'"),
    (dict(decode_kernel="off"), "gather", "decode_kernel='off'"),
    (dict(attn_softcap=50.0), "gather", "attn_softcap set"),
    (dict(sliding_window=8, decode_kernel="on"), "gather",
     "sliding_window set"),
    (dict(query_scale=0.2), "gather", "query_scale set"),
    (dict(attn_softcap=50.0, sliding_window=8, query_scale=0.2), "gather",
     "attn_softcap, sliding_window, query_scale set"),
    (dict(head_dim=80, num_heads=4, num_kv_heads=2), "gather",
     "head_dim 80"),
    (dict(num_heads=32, num_kv_heads=1), "gather", "GQA group 32"),
    (dict(head_dim=96, num_heads=32, num_kv_heads=32), "ragged",
     "decode_kernel='auto'"),
    (dict(head_dim=256, num_heads=16, num_kv_heads=1), "ragged",
     "decode_kernel='auto'"),
])
def test_decode_path_resolution(cfg, path, reason):
    got = tllama.decode_path(TModelConfig(**cfg))
    assert got[0] == path and reason in got[1]


# -- engine streams ------------------------------------------------------------

ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
EOS = {2}
REQS = [("a", list(range(10, 30)), dict(max_tokens=14)),
        ("b", list(range(50, 95)), dict(max_tokens=11)),
        ("c", list(range(3, 12)), dict(max_tokens=17))]
SAMPLED = [("s1", list(range(40, 61)), dict(max_tokens=12, temperature=0.8,
                                            top_k=20, seed=7)),
           ("s2", list(range(3, 40)), dict(max_tokens=10, temperature=1.1,
                                           top_p=0.9, seed=3)),
           ("s3", list(range(90, 101)), dict(max_tokens=9, seed=11,
                                             temperature=0.7))]


def _drive(eng, request_cls, params_cls, reqs):
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


def _streams(model: str, reqs, kv_quant: str = "", pregather: bool = True):
    """(JAX engine streams at decode_kernel="auto", the port's at "off",
    the port engine)."""
    jcfg = dataclasses.replace(
        JModelConfig(dtype="float32", max_model_len=512), name=model,
        **({"num_experts": 4, "num_experts_per_tok": 2}
           if model == "tiny-moe" else {}))
    tcfg = TModelConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})
    tcfg = dataclasses.replace(tcfg, decode_kernel="off")
    ekw = dict(ENGINE_KW, kv_quant=kv_quant)
    jeng = JNativeEngine(jcfg, JEngineConfig(**ekw), eos_token_ids=EOS,
                         seed=0)
    teng = TNativeEngine(tcfg, TEngineConfig(**ekw), eos_token_ids=EOS,
                         params=tllama.params_from_jax(
                             jax.device_get(jeng.params), tcfg, "cpu"),
                         device="cpu")
    teng.pregather = pregather
    return (_drive(jeng, JRequest, JSamplingParams, reqs),
            _drive(teng, TRequest, TSamplingParams, reqs), teng)


@pytest.mark.parametrize("case", ["greedy", "sampled", "int8-greedy",
                                  "moe-greedy", "deferred-greedy"])
def test_gather_window_streams_match_jax(case):
    model = "tiny-moe" if case == "moe-greedy" else "tiny"
    reqs = SAMPLED if case == "sampled" else REQS
    want, got, teng = _streams(
        model, reqs, kv_quant="int8" if case == "int8-greedy" else "",
        pregather=case != "deferred-greedy")
    assert got == want
    assert sum(map(len, got.values())) > 3 * len(reqs)
    m = teng.metrics()
    assert (m.decode_path, m.decode_path_reason) == (
        "gather", "decode_kernel='off'")
    assert m.decode_windows > 0 and m.decode_kernel_tag.startswith("gather")


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_gather_base_zeroes_stale_values(quant):
    """The window's base gather: every gathered K row as its page holds it
    (dequantized for int8), V rows before each slot's base length as well,
    V rows at or past it zero even where the recycled page holds NaN."""
    from dynamo_tpu_torch.engine.engine import _gather_base
    from dynamo_tpu_torch.ops.kv_quant import dequantize_rows
    rng = np.random.default_rng(9)
    L, S, PB_ = 2, 3, 2
    shape = (L, HKV, P, PS, HD)
    vals = {k: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for k in ("k", "v")}
    table = torch.from_numpy(rng.permutation(P)[:S * PB_].reshape(
        S, PB_).astype(np.int32))
    base_len = torch.tensor([5, 0, 8], dtype=torch.int32)
    if quant:
        cache = {}
        for k in ("k", "v"):
            q, sc = tatt.quantize_rows(vals[k])
            cache[k], cache[f"{k}_scale"] = q, sc
        cache["v_scale"].view(L, HKV, P * PS)[
            :, :, table[0, 1] * PS + 2] = float("nan")
        pages = {k: dequantize_rows(cache[k], cache[f"{k}_scale"],
                                    torch.float32) for k in ("k", "v")}
    else:
        cache = vals
        cache["v"][:, :, table[0, 1], 2] = float("nan")
        pages = cache
    kb = torch.empty((L, HKV, S, PB_ * PS, HD))
    vb = torch.full_like(kb, 7.0)
    _gather_base(cache, table, kb, vb, base_len)
    for s in range(S):
        want_k = pages["k"][:, :, table[s].long()].reshape(L, HKV, -1, HD)
        want_v = pages["v"][:, :, table[s].long()].reshape(L, HKV, -1, HD)
        n = int(base_len[s])
        assert torch.equal(kb[:, :, s], want_k)
        assert torch.equal(vb[:, :, s, :n], want_v[:, :, :n])
        assert bool((vb[:, :, s, n:] == 0).all())
