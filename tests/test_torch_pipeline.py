"""The port's decode loop as the JAX engine serves it: the device-carried
window, the staged plan reused with zero uploads, and the two-deep
pipeline (tests/test_decode_pipeline.py's bar, held against the JAX engine).

Streams must be TOKEN-IDENTICAL between the port at pipeline_depth=2, the
port at depth 1 and the JAX engine at depth 2, on the `tiny` config in
float32 with the JAX weights carried over by `params_from_jax`: greedy and
seeded-sampled, a stop id and an eos sampled mid-window (both force the
reconciliation fallback), and an abort while a window is in flight. Steady
state makes one host sync per window and no plan uploads after the first.
After a window in which one slot samples eos and another a stop id, the
port's cache equals the JAX kernel-mode window's (its Pallas kernel in
interpret mode) within rtol = atol = 1e-5 for f32 pages and 1e-6 for int8
pages.

On the CPU the window runs eagerly (window_graph.WindowGraphs calls the
program directly), the same function the card captures as a graph.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jengine
from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu_torch.engine import engine as tengine
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.sampler import eos_mask
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.engine.window_graph import HostCopies
from dynamo_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
# tests/test_decode_pipeline.py's geometry: windows of 4, one 64-token page
# holds a whole request
ENGINE_KW = dict(page_size=64, num_pages=32, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512, decode_steps=4)
PROMPT = list(range(10, 26))
COUNTERS = ("decode_windows", "pipeline_windows", "pipeline_overlapped",
            "pipeline_fallbacks", "decode_host_syncs", "decode_dispatches",
            "decode_plan_uploads")


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def _port(jax_params, depth, eos=None):
    return TNativeEngine(TCFG, TEngineConfig(pipeline_depth=depth,
                                             **ENGINE_KW),
                         eos_token_ids=eos, device="cpu",
                         params=tllama.params_from_jax(jax_params, TCFG))


@pytest.fixture(scope="module")
def ref(jax_params):
    """PROMPT's greedy stream with no eos, and a token that first appears
    inside the second decode window (ref[0] is the prefill's token, windows
    of 4): the eos / stop id the mid-window tests use."""
    out = _port(jax_params, 1).generate(
        PROMPT, TSamplingParams(max_tokens=12, ignore_eos=True), "probe")
    i = next(i for i in range(6, 9) if out[i] not in out[:i])
    return out, i


@pytest.fixture(scope="module")
def engines(jax_params, ref):
    """(port depth 1, port depth 2, JAX depth 2), all with eos = the mid-
    window token of `ref`, reused across tests (counters diff a snapshot)."""
    eos = {ref[0][ref[1]]}
    jeng = JNativeEngine(JCFG, JEngineConfig(pipeline_depth=2, **ENGINE_KW),
                         eos_token_ids=eos, seed=0)
    return _port(jax_params, 1, eos), _port(jax_params, 2, eos), jeng


def snap(eng):
    return {k: getattr(eng, k) for k in COUNTERS}


def delta(eng, before):
    return {k: getattr(eng, k) - v for k, v in before.items()}


def drive(eng, reqs, tag):
    """Add every request up front, step until all finish; token streams."""
    got = {}
    for i, (prompt, kw) in enumerate(reqs):
        cls_r, cls_p = ((JRequest, JSamplingParams)
                        if isinstance(eng, JNativeEngine)
                        else (TRequest, TSamplingParams))
        eng.add_request(cls_r(f"{tag}{i}", list(prompt), cls_p(**kw)))
        got[f"{tag}{i}"] = []
    done = set()
    while len(done) < len(reqs):
        for ev in eng.step():
            if ev.token is not None:
                got[ev.request_id].append(ev.token)
            if ev.finished:
                done.add(ev.request_id)
    return [got[f"{tag}{i}"] for i in range(len(reqs))]


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_pipelined_token_identical(engines, mode):
    """Depth 2 == depth 1 == the JAX engine at depth 2, with concurrent
    requests of different budgets (mid-window finishes exercise the
    fallback)."""
    sync, pipe, jeng = engines
    prompts = [list(range(3, 19)), list(range(40, 50))]
    if mode == "greedy":
        kws = [dict(max_tokens=13, ignore_eos=True),
               dict(max_tokens=6, ignore_eos=True)]
    else:
        kws = [dict(max_tokens=9, temperature=0.9, top_k=12, seed=7,
                    ignore_eos=True),
               dict(max_tokens=9, temperature=0.7, top_p=0.8, seed=3,
                    ignore_eos=True)]
    reqs = list(zip(prompts, kws))
    before = snap(pipe)
    want = drive(sync, reqs, f"id_{mode}_s")
    assert drive(pipe, reqs, f"id_{mode}_p") == want
    assert drive(jeng, reqs, f"id_{mode}_j") == want
    d = delta(pipe, before)
    assert d["pipeline_windows"] > 0 and d["pipeline_overlapped"] > 0


@pytest.mark.parametrize("how", ["stop_id", "eos"])
def test_stop_mid_window_fallback_token_identical(engines, ref, how):
    """A hidden stop id, or an eos, sampled mid-window changes slot
    membership at commit: the in-flight follow-up is discarded (fallback)
    and the stream still equals the synchronous loop's and JAX's."""
    sync, pipe, jeng = engines
    out, i = ref
    if how == "stop_id":
        kw = dict(max_tokens=12, ignore_eos=True, stop_token_ids=(out[i],))
    else:
        kw = dict(max_tokens=12)
    before = snap(pipe)
    got = {name: eng.generate(PROMPT, cls(**kw), f"{how}_{name}")
           for name, eng, cls in (("s", sync, TSamplingParams),
                                  ("p", pipe, TSamplingParams),
                                  ("j", jeng, JSamplingParams))}
    assert got["p"] == got["s"] == got["j"] == out[:i]
    assert delta(pipe, before)["pipeline_fallbacks"] >= 1


def test_abort_mid_window_drops_cleanly(engines):
    """Aborting a request while its window is in flight drops its tokens
    without touching the survivor's stream or the allocator."""
    sync, eng, _ = engines
    p = TSamplingParams(max_tokens=24, ignore_eos=True)
    prompts = [list(range(3, 19)), list(range(40, 50))]
    solo = sync.generate(prompts[0], p, "ab_solo")
    for i, pr in enumerate(prompts):
        eng.add_request(TRequest(f"ab{i}", pr, p))
    got = {"ab0": [], "ab1": []}
    aborted = False
    finished = set()
    while eng.has_work():
        if eng._pipeline is not None and not aborted \
                and len(got["ab1"]) >= 2:
            assert eng.abort("ab1")
            aborted = True
        for ev in eng.step():
            got[ev.request_id].append(ev.token)
            if ev.finished:
                finished.add(ev.request_id)
    assert aborted
    assert "ab0" in finished and "ab1" not in finished
    assert [t for t in got["ab0"] if t is not None] == solo
    assert eng.scheduler.allocator.num_free == eng.cfg.num_pages


def test_steady_state_one_sync_per_window_zero_uploads(engines,
                                                       monkeypatch):
    """A stable slot set whose pages are all allocated at its first decode
    plan: one blocking host sync per window (counted at the fetch), every
    dispatched window committed, and plan arrays staged exactly once."""
    _, eng, _ = engines
    p = TSamplingParams(max_tokens=32, ignore_eos=True)
    eng.add_request(TRequest("micro", list(range(10, 30)), p))
    while eng.scheduler.waiting:
        eng.step()
    before = snap(eng)
    waits = {"n": 0}
    real_wait = HostCopies.wait

    def counting_wait(handle):
        waits["n"] += 1
        return real_wait(handle)

    monkeypatch.setattr(HostCopies, "wait", staticmethod(counting_wait))
    while eng.has_work():
        eng.step()
    d = delta(eng, before)
    assert d["pipeline_windows"] == 32 // eng.cfg.decode_steps
    assert waits["n"] == d["decode_host_syncs"] == d["pipeline_windows"]
    assert d["decode_host_syncs"] == d["decode_dispatches"] \
        == d["decode_windows"]
    assert d["pipeline_fallbacks"] == 0
    # prompt (20) + max_tokens (32) fit one 64-token page: only the FIRST
    # window staged host arrays
    assert d["decode_plan_uploads"] == 1
    assert d["pipeline_overlapped"] >= d["pipeline_windows"] - 2


def test_pipeline_counters_on_metrics(engines):
    _, eng, _ = engines
    m0 = eng.metrics()
    eng.generate(list(range(5, 21)), TSamplingParams(max_tokens=16,
                                                     ignore_eos=True),
                 "metrics")
    m1 = eng.metrics()
    for name in COUNTERS:
        if name != "pipeline_fallbacks":
            assert getattr(m1, name) > getattr(m0, name), name
    assert m1.decode_dispatches == eng.decode_dispatches
    assert m1.pipeline_fallbacks == eng.pipeline_fallbacks


def test_depth_one_is_fully_synchronous(engines):
    sync, _, _ = engines
    before = snap(sync)
    out = sync.generate(list(range(5, 21)),
                        TSamplingParams(max_tokens=8, ignore_eos=True), "d1")
    assert len(out) == 8
    assert sync._pipeline is None
    d = delta(sync, before)
    assert d["pipeline_windows"] == d["pipeline_overlapped"] == 0
    assert d["decode_host_syncs"] == d["decode_windows"] \
        == d["decode_dispatches"] > 0


# -- the window itself against the JAX kernel-mode window -----------------------

S, P, PS, NW = 3, 12, 8, 4


def _window_inputs(seed: int, kv_quant: str):
    """A random cache of P pages (the port's has one more, its scratch
    page) and three slots mid-decode: distinct pages, prefixes of 13 / 20 /
    5 tokens, room for a whole window."""
    rng = np.random.default_rng(seed)
    shape = (TCFG.num_layers, TCFG.num_kv_heads, P, PS, TCFG.head_dim)
    if kv_quant:
        cache = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "k_scale": rng.uniform(0.001, 0.02, shape[:-1]).astype(
                     np.float32),
                 "v_scale": rng.uniform(0.001, 0.02, shape[:-1]).astype(
                     np.float32)}
    else:
        cache = {"k": rng.normal(size=shape).astype(np.float32),
                 "v": rng.normal(size=shape).astype(np.float32)}
    arrs = dict(
        tokens=np.array([7, 99, 150], np.int32),
        positions=np.array([13, 20, 5], np.int32),
        page_table=np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]],
                            np.int32),
        max_pos=np.array([30, 30, 30], np.int32),
        counters=np.array([1, 4, 2], np.int32),
        min_tokens=np.zeros(S, np.int32),
        temperature=np.zeros(S, np.float32), top_k=np.zeros(S, np.int32),
        top_p=np.ones(S, np.float32), seeds=np.zeros(S, np.int32),
        ignore_eos=np.array([False, True, True]))
    return cache, arrs


def _run_port(params, cfg, cache, arrs, eos, stop_ids):
    t = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    tcache = {k: torch.cat([torch.from_numpy(v.copy()),
                            torch.zeros_like(torch.from_numpy(v[:, :, :1]))],
                           dim=2) for k, v in cache.items()}
    toks, _, _, _, _, carry = tengine._engine_decode_window(
        cfg, eos_mask(eos, cfg.vocab_size, "cpu"), params, tcache,
        t["tokens"], t["positions"], t["counters"], t["page_table"],
        t["max_pos"], t["temperature"], t["top_k"], t["top_p"], t["seeds"],
        t["min_tokens"], t["ignore_eos"], torch.from_numpy(stop_ids),
        n_steps=NW, page_size=PS, greedy=True)
    return (toks.numpy(), [c.numpy() for c in carry],
            {k: v[:, :, :P].numpy() for k, v in tcache.items()})


def _run_jax(params, cfg, cache, arrs, eos, stop_ids):
    a = {k: jnp.asarray(v) for k, v in arrs.items()}
    toks, _, _, _, jcache, _, carry = jengine._engine_decode_window(
        cfg, tuple(sorted(eos)), None, NW, PS, False, False, True, False,
        params, {k: jnp.asarray(v) for k, v in cache.items()}, a["tokens"],
        a["positions"], a["page_table"], a["page_table"], a["max_pos"],
        a["temperature"], a["top_k"], a["top_p"], a["seeds"], a["counters"],
        a["min_tokens"], ignore_eos=a["ignore_eos"],
        stop_ids=jnp.asarray(stop_ids))
    return (np.asarray(toks), [np.asarray(c) for c in carry],
            {k: np.asarray(v) for k, v in jcache.items()})


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_window_after_eos_and_stop_matches_jax_kernel_window(jax_params,
                                                             kv_quant):
    """Slot 0 samples an eos at step 1 (ignore_eos off), slot 1 a hidden
    stop id at step 2, slot 2 runs on: tokens, final carry and the whole
    cache equal the JAX kernel-mode window's (Pallas kernel in interpret
    mode) within rtol = atol = 1e-5 for f32 pages and 1e-6 for int8 pages,
    and the dead slots wrote no KV after dying."""
    jcfg = dataclasses.replace(JCFG, decode_kernel="interpret",
                               kv_quant=kv_quant)
    tcfg = dataclasses.replace(TCFG, kv_quant=kv_quant)
    tparams = tllama.params_from_jax(jax_params, tcfg)
    cache, arrs = _window_inputs(11, kv_quant)
    none = np.full((S, 0), -1, np.int32)
    free, _, _ = _run_port(tparams, tcfg, cache, arrs, set(), none)
    eos = {int(free[1, 0])}
    stop_ids = np.full((S, 8), -1, np.int32)
    stop_ids[1, 0] = free[2, 1]
    assert free[1, 0] not in free[:1, 0] and free[2, 1] not in free[:2, 1]
    got = _run_port(tparams, tcfg, cache, arrs, eos, stop_ids)
    want = _run_jax(jax_params, jcfg, cache, arrs, eos, stop_ids)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][:2], free[:2])   # same up to death
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    for key in cache:
        # f32 rows of the second layer carry the first layer's summation-
        # order differences (up to 1.9e-6 here): 1e-5, the decode-step rows'
        # tolerance in tests/test_torch_kv_quant.py. int8 pages: the codec
        # is bit-identical, so the bytes are equal and the scales within 1e-6
        tol = 1e-6 if kv_quant else 1e-5
        np.testing.assert_allclose(got[2][key], want[2][key], rtol=tol,
                                   atol=tol, err_msg=key)
    # a dead slot's rows after its last live step are the cache's old rows
    for slot, last in ((0, 1), (1, 2)):
        for t in range(last + 1, NW):
            pos = arrs["positions"][slot] + t
            page = arrs["page_table"][slot, pos // PS]
            for key in cache:
                np.testing.assert_array_equal(
                    got[2][key][:, :, page, pos % PS],
                    cache[key][:, :, page, pos % PS])
