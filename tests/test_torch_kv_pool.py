"""The port's shared KV pool (dynamo_tpu_torch/engine/kv_pool.py, the engine's
pool hooks and the frontend's prefetcher) against the JAX package's
(tests/test_kv_pool.py's engine-level cases, :83-289, held to the
reference).

On the `tiny` config in float32 with the JAX weights carried over by
`params_from_jax` (the JAX engine on its plain attention path), page 8,
num_pages 16-32, on the CPU: a throwaway engine A seeds a pool with a
prompt's pages, engine B serves the prompt from the pool. Compared with the
JAX engines doing the same: streams token for token (greedy and
seeded-sampled), the pages fetched, the scheduler's pool-inject decisions
(page id, page) step for step, every `POOL_STATS` counter, and the pool's
bytes per page (f32 within 1e-5 rtol and atol; int8 values byte-equal, f32
scales within 1e-6), pages keyed by their token prefix (the packages hash
pages differently). Also: rot quarantined, a cross-kv_quant fetch rejected
by name, int8 dedup, prefetch racing a cancel, the prefetch window outcome,
the admission prefetcher, source eviction, per-source removed events, and
the HTTP service with a prefetcher rendering `llm_kv_pool_*` under the JAX
names and values.

The selector and router cases (:338-439) wait for the router's pool
sources; the seeded mid-fetch death (:131-156) waits for the port's
`runtime/faults.py`.
"""
import asyncio
import re

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_pool as jkv_pool
from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.kv_cache import page_hash as jpage_hash
from dynamo_tpu.engine.scheduler import SamplingParams as JSamplingParams
from dynamo_tpu.runtime.integrity import STATS as JINTEGRITY
from dynamo_tpu_torch.engine import kv_pool as tkv_pool
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.kv_cache import page_hash as tpage_hash
from dynamo_tpu_torch.engine.scheduler import (
    SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.runtime.integrity import STATS as TINTEGRITY

from tests.http_client import request

torch.set_num_threads(1)

JCFG = JModelConfig(dtype="float32", max_model_len=256, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=256)
PAGE = 8
PROMPT = list(range(10, 42))   # 4 pages; the walk matches the 3 full ones
GREEDY = dict(max_tokens=4, temperature=0.0, ignore_eos=True)
SAMPLED = dict(max_tokens=4, temperature=0.9, top_k=8, seed=1234,
               ignore_eos=True)
F32_TOL = 1e-5
SCALE_TOL = 1e-6
HOST = "127.0.0.1"


class Side:
    """One package's engine, pool, stats and hashing, under one interface."""

    def __init__(self, name, params):
        self.name = name
        self.params = params
        jax_side = name == "jax"
        self.mod = jkv_pool if jax_side else tkv_pool
        self.stats = self.mod.POOL_STATS
        self.integrity = JINTEGRITY if jax_side else TINTEGRITY
        self.page_hash = jpage_hash if jax_side else tpage_hash
        self.sp = JSamplingParams if jax_side else TSamplingParams

    def engine(self, pool=None, wid="", num_pages=32, kv_quant=""):
        kw = dict(page_size=PAGE, num_pages=num_pages, max_slots=2,
                  max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                  max_model_len=256, kv_quant=kv_quant)
        if self.name == "jax":
            eng = JNativeEngine(JCFG, JEngineConfig(**kw),
                                params=self.params, seed=0)
        else:
            eng = TNativeEngine(TCFG, TEngineConfig(**kw),
                                params=self.params, device="cpu")
        if pool is not None:
            eng.attach_kv_pool(pool, wid or "w")
        return eng

    def gen(self, eng, prompt, rid, params):
        return eng.generate(prompt, self.sp(**params), rid)

    def publish_all(self, eng):
        eng.drain_kv_events()
        eng._pool_stream.drain()

    def seeded_pool(self, prompt=PROMPT, kv_quant=""):
        pool = self.mod.SharedKvPool(capacity_pages=64)
        a = self.engine(pool, "A", kv_quant=kv_quant)
        self.gen(a, prompt, "seed-a", GREEDY)
        self.publish_all(a)
        a.close()
        return pool

    def reset(self):
        self.stats.reset()
        self.integrity.__init__()


@pytest.fixture(scope="module")
def jax_params():
    kw = dict(page_size=PAGE, num_pages=32, max_slots=2,
              max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
              max_model_len=256)
    eng = JNativeEngine(JCFG, JEngineConfig(**kw), seed=0)
    return jax.device_get(eng.params)


@pytest.fixture(scope="module")
def sides(jax_params):
    return (Side("jax", jax_params),
            Side("torch", params_from_jax(jax_params, TCFG, "cpu")))


@pytest.fixture(autouse=True)
def clean_state(sides):
    for s in sides:
        s.reset()
    yield
    for s in sides:
        s.reset()


def both(sides, fn):
    """fn(side) on the JAX side, then the port's, each from clean counters;
    returns (jax result, port result) and asserts the POOL_STATS equal."""
    out, snaps = [], []
    for s in sides:
        s.reset()
        out.append(fn(s))
        snaps.append(s.stats.snapshot())
    assert snaps[1] == snaps[0]
    return tuple(out)


def prefix_keys(prompts, hash_fn):
    out = {}
    for toks in prompts:
        parent = 0
        for i in range(len(toks) // PAGE):
            parent = hash_fn(parent, toks[i * PAGE:(i + 1) * PAGE])
            out[parent] = tuple(toks[:(i + 1) * PAGE])
    return out


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pool_pages(side, pool, prompts):
    keys = prefix_keys(prompts, side.page_hash)
    with pool._mu:
        return {keys[h]: (e.mode, sorted(e.sources), e.nbytes,
                          [_np(a) for a in e.arrays])
                for h, e in pool._entries.items()}


def assert_pools_equal(sides, pools, prompts):
    jp, tp = (pool_pages(s, p, prompts) for s, p in zip(sides, pools))
    assert sorted(jp) == sorted(tp)
    for key, (mode, sources, nbytes, arrays) in jp.items():
        tmode, tsources, tnbytes, tarrays = tp[key]
        assert (tmode, tsources, tnbytes) == (mode, sources, nbytes)
        for i, (want, got) in enumerate(zip(arrays, tarrays)):
            assert got.shape == want.shape and got.dtype == want.dtype
            if want.dtype == np.int8:
                np.testing.assert_array_equal(got, want)
            else:
                tol = SCALE_TOL if i >= 2 else F32_TOL
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return len(jp)


def _log_injects(side, eng, log):
    """Record each non-empty drain of the pool-inject queue as [(pid,
    page prefix)]."""
    sch = eng.scheduler
    drain = sch.drain_pool_injects
    keys = prefix_keys([PROMPT], side.page_hash)

    def logged():
        out = drain()
        if out:
            log.append([(pid, keys[h]) for pid, h, _ in out])
        return out
    sch.drain_pool_injects = logged


# -- warm-prefix e2e ----------------------------------------------------------

def test_cross_worker_reuse_token_identity_greedy_and_sampled(sides):
    """A prefix prefilled on A serves on B through the pool: the 3 full
    prefix pages fetched, not recomputed, tokens identical to cold
    recompute under greedy and seeded sampling, and to the JAX engines."""
    def run(s):
        oracle = s.engine()
        expect_g = s.gen(oracle, PROMPT, "og", GREEDY)
        expect_s = s.gen(oracle, PROMPT, "os", SAMPLED)
        pool = s.seeded_pool()
        log = []
        b = s.engine(pool, "B")
        _log_injects(s, b, log)
        got_g = s.gen(b, PROMPT, "bg", GREEDY)
        assert got_g == expect_g
        assert b.scheduler.pool_fetched_pages == 3
        assert s.stats.fetch_hits == 3
        assert b.scheduler._prefix_hits >= 3
        b2 = s.engine(pool, "B2")
        got_s = s.gen(b2, PROMPT, "bs", SAMPLED)
        assert got_s == expect_s
        assert b2.scheduler.pool_fetched_pages == 3
        b.close()
        b2.close()
        return got_g, got_s, log, pool

    (jg, js, jlog, jpool), (tg, ts, tlog, tpool) = both(sides, run)
    assert (tg, ts) == (jg, js)
    assert tlog == jlog and len(tlog) == 1 and len(tlog[0]) == 3
    assert assert_pools_equal(sides, (jpool, tpool),
                              [PROMPT + jg, PROMPT + js]) >= 3


def test_pool_entry_rot_quarantined_and_recomputed_not_served(sides):
    """At-rest rot in a pool entry: the fetch-time verify quarantines it
    (removed, never served) and the page is recomputed."""
    def run(s):
        expect = s.gen(s.engine(), PROMPT, "o", GREEDY)
        pool = s.seeded_pool()
        h0 = s.page_hash(0, PROMPT[:PAGE])
        with pool._mu:   # rot the first page's stored bytes
            e = pool._entries[h0]
            rotten = _np(e.arrays[0]).copy()
            rotten[0, 0, 0, 0] += 1.0
            e.arrays = ((rotten if s.name == "jax"
                         else torch.from_numpy(rotten)),) + e.arrays[1:]
        b = s.engine(pool, "B")
        got = s.gen(b, PROMPT, "b", GREEDY)
        assert got == expect
        assert s.stats.quarantined == 1 and s.integrity.quarantined >= 1
        assert h0 not in pool
        assert b.scheduler.pool_fetched_pages == 0
        b.close()
        return got

    jg, tg = both(sides, run)
    assert tg == jg


def test_cross_kv_quant_mode_fetch_rejected_by_name(sides):
    """An int8-published page fetched by an unquantized engine is rejected
    by name (PoolQuantMismatch naming both modes), walks as a miss, and
    the request recomputes: never a silent cast."""
    def run(s):
        pool = s.seeded_pool(kv_quant="int8")
        h0 = s.page_hash(0, PROMPT[:PAGE])
        with pytest.raises(s.mod.PoolQuantMismatch) as ei:
            pool.fetch(h0, "")
        assert "int8" in str(ei.value) and "off" in str(ei.value)
        assert s.stats.quant_rejected == 1
        expect = s.gen(s.engine(), PROMPT, "o", GREEDY)
        b = s.engine(pool, "B")
        got = s.gen(b, PROMPT, "b", GREEDY)
        assert got == expect and b.scheduler.pool_fetched_pages == 0
        assert s.stats.quant_rejected >= 2
        b.close()
        return got

    jg, tg = both(sides, run)
    assert tg == jg


def test_dedup_identical_int8_pages_from_two_workers_keeps_one_entry(sides):
    """Two int8 engines prefill the same prompt: the pool keeps ONE copy per
    page with both sources, counts the second publish as dedup, and an int8
    consumer serves from it; the entries hold the JAX engines' bytes."""
    def run(s):
        pool = s.mod.SharedKvPool(capacity_pages=64)
        for wid in ("A1", "A2"):
            eng = s.engine(pool, wid, kv_quant="int8")
            s.gen(eng, PROMPT, f"seed-{wid}", GREEDY)
            s.publish_all(eng)
            eng.close()
        h0 = s.page_hash(0, PROMPT[:PAGE])
        with pool._mu:
            entry = pool._entries[h0]
            assert entry.sources == {"A1", "A2"} and entry.mode == "int8"
            assert len(entry.arrays) == 4
            n_entries = len(pool._entries)
        assert s.stats.publishes == n_entries
        assert s.stats.dedup_hits >= 3
        assert s.stats.bytes == sum(e.nbytes
                                    for e in pool._entries.values())
        expect = s.gen(s.engine(kv_quant="int8"), PROMPT, "o", GREEDY)
        b = s.engine(pool, "B", kv_quant="int8")
        got = s.gen(b, PROMPT, "b", GREEDY)
        assert got == expect and b.scheduler.pool_fetched_pages == 3
        b.close()
        return got, pool

    (jg, jpool), (tg, tpool) = both(sides, run)
    assert tg == jg
    assert assert_pools_equal(sides, (jpool, tpool), [PROMPT + jg]) >= 3


# -- prefetch (the admission window) ------------------------------------------

def test_prefetch_racing_cancel_leaves_no_leaked_hbm_pages(sides):
    """Prefetched pages are sealed into the reusable pool: a request that
    never arrives leaks nothing, and another workload can take every
    page."""
    other = [(500 + i) % 250 + 1 for i in range(80)]   # 10 pages

    def run(s):
        pool = s.seeded_pool()
        b = s.engine(pool, "B", num_pages=16)
        assert b.prefetch_pool_pages(PROMPT) == 4
        assert b.scheduler.allocator.num_free == 16
        assert b.prefetch_pool_pages(PROMPT) == 0    # already warm
        expect = s.gen(s.engine(), other, "o", GREEDY)
        got = s.gen(b, other, "b-other", GREEDY)
        assert got == expect
        assert b.scheduler.allocator.num_free == 16
        b.close()
        return got

    jg, tg = both(sides, run)
    assert tg == jg


def test_prefetch_serves_from_hbm_and_counts_window_outcome(sides):
    def run(s):
        pool = s.seeded_pool()
        expect = s.gen(s.engine(), PROMPT, "o", GREEDY)
        b = s.engine(pool, "B")
        assert b.prefetch_pool_pages(PROMPT) == 4
        assert s.stats.prefetch_pages == 4
        got = s.gen(b, PROMPT, "b", GREEDY)
        assert got == expect
        # served from HBM: the admission walk fetched nothing
        assert b.scheduler.pool_fetched_pages == 0
        b.close()
        return got

    jg, tg = both(sides, run)
    assert tg == jg


def _worker_module(side):
    if side.name == "jax":
        from dynamo_tpu.llm import worker
    else:
        from dynamo_tpu_torch.llm import worker
    return worker


def test_admission_prefetcher_warms_target_worker(sides):
    """tokens -> target worker -> engine.prefetch_pool_pages between device
    steps, with the hit-vs-late window accounting."""
    def run(s):
        async def main():
            pool = s.seeded_pool()
            worker = await _worker_module(s).NativeEngineWorker(
                s.engine(pool, "B")).start()
            try:
                pref = s.mod.AdmissionPrefetcher(
                    pool, tokens_fn=lambda req: req,
                    target_fn=lambda toks: worker, page_size=PAGE)
                assert pref.matched_pages(PROMPT) == 4
                admitted = asyncio.Event()
                assert await pref.prefetch(PROMPT, admitted) == 4
                assert s.stats.prefetch_hits == 1
                assert s.stats.prefetch_late == 0
                admitted.set()
                assert await pref.prefetch(PROMPT, admitted) == 0
                assert s.stats.prefetch_late == 0
                assert await pref.prefetch([9] * 32, admitted) == 0
            finally:
                await worker.stop()
        asyncio.run(asyncio.wait_for(main(), 60))

    both(sides, run)


# -- pool store semantics -----------------------------------------------------

def test_source_eviction_drops_only_single_source_entries(sides):
    def run(s):
        pool = s.mod.SharedKvPool(capacity_pages=8)
        page = (np.ones((1, 1, 2, 2), np.float32),
                np.ones((1, 1, 2, 2), np.float32))
        assert pool.publish("A", 1, 0, 11, page) == "new"
        assert pool.publish("B", 1, 0, 11, page) == "dup"
        assert pool.publish("A", 2, 1, 22, page) == "new"
        assert pool.evict_source("A") == 1      # entry 2 was A-only
        assert 1 in pool and 2 not in pool
        with pool._mu:
            assert pool._entries[1].sources == {"B"}
        assert s.stats.source_evictions == 1
        return pool.snapshot()

    jsnap, tsnap = both(sides, run)
    assert tsnap == jsnap


def test_capacity_eviction_emits_removed_events_per_source(sides):
    def run(s):
        pool = s.mod.SharedKvPool(capacity_pages=2)
        page = (np.zeros((1, 1, 2, 2), np.float32),) * 2
        pool.publish("A", 1, 0, 11, page)
        pool.publish("A", 2, 1, 22, page)
        first = pool.drain_events("A")
        pool.publish("A", 3, 2, 33, page)     # LRU-evicts hash 1
        assert 1 not in pool and s.stats.evicted == 1
        events = pool.drain_events("A")
        assert ("removed", 0, 1, 0, 11) in events
        assert ("stored", 0, 3, 2, 33) in events
        return first, events

    jev, tev = both(sides, run)
    assert tev == jev


# -- the HTTP service's prefetcher and gauges --------------------------------

def _service_modules(side):
    if side.name == "jax":
        from dynamo_tpu.frontend import service
        from dynamo_tpu.llm import model_card, pipeline
    else:
        from dynamo_tpu_torch.frontend import service
        from dynamo_tpu_torch.llm import model_card, pipeline
    return service, model_card, pipeline


def _pool_gauges(text: str) -> dict:
    """The llm_kv_pool_* gauges of the shared pool's counters (the JAX
    service also renders the cross-host pool's llm_kv_pool_remote_*)."""
    names = {f"llm_kv_pool_{n}" for n in jkv_pool.KvPoolStats.FIELDS}
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(llm_kv_pool_\w+) ([0-9.eE+-]+)$", text, re.M)
        if m.group(1) in names}


def test_service_prefetcher_renders_pool_gauges(sides):
    """An HttpService with an AdmissionPrefetcher: a chat request warms the
    pool pages of its (mapped) prompt into the worker's HBM, and GET
    /metrics shows every llm_kv_pool_* gauge under the JAX names with the
    JAX service's values."""
    def run(s):
        service, model_card, pipeline = _service_modules(s)

        async def main():
            pool = s.seeded_pool()
            worker = await _worker_module(s).NativeEngineWorker(
                s.engine(pool, "B")).start()
            pref = s.mod.AdmissionPrefetcher(
                pool, tokens_fn=lambda req: PROMPT,
                target_fn=lambda toks: worker, page_size=PAGE)
            svc = await service.HttpService(HOST, 0,
                                            prefetcher=pref).start()
            card = model_card.ModelDeploymentCard(
                name="tiny", arch="tiny", context_length=256)
            svc.models.add("tiny", pipeline.LocalPipeline(card, worker),
                           "chat")
            try:
                status, _ = await request(HOST, svc.port, "POST",
                                          "/v1/chat/completions", {
                                              "model": "tiny",
                                              "max_tokens": 3,
                                              "messages": [{
                                                  "role": "user",
                                                  "content": "hi"}]})
                assert status == 200
                for _ in range(200):
                    if s.stats.prefetch_late + s.stats.prefetch_hits:
                        break
                    await asyncio.sleep(0.05)
                _, raw = await request(HOST, svc.port, "GET", "/metrics")
                return _pool_gauges(raw.decode())
            finally:
                await svc.stop()
                await worker.stop()
        return asyncio.run(asyncio.wait_for(main(), 60))

    jg, tg = both(sides, run)
    assert set(jg) == {f"llm_kv_pool_{n}" for n in jkv_pool.KvPoolStats.FIELDS}
    assert tg == jg
    assert tg["llm_kv_pool_prefetch_pages"] == 4
    assert tg["llm_kv_pool_prefetch_late"] == 1
