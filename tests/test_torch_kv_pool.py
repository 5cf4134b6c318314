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

Also the seeded mid-fetch death (:131-156, the `pool.fetch` failpoint on
both packages), the router's pool sources without a selector (:393-460:
`_split_pool_scores` fencing dead sources and dead pool hosts, the watch
delete evicting a dead worker's pool entries at event time), the worker's
pool publisher, and the gather decode window (`decode_kernel="off"`)
reading a page onboarded from the host tier and a page fetched from the
pool, token-identical to the JAX gather window with the same tiers. The
selector cases (:338-392): the transfer-aware selector prices a pool
depth on both packages, with equal picks, components and router counters.
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
from dynamo_tpu.runtime import faults as jfaults
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
from dynamo_tpu_torch.runtime import faults as tfaults
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
        self.faults = jfaults if jax_side else tfaults
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
        self.faults.REGISTRY.disarm()
        self.faults.REGISTRY.reset_counters()


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


def test_seeded_mid_fetch_death_salvages_to_recompute(sides):
    """Page 2 of the fetch chain dies (a corruption at the pool.fetch
    failpoint): the walk keeps the committed page and recomputes the tail,
    zero dropped streams, greedy and seeded-sampled alike."""
    def run(s):
        oracle = s.engine()
        out = []
        for i, params in enumerate((GREEDY, SAMPLED)):
            expect = s.gen(oracle, PROMPT, f"o{i}", params)
            s.stats.reset()
            pool = s.seeded_pool()
            s.faults.REGISTRY.arm("pool.fetch", s.faults.FaultSchedule(
                0, [s.faults.FaultSpec("corrupt", p=1.0, n=1, skip=1)]))
            b = s.engine(pool, f"B{i}")
            got = s.gen(b, PROMPT, f"b{i}", params)
            assert got == expect
            assert b.scheduler.pool_fetched_pages == 1
            assert s.stats.quarantined == 1
            s.faults.REGISTRY.disarm()
            b.close()
            out.append(got)
        return out

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


# -- routing: pool sources ------------------------------------------------------

class FakeClient:
    def __init__(self, instances):
        self.instances = instances


def _routers():
    from dynamo_tpu.kv_router.indexer import MatchResult as JMatch
    from dynamo_tpu.kv_router.router import KvRouter as JRouter
    from dynamo_tpu.runtime import placement as jplacement
    from dynamo_tpu_torch.kv_router.indexer import MatchResult as TMatch
    from dynamo_tpu_torch.kv_router.router import KvRouter as TRouter
    from dynamo_tpu_torch.runtime import placement as tplacement
    return ((JRouter, JMatch, jplacement), (TRouter, TMatch, tplacement))


def test_router_split_pool_scores_fences_corpse_sources():
    """pool:{w} scores leave the resident score map and fold into ONE
    fetchable depth; a source missing from the live instances is never
    counted. The port's answers are the JAX router's."""
    out = []
    for router_cls, match, _ in _routers():
        router = router_cls(object(), FakeClient({"w1": {}, "w2": {}}),
                            block_size=4)
        overlap = match(scores={"w1": 1, "pool:w1": 3, "pool:dead": 5})
        out.append((router._split_pool_scores(overlap), overlap.scores))
    assert out[1] == out[0] == (3, {"w1": 1})


def test_router_split_pool_scores_fences_dead_pool_hosts():
    """Pool-host liveness: while one member lives the depth still counts;
    the last pool host's watch delete zeroes it at event time."""
    out = []
    for router_cls, match, pl in _routers():
        m = pl.PoolMembership()
        router = router_cls(object(), FakeClient({"w1": {}}), block_size=4,
                            pool_membership=m)
        m.on_instance("put", pl.pool_host_instance_id("ph0"), {})
        m.on_instance("put", pl.pool_host_instance_id("ph1"), {})
        res = [set(m.live_hosts())]
        for gone in ("ph0", "ph1"):
            overlap = match(scores={"w1": 1, "pool:w1": 3})
            res.append(router._split_pool_scores(overlap))
            m.on_instance("delete", pl.pool_host_instance_id(gone), {})
        overlap = match(scores={"w1": 1, "pool:w1": 3})
        res += [router._split_pool_scores(overlap), overlap.scores]
        out.append(res)
    assert out[1] == out[0] == [{"ph0", "ph1"}, 3, 3, 0, {"w1": 1}]


def test_watch_delete_evicts_pool_source_entries_at_event_time():
    """A dead worker's POOL-source index entries go at watch-delete time:
    before the delete the published prefix scores as `pool:w2` (and as the
    decision's fetchable `pool_blocks`, never as resident overlap), after
    it nothing scores, with no metrics scrape between."""
    from dynamo_tpu_torch.engine.kv_cache import (
        page_hash, tokens_hash,
    )
    from dynamo_tpu_torch.kv_router.protocols import pool_source_id
    from dynamo_tpu_torch.kv_router.publisher import (
        KvEventPublisher, KvMetricsPublisher,
    )
    from dynamo_tpu_torch.kv_router.router import KvRouter
    from dynamo_tpu_torch.kv_router.scoring import WorkerMetrics
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    async def main():
        plane = MemoryPlane()
        worker_rts, comps = [], {}
        for wid in ("w1", "w2"):
            rt = await DistributedRuntime.create_local(plane, wid)
            comp = rt.namespace("ns").component("worker")
            mpub = KvMetricsPublisher()
            mpub.update(WorkerMetrics(
                request_active_slots=0, request_total_slots=8,
                kv_active_blocks=0, kv_total_blocks=100))

            async def engine(request, context, wid=wid):
                yield {"worker": wid}

            await comp.endpoint("generate").serve(
                engine, stats_handler=mpub.stats_handler)
            comps[wid] = comp
            worker_rts.append(rt)
        rrt = await DistributedRuntime.create_local(plane, "router")
        comp = rrt.namespace("ns").component("worker")
        client = comp.endpoint("generate").client()
        await client.start()
        await client.wait_for_instances()
        router = await KvRouter(comp, client, block_size=4,
                                scrape_interval_s=60.0).start()
        await router.aggregator.scrape_once()
        # w2 publishes two prefix pages into the pool namespace
        toks = list(range(100, 116))
        pool = tkv_pool.SharedKvPool(capacity_pages=8)
        page = (torch.zeros((1, 1, 2, 2)),) * 2
        parent = 0
        for i in range(2):
            ptoks = toks[i * 4:(i + 1) * 4]
            h = page_hash(parent, ptoks)
            pool.publish("w2", h, parent, tokens_hash(ptoks), page)
            parent = h
        await KvEventPublisher(comps["w2"], pool_source_id("w2")) \
            .publish_allocator_events(pool.drain_events("w2"))
        for _ in range(100):
            if router.find_matches_for_tokens(toks).scores:
                break
            await asyncio.sleep(0.01)
        try:
            assert router.find_matches_for_tokens(toks).scores == {
                "pool:w2": 2}
            await router.schedule(toks)
            assert router.decisions[-1]["pool_blocks"] == 2
            assert router.decisions[-1]["scores"] == {}
            await worker_rts[1].shutdown()     # w2 dies
            for _ in range(100):
                if "w2" not in client.instances:
                    break
                await asyncio.sleep(0.01)
            assert router.find_matches_for_tokens(toks).scores == {}
            await router.schedule(toks)
            assert router.decisions[-1]["pool_blocks"] == 0
        finally:
            await router.stop()
            await rrt.shutdown()
            await worker_rts[0].shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_worker_pool_publisher_sends_pool_events():
    """The worker's step loop drains the attached pool's events for its
    engine's pages into its pool publisher (the `pool:{worker_id}` source
    serve_llm_worker wires)."""
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker

    class Recorder:
        def __init__(self):
            self.events = []

        async def publish_allocator_events(self, events):
            self.events.extend(events)
            return len(events)

    async def main():
        pool = tkv_pool.SharedKvPool(capacity_pages=64)
        eng = TNativeEngine(TCFG, TEngineConfig(
            page_size=PAGE, num_pages=32, max_slots=2, max_prefill_chunk=32,
            prefill_buckets=(8, 16, 32), max_model_len=256), device="cpu")
        eng.attach_kv_pool(pool, "A")
        worker = await NativeEngineWorker(eng).start()
        worker.pool_publisher = rec = Recorder()
        try:
            q = asyncio.Queue()
            worker._queues["r"] = q
            worker._pending_adds.append(EngineRequest(
                "r", PROMPT, TSamplingParams(**GREEDY)))
            worker._wake.set()
            while True:
                frame = await q.get()
                if frame.finish_reason is not None:
                    break
            eng._pool_stream.drain()
            for _ in range(200):          # the loop drains after a step
                if len(rec.events) >= 4:
                    break
                worker._wake.set()
                await asyncio.sleep(0.01)
        finally:
            await worker.stop()
        return rec.events

    events = asyncio.run(asyncio.wait_for(main(), 60))
    assert [e[0] for e in events] == ["stored"] * 4


def test_gather_window_reads_onboarded_and_pool_pages(sides):
    """The gather decode window (`decode_kernel="off"`, the port's
    `_gather_base`) over pages fetched from the shared pool, and over pages
    onboarded from the host tier: streams token-identical to the JAX
    engine's gather window with the same tiers. Two engines: with a host
    tier the prefix walk claims no pool page, in JAX as in the port (the
    host rung's `pin` ends the walk at a pool-only page; ROADMAP §C)."""
    import dynamo_tpu_torch.engine.engine as tengine_mod
    other = [(500 + i) % 250 + 1 for i in range(48)]   # 6 pages

    def engine(s, **kw):
        kw = dict(page_size=PAGE, num_pages=8, max_slots=2,
                  max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                  max_model_len=256, **kw)
        if s.name == "jax":
            return JNativeEngine(JCFG, JEngineConfig(**kw), params=s.params,
                                 seed=0)
        eng = TNativeEngine(
            TModelConfig(dtype="float32", max_model_len=256,
                         decode_kernel="off"),
            TEngineConfig(**kw), params=s.params, device="cpu")
        assert eng.decode_path == "gather"
        return eng

    def run(s):
        pool = s.seeded_pool()
        b = engine(s)
        b.attach_kv_pool(pool, "B")
        got = [s.gen(b, PROMPT, "p1", GREEDY)]        # pool fetches
        fetched = b.scheduler.pool_fetched_pages
        b.close()
        h = engine(s, host_pages=16)
        cs = h._copy_stream
        submit = cs.submit

        def sync_submit(*args):
            submit(*args)
            cs.drain()
        cs.submit = sync_submit
        got.append(s.gen(h, PROMPT, "p1", GREEDY))
        got.append(s.gen(h, other, "x", GREEDY))      # evicts to the host
        got.append(s.gen(h, PROMPT, "p2", GREEDY))    # host onboards
        onboarded = h.host_pool.stats.onboarded
        h.close()
        return got, fetched, onboarded

    calls = []
    real = tengine_mod._gather_base

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    tengine_mod._gather_base = counted
    try:
        (jg, jf, jo), (tg, tf, to) = both(sides, run)
    finally:
        tengine_mod._gather_base = real
    assert tg == jg
    assert (tf, to) == (jf, jo)
    assert tf == 3 and to > 0
    assert calls, "the gather window never ran"


# -- routing: fetchable prefixes priced (JAX :338-392) ------------------------

def _pool_case(pkg: str, bw: dict, workers: dict, isl: int, scores: dict,
               pool_matched: int):
    """One package's KvScheduler over a TransferAwareSelector with a
    private cost model seeded with `bw` (the JAX test's _sched / _model):
    (pick, last_components, the JAX router counters)."""
    import random
    if pkg == "jax":
        from dynamo_tpu.kv_router import indexer, scheduler, scoring, stats
        from dynamo_tpu.observability.fleet import TransferCostModel
    else:
        from dynamo_tpu_torch.kv_router import (
            indexer, scheduler, scoring, stats,
        )
        from dynamo_tpu_torch.observability.fleet import TransferCostModel
    model = TransferCostModel()
    for link, bytes_per_s in bw.items():
        model.observe(link, int(bytes_per_s), 1.0)
    stats.ROUTER_STATS.reset()
    sel = scheduler.TransferAwareSelector(
        cost_model=model, rng=random.Random(0), health_of=lambda w: 1.0)
    if pkg == "jax":
        sel.default_block_bytes = 1 << 20
    else:
        sel.DEFAULT_BLOCK_BYTES = 1 << 20
    sched = scheduler.KvScheduler(block_size=16, selector=sel)
    sched.update_endpoints(scoring.ProcessedEndpoints({
        w: scoring.WorkerMetrics(**kw) for w, kw in workers.items()}))
    pick = sched.schedule(isl, indexer.MatchResult(scores=dict(scores)),
                          pool_matched=pool_matched)
    snap = stats.ROUTER_STATS.snapshot()
    return (getattr(pick, "worker_id", pick),
            sched.selector.last_components,
            {k: snap[k] for k in ("transfer_scored", "cold_scored",
                                  "pool_scored", "last_pool_fetch_blocks",
                                  "last_transfer_est_s",
                                  "last_transfer_bytes")})


def _pool_both(*args):
    want = _pool_case("jax", *args)
    got = _pool_case("torch", *args)
    assert got == want
    return got


POOL_LOAD = dict(request_total_slots=8, kv_total_blocks=100)


def test_selector_pool_blocks_reduce_bytes_to_move_and_join_overlap():
    _, comps, st = _pool_both(dict(w1=1 << 28, w2=1 << 28),
                              dict(w1=POOL_LOAD, w2=POOL_LOAD), 160, {}, 6)
    for w in ("w1", "w2"):
        assert comps[w]["pool_blocks"] == 6
        assert comps[w]["transfer_bytes"] == 4 * (1 << 20)
        assert comps[w]["pool_fetch_bytes"] == 6 * (1 << 20)
        assert comps[w]["overlap"] == pytest.approx(6 * 16 / 160)
    assert st["pool_scored"] >= 1
    assert st["last_pool_fetch_blocks"] == 6


def test_selector_resident_beats_fetchable_at_equal_depth():
    picked, comps, _ = _pool_both(
        dict(holder=1 << 26, fetcher=1 << 26),
        dict(holder=POOL_LOAD, fetcher=POOL_LOAD), 160, {"holder": 6}, 6)
    assert picked == "holder"
    assert comps["holder"]["pool_blocks"] == 0
    assert comps["fetcher"]["pool_blocks"] == 6
    assert comps["fetcher"]["transfer_s"] > comps["holder"]["transfer_s"]


def test_selector_pool_match_beats_no_reuse_on_fast_links():
    picked, comps, _ = _pool_both(
        dict(w1=1 << 30, w2=1 << 30),
        dict(w1=POOL_LOAD, w2=dict(POOL_LOAD, request_active_slots=1)),
        160, {}, 8)
    assert picked == "w1"
    assert comps["w1"]["overlap"] > 0
