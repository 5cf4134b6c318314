"""The port's KV-aware router (dynamo_tpu_torch/kv_router) against the JAX
package's (dynamo_tpu/kv_router), on the CPU.

The two packages hash pages differently (BLAKE2b in the port, xxh3 in the
JAX package), so the comparisons are of decisions and overlap counts, never
of hash values. Each package's own PageAllocator runs the same seeded
script of request prefills (share or allocate + seal every full page, then
free), with a small page pool so that recycled pages emit Removed events;
its events go to that package's indexer or router.

(a) Indexer level: the events (and remove_worker / revive_worker calls)
    fed to each package's KvIndexer, with frequency tracking on; after
    every step the per-worker overlap counts and the frequencies of the
    same queries are equal.
(b) Router level: three workers per package on an in-process memory
    plane publish through each package's KvEventPublisher, serve $STATS
    with the same metrics, and a KvRouter with
    DefaultWorkerSelector(rng=random.Random(seed)) schedules the same
    queries; the overlap counts and the chosen worker are equal at every
    step, through Removed events, a draining instance and a deregistered
    one.
(c) Within the port, the router's query hashes equal the worker's stored
    tokens_hash for the same tokens (compute_page_hashes vs the
    allocator's events).
"""
import asyncio
import random

import numpy as np
import pytest

PAGE = 4
NUM_PAGES = 12
WORKERS = ("w0", "w1", "w2")
METRICS = {
    "w0": {"request_active_slots": 1, "request_total_slots": 8,
           "kv_active_blocks": 2, "kv_total_blocks": NUM_PAGES},
    "w1": {"request_active_slots": 0, "request_total_slots": 8,
           "kv_active_blocks": 0, "kv_total_blocks": NUM_PAGES},
    "w2": {"request_active_slots": 2, "request_total_slots": 8,
           "kv_active_blocks": 5, "kv_total_blocks": NUM_PAGES},
}


def _pkg(name: str) -> dict:
    if name == "jax":
        from dynamo_tpu.engine import kv_cache
        from dynamo_tpu.kv_router import indexer, protocols, publisher, router
        from dynamo_tpu.kv_router import scheduler
        from dynamo_tpu.runtime import distributed
        from dynamo_tpu.runtime.transports import memory
    else:
        from dynamo_tpu_torch.engine import kv_cache
        from dynamo_tpu_torch.kv_router import (
            indexer, protocols, publisher, router, scheduler,
        )
        from dynamo_tpu_torch.runtime import distributed
        from dynamo_tpu_torch.runtime.transports import memory
    return {"kv_cache": kv_cache, "indexer": indexer, "protocols": protocols,
            "publisher": publisher, "router": router,
            "scheduler": scheduler, "distributed": distributed,
            "memory": memory}


def script(seed: int) -> list:
    """A seeded sequence of ("serve", worker, tokens), ("query", tokens),
    ("remove", worker), ("revive", worker) and ("drain", worker) steps
    over 4 documents with shared heads."""
    rng = np.random.default_rng(seed)
    docs = [list(rng.integers(3, 250, 24)) for _ in range(4)]
    docs[1][:8] = docs[0][:8]          # shared heads: partial overlaps
    docs[3][:12] = docs[2][:12]
    steps = []
    for i in range(28):
        d = docs[int(rng.integers(0, 4))]
        n = int(rng.integers(PAGE, len(d) + 1))
        tail = list(rng.integers(3, 250, int(rng.integers(0, 6))))
        toks = [int(t) for t in d[:n] + tail]
        steps.append(("serve", WORKERS[int(rng.integers(0, 3))], toks))
        q = docs[int(rng.integers(0, 4))]
        steps.append(("query", [int(t) for t in
                                q[:int(rng.integers(PAGE, len(q) + 1))]]))
        if i == 12:
            steps.append(("drain", "w2"))
        if i == 20:
            steps.append(("remove", "w1"))
    return steps


def prefill(kv_cache, alloc, tokens) -> None:
    """One request's full pages through a PageAllocator, as the scheduler
    drives it: share each cached page of the chained prefix, allocate +
    seal the rest, then free them all (finished request)."""
    parent, pages = 0, []
    for i in range(len(tokens) // PAGE):
        chunk = tokens[i * PAGE:(i + 1) * PAGE]
        h = kv_cache.page_hash(parent, chunk)
        pid = alloc.lookup(h)
        if pid is not None:
            alloc.share(pid)
        else:
            pid = alloc.allocate()
            h = alloc.seal(pid, parent, chunk)
        pages.append(pid)
        parent = h
    for pid in pages:
        alloc.free(pid)


def _events_to_router_events(protocols, wid, events, event_id):
    """Allocator events as the publisher batches them (one RouterEvent per
    chained Stored run or Removed run)."""
    out = []
    for kind, _pid, seq_hash, parent, tok_hash in events:
        if kind == "stored":
            prev = out[-1] if out else None
            if (prev is not None
                    and isinstance(prev, protocols.KvCacheStoreData)
                    and prev.blocks[-1].block_hash == parent):
                prev.blocks.append(protocols.KvCacheStoredBlockData(
                    seq_hash, tok_hash))
            else:
                out.append(protocols.KvCacheStoreData(
                    parent_hash=parent or None,
                    blocks=[protocols.KvCacheStoredBlockData(seq_hash,
                                                             tok_hash)]))
        else:
            prev = out[-1] if out else None
            if isinstance(prev, protocols.KvCacheRemoveData):
                prev.block_hashes.append(seq_hash)
            else:
                out.append(protocols.KvCacheRemoveData([seq_hash]))
    return [protocols.RouterEvent(wid, protocols.KvCacheEvent(
        event_id + i, d)) for i, d in enumerate(out)]


def _indexer_trace(pkg: str, seed: int) -> list:
    m = _pkg(pkg)
    idx = m["indexer"].KvIndexer(PAGE, expiration_duration_s=1e9)
    allocs = {w: m["kv_cache"].PageAllocator(NUM_PAGES, PAGE)
              for w in WORKERS}
    trace, eid = [], 0
    for step in script(seed):
        kind = step[0]
        if kind == "serve":
            _, wid, toks = step
            prefill(m["kv_cache"], allocs[wid], toks)
            for ev in _events_to_router_events(
                    m["protocols"], wid, allocs[wid].drain_events(), eid):
                idx.apply_event(ev)
                eid += 1
        elif kind == "query":
            res = idx.find_matches_for_tokens(step[1])
            trace.append((dict(sorted(res.scores.items())),
                          list(res.frequencies)))
        elif kind in ("drain", "remove"):
            idx.remove_worker(step[1])
            trace.append(("removed", step[1], idx.num_nodes()))
        if kind == "remove":
            # a restarted worker of the same id comes back empty
            idx.revive_worker(step[1])
            allocs[step[1]] = m["kv_cache"].PageAllocator(NUM_PAGES, PAGE)
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_indexer_overlap_counts_equal(seed):
    want, got = _indexer_trace("jax", seed), _indexer_trace("torch", seed)
    assert got == want
    # the script exercised partial overlaps, several workers per page and
    # Removed events
    assert any(len(s[0]) >= 2 for s in want if not s[0] == "removed")


async def _router_trace(pkg: str, seed: int, decisions=None) -> list:
    m = _pkg(pkg)
    DRT = m["distributed"].DistributedRuntime
    plane = m["memory"].MemoryPlane()
    served, pubs, allocs, rts = {}, {}, {}, []
    for wid in WORKERS:
        rt = await DRT.create_local(plane, wid)
        rts.append(rt)
        comp = rt.namespace("ns").component("w")

        async def engine(request, context):
            yield {}
        served[wid] = await comp.endpoint("gen").serve(
            engine, stats_handler=lambda wid=wid: dict(METRICS[wid]))
        pubs[wid] = m["publisher"].KvEventPublisher(comp, wid)
        allocs[wid] = m["kv_cache"].PageAllocator(NUM_PAGES, PAGE)
    frt = await DRT.create_local(plane, "frontend")
    rts.append(frt)
    fcomp = frt.namespace("ns").component("w")
    client = fcomp.endpoint("gen").client()
    await client.start()
    router = m["router"].KvRouter(
        fcomp, client, PAGE, selector=m["scheduler"].DefaultWorkerSelector(
            rng=random.Random(seed)), scrape_interval_s=3600.0)
    await router.start()
    while len(router.scheduler.endpoints.workers) < len(WORKERS):
        await asyncio.sleep(0.01)
    published, trace = 0, []
    try:
        for step in script(seed):
            kind = step[0]
            if kind == "serve":
                _, wid, toks = step
                if wid not in client.instances:
                    continue
                prefill(m["kv_cache"], allocs[wid], toks)
                published += await pubs[wid].publish_allocator_events(
                    allocs[wid].drain_events())
                while router.events_applied < published:
                    await asyncio.sleep(0.005)
            elif kind == "query":
                res = router.find_matches_for_tokens(step[1])
                worker = await router.schedule(step[1])
                trace.append((dict(sorted(res.scores.items())), worker))
                if decisions is not None:
                    decisions.append((len(step[1]), router.decisions[-1]))
            elif kind == "drain":
                await served[step[1]].mark_draining()
                while step[1] not in client.draining_ids():
                    await asyncio.sleep(0.005)
                trace.append(("draining", step[1]))
            elif kind == "remove":
                await served[step[1]].shutdown()
                while step[1] in client.instances:
                    await asyncio.sleep(0.005)
                trace.append(("removed", step[1],
                              sorted(router.scheduler.endpoints.workers)))
    finally:
        await router.stop()
        for rt in rts:
            await rt.shutdown()
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_router_decisions_equal(seed):
    async def both():
        return (await _router_trace("jax", seed),
                await _router_trace("torch", seed))
    want, got = asyncio.run(asyncio.wait_for(both(), 60))
    assert got == want
    decisions = [t for t in want if t[0] not in ("draining", "removed")]
    # overlap decided some picks, load others; the drained and the removed
    # worker took no decision after their step
    assert any(scores for scores, _ in decisions)
    assert {w for _, w in decisions} >= {"w0", "w1"}
    i_drain = want.index(("draining", "w2"))
    assert all(t[1] != "w2" for t in want[i_drain + 1:]
               if t[0] not in ("draining", "removed"))


def test_router_hashes_match_worker_hashes():
    """The port's router computes, from query tokens, the tokens_hash the
    port's allocator stored for the same page (and no JAX hash)."""
    from dynamo_tpu.kv_router.protocols import (
        compute_page_hashes as jax_hashes,
    )
    from dynamo_tpu_torch.engine.kv_cache import PageAllocator
    from dynamo_tpu_torch.kv_router.protocols import compute_page_hashes
    from dynamo_tpu_torch.engine import kv_cache
    toks = [int(t) for t in np.random.default_rng(5).integers(3, 250, 18)]
    alloc = PageAllocator(NUM_PAGES, PAGE)
    prefill(kv_cache, alloc, toks)
    stored = [ev[4] for ev in alloc.drain_events() if ev[0] == "stored"]
    assert stored == compute_page_hashes(toks, PAGE)
    assert len(stored) == len(toks) // PAGE
    assert not set(stored) & set(jax_hashes(toks, PAGE))


# -- the decision log's selector terms ----------------------------------------

def _reference_logit(c: dict) -> float:
    """The JAX selector's formula (dynamo_tpu/kv_router/scheduler.py
    DefaultWorkerSelector) on one candidate's recorded terms."""
    from dynamo_tpu.kv_router.scheduler import DefaultWorkerSelector
    w = DefaultWorkerSelector().overlap_weight
    return w * c["overlap"] - c["kv_usage"] - c["active"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decision_terms_reproduce_the_winner(seed):
    """Every decision of the router trace records each candidate's terms
    as the selector computed them; the reference's formula on those terms
    gives the recorded logit, and the winner is a candidate of the highest
    logit. The snapshot of each is the scrape's."""
    decisions = []
    asyncio.run(asyncio.wait_for(_router_trace("torch", seed, decisions),
                                 60))
    assert decisions
    for isl, d in decisions:
        cands = {c["worker_id"]: c for c in d["candidates"]}
        assert d["worker_id"] in cands
        for wid, c in cands.items():
            assert c["matched_blocks"] == d["scores"].get(wid, 0)
            assert c["overlap"] == c["matched_blocks"] * PAGE / max(isl, 1)
            assert 0.0 <= c["kv_usage"] and 0.0 <= c["active"]
            assert c["logit"] == pytest.approx(_reference_logit(c),
                                               rel=0, abs=1e-12)
            assert c["snapshot"] == "scraped"
        best = max(_reference_logit(c) for c in cands.values())
        assert _reference_logit(cands[d["worker_id"]]) == pytest.approx(
            best, rel=0, abs=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_selector_terms_match_the_reference_selector(seed):
    """On the same snapshot and overlap, the port's recorded terms equal
    the reference formula on the raw inputs, and the JAX selector picks
    the same worker (no ties: distinct random loads)."""
    from dynamo_tpu.kv_router import indexer as jidx, scheduler as jsch
    from dynamo_tpu.kv_router import scoring as jsc
    from dynamo_tpu_torch.kv_router import indexer as tidx
    from dynamo_tpu_torch.kv_router import scheduler as tsch
    from dynamo_tpu_torch.kv_router import scoring as tsc
    rng = np.random.default_rng(seed)
    raw = {f"w{i}": {"request_active_slots": int(rng.integers(0, 8)),
                     "request_total_slots": 8,
                     "kv_active_blocks": int(rng.integers(0, 500)),
                     "kv_total_blocks": 512} for i in range(4)}
    scores = {f"w{i}": int(rng.integers(0, 12)) for i in range(4)
              if rng.random() < 0.7}
    isl = 64
    sel = tsch.DefaultWorkerSelector(rng=random.Random(seed)).select_worker(
        tsc.ProcessedEndpoints({w: tsc.WorkerMetrics(**m)
                                for w, m in raw.items()}),
        tsch.SchedulingRequest(isl, tidx.MatchResult(dict(scores))), PAGE)
    want = jsch.DefaultWorkerSelector(rng=random.Random(seed)).select_worker(
        jsc.ProcessedEndpoints({w: jsc.WorkerMetrics(**m)
                                for w, m in raw.items()}),
        jsch.SchedulingRequest(isl, jidx.MatchResult(dict(scores))), PAGE)
    assert sel.worker_id == want.worker_id
    assert [c["worker_id"] for c in sel.candidates] == list(raw)
    for c in sel.candidates:
        m = raw[c["worker_id"]]
        assert c["overlap"] == scores.get(c["worker_id"], 0) * PAGE / isl
        assert c["kv_usage"] == m["kv_active_blocks"] / m["kv_total_blocks"]
        assert c["active"] == (m["request_active_slots"]
                               / m["request_total_slots"])
        assert c["logit"] == _reference_logit(c)


def test_aggregator_records_each_snapshot_source():
    """A worker whose stats came in this scrape is "scraped", one that
    missed it resumes from its last scrape ("carried"), one that never
    published gets unit totals ("defaulted")."""
    from dynamo_tpu_torch.kv_router.publisher import KvMetricsAggregator

    class Client:
        def __init__(self):
            self.stats = {}

        async def scrape_stats(self):
            return dict(self.stats)

        def instance_ids(self):
            return ["w0", "w1", "w2"]

    client = Client()
    agg = KvMetricsAggregator(client)
    client.stats = {"w0": METRICS["w0"], "w1": METRICS["w1"]}
    asyncio.run(agg.scrape_once())
    assert agg.snapshot_source == {"w0": "scraped", "w1": "scraped",
                                   "w2": "defaulted"}
    client.stats = {"w0": METRICS["w0"]}
    asyncio.run(agg.scrape_once())
    assert agg.snapshot_source == {"w0": "scraped", "w1": "carried",
                                   "w2": "defaulted"}
    assert agg.endpoints.workers["w1"].kv_active_blocks == 0
    assert agg.endpoints.workers["w2"].kv_total_blocks == 1


# -- the transfer-aware selector (JAX tests/test_kv_router.py:188-306) -------

def _sel_pkg(name: str) -> dict:
    if name == "jax":
        from dynamo_tpu.kv_router import indexer, scheduler, scoring, stats
        from dynamo_tpu.observability import fleet
    else:
        from dynamo_tpu_torch.kv_router import (
            indexer, scheduler, scoring, stats,
        )
        from dynamo_tpu_torch.observability import fleet
    return {"indexer": indexer, "scheduler": scheduler, "scoring": scoring,
            "stats": stats, "fleet": fleet}


JAX_STATS = ("transfer_scored", "cold_scored", "frozen_scored",
             "last_transfer_est_s", "last_transfer_bytes", "est_err_abs_frac",
             "pool_scored", "last_pool_fetch_blocks", "health_scored",
             "last_pick_health")


@pytest.fixture(autouse=True)
def _reset_router_state():
    """Both packages' process-global cost models, health scorers and
    router counters start each case empty."""
    for name in ("jax", "torch"):
        m = _sel_pkg(name)
        m["fleet"].TRANSFER_MODEL.reset()
        m["stats"].ROUTER_STATS.reset()
    from dynamo_tpu.runtime.health import HEALTH as JH
    from dynamo_tpu_torch.runtime.health import HEALTH as TH
    JH.reset()
    TH.reset()
    yield
    for name in ("jax", "torch"):
        _sel_pkg(name)["fleet"].TRANSFER_MODEL.reset()


def set_block_bytes(sel, nbytes):
    """The page bytes a selector charges for a worker that reports no
    kv_page_bytes: a JAX constructor option, the port's class constant
    (set on this instance)."""
    if hasattr(sel, "DEFAULT_BLOCK_BYTES"):
        sel.DEFAULT_BLOCK_BYTES = nbytes
    else:
        sel.default_block_bytes = nbytes


class SelectorCase:
    """One package's KvScheduler over a TransferAwareSelector with a
    private seeded cost model (the JAX test's helpers)."""

    def __init__(self, name, bw, block_size=16, block_bytes=1 << 20,
                 **kw):
        self.m = m = _sel_pkg(name)
        self.model = m["fleet"].TransferCostModel()
        for link, bytes_per_s in bw.items():
            self.model.observe(link, int(bytes_per_s), 1.0)
        kw.setdefault("rng", random.Random(0))
        self.sel = m["scheduler"].TransferAwareSelector(
            cost_model=self.model, **kw)
        set_block_bytes(self.sel, block_bytes)
        self.sched = m["scheduler"].KvScheduler(block_size=block_size,
                                                selector=self.sel)

    def endpoints(self, **workers):
        sc = self.m["scoring"]
        self.sched.update_endpoints(sc.ProcessedEndpoints({
            w: sc.WorkerMetrics(**kw) for w, kw in workers.items()}))

    def schedule(self, isl, scores=None, **kw):
        out = self.sched.schedule(
            isl, self.m["indexer"].MatchResult(scores=dict(scores or {})),
            **kw)
        return getattr(out, "worker_id", out)

    def stats(self):
        snap = self.m["stats"].ROUTER_STATS.snapshot()
        return {k: snap[k] for k in JAX_STATS}


def _both_selectors(script):
    """script(case) -> result on each package; results, last components
    and the JAX router counters must be equal. Returns the port's case
    and result."""
    out = {}
    for name in ("jax", "torch"):
        _sel_pkg(name)["stats"].ROUTER_STATS.reset()
        case, res = script(name)
        out[name] = (case, res, case.sel.last_components,
                     case.sel.last_pick, case.stats())
    (_, jres, jcomp, jpick, jst), (tcase, tres, tcomp, tpick, tst) = \
        out["jax"], out["torch"]
    assert tres == jres
    assert tcomp == jcomp
    assert tpick == jpick
    assert tst == jst
    return tcase, tres


LOAD = dict(request_total_slots=8, kv_total_blocks=100)


def test_transfer_slow_link_loses_at_equal_overlap_and_load():
    def script(name):
        c = SelectorCase(name, dict(fast=1 << 30, slow=1 << 22))
        c.endpoints(fast=LOAD, slow=LOAD)
        return c, c.schedule(160)
    c, pick = _both_selectors(script)
    assert pick == "fast"
    comps = c.sel.last_components
    assert comps["slow"]["transfer_s"] > comps["fast"]["transfer_s"]
    assert not comps["fast"]["cold"] and not comps["slow"]["cold"]


def test_transfer_overlap_shrinks_bytes_to_move():
    def script(name):
        c = SelectorCase(name, dict(warm=1 << 28, cold_w=1 << 28))
        c.endpoints(warm=LOAD, cold_w=LOAD)
        return c, c.schedule(160, {"warm": 8})
    c, pick = _both_selectors(script)
    assert pick == "warm"
    comps = c.sel.last_components
    assert comps["warm"]["transfer_bytes"] < comps["cold_w"]["transfer_bytes"]


def test_transfer_cold_link_neither_free_nor_infinite():
    def script(name):
        c = SelectorCase(name, dict(measured=1 << 24))
        c.endpoints(measured=LOAD, never_seen=LOAD)
        return c, c.schedule(160)
    c, _ = _both_selectors(script)
    comp = c.sel.last_components["never_seen"]
    assert comp["cold"] is True
    assert 0.0 < comp["transfer_s"] < float("inf")
    assert comp["transfer_s"] == pytest.approx(
        c.sel.last_components["measured"]["transfer_s"])
    assert comp["transfer_norm"] <= c.sel.MAX_PENALTY
    assert c.stats()["cold_scored"] >= 1


def test_transfer_degraded_freeze_pins_cost_term():
    def script(name):
        c = SelectorCase(name, dict(a=1 << 30, b=1 << 30))
        c.endpoints(a=LOAD, b=LOAD)
        c.schedule(160)
        live_a = c.sel.last_components["a"]["transfer_s"]
        c.sel.freeze_cost(True)
        for _ in range(8):
            c.model.observe("a", 1 << 10, 1.0)
        c.schedule(160)
        frozen = dict(c.sel.last_components["a"])
        c.sel.freeze_cost(False)
        c.schedule(160)
        return c, (live_a, frozen)
    c, (live_a, frozen) = _both_selectors(script)
    assert frozen["frozen"] is True
    assert frozen["transfer_s"] == pytest.approx(live_a)
    thawed = c.sel.last_components["a"]
    assert thawed["frozen"] is False
    assert thawed["transfer_s"] > live_a


def test_transfer_router_stats_and_components_exposed():
    def script(name):
        c = SelectorCase(name, dict(w1=1 << 28))
        c.endpoints(w1=LOAD)
        return c, c.schedule(64)
    c, _ = _both_selectors(script)
    assert c.stats()["transfer_scored"] == 1
    assert c.sel.last_pick["worker_id"] == "w1"
    for key in ("overlap", "kv_usage", "active", "transfer_s",
                "transfer_norm", "cold", "frozen", "logit"):
        assert key in c.sel.last_pick


def _fleet(seed: int):
    """A seeded fleet: 4 workers with distinct loads (no ties), some
    measured links, llama3-8b's 8 MiB pages or tiny pages, overlaps."""
    rng = np.random.default_rng(seed)
    active = rng.permutation(400)[:4]
    page = int(rng.choice([8 << 20, 64 << 10, 0]))
    workers = {f"w{i}": dict(request_active_slots=int(rng.integers(0, 8)),
                             request_total_slots=8,
                             kv_active_blocks=int(active[i]),
                             kv_total_blocks=512, kv_page_bytes=page)
               for i in range(4)}
    bw = {f"w{i}": float(rng.choice([1e8, 1e9, 1e10]))
          for i in range(4) if rng.random() < 0.5}
    scores = {f"w{i}": int(rng.integers(0, 17)) for i in range(4)
              if rng.random() < 0.6}
    return workers, bw, scores, rng


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("variant", ["plain", "pool", "qos", "frozen",
                                     "health"])
def test_transfer_components_equal_jax_on_seeded_fleets(seed, variant):
    """The selector's components equal the JAX selector's on seeded fleets
    with and without a pool depth, QoS weights, a frozen cost and a
    degraded worker's health."""
    workers, bw, scores, rng = _fleet(seed)
    pool = int(rng.integers(1, 17)) if variant == "pool" else 0
    qos = [("batch", 0.5), ("interactive", 2.0)][seed % 2] \
        if variant == "qos" else ("", 1.0)
    health = {"w1": 0.4} if variant == "health" else {}

    def script(name):
        c = SelectorCase(name, bw, block_size=64,
                         health_of=lambda w: health.get(w, 1.0),
                         block_bytes=64 << 10)
        c.endpoints(**workers)
        picks = [c.schedule(1088, scores, pool_matched=pool, qos=qos[0],
                            qos_weight=qos[1])]
        if variant == "frozen":
            c.sel.freeze_cost(True)
            c.model.observe("w0", 1 << 10, 1.0)
            picks.append(c.schedule(1088, scores))
        return c, picks
    c, _ = _both_selectors(script)
    assert len(c.sel.last_components) == 4
    if variant == "frozen":
        assert all(v["frozen"] for v in c.sel.last_components.values())


# -- the fault: the default router is the JAX default router -----------------

AB_PAGE = 64
AB_PAGE_BYTES = 64 * 32 * 8 * 128 * 2 * 2     # llama3-8b bf16: 8 MiB


def _fill_pages(kv_cache, alloc, tokens, page):
    parent, pages = 0, []
    for i in range(len(tokens) // page):
        chunk = tokens[i * page:(i + 1) * page]
        pid = alloc.allocate()
        parent = alloc.seal(pid, parent, chunk)
        pages.append(pid)
    for pid in pages:
        alloc.free(pid)


async def _default_router_picks(pkg: str, fleets: list) -> list:
    """For each (workers' $STATS, {worker: held prefix tokens}, query,
    qos) a fresh plane, workers that publish their held pages, and a
    KvRouter with NO selector argument: the package's default. Returns
    each decision's worker and the selector's components."""
    m = _pkg(pkg)
    DRT = m["distributed"].DistributedRuntime
    out = []
    for stats, held, query, qos in fleets:
        plane = m["memory"].MemoryPlane()
        rts, comps = [], {}
        for wid, st in stats.items():
            rt = await DRT.create_local(plane, wid)
            rts.append(rt)
            comps[wid] = rt.namespace("ns").component("w")

            async def engine(request, context):
                yield {}
            await comps[wid].endpoint("gen").serve(
                engine, stats_handler=lambda st=st: dict(st))
        frt = await DRT.create_local(plane, "frontend")
        rts.append(frt)
        fcomp = frt.namespace("ns").component("w")
        client = fcomp.endpoint("gen").client()
        await client.start()
        router = m["router"].KvRouter(fcomp, client, AB_PAGE,
                                      scrape_interval_s=3600.0)
        await router.start()
        try:
            published = 0
            for wid, toks in held.items():
                if len(toks) < AB_PAGE:
                    continue
                alloc = m["kv_cache"].PageAllocator(64, AB_PAGE)
                _fill_pages(m["kv_cache"], alloc, toks, AB_PAGE)
                pub = m["publisher"].KvEventPublisher(comps[wid], wid)
                published += await pub.publish_allocator_events(
                    alloc.drain_events())
            while len(router.scheduler.endpoints.workers) < len(stats) \
                    or router.events_applied < published:
                await asyncio.sleep(0.005)
            kw = {"qos": qos} if qos else {}
            wid = await router.schedule(query, **kw)
            out.append((wid, router.last_score_components))
        finally:
            await router.stop()
            for rt in rts:
                await rt.shutdown()
    return out


def _ab_case():
    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(3, 30000, 1088)]
    stats = {"A": dict(request_active_slots=4, request_total_slots=8,
                       kv_active_blocks=0, kv_total_blocks=1000,
                       kv_page_bytes=AB_PAGE_BYTES),
             "B": dict(request_active_slots=0, request_total_slots=8,
                       kv_active_blocks=0, kv_total_blocks=1000,
                       kv_page_bytes=AB_PAGE_BYTES)}
    return stats, {"A": prompt[:4 * AB_PAGE]}, prompt, ""


def _seeded_fleet(seed: int):
    rng = np.random.default_rng(100 + seed)
    docs = [[int(t) for t in rng.integers(3, 30000, 1600)]
            for _ in range(2)]
    busy = rng.permutation(8)[:3]
    kv = rng.permutation(900)[:3]
    stats = {f"w{i}": dict(request_active_slots=int(busy[i]),
                           request_total_slots=8,
                           kv_active_blocks=int(kv[i]),
                           kv_total_blocks=1000,
                           kv_page_bytes=AB_PAGE_BYTES)
             for i in range(3)}
    held = {f"w{i}": docs[int(rng.integers(0, 2))][
        :AB_PAGE * int(rng.integers(0, 12))] for i in range(3)}
    q = docs[int(rng.integers(0, 2))][:int(rng.integers(200, 1600))]
    qos = ["", "interactive", "batch", "standard"][seed % 4]
    return stats, held, q, qos


def test_default_router_picks_the_jax_default_routers_worker():
    """The A/B case: llama3-8b pages of 8 MiB, a 1088-token prompt, A
    holds 4 of its pages with 4 of 8 slots busy, B is idle. The JAX
    default router (TransferAwareSelector) picks A (logits A -0.4656, B
    -0.5704); the prefix-and-load formula alone would pick B. The port's
    default router must pick A with the same components. Then seeded
    fleets with QoS classes."""
    fleets = [_ab_case()] + [_seeded_fleet(s) for s in range(6)]

    async def go():
        return (await _default_router_picks("jax", fleets),
                await _default_router_picks("torch", fleets))
    want, got = asyncio.run(asyncio.wait_for(go(), 120))
    assert got == want
    wid, comps = got[0]
    assert wid == "A"
    assert comps["A"]["logit"] == -0.4656 and comps["B"]["logit"] == -0.5704
    # the prefix-and-load formula alone ranks B first on these inputs
    assert (2 * comps["A"]["overlap"] - comps["A"]["kv_usage"]
            - comps["A"]["active"]) < (2 * comps["B"]["overlap"]
                                       - comps["B"]["kv_usage"]
                                       - comps["B"]["active"])
    assert all(c["cold"] for c in comps.values())
    assert {q for _, _, _, q in fleets[1:]} >= {"interactive", "batch"}
    assert {c["qos"] for _, cs in got[1:] for c in cs.values()} \
        >= {"interactive", "batch", "standard"}


# -- the standalone router service (kv_router/main.py) -----------------------

async def _router_service_replies(pkg: str) -> tuple:
    """Two workers, one holding a 3-page prefix (its allocator's events on
    the event plane), the package's RouterService, and `route` queries over
    the request plane: the replies and the kv-hit-rate events published."""
    m = _pkg(pkg)
    if pkg == "jax":
        from dynamo_tpu.kv_router.main import RouterService
    else:
        from dynamo_tpu_torch.kv_router.main import RouterService
    DRT = m["distributed"].DistributedRuntime
    plane = m["memory"].MemoryPlane()
    rts = []

    async def fake_worker(request, context):
        yield {"ok": True}
    for wid in ("w0", "w1"):
        rt = await DRT.create_local(plane, wid)
        await rt.namespace("ns").component("worker").endpoint(
            "generate").serve(fake_worker, stats_handler=lambda: {
                "request_active_slots": 0, "request_total_slots": 4,
                "kv_active_blocks": 0, "kv_total_blocks": 16})
        rts.append(rt)
    rrt = await DRT.create_local(plane, "router")
    rts.append(rrt)
    svc = RouterService(rrt, "ns", "worker", block_size=4)
    await svc.start()
    hits = await rrt.namespace("ns").component("worker").subscribe(
        "kv-hit-rate")
    try:
        tokens = list(range(1, 13))
        alloc = m["kv_cache"].PageAllocator(8, 4)
        _fill_pages(m["kv_cache"], alloc, tokens, 4)
        pub = m["publisher"].KvEventPublisher(
            rts[1].namespace("ns").component("worker"), "w1")
        n = await pub.publish_allocator_events(alloc.drain_events())
        while svc.router.events_applied < n \
                or len(svc.router.scheduler.endpoints.workers) < 2:
            await asyncio.sleep(0.005)
        crt = await DRT.create_local(plane, "client")
        rts.append(crt)
        client = crt.namespace("ns").component("router").endpoint(
            "route").client()
        await client.start()
        await client.wait_for_instances()
        replies = []
        for req in ({"token_ids": tokens}, {"token_ids": tokens[:8]},
                    {"token_ids": list(range(50, 60))}, {}):
            replies.append([f async for f in await client.generate(req)])
        # (subject, decoded payload) items
        events = [(await asyncio.wait_for(hits.__anext__(), 5))[-1]
                  for _ in range(3)]
        return replies, events
    finally:
        await svc.stop()
        for rt in rts:
            await rt.shutdown()


def test_router_service_replies_equal_jax():
    async def go():
        return (await _router_service_replies("jax"),
                await _router_service_replies("torch"))
    (jrep, jev), (rep, ev) = asyncio.run(asyncio.wait_for(go(), 60))
    assert rep == jrep
    assert rep[0][0]["worker_id"] == "w1"
    assert rep[0][0]["overlap_blocks"] == 3
    assert rep[3] == [{"error": "token_ids required"}]
    assert ev == jev
    assert ev[0]["isl_blocks"] == 3 and ev[0]["overlap_blocks"] == 3


# -- the hash-sharded indexer (JAX indexer.py:327-383) --------------------------

def _stored_ev(protocols, worker, blocks, eid=0):
    return protocols.RouterEvent(worker, protocols.KvCacheEvent(
        eid, protocols.KvCacheStoreData(parent_hash=None, blocks=[
            protocols.KvCacheStoredBlockData(b, t) for b, t in blocks])))


def _indexers(**kw):
    """(JAX KvIndexerSharded, port KvIndexerSharded) and the two
    packages' protocols."""
    from dynamo_tpu.kv_router import indexer as jidx
    from dynamo_tpu.kv_router import protocols as jp
    from dynamo_tpu_torch.kv_router import indexer as tidx
    from dynamo_tpu_torch.kv_router import protocols as tp
    return jidx, tidx, jp, tp


def test_sharded_matches_unsharded():
    """JAX tests/test_kv_router.py:118 on both packages: the same seeded
    stored events through each package's KvIndexerSharded (3 shards) and
    the port's unsharded KvIndexer give the same per-worker scores, before
    and after a worker's removal. The shard a worker lands in differs
    (BLAKE2b in the port, xxh3 in JAX); the merged scores do not."""
    jidx, tidx, jp, tp = _indexers()
    idx = tidx.KvIndexer(block_size=2)
    jsh = jidx.KvIndexerSharded(block_size=2, num_shards=3)
    tsh = tidx.KvIndexerSharded(block_size=2, num_shards=3)
    rng = random.Random(0)
    workers = [f"w{i}" for i in range(8)]
    for eid in range(200):
        w = rng.choice(workers)
        chain = [(rng.randrange(1 << 30), rng.randrange(8))
                 for _ in range(rng.randrange(1, 4))]
        idx.apply_event(_stored_ev(tp, w, chain, eid))
        tsh.apply_event(_stored_ev(tp, w, chain, eid))
        jsh.apply_event(_stored_ev(jp, w, chain, eid))
    for phase in range(2):
        for _ in range(50 if phase == 0 else 20):
            q = [rng.randrange(8) for _ in range(rng.randrange(1, 5))]
            want = jsh.find_matches(q).scores
            assert tsh.find_matches(q).scores == want
            assert idx.find_matches(q).scores == want
        for x in (idx, jsh, tsh):
            x.remove_worker("w3")
    # node counts depend on placement (a prefix shared by workers of two
    # shards is a node in each), so they are not compared
    placement = {w: tsh.shards.index(tsh._shard_for(w)) for w in workers}
    assert len(set(placement.values())) > 1


def test_sharded_merges_frequencies():
    """JAX tests/test_kv_router.py:346 on both packages: with frequency
    tracking (the Python tree in every shard) the merged result carries
    both workers and the per-depth use counts summed over the shards. Each
    shard counts its own walk, so the sum depends on placement: the two
    workers are picked so that they sit in different shards in both
    packages, and then the results are equal."""
    jidx, tidx, jp, tp = _indexers()
    shs = [(jidx.KvIndexerSharded(block_size=4, num_shards=2,
                                  expiration_duration_s=60.0), jp),
           (tidx.KvIndexerSharded(block_size=4, num_shards=2,
                                  expiration_duration_s=60.0), tp)]
    names = [f"w{i}" for i in range(64)]

    def apart(a, b):
        return all(sh._shard_for(a) is not sh._shard_for(b)
                   for sh, _ in shs)
    wa, wb = next((a, b) for a in names for b in names if apart(a, b))
    out = []
    for sh, proto in shs:
        sh.apply_event(_stored_ev(proto, wa, [(101, 1)]))
        sh.apply_event(_stored_ev(proto, wb, [(201, 1)]))
        sh.apply_event(_stored_ev(proto, wa, [(102, 1), (103, 2)]))
        res = [sh.find_matches([1, 2]) for _ in range(3)]
        out.append([(r.scores, r.frequencies) for r in res])
    assert out[0] == out[1]
    scores, freqs = out[1][-1]
    assert scores == {wa: 2, wb: 1}
    assert freqs and freqs[0] >= 2
    from dynamo_tpu_torch.kv_router.indexer import RadixTree
    assert all(isinstance(s.tree, RadixTree) for s in shs[1][0].shards)


def test_sharded_parity_under_interleaved_churn():
    """JAX tests/test_kv_router.py:577 on both packages: under interleaved
    apply_event / remove_worker / revive_worker churn, including while
    evictions are mid-backlog, the port's sharded indexer answers as the
    JAX one and as an unsharded Python-tree KvIndexer do."""
    jidx, tidx, jp, tp = _indexers()
    idx = tidx.KvIndexer(block_size=2, native=False)
    jsh = jidx.KvIndexerSharded(block_size=2, num_shards=3)
    tsh = tidx.KvIndexerSharded(block_size=2, num_shards=3)
    rng = random.Random(7)
    workers = [f"w{i}" for i in range(6)]
    for eid in range(600):
        op = rng.random()
        w = rng.choice(workers)
        if op < 0.70:
            chain = [(rng.randrange(1 << 30), rng.randrange(16))
                     for _ in range(rng.randrange(1, 4))]
            idx.apply_event(_stored_ev(tp, w, chain, eid))
            tsh.apply_event(_stored_ev(tp, w, chain, eid))
            jsh.apply_event(_stored_ev(jp, w, chain, eid))
        elif op < 0.85:
            for x in (idx, jsh, tsh):
                x.remove_worker(w)
        else:
            for x in (idx, jsh, tsh):
                x.revive_worker(w)
        if eid % 20 == 0:
            for _ in range(10):
                q = [rng.randrange(16) for _ in range(3)]
                want = jsh.find_matches(q).scores
                assert tsh.find_matches(q).scores == want, (eid, q)
                assert idx.find_matches(q).scores == want, (eid, q)
    for x in (idx, jsh, tsh):
        x.process_evictions(1 << 30)
    assert tsh.eviction_backlog() == jsh.eviction_backlog() == 0
    for _ in range(50):
        q = [rng.randrange(16) for _ in range(4)]
        want = jsh.find_matches(q).scores
        assert tsh.find_matches(q).scores == want
        assert idx.find_matches(q).scores == want
