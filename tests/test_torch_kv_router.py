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
