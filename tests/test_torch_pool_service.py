"""The port's cross-host KV pool service (dynamo_tpu_torch/engine/
pool_service.py, runtime/placement.py) against the JAX package's (every
case of tests/test_pool_service.py, held to the reference).

Each case runs on both packages with the same inputs and compares what
they return: ring owners for the same integer keys (both rings place by
BLAKE2b), moved-key counts, membership events, publish / fetch results,
fencing counters (`REMOTE_STATS`, `RING_STATS`) and rebalance results. The
engine cases serve `tiny` in float32 with the JAX weights carried over by
`params_from_jax`, page 8, through a `ClusterKvPool` of in-process hosts:
streams are token-identical to the JAX all-local engine through failover,
and the pool counters match except where they follow which host owns a
page (the packages hash pages differently). Pages in the pure pool cases are the same
seeded arrays (numpy on the JAX side, torch on the port's).
"""
import asyncio
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import kv_pool as jkv_pool
from dynamo_tpu.engine import pool_service as jpool_service
from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.kv_cache import page_hash as jpage_hash
from dynamo_tpu.engine.scheduler import SamplingParams as JSamplingParams
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import placement as jplacement
from dynamo_tpu.runtime.integrity import STATS as JINTEGRITY
from dynamo_tpu_torch.engine import kv_pool as tkv_pool
from dynamo_tpu_torch.engine import pool_service as tpool_service
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
from dynamo_tpu_torch.runtime import placement as tplacement
from dynamo_tpu_torch.runtime.integrity import STATS as TINTEGRITY

torch.set_num_threads(1)

PAGE = 8
PROMPT = list(range(10, 42))   # 4 pages; the walk matches the 3 full ones
GREEDY = dict(max_tokens=4, temperature=0.0, ignore_eos=True)
SAMPLED = dict(max_tokens=4, temperature=0.9, top_k=8, seed=1234,
               ignore_eos=True)
EKW = dict(page_size=PAGE, num_pages=32, max_slots=2, max_prefill_chunk=32,
           prefill_buckets=(8, 16, 32), max_model_len=256)


class Pkg(SimpleNamespace):
    """One package's pool-service modules under one interface."""

    def engine(self, pool=None, wid="", kv_quant=""):
        kw = dict(EKW, kv_quant=kv_quant)
        if self.name == "jax":
            eng = JNativeEngine(JModelConfig(dtype="float32",
                                             max_model_len=256,
                                             decode_kernel="off"),
                                JEngineConfig(**kw), params=self.params,
                                seed=0)
        else:
            eng = TNativeEngine(TModelConfig(dtype="float32",
                                             max_model_len=256),
                                TEngineConfig(**kw), params=self.params,
                                device="cpu")
        if pool is not None:
            eng.attach_kv_pool(pool, wid or "w")
        return eng

    def gen(self, eng, prompt, rid, params):
        return eng.generate(prompt, self.sp(**params), rid)

    def arrays(self, *arrs):
        return tuple(a if self.name == "jax" else torch.from_numpy(a.copy())
                     for a in arrs)

    def page_arrays(self, seed=0, shape=(2, 2, 2, 4)):
        rng = np.random.default_rng(seed)
        return self.arrays(rng.standard_normal(shape).astype(np.float32),
                           rng.standard_normal(shape).astype(np.float32))

    def arm(self, site, *specs, seed=0):
        self.faults.REGISTRY.arm(site, self.faults.FaultSchedule(
            seed, [self.faults.FaultSpec(*a, **k) for a, k in specs]))

    def make_cluster(self, n_hosts=3, replicas=2, capacity_pages=64,
                     disk_capacity_pages=0, tmpdir=None):
        ps = self.ps
        cl = ps.ClusterKvPool(replicas=replicas)
        for i in range(n_hosts):
            hid = f"ph{i}"
            cl.add_host(ps.KvPoolHost(
                hid, capacity_pages=capacity_pages,
                disk_capacity_pages=disk_capacity_pages,
                disk_dir=f"{tmpdir}/{self.name}/{hid}" if tmpdir else None))
        cl.run_rebalance()   # drain the join enqueues (nothing resident)
        return cl

    def seeded_cluster(self, kv_quant="", **kw):
        cl = self.make_cluster(**kw)
        a = self.engine(cl, "A", kv_quant=kv_quant)
        self.gen(a, PROMPT, "seed-a", GREEDY)
        a.drain_kv_events()
        a._pool_stream.drain()
        a.close()
        return cl

    def publish_n(self, cl, n, source="w1"):
        hashes = []
        for i in range(n):
            sh = 0x1000 + i
            assert cl.publish(source, sh, 0, i, self.page_arrays(i)) == "new"
            hashes.append(sh)
        return hashes

    def reset(self):
        self.faults.REGISTRY.disarm()
        self.faults.REGISTRY.reset_counters()
        self.integrity.__init__()
        self.kv.POOL_STATS.reset()
        self.ps.REMOTE_STATS.reset()
        self.ps.RING_STATS.reset()

    def counters(self):
        return (self.ps.REMOTE_STATS.snapshot(), self.ps.RING_STATS.snapshot(),
                self.kv.POOL_STATS.snapshot(),
                {k: getattr(self.integrity, k) for k in
                 ("mismatches", "quarantined")})


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JModelConfig(dtype="float32", max_model_len=256,
                                     decode_kernel="off"),
                        JEngineConfig(**EKW), seed=0)
    return jax.device_get(eng.params)


@pytest.fixture(scope="module")
def pkgs(jax_params):
    tcfg = TModelConfig(dtype="float32", max_model_len=256)
    return (Pkg(name="jax", params=jax_params, pl=jplacement,
                ps=jpool_service, kv=jkv_pool, faults=jfaults,
                integrity=JINTEGRITY, page_hash=jpage_hash,
                sp=JSamplingParams),
            Pkg(name="torch", params=params_from_jax(jax_params, tcfg, "cpu"),
                pl=tplacement, ps=tpool_service, kv=tkv_pool, faults=tfaults,
                integrity=TINTEGRITY, page_hash=tpage_hash,
                sp=TSamplingParams))


@pytest.fixture(autouse=True)
def clean_state(pkgs):
    for p in pkgs:
        p.reset()
    yield
    for p in pkgs:
        p.reset()


def both(pkgs, case, counters=True):
    """case(pkg) on the JAX package, then the port, each from clean
    counters; asserts equal results (and, with `counters`, equal pool
    counters) and returns the port's result. Page placement depends on the
    page hashes, which the packages compute differently (xxh3, BLAKE2b), so
    an engine case whose counts follow the placement compares results
    only."""
    out = []
    for p in pkgs:
        p.reset()
        out.append((case(p), p.counters() if counters else None))
    assert out[1] == out[0]
    return out[1][0]


# -- placement ring -------------------------------------------------------------

def test_ring_determinism_across_instances(pkgs):
    """Same membership in any insertion order -> the same owners, in both
    packages."""
    def case(p):
        r1, r2 = p.pl.HashRing(vnodes=32), p.pl.HashRing(vnodes=32)
        for h in ("a", "b", "c"):
            r1.add(h)
        for h in ("c", "a", "b"):
            r2.add(h)
        owners = [r1.owners_for(k) for k in range(500)]
        assert owners == [r2.owners_for(k) for k in range(500)]
        assert r1.owners_for(123) == r1.owners_for(123)
        return owners
    both(pkgs, case)


def test_ring_replicas_distinct_and_bounded_by_membership(pkgs):
    def case(p):
        r = p.pl.HashRing(vnodes=16, replicas=3)
        r.add("a")
        out = [r.owners_for(7)]
        assert out[0] == ["a"]
        r.add("b"); r.add("c"); r.add("d")
        for k in range(200):
            owners = r.owners_for(k)
            assert len(owners) == 3 == len(set(owners))
            out.append(owners)
        assert r.owners_for(5, r=1)[0] == r.owners_for(5)[0]
        return out
    both(pkgs, case)


def test_ring_balance_bound(pkgs):
    def case(p):
        r = p.pl.HashRing(vnodes=64)
        for h in ("a", "b", "c", "d"):
            r.add(h)
        counts = {h: 0 for h in ("a", "b", "c", "d")}
        for k in range(4000):
            counts[r.lookup(k)] += 1
        for h, c in counts.items():
            assert 0.5 * 1000 < c < 2.0 * 1000, (h, counts)
        return counts
    both(pkgs, case)


def test_ring_minimal_movement_on_join(pkgs):
    def case(p):
        r = p.pl.HashRing(vnodes=64)
        for h in ("a", "b", "c"):
            r.add(h)
        before = {k: r.lookup(k) for k in range(3000)}
        epoch_before = r.epoch
        r.add("d")
        assert r.epoch == epoch_before + 1
        moved = sorted(k for k, h in before.items() if r.lookup(k) != h)
        assert len(moved) / 3000 < 0.40
        assert all(r.lookup(k) == "d" for k in moved)
        return moved
    both(pkgs, case)


def test_ring_epoch_bumps_on_every_membership_change(pkgs):
    def case(p):
        r = p.pl.HashRing()
        return [r.epoch, r.add("a"), r.epoch, r.add("a"), r.epoch,
                r.add("b"), r.epoch, r.remove("a"), r.epoch, r.remove("a"),
                r.epoch]
    assert both(pkgs, case) == [0, True, 1, False, 1, True, 2, True, 3,
                                False, 3]


def test_membership_watch_feed_joins_and_leaves_at_event_time(pkgs):
    def case(p):
        m = p.pl.PoolMembership()
        events = []
        m.on_change(lambda kind, host, epoch: events.append(
            (kind, host, epoch)))
        m.on_instance("put", p.pl.pool_host_instance_id("h1"), {})
        m.on_instance("put", "worker-7", {})     # not a pool host: ignored
        m.on_instance("put", p.pl.pool_host_instance_id("h2"), {})
        live = set(m.live_hosts())
        m.on_instance("delete", p.pl.pool_host_instance_id("h1"), {})
        return live, set(m.live_hosts()), events
    assert both(pkgs, case) == ({"h1", "h2"}, {"h2"},
                                [("join", "h1", 1), ("join", "h2", 2),
                                 ("leave", "h1", 3)])


# -- replica failover -------------------------------------------------------------

@pytest.mark.parametrize("params", [GREEDY, SAMPLED], ids=["greedy",
                                                            "sampled"])
def test_replica_failover_mid_fetch_token_identity(pkgs, params):
    """A pool host dies mid-fetch (page 2's first replica attempt, the
    watch delete not landed): the walk fails over at page granularity, every
    page still fetches, tokens equal the all-local engine's."""
    expect = pkgs[0].gen(pkgs[0].engine(), PROMPT, "o", params)

    def case(p):
        cl = p.seeded_cluster()
        p.arm("pool.remote_fetch", (("fail_n",), dict(n=1, skip=2)))
        b = p.engine(cl, "B")
        got = p.gen(b, PROMPT, "b", params)
        fetched = b.scheduler.pool_fetched_pages
        b.close()
        return got, fetched
    got, fetched = both(pkgs, case)
    assert got == expect and fetched == 3
    rs = tpool_service.REMOTE_STATS
    assert (rs.fetch_pages, rs.fetch_failovers, rs.fetch_exhausted) == \
        (3, 1, 0)


def test_dead_host_failover_whole_walk(pkgs):
    expect = pkgs[0].gen(pkgs[0].engine(), PROMPT, "o", GREEDY)

    def case(p):
        cl = p.seeded_cluster()
        h0 = p.page_hash(0, PROMPT[:PAGE])
        cl._hosts[cl.membership.owners_for(h0)[0]].kill()
        b = p.engine(cl, "B")
        out = p.gen(b, PROMPT, "b", GREEDY), b.scheduler.pool_fetched_pages
        b.close()
        return out
    # the packages hash pages differently (xxh3, BLAKE2b), so the killed
    # primary owns other pages and the failover counts differ
    assert both(pkgs, case, counters=False) == (expect, 3)
    assert tpool_service.REMOTE_STATS.fetch_failovers >= 1
    assert tpool_service.REMOTE_STATS.fetch_exhausted == 0


def test_all_replicas_exhausted_salvages_to_recompute(pkgs):
    expect = pkgs[0].gen(pkgs[0].engine(), PROMPT, "o", GREEDY)

    def case(p):
        cl = p.seeded_cluster()
        for h in list(cl._hosts.values()):
            h.kill()
        miss = cl.fetch(p.page_hash(0, PROMPT[:PAGE])) is None
        exhausted = p.ps.REMOTE_STATS.fetch_exhausted
        b = p.engine(cl, "B")
        out = (miss, exhausted, p.gen(b, PROMPT, "b", GREEDY),
               b.scheduler.pool_fetched_pages)
        b.close()
        return out
    assert both(pkgs, case) == (True, 1, expect, 0)


def test_rot_on_one_replica_quarantines_that_replica_only(pkgs):
    expect = pkgs[0].gen(pkgs[0].engine(), PROMPT, "o", GREEDY)

    def case(p):
        cl = p.seeded_cluster()
        h0 = p.page_hash(0, PROMPT[:PAGE])
        before = len(cl.owner_hosts(h0))
        p.arm("pool.remote_fetch", (("corrupt",), dict(p=1.0, n=1)))
        b = p.engine(cl, "B")
        got = p.gen(b, PROMPT, "b", GREEDY)
        p.faults.REGISTRY.disarm()
        out = (got, b.scheduler.pool_fetched_pages, before,
               len(cl.owner_hosts(h0)), h0 in cl)
        b.close()
        return out
    assert both(pkgs, case) == (expect, 3, 2, 1, True)
    assert tpool_service.REMOTE_STATS.fetch_failovers == 1
    assert TINTEGRITY.quarantined == 1


# -- epoch fencing ---------------------------------------------------------------

def test_ring_epoch_stale_write_fence(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        arr = p.page_arrays()
        stale = cl.membership.epoch
        host = cl._hosts[cl.membership.owners_for(0x42)[0]]
        cl.membership.join("late-joiner")
        r1 = host.publish_page("w1", 0x42, 0, 0x1, arr, ring_epoch=stale)
        landed = host.contains(0x42)
        r2 = host.publish_page("w1", 0x42, 0, 0x1, arr,
                               ring_epoch=cl.membership.epoch)
        return r1, landed, r2
    assert both(pkgs, case) == ("stale-epoch", False, "new")
    assert tpool_service.REMOTE_STATS.stale_epoch_rejected == 1
    assert tpool_service.REMOTE_STATS.stale_epoch_landed == 0


def test_cluster_publish_rechecks_epoch_per_publish(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=3)
        cl.membership.leave("ph2")
        return cl.publish("w1", 0x7, 0, 0x1, p.page_arrays()), 0x7 in cl
    assert both(pkgs, case) == ("new", True)
    assert tpool_service.REMOTE_STATS.stale_epoch_rejected == 0


# -- quorum publish ----------------------------------------------------------------

def test_quorum_1_publish_under_one_dead_owner(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        sh = 0x1234
        dead = cl.membership.owners_for(sh)[0]
        cl._hosts[dead].kill()
        r = cl.publish("w1", sh, 0, 0x9, p.page_arrays())
        served = cl.fetch(sh) is not None
        cl.kill_host(dead)
        return r, served, cl.run_rebalance()
    r, served, reb = both(pkgs, case)
    assert (r, served, reb["under_replicated"]) == ("new", True, 0)
    assert tpool_service.REMOTE_STATS.publish_quorum_degraded == 1


def test_publish_all_owners_unreachable_returns_unavailable(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        for h in cl._hosts.values():
            h.partition(True)
        return cl.publish("w1", 0x5, 0, 0x1, p.page_arrays()), 0x5 in cl
    assert both(pkgs, case) == ("unavailable", False)


def test_partitioned_host_fetch_fails_over_and_quorum_holds(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        sh = 0x777
        r = [cl.publish("w1", sh, 0, 0x1, p.page_arrays())]
        part = cl.membership.owners_for(sh)[0]
        cl.partition_host(part)
        r.append(cl.fetch(sh) is not None)
        r.append(p.ps.REMOTE_STATS.fetch_failovers)
        r.append(cl.publish("w1", 0x778, 0, 0x1, p.page_arrays(1)))
        r.append(cl.run_rebalance()["copied"])
        cl.partition_host(part, False)
        r.append(cl.fetch(sh) is not None)
        return r
    assert both(pkgs, case) == ["new", True, 1, "new", 0, True]
    assert tpool_service.REMOTE_STATS.publish_quorum_degraded >= 1


# -- rebalance conservation -------------------------------------------------------

def _converge(cl, budget, passes):
    results = []
    for _ in range(passes):
        results.append(cl.run_rebalance(budget=budget))
        if results[-1]["under_replicated"] == 0:
            break
    return results


def test_leave_rebalance_restores_replication(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=3)
        hashes = p.publish_n(cl, 24)
        cl.kill_host(cl.membership.live_hosts()[0])
        results = _converge(cl, 4, 20)
        for sh in hashes:
            assert len(cl.owner_hosts(sh)) >= 2, hex(sh)
            assert cl.fetch(sh) is not None
        return results
    both(pkgs, case)
    assert tpool_service.RING_STATS.under_replicated == 0
    assert tpool_service.RING_STATS.rebalanced_pages > 0


def test_join_rebalance_amortized_handoff(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        hashes = p.publish_n(cl, 24)
        newcomer = p.ps.KvPoolHost("ph-new", capacity_pages=64)
        cl.add_host(newcomer)
        results = _converge(cl, 6, 20)
        for sh in hashes:
            for hid in cl.membership.owners_for(sh):
                assert cl._hosts[hid].contains(sh), (hex(sh), hid)
        assert len(newcomer) > 0
        return results, len(newcomer)
    both(pkgs, case)


def test_rebalance_copy_faults_are_repaired_next_pass(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=3)
        hashes = p.publish_n(cl, 12)
        cl.kill_host(cl.membership.live_hosts()[-1])
        p.arm("pool.rebalance", (("drop",), dict(p=0.5)))
        results = _converge(cl, 8, 30)
        p.faults.REGISTRY.disarm()
        for sh in hashes:
            assert len(cl.owner_hosts(sh)) >= 2
        return results
    both(pkgs, case)
    assert tpool_service.REMOTE_STATS.stale_epoch_landed == 0


def test_membership_change_mid_rebalance_fences_inflight_copies(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=3)
        hashes = p.publish_n(cl, 10)
        cl.kill_host(cl.membership.live_hosts()[0])
        fired = {"done": False}
        originals = {}
        for h in cl._hosts.values():
            originals[h.host_id] = h.publish_page

            def hooked(*a, _orig=h.publish_page, **kw):
                if not fired["done"]:
                    fired["done"] = True
                    cl.membership.join("ghost")      # epoch bump mid-pass
                    cl.membership.leave("ghost")
                return _orig(*a, **kw)
            h.publish_page = hooked
        first = cl.run_rebalance(budget=100)
        assert fired["done"]
        assert p.ps.REMOTE_STATS.stale_epoch_rejected >= 1
        assert p.ps.REMOTE_STATS.stale_epoch_landed == 0
        for h in cl._hosts.values():
            h.publish_page = originals[h.host_id]
        results = _converge(cl, 100, 20)
        for sh in hashes:
            assert len(cl.owner_hosts(sh)) >= 2
            assert cl.fetch(sh) is not None
        return first, results
    both(pkgs, case)


# -- NVMe tier ---------------------------------------------------------------------

def test_disk_spill_and_promote_with_traveling_checksum(pkgs, tmp_path):
    def case(p):
        cl = p.make_cluster(n_hosts=1, replicas=1, capacity_pages=2,
                            disk_capacity_pages=8, tmpdir=str(tmp_path))
        hashes = p.publish_n(cl, 6)
        spills = p.ps.REMOTE_STATS.disk_spills
        return spills, [cl.fetch(sh) is not None for sh in hashes]
    spills, served = both(pkgs, case)
    assert spills >= 4 and all(served)
    assert tpool_service.REMOTE_STATS.disk_hits >= 4


def test_nvme_tier_rot_quarantine(pkgs, tmp_path):
    def case(p):
        cl = p.make_cluster(n_hosts=1, replicas=1, capacity_pages=2,
                            disk_capacity_pages=8, tmpdir=str(tmp_path))
        hashes = p.publish_n(cl, 5)
        spilled = [sh for sh in hashes if sh in cl._hosts["ph0"]._disk_meta]
        assert spilled
        p.arm("offload.read_tier", (("corrupt",), dict(p=1.0, n=1)))
        served = cl.fetch(spilled[0]) is not None
        p.faults.REGISTRY.disarm()
        return spilled, served, spilled[0] in cl
    spilled, served, still = both(pkgs, case)
    assert not served and not still
    assert tpool_service.REMOTE_STATS.disk_quarantined == 1
    assert TINTEGRITY.quarantined >= 1


def test_disk_tier_preserves_kv_quant_mode(pkgs, tmp_path):
    def case(p):
        cl = p.make_cluster(n_hosts=1, replicas=1, capacity_pages=1,
                            disk_capacity_pages=8, tmpdir=str(tmp_path))
        page = p.arrays(np.ones((2, 2, 2, 4), np.int8),
                        np.ones((2, 2, 2, 4), np.int8),
                        np.ones((2, 2, 2), np.float32),
                        np.ones((2, 2, 2), np.float32))
        r = [cl.publish("w1", 0xA, 0, 1, page, mode="int8"),
             cl.publish("w1", 0xB, 0, 2, page, mode="int8"),
             0xA in cl._hosts["ph0"]._disk_meta]
        with pytest.raises(p.kv.PoolQuantMismatch):
            cl._hosts["ph0"].fetch_page(0xA, mode="")
        got = cl.fetch(0xA, mode="int8")
        r.append(None if got is None else [a.dtype.__str__().split(".")[-1]
                                           for a in got])
        return r
    assert both(pkgs, case) == ["new", "new", True,
                                ["int8", "int8", "float32", "float32"]]


# -- facade / events ---------------------------------------------------------------

def test_cluster_pool_is_sharedkvpool_compatible_for_the_engine(pkgs):
    def case(p):
        cl = p.seeded_cluster()
        n = len(cl)
        b = p.engine(cl, "B")
        warmed = b.prefetch_pool_pages(PROMPT)
        b.close()
        return n, warmed
    n, warmed = both(pkgs, case)
    assert n >= 3 and warmed == 4


def test_evict_source_drops_single_source_entries_cluster_wide(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        p.publish_n(cl, 4, source="w1")
        cl.drain_events("w1")
        return cl.evict_source("w1"), len(cl), cl.drain_events("w1")
    assert both(pkgs, case) == (4, 0, [])


def test_stored_events_ride_once_per_source(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=3)
        cl.publish("w1", 0x1, 0, 0x10, p.page_arrays())
        cl.publish("w1", 0x1, 0, 0x10, p.page_arrays())
        cl.note_source("w2", 0x1, 0, 0x10)
        return cl.drain_events("w1"), cl.drain_events("w2")
    assert both(pkgs, case) == ([("stored", 0, 0x1, 0, 0x10)],
                                [("stored", 0, 0x1, 0, 0x10)])


def test_note_source_skips_unreachable_owner(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        cl.publish("w1", 0x1, 0, 0x10, p.page_arrays())
        for h in cl._hosts.values():
            h.partition(True)
        r = [cl.note_source("w2", 0x1, 0, 0x10), cl.drain_events("w2")]
        for h in cl._hosts.values():
            h.partition(False)
        r += [cl.note_source("w2", 0x1, 0, 0x10), cl.drain_events("w2")]
        return r
    assert both(pkgs, case) == [False, [], True,
                                [("stored", 0, 0x1, 0, 0x10)]]


# -- concurrency regressions -------------------------------------------------------

def test_concurrent_capacity_evictions_no_cross_host_deadlock(pkgs):
    """A capacity eviction's report scans the other hosts only after the
    evicting host's lock is released: a publish storm across tiny hosts
    always ends."""
    p = pkgs[1]
    cl = p.make_cluster(n_hosts=2, replicas=1, capacity_pages=1)
    errs = []

    def storm(wid, base):
        try:
            for i in range(60):
                cl.publish(wid, base + i, 0, 0x1, p.page_arrays(i % 4))
        except Exception as exc:   # pragma: no cover — diagnostics only
            errs.append(exc)

    ts = [threading.Thread(target=storm, args=(f"w{k}", 0x1000 * (k + 1)),
                           daemon=True) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs
    assert not any(t.is_alive() for t in ts)


def test_read_page_miss_after_concurrent_eviction_returns_none(pkgs):
    def case(p):
        h = p.ps.KvPoolHost("ph0", capacity_pages=4)
        r = h.publish_page("w1", 0x1, 0, 0x10, p.page_arrays())
        orig = h.fetch_page

        def racing_fetch(seq_hash, mode=""):
            arrays = orig(seq_hash, mode)
            with h._mu:                # a concurrent publish evicts it
                h._entries.pop(seq_hash, None)
            return arrays
        h.fetch_page = racing_fetch
        return r, h.read_page(0x1)
    assert both(pkgs, case) == ("new", None)


def test_publish_retries_once_when_membership_races_mid_publish(pkgs):
    def case(p):
        cl = p.make_cluster(n_hosts=2)
        real = cl.membership.owners_with_epoch
        calls = {"n": 0}

        def racing(key, r=None):
            calls["n"] += 1
            epoch, owners = real(key, r)
            if calls["n"] == 1:            # a change landed mid-publish
                return epoch - 1, owners
            return epoch, owners
        cl.membership.owners_with_epoch = racing
        return cl.publish("w1", 0x9, 0, 0x1, p.page_arrays()), calls["n"], \
            0x9 in cl
    assert both(pkgs, case) == ("new", 2, True)
    assert tpool_service.REMOTE_STATS.stale_epoch_rejected >= 1
    assert tpool_service.REMOTE_STATS.stale_epoch_landed == 0


# -- disagg admission: the lease re-arm ---------------------------------------------

def test_lease_rearm_before_multi_page_pool_claim_pins_one_fetcher(pkgs):
    """A multi-page pool match re-arms the item's lease before the engine
    claims the pages, so the queue never redelivers it mid-fetch; a
    one-page match keeps the normal lease."""
    from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.worker import PrefillWorker
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    cl = pkgs[1].seeded_cluster()
    eng = SimpleNamespace(cfg=SimpleNamespace(page_size=PAGE), kv_pool=cl)

    def req(rid, tokens):
        return RemotePrefillRequest(
            engine_id="dec-0", request_id=rid, token_ids=tokens,
            page_ids=list(range(len(tokens) // PAGE + 1)), page_size=PAGE)

    async def main():
        plane = MemoryPlane()
        q = PrefillQueue(plane.messaging, "ns", "tiny")
        await q.enqueue(req("r1", PROMPT))
        got, token = await q.dequeue_leased(lease_s=0.2)
        w = PrefillWorker.__new__(PrefillWorker)
        w.worker = SimpleNamespace(engine=eng)
        w.queue = q
        w.lease_s = 5.0
        assert await w._touch_for_pool_claim(got, token) is True
        await asyncio.sleep(0.3)   # the 0.2 s lease would have expired
        assert await q.dequeue_leased(lease_s=1.0, timeout=0.05) is None
        await q.ack(token)
        await q.enqueue(req("r2", PROMPT[:PAGE]))
        got2, tok2 = await q.dequeue_leased(lease_s=0.2)
        assert await w._touch_for_pool_claim(got2, tok2) is False
        await q.ack(tok2)

    asyncio.run(asyncio.wait_for(main(), 30))


# -- router: pool-host liveness ------------------------------------------------------

def test_split_pool_scores_zeroes_when_no_live_pool_host(pkgs):
    """With the pool membership wired, the last pool host's watch delete
    zeroes the fetchable depth at event time; the pool scores still leave
    the resident score map. The same answers as the JAX router."""
    from dynamo_tpu.kv_router.indexer import MatchResult as JMatch
    from dynamo_tpu.kv_router.router import KvRouter as JRouter
    from dynamo_tpu_torch.kv_router.indexer import MatchResult as TMatch
    from dynamo_tpu_torch.kv_router.router import KvRouter as TRouter

    client = SimpleNamespace(instances={"w1": {}})
    out = []
    for p, router_cls, match in ((pkgs[0], JRouter, JMatch),
                                 (pkgs[1], TRouter, TMatch)):
        m = p.pl.PoolMembership()
        router = router_cls(object(), client, block_size=4,
                            pool_membership=m)
        m.join("h1"); m.join("h2")
        a = match(scores={"w1": 1, "pool:w1": 3})
        first = router._split_pool_scores(a)
        m.on_instance("delete", p.pl.pool_host_instance_id("h1"), {})
        m.on_instance("delete", p.pl.pool_host_instance_id("h2"), {})
        b = match(scores={"w1": 1, "pool:w1": 3})
        out.append((first, router._split_pool_scores(b), a.scores, b.scores))
    assert out[1] == out[0] == (3, 0, {"w1": 1}, {"w1": 1})
