"""The port's control-plane scale harness held to the JAX package's.

Every case of tests/test_cluster_sim.py runs on the port's simcluster
(dynamo_tpu_torch/runtime/simcluster.py: mock workers, the port's router,
client and memory plane): the pure helpers equal JAX's; the 64-worker
smoke (a seeded rolling restart under load, a watch-disconnect burst, an
event-lag storm through the degraded mode and back), the lease-expiry
burst and the re-role fence under churning load hold the same contracts
(zero scheduling errors, zero post-fence picks, convergence, zero fence
violations); the transfer-aware and fail-slow A/B reports are equal to the
JAX simcluster's on the same seed, key for key. The page hashes differ
between the packages, but an overlap count only asks whether two hashes of
one package are equal, so the routing A/B does not see it. The
1000-worker case stays behind `-m slow`, as in JAX. Left out with
tracing's rest: the smoke's trace-capture leg (its `router.schedule`
spans).
"""
import asyncio

import pytest

from dynamo_tpu.runtime import simcluster as jsim
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.cpstats import CP_STATS
from dynamo_tpu_torch.runtime.simcluster import (
    SimCluster, SimConfig, family_tokens, percentile, pick_storm_targets,
)


@pytest.fixture(autouse=True)
def clean_cp_state():
    from dynamo_tpu.runtime import faults as jfaults
    from dynamo_tpu.runtime.cpstats import CP_STATS as JCP
    for reg, cp in ((faults.REGISTRY, CP_STATS), (jfaults.REGISTRY, JCP)):
        reg.disarm()
        reg.reset_counters()
        cp.reset()
    yield
    for reg, cp in ((faults.REGISTRY, CP_STATS), (jfaults.REGISTRY, JCP)):
        reg.disarm()
        reg.reset_counters()
        cp.reset()


def test_storm_targets_are_a_pure_function_of_seed():
    ids = [f"w{i:04d}" for i in range(100)]
    a = pick_storm_targets(42, ids, 0.3)
    b = pick_storm_targets(42, list(reversed(ids)), 0.3)
    assert a == b and len(a) == 30
    assert pick_storm_targets(43, ids, 0.3) != a
    for seed in (0, 42, 43, 1 << 29):
        for frac in (0.01, 0.25, 0.3, 1.0):
            assert pick_storm_targets(seed, ids, frac) == \
                jsim.pick_storm_targets(seed, ids, frac)


def test_family_tokens_deterministic_and_distinct():
    assert family_tokens(3, 16, 4) == family_tokens(3, 16, 4)
    assert family_tokens(3, 16, 4) != family_tokens(4, 16, 4)
    for fam in range(8):
        assert family_tokens(fam, 16, 8) == jsim.family_tokens(fam, 16, 8)


def test_percentile_edges():
    assert percentile([], 0.99) == 0.0
    assert percentile([1.0], 0.5) == 1.0
    assert percentile(list(map(float, range(100))), 0.99) == 98.0
    vals = sorted(float((i * 37) % 101) for i in range(101))
    for p in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert percentile(vals, p) == jsim.percentile(vals, p)


def test_cluster_sim_smoke_64_workers_storms_hold_contracts():
    async def main():
        sim = await SimCluster(SimConfig(
            workers=64, streams=512, seed=11, lease_ttl_s=2.0,
            scrape_interval_s=0.1, degraded_lag_s=0.5)).start()
        try:
            load = await sim.run_load(400)
            assert load["calls"] == 400
            assert sim.schedule_errors == 0 and sim.dead_picks == 0
            assert sim.router.indexer.num_nodes() > 0
            assert sim.router.indexer.kind == "native"

            rr = await sim.storm_rolling_restart(fraction=0.25,
                                                 load_calls=300)
            assert rr["errors"] == 0 and rr["dead_picks"] == 0
            assert rr["targets"] == 16
            assert len(sim.client.instances) == 64

            wd = await sim.storm_watch_disconnect(kills=2, load_calls=100)
            assert wd["converged"], wd
            assert wd["resyncs"] >= 1
            assert wd["errors"] == 0 and wd["dead_picks"] == 0

            lag = await sim.storm_event_lag(delay_s=1.0, load_calls=100)
            assert lag["entered"] and lag["exited"], lag
            assert lag["errors"] == 0 and lag["dead_picks"] == 0
            assert CP_STATS.router_degraded == 0
            assert CP_STATS.router_degraded_entries >= 1

            summary = sim.summary()
            assert summary["schedule_errors"] == 0
            assert summary["dead_picks"] == 0
            assert summary["p99_us"] > 0
            assert summary["schedule_calls"] == 900
        finally:
            await sim.stop()

    asyncio.run(asyncio.wait_for(main(), 120))


def test_lease_expiry_burst_prunes_then_recovers():
    async def main():
        sim = await SimCluster(SimConfig(
            workers=32, streams=128, seed=3, lease_ttl_s=1.0,
            scrape_interval_s=0.1)).start()
        try:
            le = await sim.storm_lease_expiry(fraction=0.25, load_calls=100)
            assert le["expired"] == le["targets"] == 8
            assert le["errors"] == 0 and le["dead_picks"] == 0
            assert len(sim.client.instances) == 32
        finally:
            await sim.stop()

    asyncio.run(asyncio.wait_for(main(), 120))


def _ab(pkg, method, workers, streams, seed, **kw):
    mod = jsim if pkg == "jax" else None

    async def run():
        S, C = ((mod.SimCluster, mod.SimConfig) if mod is not None
                else (SimCluster, SimConfig))
        sim = await S(C(workers=workers, streams=streams,
                        seed=seed)).start()
        try:
            return await getattr(sim, method)(**kw)
        finally:
            await sim.stop()

    return asyncio.run(asyncio.wait_for(run(), 120))


def test_routing_ab_transfer_aware_beats_prefix_only_p99():
    """The transfer-aware vs prefix-only A/B on 48 workers: the port's
    report equals the JAX simcluster's key for key and holds its
    acceptance (p99 improved by more than 2 %, cold links scored), and it
    replays identically from its seed."""
    report = _ab("port", "routing_ab", 48, 256, 11, requests=800)
    assert report == _ab("jax", "routing_ab", 48, 256, 11, requests=800)
    assert report["transfer_aware"]["ttft_p99_ms"] \
        < report["prefix_only"]["ttft_p99_ms"]
    assert report["p99_improvement"] > 0.02
    assert report["cold_links"] > 0
    assert report["measured_links"] > 0
    assert report == _ab("port", "routing_ab", 48, 256, 11, requests=800)


def test_fail_slow_ab_equals_jax():
    """The fail-slow detection A/B (seeded gray failures, hedged dispatch)
    on 32 workers: the port's report, timelines included, equals JAX's."""
    report = _ab("port", "fail_slow_ab", 32, 128, 11, requests=600)
    assert report == _ab("jax", "fail_slow_ab", 32, 128, 11, requests=600)
    assert report["timeline_replay_ok"]
    assert report["detection_on"]["dropped"] == 0
    assert report["detection_on"]["false_ejections"] == []


@pytest.mark.slow
def test_cluster_sim_full_scale_1000_workers():
    async def main():
        sim = await SimCluster(SimConfig(
            workers=1000, streams=20_000, seed=7)).start()
        try:
            await sim.run_load(2000)
            rr = await sim.storm_rolling_restart(fraction=0.3,
                                                 load_calls=2000)
            assert rr["errors"] == 0 and rr["dead_picks"] == 0
            lag = await sim.storm_event_lag(delay_s=1.5, load_calls=500)
            assert lag["entered"] and lag["exited"]
            assert sim.summary()["schedule_errors"] == 0
        finally:
            await sim.stop()

    asyncio.run(asyncio.wait_for(main(), 600))


def test_re_role_fence_under_churning_load():
    from dynamo_tpu_torch.runtime.autoscaler import ROLE_DECODE, ROLE_PREFILL

    async def main():
        sim = await SimCluster(SimConfig(workers=16, streams=64,
                                         lease_ttl_s=30.0,
                                         seed=9)).start()
        try:
            ids = sorted(sim.workers)
            for i, wid in enumerate(ids):
                await sim.workers[wid].assign_role(
                    ROLE_PREFILL if i < 8 else ROLE_DECODE)
            deadline = asyncio.get_running_loop().time() + 5.0
            while len(sim.client.ids_for_role(ROLE_PREFILL)) != 8:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)

            stop = asyncio.Event()
            mismatches = 0

            async def load():
                nonlocal mismatches
                while not stop.is_set():
                    for role in (ROLE_PREFILL, ROLE_DECODE):
                        for pick in sim.client.ids_for_role(role):
                            info = sim.client.instances.get(pick)
                            if info is None or (
                                    info.get("role") not in (role, None)
                                    or info.get("status") == "draining"):
                                mismatches += 1
                    await asyncio.sleep(0)

            load_task = asyncio.create_task(load())
            violations = 0
            for _round in range(2):
                for wid in ids[8:14]:
                    violations += await sim.re_role_worker(
                        wid, ROLE_PREFILL, old_role=ROLE_DECODE)
                for wid in ids[8:14]:
                    violations += await sim.re_role_worker(
                        wid, ROLE_DECODE, old_role=ROLE_PREFILL)
            stop.set()
            await load_task
            re_roles = sum(sim.workers[w].re_roles for w in ids)
            return violations, mismatches, re_roles
        finally:
            await sim.stop()

    violations, mismatches, re_roles = asyncio.run(
        asyncio.wait_for(main(), 60))
    assert violations == 0
    assert mismatches == 0
    assert re_roles == 24
