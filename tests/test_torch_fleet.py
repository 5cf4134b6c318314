"""The port's fleet rollup (dynamo_tpu_torch/observability/fleet.py
FleetRollup, with the port's SloWatchdog and SeriesStore) against the JAX
package's, on the CPU: the three cases of tests/test_fleet.py.

Both rollups scrape the SAME live fleet, the JAX package's simulated
cluster (runtime/simcluster.py, seeded; its workers answer $STATS with
WorkerMetrics-shaped payloads and carry roles on their instance keys), at
the same virtual timestamps, each with its own seeded TransferCostModel:
each scrape round collects the fleet's $STATS once and hands the same
replies to both (the sim's load moves between two collections).
The series they record (per worker, fleet aggregates, per role, per link,
health) must be equal name for name and value for value, and so must the
summaries' fleet / roles / links / per-stream transfer blocks and
per_role(). Each case starts with both packages' process-global health,
control-plane and per-stream transfer state empty. The serving-path
quantile series and the control-plane series read each package's own
process-global histograms and counters (the sim's runtime is the JAX
package's, so only the JAX CP_STATS moves) and are left out of the
comparison. Tolerance: exact equality (the same arithmetic on the same
scraped numbers).
"""
import asyncio
import copy

import pytest

from dynamo_tpu.observability.fleet import (
    FleetRollup as JRollup, TransferCostModel as JModel,
)
from dynamo_tpu.observability.slo import (
    SloSpec as JSpec, SloWatchdog as JWatchdog,
)
from dynamo_tpu.observability.timeseries import SeriesStore as JStore
from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu.runtime.cpstats import CP_STATS as JCP
from dynamo_tpu.runtime.integrity import XFER_STATS as JXFER
from dynamo_tpu.runtime.simcluster import SimCluster, SimConfig
from dynamo_tpu_torch.observability.fleet import (
    FleetRollup as TRollup, TransferCostModel as TModel,
)
from dynamo_tpu_torch.observability.slo import (
    SloSpec as TSpec, SloWatchdog as TWatchdog,
)
from dynamo_tpu_torch.observability.timeseries import SeriesStore as TStore
from dynamo_tpu_torch.runtime import health as thealth
from dynamo_tpu_torch.runtime.cpstats import CP_STATS as TCP

SKIP = ("serving/", "qos/", "cp/")


def _reset_globals():
    """The process-global state a rollup reads besides the scrape: the
    control-plane counters, the fail-slow health tables and the JAX
    package's per-stream transfer rows (earlier tests in the same process
    fill them)."""
    for m in (jhealth, thealth):
        m.HEALTH.reset()
        m.HEALTH_STATS.reset()
        m.HEDGE_STATS.reset()
    JCP.reset()
    TCP.reset()
    JXFER.per_stream.clear()


@pytest.fixture(autouse=True)
def clean_global_state():
    _reset_globals()
    yield
    _reset_globals()


class SharedScrape:
    """The fleet's client with one $STATS collection a round, replayed to
    every rollup of that round."""

    def __init__(self, client):
        self.client = client
        self.stats = {}

    @property
    def instances(self):
        return self.client.instances

    async def collect(self):
        self.stats = await self.client.scrape_stats()

    async def scrape_stats(self):
        return copy.deepcopy(self.stats)


def _rollups(client, capacity, **kw):
    client = SharedScrape(client)
    j = JRollup(client, store=JStore(interval_s=1.0, capacity=capacity),
                interval_s=1.0, model=JModel(), **kw)
    t = TRollup(client, store=TStore(interval_s=1.0, capacity=capacity),
                interval_s=1.0, model=TModel(), **kw)
    return j, t


def _series(rollup, ts, window_s=64.0):
    st = rollup.store
    return {n: st.get(n).window(window_s, ts) for n in st.names()
            if not n.startswith(SKIP)}


def _summary(rollup, window_s, ts):
    s = rollup.summary(window_s=window_s, ts=ts)
    return {k: s[k] for k in ("ts", "scrapes", "workers_seen", "fleet",
                              "roles", "links", "xfer_streams")}


async def _scrape_both(j, t, ts):
    await j.client.collect()
    return await j.scrape_once(ts=ts), await t.scrape_once(ts=ts)


def test_rollup_scrapes_sim_fleet_into_series_and_summary():
    async def main():
        sim = await SimCluster(SimConfig(workers=8, streams=64,
                                         seed=3)).start()
        j, t = _rollups(sim.client, 64, expected_workers=8)
        try:
            for r in (j, t):
                r.model.observe("w0000", 10_000_000, 0.01)
                r.model.observe("w0001", 2_000_000, 0.01)
            for ts in (100.0, 101.0, 102.0):
                jsnap, tsnap = await _scrape_both(j, t, ts)
            return (jsnap, tsnap, _series(j, 102.0), _series(t, 102.0),
                    _summary(j, 5.0, 102.0), _summary(t, 5.0, 102.0), t)
        finally:
            await sim.stop()

    jsnap, snap, jser, ser, jsum, summary, t = asyncio.run(main())
    assert snap == jsnap
    assert ser == jser
    assert summary == jsum
    store = t.store
    assert snap["workers"] == 8
    assert snap["links"] == 2
    assert store.get("worker/w0003/kv_active_blocks") is not None
    assert store.get("worker/w0003/engine_tok_s").latest() > 0
    assert store.get("fleet/workers_live").window(5.0, 102.0) == [8.0] * 3
    assert store.get("fleet/availability").latest() == 1.0
    assert store.get("fleet/tok_s_total").latest() > 0
    assert store.get("link/w0000/bytes_per_s").latest() == \
        pytest.approx(1e9)
    assert summary["workers_seen"] == 8
    assert summary["fleet"]["availability"]["last"] == 1.0
    assert set(summary["links"]) == {"w0000", "w0001"}


def test_rollup_feeds_watchdog_availability_drop():
    """Kill half the sim fleet; each package's watchdog over its own
    rollup's availability series fires at the same scrape."""
    def spec(cls):
        return cls(name="avail", series="fleet/availability", objective=0.7,
                   mode="below", target=0.9, short_window_s=3.0,
                   long_window_s=6.0, burn_threshold=2.0, min_samples=2)

    async def main():
        sim = await SimCluster(SimConfig(workers=8, streams=64, seed=5,
                                         lease_ttl_s=0.5)).start()
        j, t = _rollups(sim.client, 256, expected_workers=8)
        jwd = JWatchdog(j.store, [spec(JSpec)], degraded_fn=lambda: False)
        twd = TWatchdog(t.store, [spec(TSpec)], degraded_fn=lambda: False)
        try:
            ts = 100.0
            for _ in range(6):
                await _scrape_both(j, t, ts)
                assert twd.evaluate(ts) == jwd.evaluate(ts)
                ts += 1.0
            assert not twd.firing()
            targets = await sim.kill_fraction(fraction=0.5)
            fired_at = None
            for _ in range(8):
                await _scrape_both(j, t, ts)
                events = twd.evaluate(ts)
                assert events == jwd.evaluate(ts)
                if events and twd.firing():
                    fired_at = ts
                ts += 1.0
            return (targets, fired_at, twd.firing(), t.store,
                    _series(j, ts), _series(t, ts), twd.summary(),
                    jwd.summary())
        finally:
            await sim.stop()

    targets, fired_at, firing, store, jser, ser, tsum, jsum = \
        asyncio.run(main())
    assert ser == jser and tsum == jsum
    assert len(targets) == 4
    assert store.get("fleet/availability").latest() == pytest.approx(0.5)
    assert firing == ["avail"]
    assert fired_at is not None


def test_rollup_per_role_aggregates():
    """The per-role split (role/* series, per_role, summary roles) read
    from the instance keys' role field, draining counted from the watch."""
    from dynamo_tpu.runtime.autoscaler import ROLE_DECODE, ROLE_PREFILL

    async def main():
        sim = await SimCluster(SimConfig(workers=8, streams=64,
                                         seed=4)).start()
        j, t = _rollups(sim.client, 64, expected_workers=8)
        try:
            ids = sorted(sim.workers)
            for i, wid in enumerate(ids):
                await sim.workers[wid].assign_role(
                    ROLE_PREFILL if i < 5 else ROLE_DECODE)
            deadline = asyncio.get_running_loop().time() + 5.0
            while len(sim.client.ids_for_role(ROLE_PREFILL)) != 5:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)
            await _scrape_both(j, t, 100.0)
            healthy = (j.per_role(), t.per_role())
            await sim.workers[ids[0]].mark_draining()
            while ids[0] in sim.client.ids_for_role(ROLE_PREFILL):
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)
            await _scrape_both(j, t, 101.0)
            return (healthy, (j.per_role(), t.per_role()),
                    _summary(j, 5.0, 101.0), _summary(t, 5.0, 101.0),
                    _series(j, 101.0), _series(t, 101.0))
        finally:
            await sim.stop()

    (jh, healthy), (jd, drained), jsum, summary, jser, ser = \
        asyncio.run(main())
    assert healthy == jh and drained == jd
    assert summary == jsum and ser == jser
    assert healthy[ROLE_PREFILL]["workers"] == 5
    assert healthy[ROLE_DECODE]["workers"] == 3
    assert healthy[ROLE_PREFILL]["availability"] == 1.0
    assert "queue_depth" in healthy[ROLE_PREFILL]
    assert "occupancy" in healthy[ROLE_DECODE]
    assert drained[ROLE_PREFILL]["workers"] == 4
    assert drained[ROLE_PREFILL]["draining"] == 1
    assert drained[ROLE_PREFILL]["availability"] == pytest.approx(0.8)
    assert summary["roles"][ROLE_PREFILL]["workers"]["last"] == 4.0


def test_instance_role_matches_jax():
    from dynamo_tpu.runtime.component import instance_role as jrole
    from dynamo_tpu_torch.runtime.component import instance_role as trole
    for info in (None, {}, {"status": "ready"}, {"role": "prefill"},
                 {"role": "decode", "status": "draining"}):
        assert trole(info) == jrole(info)
