"""The port's closed-loop autoscaler held to the JAX package's.

Every case of tests/test_autoscaler.py runs on the port
(dynamo_tpu_torch/runtime/autoscaler.py) and, beside it, on the JAX
module with the same inputs; the outcomes are compared exactly: the
decisions (as `Decision.to_dict()`), the stats counters and the decision
timelines. The budget tuner runs over each package's own Scheduler and
StepLedger with the same fed steps. The two storm cases run the port's
simcluster (`autoscale_storm`, `TrafficShape`) and the JAX simcluster on
the same traffic shape and seed, and the reports are equal: the storm's
traffic model hashes nothing, so the page-hash difference between the
packages does not reach it.
"""
import asyncio
import json
import os
import random
import sys

import pytest

import dynamo_tpu.runtime.autoscaler as JA
import dynamo_tpu_torch.runtime.autoscaler as TA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": JA, "port": TA}


def sig(A, ts, p_workers=8, d_workers=8, queue=0.0, p_occ=0.5, d_occ=0.5,
        ttft_burn=0.0, itl_burn=0.0, ttft_firing=False, itl_firing=False,
        degraded=False, drains=0, p_draining=0, d_draining=0):
    return A.FleetSignals(
        ts=ts,
        roles={A.ROLE_PREFILL: A.RoleState(workers=p_workers,
                                           draining=p_draining,
                                           queue_depth=queue,
                                           occupancy=p_occ),
               A.ROLE_DECODE: A.RoleState(workers=d_workers,
                                          draining=d_draining,
                                          occupancy=d_occ)},
        ttft_burn=ttft_burn, itl_burn=itl_burn,
        ttft_firing=ttft_firing, itl_firing=itl_firing,
        degraded=degraded, drains_active=drains)


def mk(A, **over):
    defaults = dict(min_prefill=2, min_decode=2, cooldown_s=10.0,
                    hysteresis_ticks=3, max_moves=2,
                    max_moves_per_window=8, window_s=60.0,
                    queue_hi=3.0, queue_lo=0.25, occ_hi=0.85,
                    occ_lo=0.30, burn_hi=1.0)
    defaults.update(over)
    stats = A.AutoscalerStats()
    return A.FleetAutoscaler(A.AutoscalerConfig(**defaults),
                             stats=stats), stats


CANDS = {"decode": [f"d{i}" for i in range(8)],
         "prefill": [f"p{i}" for i in range(8)]}


def drive(A, ticks, cands=CANDS, **cfg):
    """Each tick's signals (kwargs of sig) through a fresh controller: the
    decisions of every tick, the timeline and the stats."""
    asc, stats = mk(A, **cfg)
    out = [[d.to_dict() for d in asc.decide(sig(A, ts, **kw), cands)]
           for ts, kw in ticks]
    snap = {k: v for k, v in stats.snapshot().items()
            if k != "last_decision_age_s"}
    return out, asc.timeline, snap


def both(ticks, cands=CANDS, **cfg):
    got = drive(TA, ticks, cands, **cfg)
    assert got == drive(JA, ticks, cands, **cfg)
    return got


# -- decision units ------------------------------------------------------------

def test_hysteresis_then_decision_then_cooldown():
    hot = dict(queue=40.0)
    out, _, stats = both([(0.0, hot), (1.0, hot), (2.0, hot), (3.0, hot),
                          (12.5, hot)])
    assert out[0] == out[1] == [] and out[3] == []
    d = out[2][0]
    assert d["kind"] == "re_role_to_prefill"
    assert (d["from_role"], d["to_role"]) == ("decode", "prefill")
    assert d["workers"] == ["d0", "d1"]
    assert out[4][0]["kind"] == "re_role_to_prefill"
    assert stats["hysteresis_suppressed"] == 2
    assert stats["cooldown_suppressed"] == 1
    assert stats["decisions_total"] == 2
    assert stats["decisions_re_role_to_prefill"] == 2


def test_one_tick_blip_never_actuates():
    out, _, stats = both([(float(t), dict(queue=40.0 if t % 2 == 0
                                          else 0.0)) for t in range(10)])
    assert all(o == [] for o in out)
    assert stats["decisions_total"] == 0


def test_role_minimum_guard_refuses_to_drain_below_floor():
    out, _, stats = both([(float(t), dict(queue=40.0)) for t in range(6)],
                         min_decode=8)
    assert all(o == [] for o in out)
    assert stats["guard_blocked"] > 0 and stats["decisions_total"] == 0


def test_concurrent_drain_guard():
    ticks = [(float(t), dict(queue=40.0, drains=1)) for t in range(4)]
    out, _, stats = both(ticks + [(5.0, dict(queue=40.0))])
    assert all(o == [] for o in out[:4])
    assert stats["guard_blocked"] >= 1
    assert out[4]


def test_degraded_freeze_makes_zero_decisions():
    ticks = [(0.0, dict(queue=40.0)), (1.0, dict(queue=40.0))]
    ticks += [(float(t), dict(queue=40.0, degraded=True))
              for t in range(2, 8)]
    ticks += [(8.0, dict(queue=40.0))]
    out, _, stats = both(ticks)
    assert all(o == [] for o in out[:8])
    assert len(out[8]) == 1
    assert stats["frozen_degraded"] == 6 and stats["decisions_total"] == 1


def test_bounded_actuation_caps_a_wedged_sensor():
    cands = {"decode": [f"d{i}" for i in range(50)], "prefill": []}
    out, _, stats = both(
        [(float(t), dict(d_workers=50, queue=500.0)) for t in range(60)],
        cands, cooldown_s=1.0, hysteresis_ticks=1,
        max_moves_per_window=4, window_s=1000.0, min_decode=0)
    moved = [w for o in out for d in o for w in d["workers"]]
    assert len(moved) == 4
    assert stats["guard_blocked"] > 0


def test_add_when_both_roles_hot_and_shed_when_idle():
    out, _, _ = both([(float(t), dict(queue=40.0, d_occ=0.95))
                      for t in range(3)])
    assert out[2][0]["kind"] == "add" and out[2][0]["count"] == 2
    out, _, _ = both([(float(t), dict(queue=0.0, p_occ=0.05, d_occ=0.05))
                      for t in range(3)])
    assert out[2][0]["kind"] == "shed" and out[2][0]["count"] == 1


def test_empty_queue_with_busy_workers_is_not_idle():
    out, _, stats = both([(float(t), dict(queue=0.0, p_occ=0.7, d_occ=0.6))
                          for t in range(8)])
    assert all(o == [] for o in out) and stats["decisions_total"] == 0


def test_homing_returns_the_split_to_target():
    out, _, _ = both([(float(t), dict(p_workers=12, d_workers=4, queue=0.0,
                                      p_occ=0.3, d_occ=0.5))
                      for t in range(3)], target_prefill_frac=0.5)
    assert out[2][0]["kind"] == "re_role_to_decode"
    assert "homing" in out[2][0]["reason"]
    out, _, _ = both([(float(t), dict(p_workers=4, d_workers=12, queue=0.0,
                                      p_occ=0.5, d_occ=0.1))
                      for t in range(3)], target_prefill_frac=0.5)
    assert out[2][0]["kind"] == "re_role_to_prefill"
    assert "homing" in out[2][0]["reason"]


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_decision_timeline_is_deterministic(seed):
    """A seeded 120-tick signal sequence: the port's timeline equals
    itself on a replay and the JAX controller's on the same signals."""
    def ticks():
        rng = random.Random(seed)
        out = []
        for t in range(120):
            hot = 30.0 * (1 + rng.random()) if 40 <= t < 80 else 0.0
            out.append((float(t), dict(queue=hot,
                                       d_occ=0.4 + 0.2 * rng.random())))
        return out
    _, tl, _ = both(ticks(), cooldown_s=3.0)
    assert drive(TA, ticks(), cooldown_s=3.0)[1] == tl
    assert len(tl) >= 1


def _store_and_watchdog(ts):
    from dynamo_tpu.observability.slo import SloSpec as JSpec
    from dynamo_tpu.observability.slo import SloWatchdog as JWd
    from dynamo_tpu.observability.timeseries import SeriesStore as JStore
    from dynamo_tpu_torch.observability.slo import SloSpec, SloWatchdog
    from dynamo_tpu_torch.observability.timeseries import SeriesStore
    out = []
    for Store, Spec, Wd in ((JStore, JSpec, JWd),
                            (SeriesStore, SloSpec, SloWatchdog)):
        store = Store(interval_s=1.0, capacity=64)
        for field, v in (("workers", 6.0), ("draining", 1.0),
                         ("queue_depth", 12.0), ("occupancy", 0.8),
                         ("availability", 6 / 7)):
            store.record(f"role/prefill/{field}", v, ts)
        store.record("role/decode/workers", 10.0, ts)
        store.record("serving/ttft_p95", 5.0, ts)
        wd = Wd(store, [Spec(
            name="ttft_p95", series="serving/ttft_p95", objective=3.0,
            target=0.9, short_window_s=2.0, long_window_s=4.0,
            min_samples=1)], degraded_fn=lambda: False)
        wd.evaluate(ts)
        out.append((store, wd))
    return out


def test_signals_from_store_reads_rollup_schema():
    ts = 100.0
    (jstore, jwd), (tstore, twd) = _store_and_watchdog(ts)
    js = JA.signals_from_store(jstore, jwd, ts, drains_active=2)
    s = TA.signals_from_store(tstore, twd, ts, drains_active=2)
    p = s.roles["prefill"]
    assert p.workers == 6 and p.draining == 1
    assert p.queue_depth == 12.0 and p.occupancy == 0.8
    assert s.roles["decode"].workers == 10
    assert s.ttft_burn == twd.states["ttft_p95"].burn_short
    assert s.drains_active == 2
    import dataclasses
    assert dataclasses.asdict(s) == dataclasses.asdict(js)


# -- MixedBudgetTuner (ledger -> mixed_token_budget self-tuning) ---------------

def _bare(pkg):
    """A bare Scheduler and an enabled StepLedger of one package."""
    if pkg == "jax":
        from dynamo_tpu.engine.config import EngineConfig
        from dynamo_tpu.engine.scheduler import Scheduler
        from dynamo_tpu.observability.ledger import LedgerStats, StepLedger
    else:
        from dynamo_tpu_torch.engine.config import EngineConfig
        from dynamo_tpu_torch.engine.scheduler import Scheduler
        from dynamo_tpu_torch.observability.ledger import (
            LedgerStats, StepLedger,
        )
    sched = Scheduler(EngineConfig(
        page_size=64, num_pages=32, max_slots=4, max_prefill_chunk=32,
        prefill_buckets=(8, 16, 32), max_model_len=512))
    return sched, StepLedger(enabled=True, stats=LedgerStats())


def _feed(led, useful, padded):
    led.record_step("mixed", 4, 2, useful, padded, 0, 32, 0, 0, 0, 0,
                    0, 0)


def _tune(script, **kw):
    """script: [(useful, padded) feeds, ts or None] per tick, through each
    package's tuner; the applied budgets, adjustments and stats."""
    out = {}
    for pkg, A in PKGS.items():
        sched, led = _bare(pkg)
        stats = A.AutoscalerStats()
        tuner = A.MixedBudgetTuner(sched, led, stats=stats, **kw)
        applied = []
        for feeds, ts in script:
            for u, p in feeds:
                _feed(led, u, p)
            applied.append(tuner.tick(ts) if ts is not None else None)
        out[pkg] = (applied, tuner.adjustments, sched.mixed_token_budget,
                    stats.budget_adjustments, stats.budget_current)
    assert out["port"] == out["jax"]
    return out["port"]


def test_budget_tuner_shrinks_on_padding_waste_bounded():
    script = [([(100, 512)], 5.0 * (i + 1)) for i in range(30)]
    script.append(([(100, 512)], 200.0))
    applied, adj, final, n, current = _tune(
        script, min_tokens=100, cooldown_s=2.0, hysteresis_ticks=2,
        min_budget=128)
    budgets = [b for b in applied if b is not None]
    assert budgets and budgets[-1] == 128
    assert all(b >= 128 for b in budgets)
    assert final == 128 and n == len(budgets) == len(adj)
    assert current == 128
    assert applied[-1] is None     # the floor: no further adjustment


def test_budget_tuner_grows_on_low_waste_and_needs_evidence():
    script = [([(10, 20)], 5.0)]
    script += [([(500, 512)], 10.0 + 5 * i) for i in range(6)]
    applied, _, final, _, _ = _tune(script, min_tokens=100, cooldown_s=2.0,
                                    hysteresis_ticks=2, max_budget=1024)
    assert applied[0] is None
    assert 512 < final <= 1024


def test_budget_tuner_cooldown_and_hysteresis():
    script = [([(100, 512)], 1.0), ([(100, 512)], 2.0),
              ([(100, 512), (100, 512)], 3.0)]
    applied, _, final, _, _ = _tune(script, min_tokens=100,
                                    cooldown_s=100.0, hysteresis_ticks=2)
    assert applied[0] is None and applied[1] is not None
    assert applied[2] is None and final == applied[1]


def test_set_mixed_token_budget_clamps():
    """JAX scheduler.py:881 on both packages (the port has no sequence
    parallelism, so JAX's sp = 2 leg has no counterpart)."""
    for pkg in PKGS:
        sched, _ = _bare(pkg)
        floor = 2 * 8
        assert sched.set_mixed_token_budget(4) == floor
        assert sched.set_mixed_token_budget(999) == 999
        assert sched.set_mixed_token_budget(0) == 0
        assert sched.mixed_token_budget == 0


# -- simcluster: the tier-1 smoke + the committed plan, against JAX --------------

def _storm(pkg, workers, traffic, controller, ticks, degraded_window,
           seed=10):
    if pkg == "jax":
        from dynamo_tpu.runtime.simcluster import SimCluster, SimConfig
    else:
        from dynamo_tpu_torch.runtime.simcluster import SimCluster, SimConfig

    async def main():
        sim = await SimCluster(SimConfig(
            workers=workers, streams=workers * 8, lease_ttl_s=30.0,
            seed=seed)).start()
        try:
            return await sim.autoscale_storm(
                traffic, ticks=ticks, controller=controller,
                degraded_window=tuple(degraded_window))
        finally:
            await sim.stop()

    return asyncio.run(main())


def _jax_traffic(shape):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from fleet_storm import TrafficShape as JShape
    return JShape(**shape.to_dict())


def test_traffic_shape_equals_jax():
    shape = TA.TrafficShape(seed=21, base_rate=20.0)
    jshape = _jax_traffic(shape)
    assert [shape.arrivals(t) for t in range(400)] == \
        [jshape.arrivals(t) for t in range(400)]
    assert TA.TrafficShape.from_dict(jshape.to_dict()) == shape


def test_autoscale_storm_controller_beats_static_64_workers():
    """The 64-worker storm on the port equals the JAX simcluster's report
    for both the static split and the controller, and holds the JAX
    contract: the controller halves the TTFT bad ticks, trades away no
    ITL, drops no stream, freezes in the degraded window and never
    violates the re-role fence."""
    traffic = TA.TrafficShape(seed=21, base_rate=20.0)
    jtraffic = _jax_traffic(traffic)
    static = _storm("port", 64, traffic, False, 300, (200, 220))
    ctrl = _storm("port", 64, traffic, True, 300, (200, 220))
    assert static == _storm("jax", 64, jtraffic, False, 300, (200, 220))
    assert ctrl == _storm("jax", 64, jtraffic, True, 300, (200, 220))
    assert static["slo"]["ttft_bad_ticks"] >= 10
    assert ctrl["slo"]["ttft_bad_ticks"] <= \
        static["slo"]["ttft_bad_ticks"] // 2
    assert ctrl["slo"]["itl_bad_ticks"] <= \
        static["slo"]["itl_bad_ticks"] + 2
    assert len(ctrl["controller"]["timeline"]) >= 2
    assert ctrl["streams"]["dropped"] == 0
    assert static["streams"]["dropped"] == 0
    assert ctrl["fence_violations"] == 0
    assert ctrl["decisions_in_degraded"] == 0
    assert ctrl["controller"]["frozen_degraded"] == 20


def test_autoscale_replay_matches_committed_artifact():
    """AUTOSCALE_r12.json's plan (the JAX package's committed storm)
    replayed through the port's simcluster: the decision timeline, the SLO
    verdicts and the streams equal the committed ones and the JAX
    simcluster's live replay."""
    with open(os.path.join(REPO, "AUTOSCALE_r12.json")) as f:
        plan = json.load(f)
    traffic = TA.TrafficShape.from_dict(plan["traffic"])
    args = (plan["workers"], traffic, True, plan["ticks"],
            plan["degraded_window"])
    replay = _storm("port", *args, seed=plan["seed"])
    jreplay = _storm("jax", plan["workers"], _jax_traffic(traffic), True,
                     plan["ticks"], plan["degraded_window"],
                     seed=plan["seed"])
    assert replay == jreplay
    committed = plan["controller"]
    assert replay["controller"]["timeline"] == \
        committed["controller"]["timeline"]
    assert replay["slo"]["ttft_bad_ticks"] == \
        committed["slo"]["ttft_bad_ticks"]
    assert replay["streams"] == committed["streams"]
    assert replay["fence_violations"] == 0
