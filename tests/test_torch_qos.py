"""The port's QoS admission half (dynamo_tpu_torch/runtime/qos.py and
frontend/reliability.AdmissionControl) against the JAX package's.

tests/test_qos.py's admission cases (the stride picker, the token bucket,
AdmissionState, the async AdmissionControl class-aware and legacy) run on
both packages: each case's assertions hold on each, and what the runs
observed is equal. Then one seeded arrival sequence (numpy, seed 29) of
arrivals, releases and clock steps goes through both AdmissionStates and
both class-aware AdmissionControls: every admit / queue / displace / shed
decision, every grant and every retry-after value is equal.
"""
import asyncio

import numpy as np
import pytest

from dynamo_tpu.frontend import reliability as jrel
from dynamo_tpu.runtime import qos as jqos
from dynamo_tpu_torch.frontend import reliability as trel
from dynamo_tpu_torch.runtime import qos as tqos

PKGS = ((jqos, jrel), (tqos, trel))
T = 30.0


@pytest.fixture(autouse=True)
def clean_qos_stats():
    for q, _ in PKGS:
        q.QOS_STATS.reset()
    yield
    for q, _ in PKGS:
        q.QOS_STATS.reset()


def both(case):
    (jq, jr), (tq, tr) = PKGS
    want, got = case(jq, jr), case(tq, tr)
    assert got == want
    return got


# -- weighted-fair picker ------------------------------------------------------

def test_stride_picker_service_ratios_match_weights():
    def case(Q, R):
        pk = Q.StridePicker(Q.QosPolicy())
        classes = ["interactive", "standard", "batch"]
        order = []
        for _ in range(120):
            cls = pk.order(classes)[0]
            order.append(cls)
            pk.charge(cls, classes)
        assert pk.served == {"interactive": 80, "standard": 30, "batch": 10}
        assert pk.aging_promotions == 0
        return order
    both(case)


def test_stride_picker_bounded_aging_promotes_starved_class():
    def case(Q, R):
        policy = Q.QosPolicy((
            Q.QosClass("hi", priority=1, weight=1000.0),
            Q.QosClass("lo", priority=0, weight=1.0),
        ), default="hi", aging_limit=5)
        pk = Q.StridePicker(policy)
        served_lo_at = []
        for i in range(40):
            cls = pk.order(["hi", "lo"])[0]
            pk.charge(cls, ["hi", "lo"])
            if cls == "lo":
                served_lo_at.append(i)
        assert served_lo_at and served_lo_at[0] <= 5
        assert pk.aging_promotions >= 1
        gaps = [b - a for a, b in zip(served_lo_at, served_lo_at[1:])]
        assert all(g <= 6 for g in gaps)
        return served_lo_at, pk.aging_promotions
    both(case)


def test_token_bucket_rate_and_burst():
    def case(Q, R):
        tb = Q.TokenBucket(rate_per_s=2.0, burst=4.0)
        got = [tb.take(0.0) for _ in range(5)]
        assert got == [True] * 4 + [False]
        got += [tb.take(1.0) for _ in range(3)]
        assert got[5:] == [True, True, False]
        assert Q.TokenBucket(0.0, 0.0).take(123.0)
        return got
    both(case)


# -- admission state -----------------------------------------------------------

def _policy(Q, aging=16):
    return Q.QosPolicy(aging_limit=aging)


def test_admission_weighted_fair_and_batch_first_displacement():
    def case(Q, R):
        st = Q.AdmissionState(_policy(Q), max_inflight=2, max_queued=2)
        kinds = [st.try_admit(c, 0.0).kind for c in
                 ("interactive", "batch", "batch", "batch")]
        assert kinds == ["admit", "admit", "queue", "queue"]
        d = st.try_admit("interactive", 0.0)
        assert d.kind == "displace" and d.victim_class == "batch"
        assert st.try_admit("batch", 0.0).kind == "shed"
        st.note_released("interactive")
        g = st.grant()
        assert g == "interactive"
        st.note_granted(g)
        return kinds, d.retry_after_s, g, st.active, st.queued
    both(case)


def test_admission_retry_after_scales_with_class_queue_depth():
    def case(Q, R):
        st = Q.AdmissionState(_policy(Q), max_inflight=1, max_queued=8,
                              retry_after_s=2)
        assert st.try_admit("batch", 0.0).kind == "admit"
        for _ in range(3):
            assert st.try_admit("batch", 0.0).kind == "queue"
        assert st.retry_after("batch") == 2 * (1 + 3)
        assert st.retry_after("interactive") == 2
        return st.retry_after("batch"), st.retry_after("standard")
    both(case)


def test_admission_rate_budget_sheds_over_bucket():
    def case(Q, R):
        policy = Q.QosPolicy((
            Q.QosClass("interactive", priority=2, weight=8.0),
            Q.QosClass("standard", priority=1, weight=3.0),
            Q.QosClass("batch", priority=0, weight=1.0,
                       rate_per_s=1.0, burst=2.0),
        ))
        st = Q.AdmissionState(policy, max_inflight=100, max_queued=10)
        kinds = [st.try_admit("batch", 0.0).kind for _ in range(4)]
        assert kinds == ["admit", "admit", "shed", "shed"]
        assert st.try_admit("batch", 1.0).kind == "admit"
        assert st.try_admit("interactive", 0.0).kind == "admit"
        return kinds
    both(case)


def test_admission_control_async_weighted_fair_and_displacement():
    def case(Q, R):
        async def main():
            adm = R.AdmissionControl(max_inflight=1, max_queued=2,
                                     queue_timeout_s=5.0,
                                     policy=_policy(Q))
            await adm.acquire(qos="standard")
            b = asyncio.create_task(adm.acquire(qos="batch"))
            i = asyncio.create_task(adm.acquire(qos="interactive"))
            await asyncio.sleep(0.01)
            i2 = asyncio.create_task(adm.acquire(qos="interactive"))
            with pytest.raises(R.AdmissionShed) as exc:
                await b
            assert exc.value.qos == "batch"
            adm.release(qos="standard")
            await asyncio.wait_for(i, 1.0)
            adm.release(qos="interactive")
            await asyncio.wait_for(i2, 1.0)
            adm.release(qos="interactive")
            return (exc.value.retry_after_s, adm.active,
                    Q.QOS_STATS.admission_displaced,
                    dict(Q.QOS_STATS.shed_by_class))
        return asyncio.run(asyncio.wait_for(main(), T))
    both(case)


def test_admission_control_legacy_path_unchanged():
    def case(Q, R):
        async def main():
            metrics = R.ReliabilityMetrics()
            adm = R.AdmissionControl(max_inflight=1, max_queued=0,
                                     retry_after_s=3, metrics=metrics)
            await adm.acquire()
            with pytest.raises(R.AdmissionShed) as exc:
                await adm.acquire()
            assert exc.value.retry_after_s == 3 and exc.value.qos == ""
            adm.release()
            await adm.acquire()
            return (exc.value.retry_after_s, adm.active,
                    metrics.snapshot())
        return asyncio.run(asyncio.wait_for(main(), T))
    both(case)


# -- one seeded arrival sequence through both ----------------------------------

CLASSES = ("interactive", "standard", "batch", "unknown")


def _arrivals(seed: int = 29, n: int = 400):
    """(kind, class, dt) events: an arrival of a class ("unknown" resolves
    to the default), or a release of one admitted request, then a clock
    step of dt seconds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = "arrive" if rng.random() < 0.62 else "release"
        out.append((kind, CLASSES[int(rng.integers(0, 4))],
                    float(rng.exponential(0.05))))
    return out


def _rate_policy(Q, rate: bool = True):
    """Weights 8 : 3 : 1, a concurrency cap on standard and (rate=True) a
    token bucket on batch."""
    return Q.QosPolicy((
        Q.QosClass("interactive", priority=2, weight=8.0),
        Q.QosClass("standard", priority=1, weight=3.0,
                   max_concurrency=3),
        Q.QosClass("batch", priority=0, weight=1.0,
                   rate_per_s=4.0 if rate else 0.0, burst=3.0),
    ), aging_limit=4)


def _state_run(Q):
    """AdmissionState driven synchronously on a virtual clock."""
    st = Q.AdmissionState(_rate_policy(Q), max_inflight=4, max_queued=5,
                          retry_after_s=2)
    now, log, running = 0.0, [], []
    for kind, cls, dt in _arrivals():
        if kind == "arrive":
            d = st.try_admit(cls, now)
            name = st.policy.resolve(cls).name
            if d.kind == "admit":
                running.append(name)
            log.append(("arrive", name, d.kind, d.retry_after_s,
                        d.victim_class))
        elif running:
            done = running.pop(0)
            st.note_released(done)
            g = st.grant()
            if g is not None:
                st.note_granted(g)
                running.append(g)
            log.append(("release", done, g))
        now += dt
    return log, st.active, st.queued, st.displaced, st.picker.served


def test_seeded_arrivals_admission_state_equal():
    want, got = _state_run(jqos), _state_run(tqos)
    for i, (a, b) in enumerate(zip(want[0], got[0])):
        assert b == a, i
    assert got[1:] == want[1:]
    kinds = {e[2] for e in got[0] if e[0] == "arrive"}
    assert kinds == {"admit", "queue", "shed", "displace"}, kinds


def _control_run(Q, R):
    """The same arrivals through the async class-aware AdmissionControl:
    waiters hold futures, a release grants weighted-fair, displaced
    waiters and sheds raise AdmissionShed with their retry-after."""
    async def main():
        # the async path reads the wall clock for the token buckets, so
        # the rate budget is off here (the virtual-clock run covers it)
        adm = R.AdmissionControl(4, max_queued=5, queue_timeout_s=T,
                                 retry_after_s=2,
                                 policy=_rate_policy(Q, rate=False))
        log, holders, waiting = [], [], []

        async def arrive(i, cls):
            try:
                await adm.acquire(qos=cls)
            except R.AdmissionShed as e:
                log.append((i, "shed", e.qos, e.retry_after_s))
                return
            log.append((i, "run", adm.policy.resolve(cls).name))
            holders.append(cls)

        for i, (kind, cls, _dt) in enumerate(_arrivals()):
            if kind == "arrive":
                t = asyncio.create_task(arrive(i, cls))
                waiting.append(t)
            elif holders:
                adm.release(qos=holders.pop(0))
            # every decision this event triggers settles before the next
            for _ in range(3):
                await asyncio.sleep(0)
        while holders:
            adm.release(qos=holders.pop(0))
            for _ in range(3):
                await asyncio.sleep(0)
        await asyncio.gather(*waiting)
        return (log, adm.active, Q.QOS_STATS.admission_displaced,
                dict(Q.QOS_STATS.shed_by_class))
    return asyncio.run(asyncio.wait_for(main(), T))


def test_seeded_arrivals_admission_control_equal():
    want = _control_run(jqos, jrel)
    got = _control_run(tqos, trel)
    for i, (a, b) in enumerate(zip(want[0], got[0])):
        assert b == a, i
    assert got[1:] == want[1:]
    assert got[1] == 0
    assert any(e[1] == "shed" for e in got[0])


# -- the class table's targets and the router's class weighting ---------------

def test_default_classes_carry_jax_targets_and_latency_weights():
    (jq, _), (tq, _) = PKGS
    for j, t in zip(jq.DEFAULT_CLASSES, tq.DEFAULT_CLASSES):
        assert (t.name, t.ttft_target_s, t.itl_target_s, t.latency_weight) \
            == (j.name, j.ttft_target_s, j.itl_target_s, j.latency_weight)
    assert tq.DEFAULT_POLICY.names() == jq.DEFAULT_POLICY.names()


def test_qos_baggage_helpers_and_router_weighting():
    """The class latency weight scales the transfer cost term: the slow
    link holds a big resident prefix, batch (x0.5) keeps the prefix win,
    interactive (x2.0) routes to the fast link; on both packages with the
    same components."""
    import random

    def case(Q, R):
        if Q is jqos:
            from dynamo_tpu.kv_router import indexer, scheduler, scoring
            from dynamo_tpu.observability.fleet import TransferCostModel
        else:
            from dynamo_tpu_torch.kv_router import (
                indexer, scheduler, scoring,
            )
            from dynamo_tpu_torch.observability.fleet import (
                TransferCostModel,
            )
        assert Q.qos_of({"qos": "batch"}) == "batch"
        assert Q.qos_of(None) == "" and Q.qos_of({}) == ""
        assert Q.qos_label({"qos": "interactive"}) == "interactive"
        assert Q.qos_label({}) == "standard"
        assert Q.qos_label({"qos": "bogus"}) == "standard"
        model = TransferCostModel()
        model.observe("slow", 2_000_000, 1.0)
        model.observe("fast", 100_000_000, 0.1)
        load = dict(kv_active_blocks=0, kv_total_blocks=100,
                    request_active_slots=0, request_total_slots=8)
        eps = scoring.ProcessedEndpoints(workers={
            "slow": scoring.WorkerMetrics(**load),
            "fast": scoring.WorkerMetrics(**load)})
        sel = scheduler.TransferAwareSelector(
            rng=random.Random(0), cost_model=model,
            health_of=lambda w: 1.0)
        overlap = indexer.MatchResult(scores={"slow": 64})
        out = []
        for cls in ("batch", "interactive"):
            w = Q.DEFAULT_POLICY.resolve(cls).latency_weight
            pick = sel.select_worker(eps, scheduler.SchedulingRequest(
                640, overlap, qos=cls, qos_weight=w), 8)
            out.append((pick.worker_id, sel.last_components))
        return out, sel.last_pick
    (batch, inter), pick = both(case)
    assert batch[0] == "slow"
    assert inter[0] == "fast"
    assert pick["qos"] == "interactive"


def test_per_class_histograms_feed_rollup_series_and_slo_specs():
    """Per-class serving histograms -> the rollup's qos/{class}/* series
    -> the per-class SloSpecs; the same series, summary and alerts on
    both packages."""
    def case(Q, R):
        if Q is jqos:
            from dynamo_tpu.observability.fleet import FleetRollup
            from dynamo_tpu.observability.serving import SERVING
            from dynamo_tpu.observability.slo import (
                SloWatchdog, qos_slo_specs,
            )
            from dynamo_tpu.observability.timeseries import SeriesStore
        else:
            from dynamo_tpu_torch.observability.fleet import FleetRollup
            from dynamo_tpu_torch.observability.serving import SERVING
            from dynamo_tpu_torch.observability.slo import (
                SloWatchdog, qos_slo_specs,
            )
            from dynamo_tpu_torch.observability.timeseries import (
                SeriesStore,
            )
        SERVING.reset()
        try:
            for _ in range(6):
                SERVING.ttft.observe("m", "interactive", value=0.02)
                SERVING.ttft.observe("m", "batch", value=28.0)
                SERVING.itl.observe("m", "batch", value=0.01)
            SERVING.queue_wait.observe("batch", value=0.5)

            class _Client:
                async def scrape_stats(self):
                    return {}

            store = SeriesStore(interval_s=1.0, capacity=64)
            rollup = FleetRollup(_Client(), store=store, interval_s=1.0)
            for t in (100.0, 101.0, 102.0):
                asyncio.run(rollup.scrape_once(ts=t))
            series = {n: store.get(n).window(10.0, 102.0)
                      for n in store.names("qos/")}
            specs = qos_slo_specs(short_window_s=2.0, long_window_s=3.0,
                                  min_samples=2)
            wd = SloWatchdog(store, specs, degraded_fn=lambda: False)
            events = wd.evaluate(102.0)
            return (series, rollup.summary(ts=102.0)["qos"],
                    [vars(s) for s in specs], events)
        finally:
            SERVING.reset()
    series, qos, specs, events = both(case)
    assert series["qos/interactive/ttft_p95"][-1] < 0.1
    assert series["qos/batch/ttft_p95"][-1] > 1.0
    assert "qos/batch/itl_p99" in series
    assert "qos/batch/queue_wait_p95" in series
    assert "batch" in qos
    assert {"ttft_p95/interactive", "ttft_p95/batch",
            "itl_p99/batch"} <= {s["name"] for s in specs}
    assert all(s["degraded_exempt"] for s in specs)
    fired = {e["slo"] for e in events if e["event"] == "fire"}
    assert "ttft_p95/batch" in fired
    assert "ttft_p95/interactive" not in fired
