"""The port's QoS admission half (dynamo_tpu_torch/runtime/qos.py and
frontend/reliability.AdmissionControl) against the JAX package's.

tests/test_qos.py's admission cases (the stride picker, the token bucket,
AdmissionState, the async AdmissionControl class-aware and legacy) run on
both packages: each case's assertions hold on each, and what the runs
observed is equal. Then one seeded arrival sequence (numpy, seed 29) of
arrivals, releases and clock steps goes through both AdmissionStates and
both class-aware AdmissionControls: every admit / queue / displace / shed
decision, every grant and every retry-after value is equal.

tests/test_qos.py's scheduler and queue cases run on both packages too:
select_victim, the waiting queue's class bypass and aging pin, the
cross-class preemption budget, and preempt / resume token-identical to the
uninterrupted run, aggregated and disaggregated, greedy and seeded-sampled
in f32, on each of the port's decode paths (tests/torch_decode_paths.py:
the ragged kernel's plain version, the gather window, a tiny Gemma-2), the
streams and QOS_STATS equal to JAX's. The class-aware prefill queue
(disagg/queue.py with a policy): sub-queues, the weighted dequeue, FIFO
without a policy, seeded enqueue / dequeue sequences (dequeue order, lease
routing, depth, aging promotions equal) and the failpoint before any pop.
The QoS storm of tools/torch_fleet_storm.py replays JAX's qos_storm_once
and the committed QOS_r14.json.
"""
import asyncio
import os

import numpy as np
import pytest

from dynamo_tpu.frontend import reliability as jrel
from dynamo_tpu.runtime import qos as jqos
from dynamo_tpu_torch.frontend import reliability as trel
from dynamo_tpu_torch.runtime import qos as tqos
from tests import torch_decode_paths as paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


# -- victims, the waiting queue's class bypass, the preemption budget ---------

class _Seq:
    def __init__(self, qos, computed):
        self.qos = qos
        self.num_computed = computed


def test_select_victim_lowest_class_then_youngest():
    def case(Q, R):
        running = [_Seq("interactive", 2), _Seq("batch", 50),
                   _Seq("batch", 10), None, _Seq("standard", 1)]
        v = Q.select_victim(running)
        assert v.qos == "batch" and v.num_computed == 10
        same = [_Seq("standard", 9), _Seq("standard", 3),
                _Seq("standard", 7)]
        assert Q.select_victim(same).num_computed == 3
        assert Q.select_victim([_Seq("interactive", 1)],
                               below_prio=2) is None
        return running.index(v), same.index(Q.select_victim(same))
    both(case)


def _sched_modules(Q):
    if Q is jqos:
        from dynamo_tpu.engine import scheduler
        from dynamo_tpu.engine.config import EngineConfig
    else:
        from dynamo_tpu_torch.engine import scheduler
        from dynamo_tpu_torch.engine.config import EngineConfig
    return scheduler, EngineConfig


def _sched(Q, num_pages=64):
    S, EngineConfig = _sched_modules(Q)
    return S, S.Scheduler(EngineConfig(
        page_size=8, num_pages=num_pages, max_slots=2,
        max_prefill_chunk=16, prefill_buckets=(8, 16), max_model_len=128,
        decode_steps=4))


def test_waiting_queue_class_bypass_with_aging_pin():
    def case(Q, R):
        S, s = _sched(Q)
        s.qos_policy = Q.QosPolicy(aging_limit=2)

        def add(rid, qos):
            s.add_request(S.EngineRequest(
                rid, list(range(3, 12)), S.SamplingParams(max_tokens=2),
                qos=qos))
            return [x.request_id for x in s.waiting]

        for i in range(3):
            add(f"b{i}", "batch")
        add("i0", "interactive")
        assert add("i1", "interactive") == ["i0", "i1", "b0", "b1", "b2"]
        assert add("i2", "interactive") == \
            ["i0", "i1", "b0", "b1", "b2", "i2"]
        assert all(x.qos_bypassed <= 2 for x in s.waiting)
        assert Q.QOS_STATS.sched_aging_pins >= 1
        return ([(x.request_id, x.qos_bypassed) for x in s.waiting],
                Q.QOS_STATS.snapshot())
    both(case)


def test_cross_class_preempt_charged_and_budget_bounded():
    def case(Q, R):
        S, s = _sched(Q, num_pages=4)
        s.qos_policy = Q.QosPolicy((
            Q.QosClass("interactive", priority=2, weight=8.0,
                       preempt_budget=1),
            Q.QosClass("standard", priority=1, weight=3.0),
            Q.QosClass("batch", priority=0, weight=1.0),
        ), default="standard")

        def req(rid, lo, qos):
            return S.EngineRequest(
                rid, list(range(lo, lo + 9)),
                S.SamplingParams(max_tokens=5, ignore_eos=True), qos=qos)

        for i in range(2):
            s.add_request(req(f"b{i}", 3, "batch"))
        while s.waiting:
            plan = s.schedule()
            for r in range(len(plan.seqs)):
                if plan.seqs[r] is not None:
                    s.commit_prefill_row(plan, r, 7)
        assert sum(1 for x in s.running if x is not None) == 2
        s.add_request(req("hi", 3, "interactive"))
        plan = s.schedule()
        assert plan is not None
        assert s._qos_preempt_debt == {"interactive": 1}
        assert Q.QOS_STATS.preempt_by_class == {"interactive": 1}
        assert Q.QOS_STATS.preempted_by_class == {"batch": 1}
        s.add_request(req("hi2", 20, "interactive"))
        before = Q.QOS_STATS.preemptions_total
        s._preempt_for(next(x for x in s.waiting
                            if x.request_id == "hi2"))
        assert Q.QOS_STATS.preemptions_total == before
        assert Q.QOS_STATS.preempt_denied_budget >= 1
        victims = [x.request_id for x in s.waiting if x.qos == "batch"]
        assert victims and victims[0].startswith("b")
        return ([x.request_id if x else None for x in s.running],
                [(x.request_id, x.epoch) for x in s.waiting],
                dict(s._qos_preempt_debt), Q.QOS_STATS.snapshot())
    both(case)


# -- preempt / resume, both packages, on each of the port's decode paths ------

ENGINE_KW = dict(page_size=8, max_prefill_chunk=32,
                 prefill_buckets=(8, 16, 32), max_model_len=512)


def _engines(path):
    """(JAX engine maker, port engine maker) on `path`'s config and
    weights (tests/torch_decode_paths.py)."""
    from dynamo_tpu.engine.config import EngineConfig as JEC
    from dynamo_tpu.engine.engine import NativeEngine as JEngine
    from dynamo_tpu_torch.engine.config import EngineConfig as TEC
    from dynamo_tpu_torch.engine.engine import NativeEngine as TEngine
    jcfg, tcfg, tree, tparams = paths.env(path)

    def jmake(num_pages=64, max_slots=4):
        return JEngine(jcfg, JEC(num_pages=num_pages, max_slots=max_slots,
                                 **ENGINE_KW),
                       params=paths.jax_params(tree), seed=0)

    def tmake(num_pages=64, max_slots=4):
        eng = TEngine(tcfg, TEC(num_pages=num_pages, max_slots=max_slots,
                                **ENGINE_KW), params=tparams, device="cpu")
        paths.check_path(eng, path)
        return eng
    return jmake, tmake


def _req_mod(eng):
    if type(eng).__module__.startswith("dynamo_tpu_torch"):
        from dynamo_tpu_torch.engine import scheduler
    else:
        from dynamo_tpu.engine import scheduler
    return scheduler


def _to_end(eng, want):
    toks = {rid: [] for rid in want}
    while eng.has_work():
        for ev in eng.step():
            if ev.request_id in toks and ev.token is not None:
                toks[ev.request_id].append(ev.token)
    return toks


def _preempt_aggregated(make, Q, temperature):
    alone = make(max_slots=1)
    S = _req_mod(alone)
    prompt_b, prompt_i = list(range(3, 33)), list(range(40, 60))
    # 40 tokens on one slot (tests/test_qos.py has 10 on 5 pages): the
    # port's ragged path overlaps a follow-up window, and a 10-token
    # request would finish before the arrival needed its pages; with one
    # slot the arrival can only run by preempting the batch decode
    pb = dict(max_tokens=40, temperature=temperature, seed=7,
              ignore_eos=True)
    pi = dict(max_tokens=6, temperature=temperature, seed=11,
              ignore_eos=True)
    # each alone, in turn, on one engine (the prompts share no page)
    expect_b = alone.generate(prompt_b, S.SamplingParams(**pb), "b")
    expect_i = alone.generate(prompt_i, S.SamplingParams(**pi), "i")
    alone.close()
    eng = make(max_slots=1)
    eng.add_request(S.EngineRequest("b", prompt_b, S.SamplingParams(**pb),
                                    qos="batch"))
    emitted = []
    while len(emitted) < 3:
        for ev in eng.step():
            if ev.token is not None:
                emitted.append(ev.token)
    seq_b = next(x for x in eng.scheduler.running if x is not None)
    epoch = seq_b.epoch
    eng.add_request(S.EngineRequest("i", prompt_i, S.SamplingParams(**pi),
                                    qos="interactive"))
    toks = _to_end(eng, ("b", "i"))
    assert Q.QOS_STATS.preemptions_total >= 1
    assert seq_b.epoch > epoch
    assert emitted + toks["b"] == expect_b
    assert toks["i"] == expect_i
    eng.close()
    return (emitted + toks["b"], toks["i"], seq_b.epoch - epoch,
            Q.QOS_STATS.snapshot(), dict(Q.QOS_STATS.preempt_by_class))


@pytest.mark.parametrize("path", paths.PATHS)
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_preempt_resume_token_identical_aggregated(temperature, path):
    """A batch decode preempted mid-decode by an interactive arrival (no
    free page) resumes token-identically to its run alone, its epoch
    bumped, in each package; the streams and QOS_STATS equal JAX's."""
    jmake, tmake = _engines(path)
    want = _preempt_aggregated(jmake, jqos, temperature)
    for q, _ in PKGS:
        q.QOS_STATS.reset()
    assert _preempt_aggregated(tmake, tqos, temperature) == want


def _preempt_disagg(make, Q, temperature):
    """A remotely prefilled decode (allocate, inject, activate) on a
    one-slot decode engine, preempted by an interactive arrival and
    resumed from its committed prefix."""
    probe = make(max_slots=1)
    S = _req_mod(probe)
    port = type(probe).__module__.startswith("dynamo_tpu_torch")
    prompt, prompt_i = list(range(40, 60)), list(range(10, 30))
    p = dict(max_tokens=24, temperature=temperature, seed=5,
             ignore_eos=True)
    pi = dict(max_tokens=4, temperature=temperature, seed=9,
              ignore_eos=True)
    # each alone, in turn, on one engine (the prompts share no page)
    expect = probe.generate(prompt, S.SamplingParams(**p), "direct")
    expect_i = probe.generate(prompt_i, S.SamplingParams(**pi), "i")
    probe.close()
    pre, dec = make(max_slots=1), make(max_slots=1)
    alloc = dec.allocate_remote(S.EngineRequest(
        "r", prompt, S.SamplingParams(**p), qos="batch"))
    assert alloc is not None
    pre.add_request(S.EngineRequest("r", prompt, S.SamplingParams(**p),
                                    prefill_only=True))
    outs = []
    while pre.has_work():
        outs.extend(pre.step())
    first = outs[0].token
    pages = pre.extract_pages(pre.scheduler.parked["r"].pages)
    if port:
        dec.inject_pages(alloc.page_ids, pages["k"], pages["v"],
                         ready=pages["ready"])
    else:
        import jax
        dec.inject_pages(alloc.page_ids,
                         jax.device_put(pages["k"], dec.cache_sharding),
                         jax.device_put(pages["v"], dec.cache_sharding))
    pre.release_parked("r")
    dec.activate_remote("r", first)
    toks = [first]
    while len(toks) < 3:
        for ev in dec.step():
            if ev.token is not None:
                toks.append(ev.token)
    dec.add_request(S.EngineRequest("i", prompt_i, S.SamplingParams(**pi),
                                    qos="interactive"))
    done = _to_end(dec, ("r", "i"))
    assert Q.QOS_STATS.preemptions_total >= 1
    assert toks + done["r"] == expect
    assert done["i"] == expect_i
    pre.close()
    dec.close()
    return toks + done["r"], done["i"], Q.QOS_STATS.snapshot()


@pytest.mark.parametrize("path", paths.PATHS)
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_preempt_resume_token_identical_disagg(temperature, path):
    """The same on the disaggregated path: the resume recomputes from the
    committed prefix of a sequence whose first pages were injected."""
    jmake, tmake = _engines(path)
    want = _preempt_disagg(jmake, jqos, temperature)
    for q, _ in PKGS:
        q.QOS_STATS.reset()
    assert _preempt_disagg(tmake, tqos, temperature) == want


# -- the class-aware prefill queue ---------------------------------------------

def _queue_modules(Q):
    if Q is jqos:
        from dynamo_tpu.disagg import PrefillQueue, RemotePrefillRequest
        from dynamo_tpu.runtime import faults
        from dynamo_tpu.runtime.transports.memory import MemoryPlane
    else:
        from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest
        from dynamo_tpu_torch.disagg.queue import PrefillQueue
        from dynamo_tpu_torch.runtime import faults
        from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
    return PrefillQueue, RemotePrefillRequest, MemoryPlane, faults


def _item(RPR, rid, qos):
    return RPR(engine_id="e", request_id=rid, token_ids=[1, 2, 3],
               page_ids=[0], page_size=8, qos=qos)


def test_prefill_queue_class_subqueues_weighted_dequeue_and_ack():
    def case(Q, R):
        PQ, RPR, Plane, _ = _queue_modules(Q)

        async def main():
            plane = Plane()
            q = PQ(plane.messaging, "ns", "m",
                   qos_policy=Q.QosPolicy(aging_limit=4))
            for i in range(4):
                await q.enqueue(_item(RPR, f"b{i}", "batch"))
            await q.enqueue(_item(RPR, "i0", "interactive"))
            assert await q.depth() == 5
            # the sub-queue the items went to
            assert await plane.messaging.queue_depth(
                "ns.prefill_queue.m.q.batch") == 4
            got, tok = await q.dequeue_leased(timeout=1.0, lease_s=5.0)
            assert got.request_id == "i0" and got.qos == "interactive"
            await q.ack(tok)
            seen = []
            for _ in range(4):
                got, tok = await q.dequeue_leased(timeout=1.0, lease_s=5.0)
                seen.append(got.request_id)
                await q.ack(tok)
            assert sorted(seen) == ["b0", "b1", "b2", "b3"]
            assert await q.depth() == 0
            assert await q.dequeue_leased(timeout=0.12) is None
            return seen, dict(q._picker.served)
        return asyncio.run(asyncio.wait_for(main(), T))
    both(case)


def test_prefill_queue_without_policy_is_fifo():
    def case(Q, R):
        PQ, RPR, Plane, _ = _queue_modules(Q)

        async def main():
            plane = Plane()
            q = PQ(plane.messaging, "ns", "m")
            for i in range(3):
                await q.enqueue(_item(RPR, f"r{i}",
                                      "interactive" if i == 2 else "batch"))
            assert await plane.messaging.queue_depth(
                "ns.prefill_queue.m") == 3
            order = []
            for _ in range(3):
                got, tok = await q.dequeue_leased(timeout=1.0)
                order.append(got.request_id)
                await q.ack(tok)
            assert order == ["r0", "r1", "r2"]
            return order
        return asyncio.run(asyncio.wait_for(main(), T))
    both(case)


def _seeded_ops(seed, n=160):
    """Seeded enqueue / dequeue events over the three classes, the unknown
    class (the default) and the legacy base queue."""
    rng = np.random.default_rng(seed)
    classes = ("interactive", "standard", "batch", "bogus", "base")
    weights = (0.15, 0.2, 0.5, 0.05, 0.1)
    ops = []
    for i in range(n):
        if rng.random() < 0.55:
            ops.append(("enq", f"q{i}",
                        classes[int(rng.choice(5, p=weights))]))
        else:
            ops.append(("deq", int(rng.integers(0, 3)), ""))
    return ops


def _queue_run(Q, seed, aging):
    """The seeded events through one queue: the dequeue order, the lease
    routing (an ack, a touch or a nack-by-expiry on the item's own
    sub-queue), depth after each event and the aging promotions."""
    PQ, RPR, Plane, _ = _queue_modules(Q)

    async def main():
        plane = Plane()
        q = PQ(plane.messaging, "ns", "m",
               qos_policy=Q.QosPolicy(aging_limit=aging))
        legacy = PQ(plane.messaging, "ns", "m")   # a policy-less enqueuer
        log = []
        for kind, a, cls in _seeded_ops(seed):
            if kind == "enq":
                if cls == "base":
                    await legacy.enqueue(_item(RPR, a, "batch"))
                else:
                    await q.enqueue(_item(RPR, a, cls))
            else:
                got = await q.dequeue_leased(timeout=0.01, lease_s=30.0)
                if got is None:
                    log.append(("empty",))
                    continue
                req, tok = got
                if a == 1:
                    assert await q.touch(tok, lease_s=30.0)
                await q.ack(tok)
                log.append((req.request_id, req.qos))
            log.append(await q.depth())
        return (log, dict(q._picker.served), q._picker.aging_promotions,
                Q.QOS_STATS.queue_aging_promotions, q._lease_queues)
    return asyncio.run(asyncio.wait_for(main(), T))


@pytest.mark.parametrize("seed,aging", [(3, 2), (17, 4), (41, 16)])
def test_prefill_queue_seeded_dequeue_order_equal(seed, aging):
    want = _queue_run(jqos, seed, aging)
    got = _queue_run(tqos, seed, aging)
    assert got == want
    if aging <= 4:
        assert got[2] > 0 and got[3] == got[2]
    assert got[4] == {}     # every lease settled


def test_prefill_queue_classed_failpoint_fires_before_any_pop():
    """An armed `queue.dequeue` drop raises before any sub-queue pop, so
    the item stays queued, in both packages."""
    def case(Q, R):
        PQ, RPR, Plane, faults = _queue_modules(Q)

        async def main():
            plane = Plane()
            q = PQ(plane.messaging, "ns", "m", qos_policy=Q.QosPolicy())
            await q.enqueue(_item(RPR, "b0", "batch"))
            faults.REGISTRY.arm_from_dict({"queue.dequeue": {
                "seed": 0, "specs": [{"kind": "drop", "n": 1}]}})
            try:
                with pytest.raises(faults.FaultInjected):
                    await q.dequeue_leased(timeout=0.2)
                depth = await q.depth()
                got, tok = await q.dequeue_leased(timeout=1.0)
                await q.ack(tok)
            finally:
                faults.REGISTRY.disarm()
            return depth, got.request_id
        return asyncio.run(asyncio.wait_for(main(), T))
    assert both(case) == (1, "b0")


# -- the QoS storm ------------------------------------------------------------

def _storms():
    import importlib
    import os
    import sys
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return (importlib.import_module("fleet_storm"),
            importlib.import_module("torch_fleet_storm"))


def test_qos_storm_replays_jax_and_committed_artifact():
    """tools/torch_fleet_storm.py's storm on the port's QoS machinery: its
    timeline, per-class outcomes, aging promotions and SLO alerts equal
    JAX's qos_storm_once on the same shapes (QoS and FIFO), and the
    committed QOS_r14.json's."""
    import json
    import os
    jstorm, tstorm = _storms()
    with open(os.path.join(REPO, "QOS_r14.json")) as f:
        plan = json.load(f)
    keys = ("timeline", "per_class", "aging_promotions", "slo_alerts",
            "admission_displaced", "requests")
    shape = tstorm.TenantShape.from_dict(plan["shape"])
    mine = tstorm.qos_storm_once(shape, True, ticks=plan["ticks"])
    for k in keys:
        assert mine[k] == plan["qos"][k], k
    fifo = tstorm.qos_storm_once(shape, False, ticks=plan["ticks"])
    for k in keys:
        assert fifo[k] == plan["fifo"][k], k
    for seed, mult in ((3, 9.0), (21, 20.0)):
        kw = dict(seed=seed, crowd_mult=mult)
        for on in (True, False):
            want = jstorm.qos_storm_once(jstorm.TenantShape(**kw), on,
                                         ticks=160)
            got = tstorm.qos_storm_once(tstorm.TenantShape(**kw), on,
                                        ticks=160)
            for k in keys:
                assert got[k] == want[k], (seed, on, k)


def test_qos_storm_contracts_and_exit_code(capsys):
    """The tool's contracts hold on the default storm (exit 0), and a bound
    the storm cannot meet exits 1, as tools/fleet_storm.py --mode qos."""
    _, tstorm = _storms()
    report = tstorm.run_qos_storm()
    assert all(report["contracts"].values()), report["contracts"]
    assert tstorm.main(["--mode", "qos", "--no-artifact"]) == 0
    assert tstorm.main(["--mode", "qos", "--no-artifact",
                        "--interactive-bound-s", "0.5"]) == 1
    capsys.readouterr()
