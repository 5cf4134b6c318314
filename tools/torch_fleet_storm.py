#!/usr/bin/env python
"""torch_fleet_storm: the port's telemetry, autoscaler and QoS storms.

The counterpart of tools/fleet_storm.py for dynamo_tpu_torch, with its
three modes. Nothing of JAX is imported.

`--mode autoscale` (the default): the closed-loop autoscaler chain. A
seeded diurnal + flash-crowd traffic shape (runtime/autoscaler.py
`TrafficShape`) goes through the simulated cluster's virtual-clock
`autoscale_storm` three times: with the static prefill / decode split,
with the `FleetAutoscaler` closing the loop, and again with the controller
(the replay). A live engine then runs a `MixedBudgetTuner` leg: its
ledger's padding waste walks `mixed_token_budget` down. Contracts: the
static split burns the TTFT SLO (>= 10 bad ticks) and the controller holds
it (at most half of static's) without trading away ITL, the controller
acted, zero dropped streams across every re-role drain, zero decisions
while degraded-frozen, zero re-role fence violations, the replay's
decision timeline equals the controller's, and the tuner adjusted the
budget at least once.

`--mode slo`: the resource-telemetry chain. (1) A live engine serves a
churn of staggered requests with its step ledger on; the drained samples
go to a JSONL file and a summary into the report. (2) A simulated fleet
(64 workers, 16 with --quick) under a FleetRollup scrape loop, with
per-link KV-transfer bandwidth EWMAs fed seeded samples. (3) A seeded
storm (a lease-expiry kill of 40% of the fleet, a collapsed victim link)
drives the availability and bandwidth-floor SLOs over their burn
thresholds; the revived fleet and healthy links clear them; the alerts
ride the event plane (`<ns>.slo.alerts`) to a subscriber. Contracts: an
alert fires in the storm (none before it), every alert clears, the event
plane delivers every alert, the degraded-exempt event-lag SLO stays
quiet, and the sim scheduled with zero errors.

`--mode qos`: a seeded BATCH flash crowd arrives under steady interactive
and standard load and goes through the port's QoS machinery
(runtime/qos.py): `AdmissionState` at the door (weighted-fair admission,
token buckets, batch-first displacement, class-scaled Retry-After),
`StridePicker` ordering prefill service and decode-slot grants (weighted
deficit with bounded aging), and `select_victim` for cross-class decode
preemption charged against the preemptor's class budget. Per-class TTFT
series feed the port's `SloWatchdog` with `qos_slo_specs`. The storm runs
twice with the policy (the second a replay) and once as FIFO over the
same arrivals. Contracts: interactive p99 TTFT within its bound while
FIFO's is more than twice it; batch not starved (aging promotions > 0,
every admitted batch request completes); zero dropped streams across
every preemption; at least one preemption; batch sheds first at the door;
at least one per-class SLO fires and clears; the decision / victim
timeline replays equal.

Every mode exits 1 when a contract is violated. The live-engine legs (the
slo mode's ledger, the autoscale mode's tuner) run on the card unless
`--device cpu` is given.

Usage:
    python tools/torch_fleet_storm.py [--mode autoscale|slo|qos]
        [--quick] [--device cuda|cpu] [--no-artifact] [--out PATH]
        the report goes to build/torch_{autoscale,slo,qos}_storm.json
        unless --no-artifact; the slo mode's ledger samples go to
        build/torch_ledger.jsonl (--ledger-out)
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import random
import sys
import time
import zlib

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO_ROOT, "build")
DEFAULT_OUT = os.path.join(BUILD, "torch_qos_storm.json")


@dataclasses.dataclass(frozen=True)
class TenantShape:
    """Seeded multi-tenant arrivals: steady interactive and standard load,
    a BATCH flash crowd in [crowd_start, crowd_start + crowd_len).
    `arrivals(cls, tick)` is a pure function of (shape, class, tick), one
    seeded draw a tick (zlib.crc32 of the class, never hash()), so a
    replay in any process sees the same stream."""

    seed: int = 14
    interactive_rate: float = 3.0
    standard_rate: float = 1.2
    batch_rate: float = 0.6
    crowd_start: int = 30
    crowd_len: int = 40
    crowd_mult: float = 14.0

    def rate(self, cls: str, tick: int) -> float:
        r = {"interactive": self.interactive_rate,
             "standard": self.standard_rate,
             "batch": self.batch_rate}[cls]
        if cls == "batch" and \
                self.crowd_start <= tick < self.crowd_start + self.crowd_len:
            r *= self.crowd_mult
        return r

    def arrivals(self, cls: str, tick: int) -> int:
        r = self.rate(cls, tick)
        n = int(r)
        rng = random.Random((self.seed * 1000003 + tick) * 131
                            + zlib.crc32(cls.encode()) % 9973)
        return n + (1 if rng.random() < r - n else 0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TenantShape":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def storm_policy(qos_on: bool, aging_limit: int):
    """The storm's class table; qos_on=False folds every class into one
    (the FIFO baseline)."""
    from dynamo_tpu_torch.runtime.qos import QosClass, QosPolicy
    if not qos_on:
        return QosPolicy((QosClass("standard", priority=1, weight=1.0,
                                   ttft_target_s=8.0),),
                         default="standard", aging_limit=aging_limit)
    return QosPolicy((
        QosClass("interactive", priority=2, weight=8.0, ttft_target_s=3.0,
                 itl_target_s=1.0, preempt_budget=4, latency_weight=2.0),
        QosClass("standard", priority=1, weight=3.0, ttft_target_s=8.0,
                 itl_target_s=1.0, preempt_budget=1),
        # the flash crowd overruns the batch token bucket and sheds at the
        # door; sized so the admitted batch backlog drains (and its TTFT
        # SLO clears) well inside the run
        QosClass("batch", priority=0, weight=1.0, ttft_target_s=12.0,
                 itl_target_s=2.0, rate_per_s=2.5, burst=6.0),
    ), default="standard", aging_limit=aging_limit)


def percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return float(sorted_vals[i])


class _VStream:
    __slots__ = ("rid", "cls", "qos", "t_arr", "prefill_left",
                 "decode_left", "num_computed", "preempted", "ttft",
                 "done_at")

    def __init__(self, rid, cls, qos, t_arr, prefill, decode):
        self.rid, self.cls, self.t_arr = rid, cls, t_arr
        self.qos = qos                  # select_victim reads .qos
        self.prefill_left = prefill
        self.decode_left = decode
        self.num_computed = 0
        self.preempted = ""             # the preemptor class owing debt
        self.ttft = None
        self.done_at = None


def qos_storm_once(shape: TenantShape, qos_on: bool, ticks: int = 220,
                   max_inflight: int = 60, max_queued: int = 20,
                   prefill_tok_s: float = 2600.0, decode_slots: int = 18,
                   decode_tok_s: float = 30.0, aging_limit: int = 8,
                   drain_ticks: int = 30) -> dict:
    """One virtual-clock storm. Prefill drains admitted requests at
    `prefill_tok_s` in the picker's class order; a finished prefill wants a
    decode slot (TTFT = the tick it gets one + 1 - arrival); a blocked
    higher class preempts the lowest-class decode, whose progress is kept
    (it resumes from its committed tokens at the head of its class band,
    never restarts, never drops). Per-class TTFT p95 series over the last
    10 first tokens feed the SloWatchdog."""
    from dynamo_tpu_torch.observability.slo import SloWatchdog, qos_slo_specs
    from dynamo_tpu_torch.observability.timeseries import SeriesStore
    from dynamo_tpu_torch.runtime.qos import (
        AdmissionState, StridePicker, select_victim,
    )
    policy = storm_policy(qos_on, aging_limit)
    classes = ("interactive", "standard", "batch")

    def label(cls: str) -> str:
        return policy.resolve(cls).name   # FIFO folds all into standard

    adm = AdmissionState(policy, max_inflight, max_queued)
    prefill_pick = StridePicker(policy)
    decode_pick = StridePicker(policy)
    store = SeriesStore(interval_s=1.0, capacity=max(600, ticks + 8))
    wd = SloWatchdog(store, qos_slo_specs(
        policy, short_window_s=8.0, long_window_s=24.0, min_samples=3),
        degraded_fn=lambda: False)
    timeline = []
    adm_waiting = {}            # class -> [stream] (admission queue)
    prefill_q = {}              # class -> [stream] (admitted, prefilling)
    decode_wait = {}            # class -> [stream] (prefilled, want a slot)
    running = [None] * decode_slots
    preempt_debt = {}
    stats = {c: {"arrived": 0, "admitted": 0, "shed": 0, "done": 0,
                 "preempted": 0, "ttfts": []} for c in classes}
    ttft_window = {c: [] for c in classes}
    rid_seq = 0
    tick = 0

    def shed(s):
        stats[s.cls]["shed"] += 1
        timeline.append([tick, "shed", s.rid, label(s.cls)])

    def enter_prefill(s):
        prefill_q.setdefault(label(s.cls), []).append(s)
        stats[s.cls]["admitted"] += 1

    def take_slot(s, slot):
        running[slot] = s
        if s.ttft is None:
            s.ttft = tick + 1.0 - s.t_arr
            stats[s.cls]["ttfts"].append(s.ttft)
            w = ttft_window[s.cls]
            w.append(s.ttft)
            del w[:-10]
        if s.preempted and preempt_debt.get(s.preempted, 0):
            # the victim resumed: repay its preemptor's outstanding debt
            n = preempt_debt[s.preempted]
            if n > 1:
                preempt_debt[s.preempted] = n - 1
            else:
                preempt_debt.pop(s.preempted, None)
            s.preempted = ""

    def serve(picker, backlog):
        cls = picker.order(backlog)[0]
        before = picker.aging_promotions
        picker.charge(cls, backlog)
        if picker.aging_promotions > before:
            timeline.append([tick, "aging", cls])
        return cls

    for tick in range(ticks):
        ts = float(tick)
        # 1. arrivals at the door; the last drain_ticks take none, so the
        # completion contracts read a drained system
        for cls in classes if tick < ticks - drain_ticks else ():
            for _ in range(shape.arrivals(cls, tick)):
                rid_seq += 1
                rng = random.Random(shape.seed * 7919 + rid_seq)
                s = _VStream(rid_seq, cls, label(cls), ts,
                             rng.randint(150, 500), rng.randint(40, 140))
                stats[cls]["arrived"] += 1
                d = adm.try_admit(label(cls), now=ts)
                if d.kind == "admit":
                    enter_prefill(s)
                elif d.kind == "shed":
                    shed(s)
                else:
                    if d.kind == "displace":
                        vic_q = adm_waiting.get(d.victim_class, [])
                        if vic_q:
                            shed(vic_q.pop())    # the newest sheds first
                            timeline.append([tick, "displace",
                                             d.victim_class])
                    adm_waiting.setdefault(label(s.cls), []).append(s)
        # 2. prefill service in weighted-deficit class order
        capacity = prefill_tok_s
        while capacity > 0:
            backlog = [c for c, q in prefill_q.items() if q]
            if not backlog:
                break
            cls = serve(prefill_pick, backlog)
            s = prefill_q[cls][0]
            take = min(s.prefill_left, capacity)
            s.prefill_left -= take
            capacity -= take
            if s.prefill_left <= 0:
                prefill_q[cls].pop(0)
                decode_wait.setdefault(cls, []).append(s)
        # 3. free decode slots, weighted-fair; then cross-class preemption
        # for the blocked higher classes, within their budgets
        while None in running:
            backlog = [c for c, q in decode_wait.items() if q]
            if not backlog:
                break
            cls = serve(decode_pick, backlog)
            take_slot(decode_wait[cls].pop(0), running.index(None))
        if qos_on:
            for cls in sorted((c for c, q in decode_wait.items() if q),
                              key=lambda c: -policy.priority_of(c)):
                c_obj = policy.resolve(cls)
                while decode_wait[cls]:
                    if c_obj.preempt_budget <= 0 or \
                            preempt_debt.get(cls, 0) >= c_obj.preempt_budget:
                        break
                    victim = select_victim(running, policy,
                                           below_prio=c_obj.priority)
                    if victim is None:
                        break
                    slot = running.index(victim)
                    running[slot] = None
                    victim.preempted = cls
                    preempt_debt[cls] = preempt_debt.get(cls, 0) + 1
                    stats[victim.cls]["preempted"] += 1
                    decode_wait.setdefault(label(victim.cls),
                                           []).insert(0, victim)
                    s = decode_wait[cls].pop(0)
                    take_slot(s, slot)
                    timeline.append([tick, "preempt", s.rid, victim.rid,
                                     cls, label(victim.cls)])
        # 4. decode progress; a completion releases its admission slot
        for i, s in enumerate(running):
            if s is None:
                continue
            s.decode_left -= decode_tok_s
            s.num_computed += decode_tok_s
            if s.decode_left <= 0:
                running[i] = None
                s.done_at = ts
                stats[s.cls]["done"] += 1
                adm.note_released(label(s.cls))
                g = adm.grant()
                if g is not None:
                    q = adm_waiting.get(g, [])
                    if q:
                        adm.note_granted(g)
                        enter_prefill(q.pop(0))
                    else:
                        adm.note_abandoned(g)
        # 5. per-class series and the watchdog
        for cls in classes:
            w = ttft_window[cls]
            if w:
                store.record(f"qos/{label(cls)}/ttft_p95",
                             percentile(sorted(w), 0.95), ts)
        wd.evaluate(ts)

    lat = {c: sorted(stats[c]["ttfts"]) for c in classes}
    return {
        "mode": "qos" if qos_on else "fifo",
        "ticks": ticks,
        "requests": rid_seq,
        "per_class": {
            c: {"arrived": stats[c]["arrived"],
                "admitted": stats[c]["admitted"],
                "done": stats[c]["done"],
                "shed": stats[c]["shed"],
                "preempted": stats[c]["preempted"],
                "ttft_p50_s": round(percentile(lat[c], 0.5), 3),
                "ttft_p99_s": round(percentile(lat[c], 0.99), 3)}
            for c in classes},
        "aging_promotions": (prefill_pick.aging_promotions
                             + decode_pick.aging_promotions),
        "admission_displaced": adm.displaced,
        "dropped_streams": 0,    # a victim keeps its progress: none drop
        "slo_alerts": list(wd.alerts),
        "slo_firing_at_end": wd.firing(),
        "timeline": timeline,
    }


def run_qos_storm(seed: int = 10, ticks: int = 220,
                  interactive_bound_s: float = 3.0) -> dict:
    """QoS against FIFO over the same seeded burst, and a replay."""
    shape = TenantShape(seed=seed + 4)
    qos = qos_storm_once(shape, True, ticks=ticks)
    fifo = qos_storm_once(shape, False, ticks=ticks)
    replay = qos_storm_once(shape, True, ticks=ticks)
    pc = qos["per_class"]
    fired = [ev for ev in qos["slo_alerts"] if ev["event"] == "fire"
             and ev["slo"].startswith(("ttft_p95/", "itl_p99/"))]
    cleared = [ev for ev in qos["slo_alerts"] if ev["event"] == "clear"]
    contracts = {
        "interactive_p99_held":
            pc["interactive"]["ttft_p99_s"] <= interactive_bound_s,
        "fifo_burns_interactive":
            fifo["per_class"]["interactive"]["ttft_p99_s"]
            > 2 * pc["interactive"]["ttft_p99_s"],
        "batch_not_starved":
            qos["aging_promotions"] > 0
            and pc["batch"]["done"] == pc["batch"]["admitted"],
        "zero_dropped_streams":
            qos["dropped_streams"] == 0
            and sum(c["done"] for c in pc.values())
            == sum(c["admitted"] for c in pc.values()),
        "preemptions_happened":
            sum(c["preempted"] for c in pc.values()) >= 1,
        "batch_sheds_first":
            pc["batch"]["shed"] > 0 and pc["interactive"]["shed"] == 0,
        "per_class_slo_fired_and_cleared":
            bool(fired) and len(cleared) >= len(fired)
            and not qos["slo_firing_at_end"],
        "replay_bit_identical": replay["timeline"] == qos["timeline"],
    }
    return {"shape": shape.to_dict(), "ticks": ticks, "seed": seed,
            "interactive_bound_s": interactive_bound_s, "qos": qos,
            "fifo": fifo, "replay_timeline_len": len(replay["timeline"]),
            "contracts": contracts}


# -- the slo and autoscale modes --------------------------------------------

def storm_engine(device: str):
    """The live-engine legs' engine: tiny in f32 with the JAX storm's
    geometry (tools/fleet_storm.py), its step ledger on."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    cfg = ModelConfig(dtype="float32", max_model_len=512)
    eng = NativeEngine(cfg, EngineConfig(
        page_size=64, num_pages=32, max_slots=4, max_prefill_chunk=32,
        prefill_buckets=(8, 16, 32), max_model_len=512, decode_steps=4,
        pipeline_depth=2), seed=0, device=device)
    eng.ledger.configure(enabled=True)
    return eng


def staggered(eng, pending: list, on_step=None) -> set:
    """Admit the first request, then one more every third device step,
    and step until all finish; returns the finished ids."""
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    eng.add_request(EngineRequest(*pending.pop(0)))
    done = set()
    while eng.has_work() or pending:
        if pending and eng.step_count % 3 == 1:
            eng.add_request(EngineRequest(*pending.pop(0)))
        for ev in eng.step():
            if ev.finished:
                done.add(ev.request_id)
        if on_step is not None:
            on_step()
    return done


def run_engine_ledger(jsonl_path: str, quick: bool = False,
                      device: str = "cuda") -> dict:
    """slo leg 1: a live engine under churn, its ledger drained to JSONL."""
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    eng = storm_engine(device)
    rng = random.Random(10)
    # staggered admissions while decode runs: the ledger sees all three
    # step kinds (prefill, mixed, decode windows)
    pending = [(f"led{i}",
                [rng.randrange(3, 250) for _ in range(rng.randrange(8, 24))],
                SamplingParams(max_tokens=6 + 2 * (i % 4), temperature=0.0,
                               ignore_eos=True))
               for i in range(3 if quick else 8)]
    done = staggered(eng, pending)
    summary = eng.ledger.summary()
    os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
    n = eng.ledger.write_jsonl(jsonl_path)
    eng.close()
    summary.update(jsonl=os.path.basename(jsonl_path), written=n,
                   requests=len(done))
    return summary


async def run_fleet_storm(args) -> dict:
    """slo legs 2 and 3: the rollup and the SLO fire -> clear over a seeded
    simulated storm."""
    from dynamo_tpu_torch.observability.fleet import (
        FleetRollup, TransferCostModel,
    )
    from dynamo_tpu_torch.observability.slo import (
        SloSpec, SloWatchdog, wire_event_plane,
    )
    from dynamo_tpu_torch.observability.timeseries import SeriesStore
    from dynamo_tpu_torch.runtime.simcluster import SimCluster, SimConfig
    from dynamo_tpu_torch.runtime.transports.codec import unpackb
    interval = 0.1
    sim = await SimCluster(SimConfig(
        workers=args.workers, streams=args.workers * 8,
        lease_ttl_s=0.6, seed=args.seed)).start()
    model = TransferCostModel()
    store = SeriesStore(interval_s=interval, capacity=4096)
    rollup = FleetRollup(sim.client, store=store, interval_s=interval,
                         model=model, expected_workers=args.workers)
    rng = random.Random(args.seed)
    links = sorted(sim.workers)[:8]
    victim = links[0]

    def feed_links(degraded: bool) -> None:
        # seeded per-link samples: ~1 GB/s healthy; the victim link
        # collapses to ~20 MB/s during the storm
        for link in links:
            bw = 2e7 if (degraded and link == victim) \
                else 1e9 * (0.8 + 0.4 * rng.random())
            model.observe(link, int(bw * 0.01), 0.01)

    specs = [
        SloSpec(name="fleet_availability", series="fleet/availability",
                objective=0.85, mode="below", target=0.9,
                short_window_s=1.0, long_window_s=3.0,
                burn_threshold=2.0, min_samples=3),
        SloSpec(name=f"kv_bw_floor/{victim}",
                series=f"link/{victim}/bytes_per_s",
                objective=1e8, mode="below", target=0.9,
                short_window_s=1.0, long_window_s=3.0,
                burn_threshold=2.0, min_samples=3),
        # degraded-exempt: event-plane lag wobbles are sanctioned while the
        # router rides its stale snapshot; it must stay quiet in the storm
        SloSpec(name="event_lag", series="cp/event_lag_seconds",
                objective=5.0, mode="above", target=0.9,
                short_window_s=1.0, long_window_s=3.0,
                burn_threshold=2.0, degraded_exempt=True),
    ]
    delivered = []

    async def consume(sub):
        async for _subject, payload in sub:
            delivered.append(unpackb(payload))

    subject = f"{sim.cfg.namespace}.slo.alerts"
    sub = await sim.plane.messaging.subscribe(subject)
    consumer = asyncio.create_task(consume(sub))
    wd = SloWatchdog(store, specs, degraded_fn=lambda: False)
    wire_event_plane(wd, sim.plane.messaging, subject)

    async def tick(n: int, degraded: bool) -> None:
        for _ in range(n):
            feed_links(degraded)
            await rollup.scrape_once()
            wd.evaluate(time.time())
            await sim.run_load(8)
            await asyncio.sleep(interval)

    report: dict = {"rollup": {}, "slo_states": {}}
    try:
        await tick(args.phase_ticks, degraded=False)
        report["rollup"]["healthy"] = rollup.summary(window_s=5.0)
        report["slo_states"]["healthy"] = wd.summary()
        fired_before = list(wd.firing())

        targets = await sim.kill_fraction(fraction=0.4)
        await tick(args.phase_ticks * 2, degraded=True)
        report["rollup"]["storm"] = rollup.summary(window_s=5.0)
        report["slo_states"]["storm"] = wd.summary()
        firing_in_storm = list(wd.firing())

        await sim.revive(targets)
        # recovery: healthy links and the whole fleet until every alert
        # clears
        for _ in range(args.phase_ticks * 6):
            await tick(1, degraded=False)
            if not wd.firing():
                break
        report["rollup"]["recovered"] = rollup.summary(window_s=5.0)
        report["slo_states"]["recovered"] = wd.summary()
        await asyncio.sleep(0.2)      # let the last publishes land
    finally:
        consumer.cancel()
        aclose = getattr(sub, "aclose", None)
        if aclose is not None:
            await aclose()
        await sim.stop()

    report["alerts"] = wd.alerts
    report["alerts_delivered"] = delivered
    report["storm"] = {"killed": len(targets), "victim_link": victim,
                       "firing_in_storm": firing_in_storm,
                       "fired_before_storm": fired_before}
    fired = [ev for ev in wd.alerts if ev["event"] == "fire"]
    cleared = [ev for ev in wd.alerts if ev["event"] == "clear"]
    report["contracts"] = {
        "alert_fired_in_storm": bool(firing_in_storm)
        and not fired_before,
        "all_alerts_cleared": not wd.firing()
        and len(cleared) == len(fired) and bool(fired),
        "event_plane_roundtrip": len(delivered) == len(wd.alerts),
        "degraded_exempt_quiet": not any(
            ev["slo"] == "event_lag" for ev in wd.alerts),
        "zero_schedule_errors": sim.schedule_errors == 0,
    }
    return report


def run_budget_tuner(quick: bool = False, device: str = "cuda") -> dict:
    """autoscale's live leg: a tiny engine whose ledger padding waste
    drives `MixedBudgetTuner` adjustments of `mixed_token_budget` (a
    virtual clock of 2.5 s an engine step)."""
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    from dynamo_tpu_torch.runtime.autoscaler import (
        AutoscalerStats, MixedBudgetTuner,
    )
    eng = storm_engine(device)
    stats = AutoscalerStats()
    tuner = MixedBudgetTuner(eng.scheduler, eng.ledger,
                             min_tokens=64, cooldown_s=4.0,
                             hysteresis_ticks=2, stats=stats)
    budget0 = eng.scheduler.mixed_token_budget
    rng = random.Random(13)
    # tiny staggered prompts under the default (oversized) budget: the
    # [Bb, Tb] buckets charge far more padding than useful tokens, so the
    # windowed waste sits over pad_hi and the tuner walks the budget down
    pending = [(f"tune{i}",
                [rng.randrange(3, 250) for _ in range(rng.randrange(6, 18))],
                SamplingParams(max_tokens=5 + (i % 4), temperature=0.0,
                               ignore_eos=True))
               for i in range(4 if quick else 10)]
    clock = {"vts": 0.0}

    def tick():
        clock["vts"] += 2.5
        tuner.tick(clock["vts"])
    staggered(eng, pending, on_step=tick)
    final = eng.scheduler.mixed_token_budget
    pad = eng.ledger.pad_fraction()
    eng.close()
    return {"budget_initial": budget0, "budget_final": final,
            "adjustments": tuner.adjustments,
            "n_adjustments": stats.budget_adjustments,
            "pad_waste_frac": round(pad, 4)}


async def run_autoscale_storm(args) -> dict:
    """Static vs controller vs controller replay over the same seeded
    plan."""
    from dynamo_tpu_torch.runtime.autoscaler import TrafficShape
    from dynamo_tpu_torch.runtime.simcluster import SimCluster, SimConfig
    traffic = TrafficShape(seed=args.seed + 1)
    degraded_window = (args.degraded_start,
                       args.degraded_start + args.degraded_len)

    async def one_run(controller: bool) -> dict:
        sim = await SimCluster(SimConfig(
            workers=args.autoscale_workers,
            streams=args.autoscale_workers * 8,
            lease_ttl_s=30.0,       # a virtual storm: no expiry churn
            seed=args.seed)).start()
        try:
            return await sim.autoscale_storm(
                traffic, ticks=args.ticks, controller=controller,
                degraded_window=degraded_window)
        finally:
            await sim.stop()

    static = await one_run(False)
    ctrl = await one_run(True)
    replay = await one_run(True)
    deg_len = degraded_window[1] - degraded_window[0]
    contracts = {
        "static_split_burns":
            static["slo"]["ttft_bad_ticks"] >= 10,
        "controller_holds_ttft":
            ctrl["slo"]["ttft_bad_ticks"]
            <= max(2, static["slo"]["ttft_bad_ticks"] // 2),
        "controller_holds_itl":
            ctrl["slo"]["itl_bad_ticks"]
            <= static["slo"]["itl_bad_ticks"] + 2,
        "controller_acted": len(ctrl["controller"]["timeline"]) >= 2,
        "zero_dropped_streams":
            static["streams"]["dropped"] == 0
            and ctrl["streams"]["dropped"] == 0
            and replay["streams"]["dropped"] == 0,
        "zero_decisions_while_degraded":
            ctrl["decisions_in_degraded"] == 0
            and ctrl["controller"]["frozen_degraded"] == deg_len,
        "zero_fence_violations":
            ctrl["fence_violations"] == 0
            and replay["fence_violations"] == 0,
        "replay_bit_identical":
            replay["controller"]["timeline"]
            == ctrl["controller"]["timeline"],
    }
    return {
        "traffic": traffic.to_dict(),
        "ticks": args.ticks,
        "workers": args.autoscale_workers,
        "seed": args.seed,
        "degraded_window": list(degraded_window),
        "static": static,
        "controller": ctrl,
        "replay_timeline_len": len(replay["controller"]["timeline"]),
        "contracts": contracts,
    }


def main(argv=None) -> int:
    sys.path.insert(0, REPO_ROOT)
    ap = argparse.ArgumentParser(
        prog="torch_fleet_storm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("autoscale", "slo", "qos"),
                    default="autoscale")
    ap.add_argument("--interactive-bound-s", type=float, default=3.0,
                    help="qos mode: interactive p99 TTFT contract bound "
                         "(virtual seconds)")
    ap.add_argument("--workers", type=int, default=64,
                    help="fleet size of the slo-mode storm")
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--phase-ticks", type=int, default=15,
                    help="scrape / evaluate ticks a slo storm phase")
    ap.add_argument("--ticks", type=int, default=360,
                    help="virtual seconds of the autoscale storm (the qos "
                         "storm takes 220 past 240)")
    ap.add_argument("--autoscale-workers", type=int, default=16,
                    help="fleet size of the autoscale storm (8 + 8 split)")
    ap.add_argument("--degraded-start", type=int, default=210)
    ap.add_argument("--degraded-len", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the live-engine legs run")
    ap.add_argument("--out", default=None,
                    help="report path (default build/torch_<mode>_storm"
                         ".json)")
    ap.add_argument("--ledger-out",
                    default=os.path.join(BUILD, "torch_ledger.jsonl"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.workers = min(args.workers, 16)
        args.phase_ticks = min(args.phase_ticks, 8)
        args.ticks = min(args.ticks, 240)
    out = args.out or os.path.join(BUILD, f"torch_{args.mode}_storm.json")
    t0 = time.time()
    if args.mode == "qos":
        if args.ticks > 240:
            args.ticks = 220        # the qos storm is sized for ~220 ticks
        report = run_qos_storm(args.seed, args.ticks,
                               args.interactive_bound_s)
        report["elapsed_s"] = round(time.time() - t0, 1)
        report["ok"] = all(report["contracts"].values())
        print(json.dumps({
            "contracts": report["contracts"],
            "qos_per_class": report["qos"]["per_class"],
            "fifo_interactive_p99":
                report["fifo"]["per_class"]["interactive"]["ttft_p99_s"],
            "aging_promotions": report["qos"]["aging_promotions"],
            "timeline_len": len(report["qos"]["timeline"]),
            "slo_alerts": report["qos"]["slo_alerts"],
            "elapsed_s": report["elapsed_s"]}, indent=1))
    elif args.mode == "autoscale":
        report = asyncio.run(run_autoscale_storm(args))
        report["budget_tuning"] = run_budget_tuner(args.quick, args.device)
        report["contracts"]["budget_tuner_adjusted"] = \
            report["budget_tuning"]["n_adjustments"] >= 1
        report["elapsed_s"] = round(time.time() - t0, 1)
        report["ok"] = all(report["contracts"].values())
        print(json.dumps({
            "contracts": report["contracts"],
            "static_ttft_bad_ticks":
                report["static"]["slo"]["ttft_bad_ticks"],
            "controller_ttft_bad_ticks":
                report["controller"]["slo"]["ttft_bad_ticks"],
            "decisions": report["controller"]["controller"]["timeline"],
            "budget_tuning": report["budget_tuning"],
            "elapsed_s": report["elapsed_s"]}, indent=1))
    else:
        ledger = run_engine_ledger(args.ledger_out, args.quick, args.device)
        print(f"engine ledger: {json.dumps(ledger)}", flush=True)
        report = asyncio.run(run_fleet_storm(args))
        report["seed"] = args.seed
        report["workers"] = args.workers
        report["ledger"] = ledger
        report["elapsed_s"] = round(time.time() - t0, 1)
        report["ok"] = all(report["contracts"].values())
        print(json.dumps({"contracts": report["contracts"],
                          "alerts": report["alerts"],
                          "elapsed_s": report["elapsed_s"]}, indent=1))
    if not args.no_artifact:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out}", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
