#!/usr/bin/env python
"""torch_fleet_storm: the port's multi-tenant QoS storm on a virtual clock.

The counterpart of `tools/fleet_storm.py --mode qos` for dynamo_tpu_torch:
a seeded BATCH flash crowd arrives under steady interactive and standard
load and goes through the port's QoS machinery (runtime/qos.py):
`AdmissionState` at the door (weighted-fair admission, token buckets,
batch-first displacement, class-scaled Retry-After), `StridePicker`
ordering prefill service and decode-slot grants (weighted deficit with
bounded aging), and `select_victim` for cross-class decode preemption
charged against the preemptor's class budget. Per-class TTFT series feed
the port's `SloWatchdog` with `qos_slo_specs`. The storm runs twice with
the policy (the second a replay) and once as FIFO over the same arrivals.

Contracts (exit 1 when one is violated): interactive p99 TTFT within
its bound while FIFO's is more than twice it; batch not starved (aging
promotions > 0, every admitted batch request completes); zero dropped
streams across every preemption; at least one preemption; batch sheds
first at the door; at least one per-class SLO fires and clears; the
decision / victim timeline replays equal.

Only the qos mode is ported: `--mode slo` and `--mode autoscale` are not.
Nothing of JAX is imported.

Usage:
    python tools/torch_fleet_storm.py --mode qos [--no-artifact]
        run the storm and print the verdicts; the report goes to
        build/torch_qos_storm.json unless --no-artifact (or --out PATH)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time
import zlib

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO_ROOT, "build", "torch_qos_storm.json")


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


def main(argv=None) -> int:
    sys.path.insert(0, REPO_ROOT)
    ap = argparse.ArgumentParser(
        prog="torch_fleet_storm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("qos",), default="qos")
    ap.add_argument("--interactive-bound-s", type=float, default=3.0,
                    help="interactive p99 TTFT contract bound (virtual s)")
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=220,
                    help="virtual seconds of the storm")
    ap.add_argument("--out", default=None,
                    help=f"report path (default {DEFAULT_OUT})")
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.time()
    report = run_qos_storm(args.seed, args.ticks, args.interactive_bound_s)
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
    if not args.no_artifact:
        out = args.out or DEFAULT_OUT
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out}", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
