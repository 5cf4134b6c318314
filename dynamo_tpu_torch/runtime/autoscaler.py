"""Closed-loop fleet autoscaler: SLO-driven prefill<->decode re-roling.

Copied from dynamo_tpu/runtime/autoscaler.py (all of it). The controller
closes the loop between the telemetry plane and the actuators:

- **sensors**: the fleet rollup's per-role aggregates
  (observability/fleet.py `role/{role}/*` series: queue depth, occupancy,
  availability) and the SLO watchdog's TTFT/ITL burn rates
  (observability/slo.py); `signals_from_store` / `signals_from_rollup`
  fold them into one `FleetSignals` snapshot;
- **actuators**: graceful drain + role re-registration
  (`ServedEndpoint.re_role` on real workers, `SimWorker.set_role` in the
  simcluster), plus shed / add-N of whole workers.

The robustness machinery around the decision function: a **cooldown**
after any actuation; **hysteresis** (a pressure direction must hold for
`hysteresis_ticks` consecutive ticks); **do-no-harm guards** (a re-role or
shed is refused below the source role's minimum, or while a previous drain
is still migrating streams); the **degraded freeze** (while the router
rides its stale-snapshot degraded mode the controller makes no decisions
and counts `frozen_degraded`); **bounded actuation** (at most `max_moves`
workers a decision and `max_moves_per_window` a `window_s`).

Decisions are a pure function of the `FleetSignals` sequence (plus the
candidate worker lists), so a seeded virtual-clock storm replays the exact
decision timeline (runtime/simcluster.py `autoscale_storm`, driven by
`TrafficShape`, the port's copy of tools/fleet_storm.py:82).

`MixedBudgetTuner` is the local self-tuning leg: it watches the step
ledger's windowed padding waste (observability/ledger.py `useful_total` /
`padded_total`) and adapts the scheduler's `mixed_token_budget` through
`Scheduler.set_mixed_token_budget`, with the same cooldown, hysteresis and
bounded-step discipline. The `llm_autoscaler_*` gauges render on the
frontend's and the exporter's /metrics (AUTOSCALER_STATS).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import random
import time
from collections import deque
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

log = logging.getLogger("dynamo_tpu_torch.autoscaler")

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


class AutoscalerStats:
    """Process-local controller counters (/metrics: llm_autoscaler_*).

    Same pattern as kv_router/stats.py ROUTER_STATS: plain numbers
    bumped on the decision path, folded into Prometheus gauges at
    /metrics render time by frontend/service.py and
    observability/exporter.py. `last_decision_age_s` is derived at
    snapshot time from the last actuation's timestamp — the "is the
    controller alive or wedged" signal an operator reads first."""

    FIELDS = (
        "decisions_total",            # actuated decisions, all kinds
        "decisions_re_role_to_prefill",
        "decisions_re_role_to_decode",
        "decisions_add",
        "decisions_shed",
        "cooldown_suppressed",        # pressure seen inside cooldown
        "hysteresis_suppressed",      # pressure not yet sustained
        "guard_blocked",              # do-no-harm refusals
        "frozen_degraded",            # ticks frozen by degraded mode
        "last_decision_age_s",        # seconds since the last actuation
        "budget_adjustments",         # MixedBudgetTuner actuations
        "budget_current",             # last applied mixed_token_budget
    )

    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)
        self.last_decision_ts: Optional[float] = None

    def note_decision(self, kind: str, ts: float) -> None:
        self.decisions_total += 1
        field = "decisions_" + kind
        setattr(self, field, getattr(self, field) + 1)
        self.last_decision_ts = ts

    def snapshot(self) -> Dict[str, float]:
        out = {name: getattr(self, name) for name in self.FIELDS}
        if self.last_decision_ts is not None:
            out["last_decision_age_s"] = max(
                0.0, self._clock() - self.last_decision_ts)
        return out


AUTOSCALER_STATS = AutoscalerStats()


@dataclasses.dataclass
class RoleState:
    """One role's aggregate view (the rollup's `role/{role}/*` series)."""

    workers: int = 0            # ready (non-draining) workers
    draining: int = 0
    queue_depth: float = 0.0    # waiting requests across the role
    occupancy: float = 0.0      # active slots / total slots
    availability: float = 1.0   # ready / (ready + draining)


@dataclasses.dataclass
class FleetSignals:
    """One controller tick's sensor snapshot. A pure value: the
    decision function sees nothing else, which is what makes a seeded
    storm's decision timeline replayable."""

    ts: float
    roles: Dict[str, RoleState]
    ttft_burn: float = 0.0       # short-window burn rate of the TTFT SLO
    itl_burn: float = 0.0        # short-window burn rate of the ITL SLO
    ttft_firing: bool = False
    itl_firing: bool = False
    degraded: bool = False       # router stale-snapshot degraded mode
    drains_active: int = 0       # re-role/drain actuations still migrating


def signals_from_store(store, watchdog, ts: float,
                       ttft_slo: str = "ttft_p95",
                       itl_slo: str = "itl_p99",
                       degraded: bool = False,
                       drains_active: int = 0) -> FleetSignals:
    """Build FleetSignals from the rollup's SeriesStore schema
    (`role/{role}/{field}`) plus the watchdog's burn state. Shared by
    the live path (signals_from_rollup) and the virtual-clock storm,
    so the controller consumes ONE sensor schema everywhere."""
    roles: Dict[str, RoleState] = {}
    for name in store.names("role/"):
        _, role, field = name.split("/", 2)
        series = store.get(name)
        latest = series.latest() if series is not None else None
        if latest is None:
            continue
        st = roles.setdefault(role, RoleState())
        if field == "workers":
            st.workers = int(latest)
        elif field == "draining":
            st.draining = int(latest)
        elif field == "queue_depth":
            st.queue_depth = latest
        elif field == "occupancy":
            st.occupancy = latest
        elif field == "availability":
            st.availability = latest
    sig = FleetSignals(ts=ts, roles=roles, degraded=degraded,
                       drains_active=drains_active)
    if watchdog is not None:
        for spec_name, st in watchdog.states.items():
            if ttft_slo in spec_name:
                sig.ttft_burn = st.burn_short or 0.0
                sig.ttft_firing = st.firing
            elif itl_slo in spec_name:
                sig.itl_burn = st.burn_short or 0.0
                sig.itl_firing = st.firing
    return sig


def signals_from_rollup(rollup, watchdog, ts: Optional[float] = None,
                        ttft_slo: str = "ttft_p95",
                        itl_slo: str = "itl_p99",
                        drains_active: int = 0) -> FleetSignals:
    """The live-fleet sensor fold: rollup series (recorded by
    `FleetRollup.scrape_once`, incl. the per-role aggregates) +
    watchdog burn state + the router's degraded flag."""
    from dynamo_tpu_torch.runtime.cpstats import CP_STATS
    if ts is None:
        ts = rollup.clock()
    return signals_from_store(rollup.store, watchdog, ts,
                              ttft_slo=ttft_slo, itl_slo=itl_slo,
                              degraded=bool(CP_STATS.router_degraded),
                              drains_active=drains_active)


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Controller policy. The defaults are tuned for ~1 Hz ticks over
    the rollup's 1 s series."""

    min_prefill: int = 1          # do-no-harm floor per role
    min_decode: int = 1
    cooldown_s: float = 20.0      # quiet period after ANY actuation
    hysteresis_ticks: int = 3     # sustained-pressure floor
    max_moves: int = 2            # workers per decision
    max_moves_per_window: int = 8   # bounded actuation over window_s
    window_s: float = 120.0
    queue_hi: float = 3.0         # waiting per prefill worker => hot
    queue_lo: float = 0.25        # => cold (shed candidate)
    occ_hi: float = 0.85          # decode slot occupancy => hot
    occ_lo: float = 0.30          # => cold
    burn_hi: float = 1.0          # SLO burn rate counted as pressure
    # steady-state homing: with both roles quiet, drift the split back
    # toward this prefill fraction (None = no homing — the fleet stays
    # wherever the last storm left it). The reference planner's
    # configured baseline ratio; what re-roles flash-crowd conscripts
    # back to decode once the queue drains.
    target_prefill_frac: Optional[float] = None

    def role_min(self, role: str) -> int:
        return self.min_prefill if role == ROLE_PREFILL else self.min_decode


@dataclasses.dataclass(frozen=True)
class Decision:
    """One actuated controller decision (the timeline unit)."""

    ts: float
    kind: str                     # re_role_to_prefill | re_role_to_decode
    #                               | add | shed
    workers: Tuple[str, ...]      # targets ('' for add: count only)
    from_role: str = ""
    to_role: str = ""
    count: int = 0
    reason: str = ""

    def to_dict(self) -> dict:
        return {"ts": round(self.ts, 3), "kind": self.kind,
                "workers": list(self.workers),
                "from_role": self.from_role, "to_role": self.to_role,
                "count": self.count, "reason": self.reason}


class Cooldown:
    """Per-controller actuation cooldown (virtual-clock friendly)."""

    def __init__(self, cooldown_s: float):
        self.cooldown_s = cooldown_s
        self.last_ts: Optional[float] = None

    def ready(self, ts: float) -> bool:
        return self.last_ts is None or ts - self.last_ts >= self.cooldown_s

    def note(self, ts: float) -> None:
        self.last_ts = ts


class Hysteresis:
    """Consecutive-tick streak per pressure direction; a direction
    change resets the streak, so flapping pressure never actuates."""

    def __init__(self):
        self.direction: Optional[str] = None
        self.streak = 0

    def observe(self, direction: Optional[str]) -> int:
        if direction is None:
            self.direction, self.streak = None, 0
        elif direction == self.direction:
            self.streak += 1
        else:
            self.direction, self.streak = direction, 1
        return self.streak


class FleetAutoscaler:
    """The decision loop. `decide(signals, candidates)` is pure;
    `actuate()` hands decisions to the injected async actuator (the
    storm's `SimWorker.set_role`, a real fleet's
    `ServedEndpoint.re_role`). This class OWNS the cooldown and
    hysteresis objects."""

    def __init__(self, cfg: Optional[AutoscalerConfig] = None,
                 actuator: Optional[
                     Callable[[Decision], Awaitable[None]]] = None,
                 stats: Optional[AutoscalerStats] = None):
        self.cfg = cfg or AutoscalerConfig()
        self.actuator = actuator
        self.stats = stats if stats is not None else AUTOSCALER_STATS
        self.cooldown = Cooldown(self.cfg.cooldown_s)
        self.hysteresis = Hysteresis()
        self._window: deque = deque()     # (ts, moves) actuation history
        self.timeline: List[dict] = []    # actuated decisions, in order
        self.frozen_ticks = 0
        self.ticks = 0

    # -- pressure classification ---------------------------------------------

    def _plan(self, sig: FleetSignals) -> Optional[Tuple[str, str]]:
        """(direction, reason) for this tick, or None when balanced."""
        cfg = self.cfg
        p = sig.roles.get(ROLE_PREFILL, RoleState())
        d = sig.roles.get(ROLE_DECODE, RoleState())
        queue_per_p = p.queue_depth / max(1, p.workers)
        prefill_hot = (sig.ttft_firing or sig.ttft_burn >= cfg.burn_hi
                       or queue_per_p >= cfg.queue_hi)
        decode_hot = (sig.itl_firing or sig.itl_burn >= cfg.burn_hi
                      or d.occupancy >= cfg.occ_hi)
        if prefill_hot and decode_hot:
            return ("add", f"both roles hot (queue/prefill={queue_per_p:.2f},"
                           f" decode occ={d.occupancy:.2f})")
        if prefill_hot:
            return ("re_role_to_prefill",
                    f"ttft burn={sig.ttft_burn:.2f} firing={sig.ttft_firing}"
                    f" queue/prefill={queue_per_p:.2f}")
        if decode_hot:
            return ("re_role_to_decode",
                    f"itl burn={sig.itl_burn:.2f} firing={sig.itl_firing}"
                    f" decode occ={d.occupancy:.2f}")
        prefill_quiet = queue_per_p <= cfg.queue_lo and not sig.ttft_firing
        decode_cold = d.occupancy <= cfg.occ_lo and not sig.itl_firing
        # shed demands REAL idleness on both sides (occupancy floors,
        # not just an empty queue — an empty queue with busy workers
        # means capacity exactly matches demand, not excess)
        prefill_cold = prefill_quiet and p.occupancy <= cfg.occ_lo
        if cfg.target_prefill_frac is not None:
            # homing: both roles quiet and the split off the configured
            # steady-state ratio — drift back, one paced decision at a
            # time (what returns flash-crowd conscripts to decode)
            total = p.workers + d.workers
            target_p = int(round(cfg.target_prefill_frac * total))
            if p.workers > target_p and prefill_quiet \
                    and p.occupancy <= 2 * cfg.occ_lo:
                return ("re_role_to_decode",
                        f"homing: prefill {p.workers} > target {target_p} "
                        f"while idle (occ={p.occupancy:.2f})")
            if p.workers < target_p and decode_cold:
                return ("re_role_to_prefill",
                        f"homing: prefill {p.workers} < target {target_p} "
                        f"while decode idle (occ={d.occupancy:.2f})")
        if prefill_cold and decode_cold:
            return ("shed", f"fleet idle (queue/prefill={queue_per_p:.2f},"
                            f" prefill occ={p.occupancy:.2f},"
                            f" decode occ={d.occupancy:.2f})")
        return None

    # -- bounded actuation budget --------------------------------------------

    def _window_budget(self, ts: float) -> int:
        while self._window and ts - self._window[0][0] > self.cfg.window_s:
            self._window.popleft()
        used = sum(n for _, n in self._window)
        return max(0, self.cfg.max_moves_per_window - used)

    # -- the decision function -----------------------------------------------

    def decide(self, sig: FleetSignals,
               candidates: Dict[str, List[str]]) -> List[Decision]:
        """One controller tick. `candidates` maps role -> orderable
        worker ids (preference order: the caller puts the least-loaded
        first). Returns the actuated decisions (0 or 1 per tick);
        every suppression lands on a stats counter instead."""
        cfg, stats = self.cfg, self.stats
        self.ticks += 1
        if sig.degraded:
            # degraded freeze: the snapshot is sanctioned-stale; hold
            # everything (incl. the hysteresis streak) until it clears
            self.frozen_ticks += 1
            stats.frozen_degraded += 1
            return []
        planned = self._plan(sig)
        streak = self.hysteresis.observe(planned[0] if planned else None)
        if planned is None:
            return []
        direction, reason = planned
        if streak < cfg.hysteresis_ticks:
            stats.hysteresis_suppressed += 1
            return []
        if not self.cooldown.ready(sig.ts):
            stats.cooldown_suppressed += 1
            return []
        if sig.drains_active > 0:
            # do-no-harm: a previous drain is still migrating streams
            stats.guard_blocked += 1
            return []
        budget = min(cfg.max_moves, self._window_budget(sig.ts))
        if budget <= 0:
            stats.guard_blocked += 1
            return []
        decision = self._build(sig, candidates, direction, reason, budget)
        if decision is None:
            stats.guard_blocked += 1
            return []
        self.cooldown.note(sig.ts)
        self._window.append((sig.ts, max(1, decision.count)))
        stats.note_decision(decision.kind, sig.ts)
        self.timeline.append(decision.to_dict())
        return [decision]

    def _build(self, sig: FleetSignals, candidates: Dict[str, List[str]],
               direction: str, reason: str,
               budget: int) -> Optional[Decision]:
        cfg = self.cfg
        roles = sig.roles

        def headroom(role: str) -> int:
            st = roles.get(role, RoleState())
            return st.workers - st.draining - cfg.role_min(role)

        if direction in ("re_role_to_prefill", "re_role_to_decode"):
            src = ROLE_DECODE if direction.endswith("prefill") else \
                ROLE_PREFILL
            dst = ROLE_PREFILL if src == ROLE_DECODE else ROLE_DECODE
            n = min(budget, headroom(src), len(candidates.get(src, ())))
            if n <= 0:
                return None     # role-minimum guard (or no candidates)
            return Decision(sig.ts, direction,
                            tuple(candidates[src][:n]),
                            from_role=src, to_role=dst, count=n,
                            reason=reason)
        if direction == "add":
            # target the hotter role; actuation brings spare/new workers
            p = roles.get(ROLE_PREFILL, RoleState())
            d = roles.get(ROLE_DECODE, RoleState())
            queue_per_p = p.queue_depth / max(1, p.workers)
            dst = ROLE_PREFILL if (queue_per_p / max(cfg.queue_hi, 1e-9)
                                   >= d.occupancy / max(cfg.occ_hi, 1e-9)) \
                else ROLE_DECODE
            return Decision(sig.ts, "add", (), to_role=dst, count=budget,
                            reason=reason)
        if direction == "shed":
            # shed from the colder (lower-utilization) role, floor-guarded
            p = roles.get(ROLE_PREFILL, RoleState())
            d = roles.get(ROLE_DECODE, RoleState())
            queue_per_p = p.queue_depth / max(1, p.workers)
            src = ROLE_PREFILL if (queue_per_p / max(cfg.queue_hi, 1e-9)
                                   <= d.occupancy / max(cfg.occ_hi, 1e-9)) \
                else ROLE_DECODE
            n = min(1, budget, headroom(src), len(candidates.get(src, ())))
            if n <= 0:
                return None
            return Decision(sig.ts, "shed", tuple(candidates[src][:n]),
                            from_role=src, count=n, reason=reason)
        return None

    async def actuate(self, decisions: List[Decision]) -> None:
        """Hand actuated decisions to the injected actuator, one at a
        time and in order — the cooldown owned by this controller is
        what keeps consecutive drains apart."""
        if self.actuator is None:
            return
        for d in decisions:
            await self.actuator(d)

    def summary(self) -> dict:
        return {
            "ticks": self.ticks,
            "decisions": len(self.timeline),
            "frozen_ticks": self.frozen_ticks,
            "timeline": list(self.timeline),
        }


class MixedBudgetTuner:
    """Ledger-driven `mixed_token_budget` self-tuning (item-4 local leg).

    Watches the windowed padding-waste fraction of the per-step ledger
    (delta of `useful_total`/`padded_total` between ticks — NOT the
    cumulative fraction, which a long healthy history would pin) and
    adapts the scheduler's mixed-step token budget through
    `Scheduler.set_mixed_token_budget`:

    - waste above `pad_hi`: the [Bb, Tb] buckets are too wide for the
      live traffic — shrink the budget by `step_frac` (bounded below
      by `min_budget`, never to 0: 0 flips the engine to legacy
      alternating, a MODE change no tuner should make silently);
    - waste below `pad_lo` with work waiting: the ladder has headroom —
      grow by `step_frac` (bounded by `max_budget`) so prefill chunks
      ride along with more decode rows per step.

    Same safety discipline as the fleet controller: per-adjustment
    cooldown, consecutive-tick hysteresis, a minimum evidence window
    (`min_tokens` padded tokens between decisions), and bounded step
    size — a few bad steps can never collapse the budget."""

    def __init__(self, scheduler, ledger,
                 pad_lo: float = 0.10, pad_hi: float = 0.30,
                 step_frac: float = 0.25,
                 min_budget: int = 128, max_budget: int = 4096,
                 cooldown_s: float = 15.0, hysteresis_ticks: int = 2,
                 min_tokens: int = 512,
                 stats: Optional[AutoscalerStats] = None):
        self.scheduler = scheduler
        self.ledger = ledger
        self.pad_lo, self.pad_hi = pad_lo, pad_hi
        self.step_frac = step_frac
        self.min_budget, self.max_budget = min_budget, max_budget
        self.min_tokens = min_tokens
        self.cooldown = Cooldown(cooldown_s)
        self.hysteresis = Hysteresis()
        self.hysteresis_ticks = hysteresis_ticks
        self.stats = stats if stats is not None else AUTOSCALER_STATS
        self._useful0 = ledger.useful_total
        self._padded0 = ledger.padded_total
        self.adjustments: List[dict] = []

    def window_pad_frac(self) -> Optional[float]:
        """Padding-waste fraction since the last consumed window; None
        below the evidence floor."""
        dp = self.ledger.padded_total - self._padded0
        if dp < self.min_tokens:
            return None
        du = self.ledger.useful_total - self._useful0
        return max(0.0, 1.0 - du / dp)

    def tick(self, ts: float) -> Optional[int]:
        """One evaluation; returns the newly applied budget when an
        adjustment actuated, else None."""
        pad = self.window_pad_frac()
        if pad is None:
            return None
        # window consumed: the next verdict needs fresh evidence
        self._useful0 = self.ledger.useful_total
        self._padded0 = self.ledger.padded_total
        current = self.scheduler.mixed_token_budget
        if current <= 0:
            return None      # legacy alternating mode: not ours to flip
        direction = ("shrink" if pad > self.pad_hi
                     else "grow" if pad < self.pad_lo else None)
        streak = self.hysteresis.observe(direction)
        if direction is None or streak < self.hysteresis_ticks:
            return None
        if not self.cooldown.ready(ts):
            return None
        if direction == "shrink":
            target = max(self.min_budget,
                         int(current * (1.0 - self.step_frac)))
        else:
            target = min(self.max_budget,
                         int(current * (1.0 + self.step_frac)))
        if target == current:
            return None
        applied = self.scheduler.set_mixed_token_budget(target)
        self.cooldown.note(ts)
        self.stats.budget_adjustments += 1
        self.stats.budget_current = applied
        self.adjustments.append({
            "ts": round(ts, 3), "pad_frac": round(pad, 4),
            "direction": direction, "from": current, "to": applied})
        log.info("mixed_token_budget %s: %d -> %d (pad_frac=%.3f)",
                 direction, current, applied, pad)
        return applied


@dataclasses.dataclass(frozen=True)
class TrafficShape:
    """Seeded diurnal + flash-crowd traffic generator (requests/second at
    integer virtual-clock ticks; JAX tools/fleet_storm.py:82).
    `arrivals(tick)` is a pure function of (shape, tick): the fractional
    part of the rate resolves through a per-tick seeded draw, not a
    stateful rng, so any replay of the same shape produces the identical
    arrival stream."""

    seed: int = 12
    base_rate: float = 5.0        # requests/s at the diurnal midline
    diurnal_amp: float = 0.4      # peak/trough swing fraction
    diurnal_period_s: float = 240.0
    flash_start: int = 100        # flash-crowd window [start, start+len)
    flash_len: int = 60
    flash_mult: float = 2.2

    def rate(self, tick: int) -> float:
        r = self.base_rate * (1.0 + self.diurnal_amp * math.sin(
            2.0 * math.pi * tick / self.diurnal_period_s))
        if self.flash_start <= tick < self.flash_start + self.flash_len:
            r *= self.flash_mult
        return max(0.0, r)

    def arrivals(self, tick: int) -> int:
        r = self.rate(tick)
        n = int(r)
        frac_rng = random.Random(self.seed * 1000003 + tick)
        return n + (1 if frac_rng.random() < r - n else 0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficShape":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
