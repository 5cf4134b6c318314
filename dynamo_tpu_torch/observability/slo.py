"""SLO burn-rate watchdog over the fleet time-series.

Copied from dynamo_tpu/observability/slo.py: declarative SLO specs (TTFT p95, ITL p99, error rate, availability,
transfer-bandwidth floor — any series the rollup records) evaluated
with the multi-window burn-rate method over
observability/timeseries.py series, emitting `llm_slo_*` gauges and
event-plane alerts.

Burn-rate semantics (the Google SRE multi-window form, reduced to two
windows):

- a sample is **bad** when it violates the spec's objective
  (`mode="above"`: value > objective is bad; `"below"`: value <
  objective is bad — a bandwidth floor);
- the **burn rate** over a window is `bad_fraction / error_budget`
  where `error_budget = 1 - target`: burn 1.0 consumes the budget
  exactly at the promised rate, burn N consumes it N times too fast;
- the alert **fires** only when BOTH the short and the long window
  burn at `burn_threshold` or above — the short window gives fast
  detection, the long window keeps a 2-sample blip from paging;
- it **clears** with hysteresis: both windows must fall below
  `clear_threshold` (default half the fire threshold), so a burn
  hovering at the threshold cannot flap;
- a window with fewer than `min_samples` samples yields no verdict
  (None): the watchdog neither fires nor clears on missing data.

Degraded-mode awareness: the router's stale-snapshot degraded mode
is a SANCTIONED state — scheduling keeps answering on last-good
scores while the event plane catches up, and serving quality metrics
wobble by design. Specs marked `degraded_exempt=True` hold their state
frozen (no fire, no clear, `suppressed` counted) while the degraded
flag is up, so a sanctioned degradation cannot page anyone.

Everything takes explicit timestamps: a seeded, virtual-clock storm
plan (`seeded_storm_plan`) driven through evaluate() gives the
fire->clear transition deterministically. Alerts published on the event
plane (`wire_event_plane`) are encoded with the port's codec
(runtime/transports/codec.py, byte-identical to msgpack).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional

from dynamo_tpu_torch.observability.metrics import MetricsRegistry
from dynamo_tpu_torch.observability.timeseries import SeriesStore


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative SLO over one rollup series."""

    name: str                    # alert name ("ttft_p95", "bw_floor/w3")
    series: str                  # SeriesStore series the samples live in
    objective: float             # the threshold a good sample respects
    mode: str = "above"          # "above": bad when value > objective;
    #                              "below": bad when value < objective
    target: float = 0.99         # promised good fraction (error budget
    #                              = 1 - target)
    short_window_s: float = 30.0
    long_window_s: float = 300.0
    burn_threshold: float = 2.0  # fire when BOTH windows burn >= this
    clear_threshold: Optional[float] = None   # default: threshold / 2
    degraded_exempt: bool = False             # freeze during sanctioned
    #                                           degraded mode
    min_samples: int = 3         # per-window verdict floor

    def __post_init__(self):
        if self.mode not in ("above", "below"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")

    @property
    def clear_at(self) -> float:
        return (self.clear_threshold if self.clear_threshold is not None
                else self.burn_threshold / 2.0)

    def is_bad(self, value: float) -> bool:
        return (value > self.objective if self.mode == "above"
                else value < self.objective)


@dataclasses.dataclass
class SloState:
    firing: bool = False
    burn_short: Optional[float] = None
    burn_long: Optional[float] = None
    transitions: int = 0         # fire->clear or clear->fire flips
    suppressed: int = 0          # evaluations frozen by degraded mode
    fired_at: Optional[float] = None
    cleared_at: Optional[float] = None


class SloWatchdog:
    """Evaluates every spec over a SeriesStore; keeps per-SLO state,
    renders `llm_slo_*` gauges, and hands alert events (fire/clear
    dicts) to `on_alert` — typically an event-plane publish
    (`wire_event_plane`)."""

    def __init__(self, store: SeriesStore, specs: List[SloSpec],
                 registry: Optional[MetricsRegistry] = None,
                 on_alert: Optional[Callable[[dict], None]] = None,
                 degraded_fn: Optional[Callable[[], bool]] = None):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo names in {names}")
        self.store = store
        self.specs = list(specs)
        self.on_alert = on_alert
        self.degraded_fn = degraded_fn or _default_degraded
        self.states: Dict[str, SloState] = {
            s.name: SloState() for s in specs}
        self.alerts: List[dict] = []     # full event history (bounded)
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self._g_burn_short = r.gauge(
            "llm_slo_burn_rate_short",
            "SLO error-budget burn rate over the short window "
            "(1.0 = consuming the budget exactly at the promised rate)",
            ("slo",))
        self._g_burn_long = r.gauge(
            "llm_slo_burn_rate_long",
            "SLO error-budget burn rate over the long window", ("slo",))
        self._g_firing = r.gauge(
            "llm_slo_firing",
            "1 while the SLO's multi-window burn-rate alert is firing",
            ("slo",))
        self._g_transitions = r.gauge(
            "llm_slo_transitions",
            "cumulative fire/clear transitions of the SLO alert",
            ("slo",))
        self._g_suppressed = r.gauge(
            "llm_slo_suppressed",
            "SLO evaluations frozen by the router's sanctioned "
            "degraded mode (degraded_exempt specs)", ("slo",))

    # -- evaluation -----------------------------------------------------------

    def _burn(self, spec: SloSpec, window_s: float,
              ts: float) -> Optional[float]:
        series = self.store.get(spec.series)
        if series is None:
            return None
        frac = series.frac_where(spec.is_bad, window_s, ts,
                                 min_samples=spec.min_samples)
        if frac is None:
            return None
        return frac / (1.0 - spec.target)

    def evaluate(self, ts: float) -> List[dict]:
        """One evaluation pass at (virtual or wall) time `ts`; returns
        the alert events this pass emitted."""
        degraded = bool(self.degraded_fn())
        events: List[dict] = []
        for spec in self.specs:
            st = self.states[spec.name]
            bs = self._burn(spec, spec.short_window_s, ts)
            bl = self._burn(spec, spec.long_window_s, ts)
            st.burn_short, st.burn_long = bs, bl
            if spec.degraded_exempt and degraded:
                # sanctioned degradation: no false burn, no transition
                st.suppressed += 1
            elif st.firing:
                if (bs is not None and bl is not None
                        and bs < spec.clear_at and bl < spec.clear_at):
                    st.firing = False
                    st.cleared_at = ts
                    st.transitions += 1
                    events.append(self._event("clear", spec, st, ts))
            else:
                if (bs is not None and bl is not None
                        and bs >= spec.burn_threshold
                        and bl >= spec.burn_threshold):
                    st.firing = True
                    st.fired_at = ts
                    st.transitions += 1
                    events.append(self._event("fire", spec, st, ts))
            slo = spec.name
            self._g_burn_short.set(slo, value=bs if bs is not None else 0.0)
            self._g_burn_long.set(slo, value=bl if bl is not None else 0.0)
            self._g_firing.set(slo, value=1.0 if st.firing else 0.0)
            self._g_transitions.set(slo, value=st.transitions)
            self._g_suppressed.set(slo, value=st.suppressed)
        for ev in events:
            self.alerts.append(ev)
            if self.on_alert is not None:
                self.on_alert(ev)
        del self.alerts[:-1024]   # bounded history
        return events

    def _event(self, kind: str, spec: SloSpec, st: SloState,
               ts: float) -> dict:
        return {"event": kind, "slo": spec.name, "ts": round(ts, 3),
                "series": spec.series, "objective": spec.objective,
                "mode": spec.mode,
                "burn_short": round(st.burn_short, 3)
                if st.burn_short is not None else None,
                "burn_long": round(st.burn_long, 3)
                if st.burn_long is not None else None,
                "threshold": spec.burn_threshold}

    def firing(self) -> List[str]:
        return sorted(name for name, st in self.states.items()
                      if st.firing)

    def summary(self) -> dict:
        return {
            name: {"firing": st.firing,
                   "burn_short": st.burn_short,
                   "burn_long": st.burn_long,
                   "transitions": st.transitions,
                   "suppressed": st.suppressed}
            for name, st in sorted(self.states.items())}

    def render(self) -> str:
        return self.registry.render()


def _default_degraded() -> bool:
    """The router's stale-snapshot degraded flag (runtime/cpstats.py) —
    process-local, the sanctioned state the router's hysteresis manages."""
    from dynamo_tpu_torch.runtime.cpstats import CP_STATS
    return bool(CP_STATS.router_degraded)


def wire_event_plane(watchdog: SloWatchdog, messaging, subject: str):
    """Route alert events onto the runtime event plane (the transport
    every other alert-shaped signal in this repo rides): each fire/clear
    publishes the codec-packed dict on `subject`. Returns the previous
    on_alert so callers can chain."""
    import asyncio

    from dynamo_tpu_torch.runtime.transports.codec import packb
    prev = watchdog.on_alert

    def publish(ev: dict) -> None:
        if prev is not None:
            prev(ev)
        asyncio.ensure_future(
            messaging.publish(subject, packb(ev)))

    watchdog.on_alert = publish
    return prev


def qos_slo_specs(policy=None, short_window_s: float = 30.0,
                  long_window_s: float = 300.0,
                  burn_threshold: float = 2.0,
                  min_samples: int = 3) -> List[SloSpec]:
    """Per-tenant-class SloSpecs from a QosPolicy (runtime/qos.py):
    one TTFT-p95 and one ITL-p99 spec per class, objectives taken from
    the class targets, evaluating the rollup's `qos/{class}/...`
    series (FleetRollup.scrape_once records them from the per-class
    serving histograms). All specs are degraded-exempt — the router's
    sanctioned stale-snapshot mode wobbles serving quality by design
    and must not page a tenant class."""
    from dynamo_tpu_torch.runtime.qos import DEFAULT_POLICY
    policy = policy or DEFAULT_POLICY
    specs: List[SloSpec] = []
    for name in policy.names():
        c = policy.classes[name]
        specs.append(SloSpec(
            name=f"ttft_p95/{name}", series=f"qos/{name}/ttft_p95",
            objective=c.ttft_target_s, mode="above", target=0.9,
            short_window_s=short_window_s, long_window_s=long_window_s,
            burn_threshold=burn_threshold, min_samples=min_samples,
            degraded_exempt=True))
        specs.append(SloSpec(
            name=f"itl_p99/{name}", series=f"qos/{name}/itl_p99",
            objective=c.itl_target_s, mode="above", target=0.9,
            short_window_s=short_window_s, long_window_s=long_window_s,
            burn_threshold=burn_threshold, min_samples=min_samples,
            degraded_exempt=True))
    return specs


def seeded_storm_plan(seed: int, n_intervals: int = 120,
                      interval_s: float = 1.0,
                      storm_start: int = 40, storm_len: int = 40,
                      good_value: float = 0.05, bad_value: float = 2.0,
                      jitter: float = 0.2) -> List[tuple]:
    """Deterministic storm timeline for one series: a pure function of
    (seed, shape) -> [(ts, value)] with jittered good samples, a storm
    window of jittered bad samples, then recovery. A test
    replays it through a watchdog and asserts the fire->clear
    transition lands identically every run (same seed, same events)."""
    rng = random.Random(seed)
    out = []
    for i in range(n_intervals):
        base = (bad_value if storm_start <= i < storm_start + storm_len
                else good_value)
        value = base * (1.0 + jitter * (2.0 * rng.random() - 1.0))
        out.append((i * interval_s, value))
    return out
