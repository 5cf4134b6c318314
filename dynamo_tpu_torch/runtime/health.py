"""Gray-failure detection: fleet-relative health scoring for fail-slow
workers, and the per-class hedge budget.

Copied whole from dynamo_tpu/runtime/health.py (:1-335). A worker that
stays alive but slow (a throttled card, a flaky link) trips nothing that
is crash-stop; this module folds the per-attempt latency evidence the
reliability layer produces (frontend/reliability.ReliableClient) into one
health score per worker and emits SLOW-enter / SLOW-exit decisions with
hysteresis:

- fleet-relative and robust: a worker is scored against the fleet median
  with a MAD z-score (z = 0.6745 (x - med) / MAD), MAD floored at a
  fraction of the median;
- a worker with fewer than `min_evidence` observations scores 1.0 and is
  never condemned (cold workers are exempt);
- entering SLOW takes `enter_evals` consecutive evaluations over
  `z_enter`, leaving takes `exit_evals` under `z_exit` (< z_enter);
- scoring is a pure function of the observations and the injected clock;
  every transition is appended to `timeline`.

The breaker's latency-tripped SLOW state and the hedge trigger consume it
(frontend/reliability.py), and so does the router's logit
(kv_router/scheduler.TransferAwareSelector pays HEALTH_WEIGHT * (1 -
score)); /metrics folds HEALTH_STATS and HEDGE_STATS as `llm_health_*` /
`llm_hedge_*` (frontend/service.py). Nothing feeds `observe_link_err` in
either package (the JAX package calls it only from its tests); it is kept
so the scorer's arithmetic stays the JAX package's.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class HealthStats:
    """Process-local detection counters (/metrics: llm_health_*), the
    same render-time-fold pattern as kv_router/stats.py ROUTER_STATS."""

    FIELDS = (
        "evals",            # scoring evaluations run
        "slow_enters",      # SLOW-enter decisions (hysteresis satisfied)
        "slow_exits",       # SLOW-exit decisions (recovered)
        "workers_tracked",  # workers with any latency evidence
        "workers_slow",     # workers currently marked SLOW
        "cold_exempt",      # workers under the min-evidence floor
        "min_score_milli",  # worst current health score x1000
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


class HedgeStats:
    """Hedged-dispatch counters (/metrics: llm_hedge_*)."""

    FIELDS = (
        "fired",               # hedge attempts dispatched
        "wins",                # hedge produced the first token
        "losses",              # primary produced the first token
        "budget_denied",       # hedge wanted but per-class budget said no
        "suppressed_commit",   # hedge suppressed: tokens already committed
        "no_candidate",        # hedge wanted but no healthy second instance
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)
        self.fired_by_class: Dict[str, int] = {}

    def snapshot(self) -> dict:
        out = {name: getattr(self, name) for name in self.FIELDS}
        out["fired_by_class"] = dict(self.fired_by_class)
        return out


HEALTH_STATS = HealthStats()
HEDGE_STATS = HedgeStats()


class HedgeBudget:
    """Per-class hedge budget: hedges may consume at most
    ``budget_frac`` of the class's request volume (plus a small burst
    allowance so the first sick request of a quiet class can still
    hedge). A sick fleet cannot melt itself with duplicate work: when
    every primary is slow, hedging saturates at the budget instead of
    doubling total dispatch."""

    def __init__(self, budget_frac: float = 0.1, burst: int = 2):
        self.budget_frac = float(budget_frac)
        self.burst = int(burst)
        self._requests: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}

    def on_request(self, cls: str = "") -> None:
        self._requests[cls] = self._requests.get(cls, 0) + 1

    def try_fire(self, cls: str = "") -> bool:
        """True (and charge the budget) if a hedge may fire now."""
        allowed = self.budget_frac * self._requests.get(cls, 0) + self.burst
        if self._fired.get(cls, 0) + 1 > allowed:
            return False
        self._fired[cls] = self._fired.get(cls, 0) + 1
        return True

    def snapshot(self) -> dict:
        return {"requests": dict(self._requests),
                "fired": dict(self._fired)}


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    if n % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])


class HealthScorer:
    """Per-worker health from fleet-relative robust latency statistics.

    ``observe(worker, seconds)`` feeds per-attempt service time (any
    consistent latency signal works: attempt wall time in the
    reliability layer, TTFT in the sim). ``observe_link_err(worker,
    frac)`` folds the transfer plane's signed estimator-error EWMA as
    secondary evidence: a link persistently *slower than its own
    estimate* (positive error) inflates the worker's effective z.
    ``evaluate(now)`` recomputes scores and returns the SLOW
    transitions that fired this round.
    """

    def __init__(self,
                 z_enter: float = 3.0,
                 z_exit: float = 1.5,
                 enter_evals: int = 2,
                 exit_evals: int = 2,
                 min_evidence: int = 8,
                 alpha: float = 0.3,
                 err_weight: float = 2.0,
                 z_max: float = 8.0,
                 mad_floor_frac: float = 0.05,
                 clock: Optional[Callable[[], float]] = None):
        if z_exit >= z_enter:
            raise ValueError("hysteresis requires z_exit < z_enter")
        self.z_enter = float(z_enter)
        self.z_exit = float(z_exit)
        self.enter_evals = int(enter_evals)
        self.exit_evals = int(exit_evals)
        self.min_evidence = int(min_evidence)
        self.alpha = float(alpha)
        self.err_weight = float(err_weight)
        self.z_max = float(z_max)
        self.mad_floor_frac = float(mad_floor_frac)
        self._clock = clock or time.monotonic
        # per-worker evidence
        self._ewma: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._link_err: Dict[str, float] = {}
        # per-worker decision state
        self._score: Dict[str, float] = {}
        self._z: Dict[str, float] = {}
        self._slow: Dict[str, bool] = {}
        self._enter_streak: Dict[str, int] = {}
        self._exit_streak: Dict[str, int] = {}
        # replayable decision record: {"t", "worker", "event", "z", "score"}
        self.timeline: List[dict] = []

    # -- evidence -------------------------------------------------------------

    def observe(self, worker: str, seconds: float) -> None:
        """One latency sample for ``worker`` (attempt wall time, TTFT)."""
        v = float(seconds)
        prev = self._ewma.get(worker)
        self._ewma[worker] = v if prev is None else (
            self.alpha * v + (1.0 - self.alpha) * prev)
        self._count[worker] = self._count.get(worker, 0) + 1

    def observe_link_err(self, worker: str, err_frac: float) -> None:
        """Signed transfer estimator error for a link terminating at
        ``worker`` (TransferCostModel.est_err_frac): positive = the link
        is slower than its own history predicts — gray-NIC evidence."""
        prev = self._link_err.get(worker)
        v = float(err_frac)
        self._link_err[worker] = v if prev is None else (
            self.alpha * v + (1.0 - self.alpha) * prev)

    def forget(self, worker: str) -> None:
        """Evict all state for a dead instance (watch-delete hook): a
        reused worker name must start cold, not inherit a corpse's z."""
        for d in (self._ewma, self._count, self._link_err, self._score,
                  self._z, self._slow, self._enter_streak,
                  self._exit_streak):
            d.pop(worker, None)

    def reset(self) -> None:
        self.__init__(z_enter=self.z_enter, z_exit=self.z_exit,
                      enter_evals=self.enter_evals,
                      exit_evals=self.exit_evals,
                      min_evidence=self.min_evidence, alpha=self.alpha,
                      err_weight=self.err_weight, z_max=self.z_max,
                      mad_floor_frac=self.mad_floor_frac,
                      clock=self._clock)

    # -- scoring --------------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Recompute fleet-relative scores; returns the SLOW transitions
        (timeline events) that fired this evaluation."""
        t = self._clock() if now is None else float(now)
        HEALTH_STATS.evals += 1
        warm = {w: x for w, x in self._ewma.items()
                if self._count.get(w, 0) >= self.min_evidence}
        cold = len(self._ewma) - len(warm)
        events: List[dict] = []
        if len(warm) >= 3:
            med = _median(list(warm.values()))
            mad = _median([abs(x - med) for x in warm.values()])
            mad = max(mad, self.mad_floor_frac * max(med, 1e-9), 1e-9)
            for w, x in warm.items():
                z = 0.6745 * (x - med) / mad
                z += self.err_weight * max(0.0, self._link_err.get(w, 0.0))
                self._z[w] = z
                self._score[w] = min(1.0, max(
                    0.0, 1.0 - max(0.0, z) / self.z_max))
                events.extend(self._hysteresis(w, z, t))
        # cold workers (and everyone, pre-quorum) are healthy by fiat
        for w in self._ewma:
            if w not in warm:
                self._z[w] = 0.0
                self._score[w] = 1.0
        HEALTH_STATS.workers_tracked = len(self._ewma)
        HEALTH_STATS.workers_slow = sum(
            1 for v in self._slow.values() if v)
        HEALTH_STATS.cold_exempt = cold
        scores = [v for v in self._score.values()]
        HEALTH_STATS.min_score_milli = int(
            1000 * (min(scores) if scores else 1.0))
        return events

    def _hysteresis(self, worker: str, z: float, t: float) -> List[dict]:
        events: List[dict] = []
        if not self._slow.get(worker, False):
            if z >= self.z_enter:
                streak = self._enter_streak.get(worker, 0) + 1
                self._enter_streak[worker] = streak
                if streak >= self.enter_evals:
                    self._slow[worker] = True
                    self._enter_streak[worker] = 0
                    HEALTH_STATS.slow_enters += 1
                    events.append(self._record(
                        t, worker, "slow_enter", z))
            else:
                self._enter_streak[worker] = 0
        else:
            if z <= self.z_exit:
                streak = self._exit_streak.get(worker, 0) + 1
                self._exit_streak[worker] = streak
                if streak >= self.exit_evals:
                    self._slow[worker] = False
                    self._exit_streak[worker] = 0
                    HEALTH_STATS.slow_exits += 1
                    events.append(self._record(
                        t, worker, "slow_exit", z))
            else:
                self._exit_streak[worker] = 0
        return events

    def _record(self, t: float, worker: str, event: str, z: float) -> dict:
        ev = {"t": round(float(t), 6), "worker": worker, "event": event,
              "z": round(float(z), 4),
              "score": round(self._score.get(worker, 1.0), 4)}
        self.timeline.append(ev)
        return ev

    # -- consumers ------------------------------------------------------------

    def score(self, worker: str) -> float:
        """Health in [0, 1]; 1.0 absent evidence (never condemn cold)."""
        return self._score.get(worker, 1.0)

    def zscore(self, worker: str) -> float:
        return self._z.get(worker, 0.0)

    def is_slow(self, worker: str) -> bool:
        return self._slow.get(worker, False)

    def slow_workers(self) -> List[str]:
        return sorted(w for w, v in self._slow.items() if v)

    def evidence(self, worker: str) -> int:
        return self._count.get(worker, 0)

    def snapshot(self) -> dict:
        return {
            "workers": {
                w: {"score": round(self._score.get(w, 1.0), 4),
                    "z": round(self._z.get(w, 0.0), 4),
                    "n": self._count.get(w, 0),
                    "slow": self._slow.get(w, False)}
                for w in sorted(self._ewma)},
            "slow": self.slow_workers(),
            "timeline_len": len(self.timeline),
        }


# process-wide scorer the reliability layer and /metrics folds consult
HEALTH = HealthScorer()
