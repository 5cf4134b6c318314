"""Request reliability layer: zero-drop serving over a churning worker fleet.

Copied whole from dynamo_tpu/frontend/reliability.py (:1-1206). It wraps a
runtime `Client` (and an optional KvRouter) with:

- mid-stream migration: every streamed token is a committed prefix; when
  the serving worker dies (dispatch failure, transport error, a stall past
  the per-stream timeout, a worker-side ERROR frame), the request is
  re-dispatched to a surviving instance as prompt + committed tokens with
  `PreprocessedRequest.resume_committed` set (:669-683). The new worker
  re-prefills the whole sequence and continues, so the client sees no
  duplicated or missing token; a greedy stream stays token-identical to an
  uninterrupted run wherever the engine's next token depends only on the
  token sequence (float32 on the CPU; in bf16 on the card the re-prefill
  rounds differently from the decode steps it replaces, so a near tie can
  go the other way). A seeded sampled stream resumes with the same seed
  and a reset step counter: a valid continuation, not a bit-identical one;
- bounded retries with exponential backoff and jitter; committed progress
  resets the backoff;
- per-request deadlines (runtime/engine.Context.set_deadline), carried
  over the wire and bounding every dispatch and frame wait;
- a per-instance circuit breaker: N consecutive failures eject an instance
  from selection, the KV router's scoring included
  (`KvRouter.schedule(exclude=...)`, :625-668); after a cooldown one probe
  dispatch is admitted, and probe successes re-admit it. A watch delete
  makes the breaker and the health scorer forget the instance;
- load shedding (AdmissionControl, used by frontend/service.py): bounded
  concurrent admissions and a bounded wait queue, legacy or class-aware
  (runtime/qos.py); past the caps a request is shed with 429 and
  Retry-After;
- fail-slow tolerance: per-attempt first-frame times feed the health
  scorer (runtime/health.py), whose SLOW decisions drive the breaker's
  latency-tripped state (a reduced dispatch share, never an ejection), and
  pre-commit hedged dispatch (off by default, `hedge_enabled = False`):
  while nothing is committed, one budgeted hedge may race a slow primary,
  the first frame wins and the loser is cancelled, so exactly one attempt
  ever commits tokens.

The request's QoS class (its baggage) goes to KvRouter.schedule, whose
selector scales the transfer cost by the class's latency weight; a routing
failure falls back to the load-balancing pick and adds one to
ROUTER_STATS.fallbacks (/metrics: llm_router_fallbacks), as the raw sink
does. The snapshot publisher feeds the standalone exporter
(observability/exporter.py, `llm_reliability_*{source}`).
"""
from __future__ import annotations

import asyncio
import copy
import dataclasses
import logging
import random
import time
from typing import Dict, Optional, Set

from dynamo_tpu_torch.kv_router.stats import ROUTER_STATS
from dynamo_tpu_torch.observability.metrics import MetricsRegistry
from dynamo_tpu_torch.observability.serving import SERVING, ttft_quantile
from dynamo_tpu_torch.protocols.common import (
    EngineOutput, FinishReason, PreprocessedRequest, preprocessed_from_wire,
    to_wire,
)
from dynamo_tpu_torch.runtime.deadline import DeadlineExceeded, with_deadline
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.health import (
    HEALTH, HEDGE_STATS, HealthScorer, HedgeBudget,
)
from dynamo_tpu_torch.runtime.qos import QOS_STATS, AdmissionState, qos_of
from dynamo_tpu_torch.runtime.tracing import TRACE_KEY, TRACER

log = logging.getLogger("dynamo_tpu_torch.reliability")

# event-plane subject (published under a component: "{ns}.{comp}.reliability")
# carrying counter snapshots for a standalone metrics exporter
RELIABILITY_SUBJECT = "reliability"


@dataclasses.dataclass
class ReliabilityPolicy:
    """Knobs for the per-request reliability state machine (defaults sized
    for production serving; tests shrink the timeouts)."""

    # no COMMITTED frame for this long => the serving instance is presumed
    # dead and the stream migrates (data-plane keepalives keep a merely
    # slow worker alive at the transport layer, but a worker whose engine
    # died keeps the transport open while producing nothing — this is the
    # layer that catches it)
    stall_timeout_s: float = 30.0
    # bound on the dispatch round trip (instance pick + request-plane ack)
    dispatch_timeout_s: float = 10.0
    # dispatch attempts without any committed progress before giving up
    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.5          # multiplicative jitter fraction
    # default end-to-end deadline armed when the caller didn't set one
    # (None = unbounded requests stay unbounded)
    request_deadline_s: Optional[float] = None
    # how long one dispatch attempt waits for ANY serving instance to
    # appear before the attempt fails and the retry/backoff ladder
    # takes over (was a hardcoded 5.0 inside the scheduler pick)
    instance_wait_s: float = 5.0
    # -- fail-slow plane (runtime/health.py) --
    # hedged dispatch: when the primary attempt has produced NO frame
    # after the adaptive per-class delay (hedge_quantile of the live
    # TTFT histogram, floored at hedge_min_delay_s, capped at
    # hedge_max_delay_s), dispatch ONE hedge to the next-best healthy
    # instance; first frame wins, the loser is cancelled through the
    # abort path. Hedges only ever fire while the committed prefix is
    # empty, so token identity is preserved by construction.
    hedge_enabled: bool = False
    hedge_quantile: float = 0.95
    hedge_min_delay_s: float = 0.05
    hedge_max_delay_s: float = 5.0
    # per-class hedge budget: fired <= frac * class request count + burst
    hedge_budget_frac: float = 0.1
    hedge_burst: int = 2
    # cadence of fleet-relative health evaluations (runtime/health.py)
    health_eval_interval_s: float = 1.0


class ReliabilityMetrics:
    """The reliability counters, on a (shared or private) registry.

    `snapshot()` feeds the event-plane publication a standalone metrics
    exporter consumes."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.migrations = r.counter(
            "llm_reliability_migrations_total",
            "streams re-dispatched mid-stream after a worker death")
        self.retries = r.counter(
            "llm_reliability_retries_total",
            "dispatch retries (no committed progress yet)")
        self.breaker_opens = r.counter(
            "llm_reliability_breaker_opens_total",
            "circuit breaker open transitions (instance ejected)")
        self.breaker_closes = r.counter(
            "llm_reliability_breaker_closes_total",
            "circuit breaker close transitions (instance re-admitted)")
        self.shed_requests = r.counter(
            "llm_reliability_shed_requests_total",
            "requests shed at admission (429 + Retry-After)")
        self.stall_fires = r.counter(
            "llm_reliability_stall_deadline_total",
            "per-stream stall deadlines fired")
        self.deadline_exceeded = r.counter(
            "llm_reliability_deadline_exceeded_total",
            "requests failed by their end-to-end deadline")
        # class-aware admission (runtime/qos.py): sheds split per QoS
        # class — llm_reliability_shed_requests_total stays the fleet
        # total, this partitions it by tenant class
        self.shed_by_class = r.counter(
            "llm_qos_shed_total",
            "requests shed at admission, by QoS class", ("qos",))

    FIELDS = ("migrations", "retries", "breaker_opens", "breaker_closes",
              "shed_requests", "stall_fires", "deadline_exceeded")

    def snapshot(self) -> Dict[str, float]:
        return {name: getattr(self, name).get() for name in self.FIELDS}

    async def publish(self, component) -> None:
        """One counter snapshot onto the component's event plane (subject
        `{ns}.{component}.reliability`)."""
        await component.publish(RELIABILITY_SUBJECT, self.snapshot())

    def start_publishing(self, component,
                         interval_s: float = 2.0) -> asyncio.Task:
        async def loop():
            while True:
                await asyncio.sleep(interval_s)
                try:
                    await self.publish(component)
                except Exception:  # dynalint: swallow-ok=periodic-publish-retries-next-tick
                    log.exception("reliability snapshot publish failed")

        return asyncio.create_task(loop())


# -- circuit breaker ----------------------------------------------------------


@dataclasses.dataclass
class _BreakerState:
    state: str = "closed"            # closed | open | half_open
    consecutive_failures: int = 0
    probe_successes: int = 0
    open_until: float = 0.0
    probe_inflight: bool = False
    # latency-tripped SLOW plane (orthogonal to the error states above:
    # a SLOW instance still answers, so it is never fully ejected)
    slow: bool = False
    reearn_until: float = 0.0        # post-SLOW traffic re-earn ramp


class CircuitBreaker:
    """Per-instance dispatch gate (closed -> open -> half-open -> closed).

    `failure_threshold` consecutive failures open the breaker: the
    instance is ejected from selection (`blocked()` feeds both the local
    pick and KvRouter.schedule(exclude=...)). After `cooldown_s` the
    breaker goes half-open and admits ONE probe dispatch at a time;
    `probe_successes` successful probes close it, any probe failure
    re-opens it for another cooldown.

    Distinct from error-tripped OPEN is the latency-tripped **SLOW**
    state (`trip_slow`/`clear_slow`, driven by runtime/health.py's
    fleet-relative scorer): a SLOW instance is *never* ejected — it
    keeps `slow_share` of the dispatch it would otherwise win
    (`dispatch_weight`), and that residual traffic is the probe stream
    that produces the fresh latency evidence recovery needs. After
    `clear_slow` the weight ramps linearly back to 1.0 over `reearn_s`,
    so a recovered worker re-earns traffic gradually instead of being
    slammed with a full share while still warming back up.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 probe_successes: int = 1,
                 metrics: Optional[ReliabilityMetrics] = None,
                 clock=time.monotonic,
                 slow_share: float = 0.25, reearn_s: float = 30.0):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.probe_successes = probe_successes
        self.metrics = metrics
        self._clock = clock
        self.slow_share = slow_share
        self.reearn_s = reearn_s
        self._states: Dict[str, _BreakerState] = {}

    def _state(self, instance: str) -> _BreakerState:
        return self._states.setdefault(instance, _BreakerState())

    def _tick(self, st: _BreakerState) -> None:
        if st.state == "open" and self._clock() >= st.open_until:
            st.state = "half_open"
            st.probe_inflight = False
            st.probe_successes = 0

    def allow(self, instance: str) -> bool:
        """May this instance be dispatched to right now? (Does not consume
        the half-open probe slot; call on_dispatch once committed.)"""
        st = self._state(instance)
        self._tick(st)
        if st.state == "closed":
            return True
        if st.state == "half_open":
            return not st.probe_inflight
        return False

    def blocked(self) -> Set[str]:
        """Instances currently ineligible for dispatch."""
        return {i for i in self._states if not self.allow(i)}

    def on_dispatch(self, instance: str) -> None:
        """Mark a dispatch to `instance` (consumes the half-open probe)."""
        st = self._state(instance)
        if st.state == "half_open":
            st.probe_inflight = True

    def record_success(self, instance: str) -> None:
        st = self._state(instance)
        self._tick(st)
        st.consecutive_failures = 0
        if st.state == "half_open":
            st.probe_inflight = False
            st.probe_successes += 1
            if st.probe_successes >= self.probe_successes:
                st.state = "closed"
                if self.metrics:
                    self.metrics.breaker_closes.inc()
                log.info("breaker closed for %s (probes succeeded)", instance)

    def release_probe(self, instance: str) -> None:
        """Free a consumed half-open probe slot with NO outcome: the
        attempt was abandoned for reasons unrelated to the instance
        (caller cancel, request deadline). Without this, an abandoned
        probe would leave probe_inflight set forever and the instance
        permanently ejected."""
        st = self._states.get(instance)
        if st is not None and st.state == "half_open":
            st.probe_inflight = False

    def record_failure(self, instance: str) -> None:
        st = self._state(instance)
        self._tick(st)
        st.consecutive_failures += 1
        if st.state == "half_open" or (
                st.state == "closed"
                and st.consecutive_failures >= self.failure_threshold):
            reopening = st.state == "half_open"
            st.state = "open"
            st.probe_inflight = False
            st.open_until = self._clock() + self.cooldown_s
            if not reopening and self.metrics:
                self.metrics.breaker_opens.inc()
            log.warning("breaker %s for %s after %d consecutive failures",
                        "re-opened" if reopening else "opened", instance,
                        st.consecutive_failures)

    # -- latency-tripped SLOW plane (fail-slow, runtime/health.py) -----------

    def trip_slow(self, instance: str) -> None:
        """Latency trip: reduce the instance's dispatch share to
        `slow_share` without ejecting it (the residual traffic is the
        recovery probe stream)."""
        st = self._state(instance)
        if not st.slow:
            st.slow = True
            st.reearn_until = 0.0
            log.warning("breaker SLOW for %s (latency-tripped; dispatch "
                        "share reduced to %.0f%%)", instance,
                        100 * self.slow_share)

    def clear_slow(self, instance: str) -> None:
        """Recovery: start the linear re-earn ramp back to full share."""
        st = self._states.get(instance)
        if st is not None and st.slow:
            st.slow = False
            st.reearn_until = self._clock() + self.reearn_s
            log.info("breaker SLOW cleared for %s (re-earning traffic "
                     "over %.0fs)", instance, self.reearn_s)

    def is_slow(self, instance: str) -> bool:
        st = self._states.get(instance)
        return st is not None and st.slow

    def dispatch_weight(self, instance: str) -> float:
        """Fraction of would-be dispatch this instance should receive:
        1.0 healthy, `slow_share` while SLOW, ramping slow_share -> 1.0
        over `reearn_s` after recovery."""
        st = self._states.get(instance)
        if st is None:
            return 1.0
        if st.slow:
            return self.slow_share
        if st.reearn_until:
            rem = st.reearn_until - self._clock()
            if rem > 0:
                return self.slow_share + (1.0 - self.slow_share) * (
                    1.0 - rem / self.reearn_s)
            st.reearn_until = 0.0
        return 1.0

    def state_of(self, instance: str) -> str:
        """closed | open | half_open | slow (error states trump SLOW —
        an instance can be both, and OPEN is the stronger claim)."""
        st = self._states.get(instance)
        if st is None:
            return "closed"
        self._tick(st)
        if st.state == "closed" and st.slow:
            return "slow"
        return st.state

    def forget(self, instance: str) -> None:
        """Drop state for a departed instance (lease pruned for good)."""
        self._states.pop(instance, None)


# -- admission control (load shedding) ----------------------------------------


class AdmissionShed(Exception):
    """Raised by AdmissionControl.acquire when the request must be shed;
    carries the Retry-After hint (and the shed request's QoS class in
    class-aware mode)."""

    def __init__(self, retry_after_s: int, qos: str = ""):
        super().__init__("admission queue full")
        self.retry_after_s = retry_after_s
        self.qos = qos


class AdmissionControl:
    """Bounded concurrent admissions + bounded wait queue, optionally
    WEIGHTED-FAIR across QoS classes (runtime/qos.py, ROADMAP item 5).

    Without a policy (the legacy shape): up to `max_inflight` requests
    run, up to `max_queued` more wait FIFO (at most `queue_timeout_s`),
    anything past that is shed immediately — the caller maps
    AdmissionShed to HTTP 429 with Retry-After.

    With a `QosPolicy`, admission becomes class-aware end to end
    (AdmissionState owns the synchronous logic; this wrapper owns the
    futures): per-class token-bucket rate budgets and concurrency caps,
    freed slots granted to queued classes in weighted-fair order with
    the bounded-aging no-starvation guarantee, over-cap arrivals shed
    the LOWEST-priority queued work first (batch sheds before
    interactive ever does), and the Retry-After hint scales with the
    shedder's own class queue depth instead of a constant. Shed
    counters split per class (`llm_qos_shed_total{qos}`)."""

    def __init__(self, max_inflight: int, max_queued: int = 0,
                 queue_timeout_s: float = 5.0, retry_after_s: int = 1,
                 metrics: Optional[ReliabilityMetrics] = None,
                 policy=None):
        self.max_inflight = max_inflight
        self.max_queued = max_queued
        self.queue_timeout_s = queue_timeout_s
        self.retry_after_s = retry_after_s
        self.metrics = metrics
        self.policy = policy
        self.active = 0
        self._waiters: "list[asyncio.Future]" = []
        self._state = None
        self._class_waiters: Dict[str, "list[asyncio.Future]"] = {}
        if policy is not None:
            self._state = AdmissionState(policy, max_inflight,
                                         max_queued, retry_after_s)

    def _shed(self, qos: str = "",
              retry_after_s: Optional[int] = None) -> AdmissionShed:
        if self.metrics:
            self.metrics.shed_requests.inc()
            if qos:
                self.metrics.shed_by_class.inc(qos)
        if qos:
            QOS_STATS.note_shed(qos)
        return AdmissionShed(retry_after_s if retry_after_s is not None
                             else self.retry_after_s, qos)

    async def acquire(self, qos: Optional[str] = None) -> None:
        if self._state is None:
            await self._acquire_legacy()
            return
        cls = self.policy.resolve(qos).name
        d = self._state.try_admit(cls, time.monotonic())
        if d.kind == "admit":
            self.active += 1
            return
        if d.kind == "shed":
            raise self._shed(cls, d.retry_after_s)
        if d.kind == "displace":
            # batch-first displacement: the newest waiter of the
            # lowest-priority backlogged class is shed to make room
            QOS_STATS.admission_displaced += 1
            victims = self._class_waiters.get(d.victim_class, [])
            while victims:
                vic = victims.pop()
                if not vic.done():
                    vic.set_exception(self._shed(d.victim_class,
                                                 d.retry_after_s))
                    break
        fut = asyncio.get_running_loop().create_future()
        self._class_waiters.setdefault(cls, []).append(fut)
        try:
            await asyncio.wait_for(fut, self.queue_timeout_s)
        except asyncio.TimeoutError:
            waiters = self._class_waiters.get(cls, [])
            if fut in waiters:
                waiters.remove(fut)
                self._state.note_abandoned(cls)
                raise self._shed(cls,
                                 self._state.retry_after(cls)) from None
            # lost the race: release() granted the slot as we timed out
            return

    async def _acquire_legacy(self) -> None:
        if self.active < self.max_inflight:
            self.active += 1
            return
        if len(self._waiters) >= self.max_queued:
            raise self._shed()
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            await asyncio.wait_for(fut, self.queue_timeout_s)
        except asyncio.TimeoutError:
            if fut in self._waiters:
                self._waiters.remove(fut)
                raise self._shed() from None
            # lost the race: release() granted the slot as we timed out
            return

    def release(self, qos: Optional[str] = None) -> None:
        if self._state is None:
            while self._waiters:
                fut = self._waiters.pop(0)
                if not fut.done():
                    fut.set_result(None)   # slot transfers; active same
                    return
            self.active = max(0, self.active - 1)
            return
        cls = self.policy.resolve(qos).name
        self._state.note_released(cls)
        self.active = max(0, self.active - 1)
        # grant the freed slot weighted-fair across queued classes
        # (StridePicker order, bounded aging — runtime/qos.py)
        while True:
            before = self._state.picker.aging_promotions
            grant = self._state.grant()
            if grant is None:
                return
            QOS_STATS.admission_aging_promotions += \
                self._state.picker.aging_promotions - before
            waiters = self._class_waiters.get(grant, [])
            fut = None
            while waiters:
                cand = waiters.pop(0)
                if not cand.done():
                    fut = cand
                    break
            if fut is not None:
                self._state.note_granted(grant)
                self.active += 1
                fut.set_result(None)
                return
            # the picked class had no live waiter (raced a timeout that
            # hasn't noted itself yet): reconcile and try the next class
            self._state.note_abandoned(grant)


# -- the migrating client ------------------------------------------------------


class ReliableClient:
    """Wraps a runtime Client (and optional KvRouter) with the full
    reliability state machine. `generate` matches Client.generate's frame
    contract (decoded EngineOutput dicts), so it drops into
    llm/pipeline.RemoteEngineSink and direct callers alike.
    """

    def __init__(self, client, policy: Optional[ReliabilityPolicy] = None,
                 router=None, breaker: Optional[CircuitBreaker] = None,
                 metrics: Optional[ReliabilityMetrics] = None,
                 route_policy: str = "round_robin",
                 rng: Optional[random.Random] = None,
                 health: Optional[HealthScorer] = None):
        self.client = client
        self.policy = policy or ReliabilityPolicy()
        self.router = router
        self.metrics = metrics or ReliabilityMetrics()
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            metrics=self.metrics)
        self.route_policy = route_policy
        self._rng = rng or random.Random()
        self._rr = 0
        self.health = health if health is not None else HEALTH
        self._hedge_budget = HedgeBudget(self.policy.hedge_budget_frac,
                                         self.policy.hedge_burst)
        self._last_health_eval = float("-inf")
        # watch-delete eviction: a departed instance's breaker/health
        # state must not leak onto a later same-named registration (the
        # kv_router and exporter evictions' sibling hook) — without this
        # a reused worker name inherits a corpse's failure streak, SLOW
        # flag, or latency EWMA
        if hasattr(self.client, "add_listener"):
            self.client.add_listener(self._on_instance_event)

    def _on_instance_event(self, kind: str, worker_id: str,
                           info: Optional[dict]) -> None:
        # called synchronously from the watch pump — keep it cheap
        if kind == "delete":
            self.breaker.forget(worker_id)
            self.health.forget(worker_id)

    def _health_tick(self) -> None:
        """Periodic fleet-relative health evaluation; SLOW transitions
        drive the breaker's latency-tripped state."""
        now = time.monotonic()
        if now - self._last_health_eval < self.policy.health_eval_interval_s:
            return
        self._last_health_eval = now
        for ev in self.health.evaluate(now):
            if ev["event"] == "slow_enter":
                self.breaker.trip_slow(ev["worker"])
            elif ev["event"] == "slow_exit":
                self.breaker.clear_slow(ev["worker"])

    # -- instance selection ---------------------------------------------------

    async def _pick_instance(self, pre: PreprocessedRequest,
                             ctx: Context) -> str:
        # one "schedule" span per pick, covering router scoring AND the
        # load-balancing fallback. The llm_schedule_seconds histogram is
        # observed by KvRouter.schedule itself when a router is wired
        # (cluster_sim drives the router directly); only the fallback
        # path observes here, so a pick is never double-counted.
        t0 = time.monotonic()
        picked = None
        span = TRACER.begin_span("schedule", ctx.trace)
        try:
            picked = await self._pick_instance_inner(pre, ctx)
            return picked
        finally:
            if self.router is None:
                SERVING.schedule.observe(value=time.monotonic() - t0)
            TRACER.end_span(span, instance=picked,
                            error=picked is None)

    async def _pick_instance_inner(self, pre: PreprocessedRequest,
                                   ctx: Context) -> str:
        blocked = self.breaker.blocked()
        wid = await self._choose(pre, ctx, blocked)
        # latency-tripped SLOW plane: a SLOW (or still re-earning)
        # instance keeps only dispatch_weight of the picks it would
        # otherwise win — a seeded coin diverts the rest to the next
        # choice, so degraded-but-alive workers shed load without ever
        # being fully ejected
        weight = self.breaker.dispatch_weight(wid)
        if weight < 1.0 and self._rng.random() >= weight:
            alt = await self._choose(pre, ctx, blocked | {wid},
                                     required=False)
            if alt is not None:
                wid = alt
        self.breaker.on_dispatch(wid)
        return wid

    async def _choose(self, pre: PreprocessedRequest, ctx: Context,
                      exclude: Set[str],
                      required: bool = True) -> Optional[str]:
        if self.router is not None:
            try:
                # the decision log is keyed by the engine-level id: a
                # retry or migration clone logs as {id}~a{n}
                # the QoS class rides the baggage: the selector scales its
                # transfer cost by the class's latency weight
                wid = await self.router.schedule(pre.token_ids,
                                                 exclude=exclude,
                                                 request_id=pre.request_id,
                                                 qos=qos_of(ctx.baggage))
                if wid not in exclude or required:
                    return wid
                # the router's all-excluded fallback handed back an
                # excluded instance; an optional pick declines it
                return None
            except Exception:  # dynalint: swallow-ok=falls-back-to-load-balancing
                ROUTER_STATS.fallbacks += 1
                log.exception("kv routing failed; falling back to %s",
                              self.route_policy)
        ids = [i for i in self.client.instance_ids() if i not in exclude]
        if not ids:
            if not required:
                return None
            ids = self.client.instance_ids()   # all ejected: probe anyway
        if not ids:
            rem = ctx.time_remaining()
            wait = self.policy.instance_wait_s
            await with_deadline(
                self.client.wait_for_instances(
                    timeout=min(wait, rem) if rem is not None else wait),
                None, ctx)
            ids = self.client.instance_ids()
        if self.route_policy == "round_robin":
            self._rr = (self._rr + 1) % len(ids)
            wid = sorted(ids)[self._rr]
        else:
            wid = self._rng.choice(ids)
        return wid

    # -- migration bookkeeping ------------------------------------------------

    @staticmethod
    def _attempt_request(pre: PreprocessedRequest, committed: list,
                         attempt_no: int) -> PreprocessedRequest:
        if not committed and attempt_no == 1:
            return pre
        clone = copy.deepcopy(pre)
        # every re-dispatch gets a fresh engine-level id: the abandoned
        # attempt may still be ACTIVE on its worker (stall, not death) and
        # a round-robin/router re-pick can land the retry on that same
        # worker — a duplicate id there is rejected at engine admission
        clone.request_id = f"{pre.request_id}~a{attempt_no}"
        if committed:
            clone.token_ids = list(pre.token_ids) + list(committed)
            clone.resume_committed = len(committed)
        return clone

    async def _backoff(self, failures: int, ctx: Context) -> None:
        delay = min(self.policy.backoff_max_s,
                    self.policy.backoff_base_s * (2 ** max(0, failures - 1)))
        delay *= 1.0 + self.policy.backoff_jitter * self._rng.random()
        rem = ctx.time_remaining()
        if rem is not None:
            delay = min(delay, rem)
        if delay > 0:
            await asyncio.sleep(delay)

    # -- hedged dispatch (fail-slow plane) ------------------------------------

    def _hedge_delay(self, qos: str) -> float:
        """Adaptive hedge trigger: the hedge_quantile of the LIVE TTFT
        histogram (per-class view when available), floored/capped by
        policy — cold histograms fall back to the floor."""
        v = ttft_quantile(self.policy.hedge_quantile, qos)
        if not (v == v):                       # NaN: no observations yet
            return self.policy.hedge_min_delay_s
        return min(max(v, self.policy.hedge_min_delay_s),
                   self.policy.hedge_max_delay_s)

    async def _pick_hedge_instance(self, pre: PreprocessedRequest,
                                   ctx: Context,
                                   exclude: Set[str]) -> Optional[str]:
        """Next-best HEALTHY instance for a hedge (never the primary,
        never a blocked one); None when the fleet has no second choice."""
        if self.router is not None:
            wid = await self._choose(pre, ctx, exclude, required=False)
            if wid is not None and wid not in exclude:
                return wid
        ids = [i for i in self.client.instance_ids() if i not in exclude]
        if not ids:
            return None
        # healthiest-first: the hedge exists to dodge a slow primary,
        # so it goes to the best-scored candidate, not the next
        # round-robin slot
        return max(ids, key=lambda w: (self.health.score(w),
                                       self.breaker.dispatch_weight(w), w))

    async def _start_hedge(self, req: PreprocessedRequest, ctx: Context,
                           instance: str):
        """Dispatch the duplicate (hedge) attempt of ``req`` to
        ``instance`` under a fresh engine-level request id. Pre-commit
        only: the caller (_hedge_race) races first frames, first one
        WINS, and the loser is cancelled through the abort path before
        anything is committed."""
        hreq = copy.deepcopy(req)
        # a distinct engine-level id: the primary is still live on its
        # worker, and engine admission rejects duplicate in-flight ids
        hreq.request_id = f"{req.request_id}~h"
        h_ctx = ctx.child()
        # dynalint: span-ok=ends-here-on-dispatch-failure-else-in-the-race-settlement
        hspan = TRACER.begin_span("hedge", ctx.trace, instance=instance,
                                  engine_request_id=hreq.request_id)
        if hspan is not None:
            h_ctx.trace = hspan.context()
            h_ctx.baggage[TRACE_KEY] = h_ctx.trace.to_wire()
        try:
            stream = await with_deadline(
                self.client.generate(to_wire(hreq), h_ctx,
                                     instance=instance),
                self.policy.dispatch_timeout_s, ctx)
        except BaseException:
            TRACER.end_span(hspan, outcome="hedge_dispatch_failed",
                            error=True)
            raise
        return stream, stream.__aiter__(), h_ctx, hspan

    async def _abandon(self, slot: dict, record_failure: bool) -> None:
        """Close out one raced attempt: cancel its pending first-frame
        task, stop the responder, release the data-plane stream, and
        settle its breaker slot (record_failure for a genuine error,
        release_probe for a first-wins-race loser — losing a race is
        not the instance's fault)."""
        task = slot.get("task")
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            # dynalint: swallow-ok=we-cancelled-it-a-real-error-settled-the-race-already
            except (asyncio.CancelledError, Exception):
                pass
        slot["ctx"].stop_generating()
        aclose = getattr(slot["stream"], "aclose", None)
        if aclose is not None:
            try:
                await aclose()
            except Exception:  # dynalint: swallow-ok=best-effort-stream-close
                pass
        if slot.get("span") is not None:
            TRACER.end_span(slot["span"],
                            outcome="hedge_error" if record_failure
                            else "hedge_lost")
        if record_failure:
            self.breaker.record_failure(slot["inst"])
        else:
            self.breaker.release_probe(slot["inst"])

    def _race_bound(self, ctx: Context, stall_deadline: float) -> float:
        bound = stall_deadline - time.monotonic()
        rem = ctx.time_remaining()
        if rem is not None:
            bound = min(bound, rem)
        return bound

    async def _hedge_race(self, req: PreprocessedRequest, ctx: Context,
                          instance: str, stream, it, sub_ctx,
                          t0: float, qos: str):
        """Pre-commit hedge window: wait for the primary's first frame
        up to the adaptive per-class percentile delay; if the delay
        fires first (and the per-class budget allows), _start_hedge
        dispatches ONE duplicate attempt to the next-best healthy
        instance and the two first frames race. The first frame WINS;
        the loser is cancelled through the abort path (stop_generating
        + stream close + breaker probe release) BEFORE the winning
        frame is returned, so nothing is ever committed by two
        attempts — the committed prefix is empty for the whole race by
        precondition, which is what makes hedging token-exact by
        construction.

        Returns (first_frame, inst, stream, it, sub_ctx, t0, error,
        deadline_hit): the surviving attempt's plumbing with its first
        frame already pulled, or first_frame None with `error` set
        (every attempt died / stall fired) or deadline_hit True. The
        returned attempt's breaker outcome is NOT yet settled — the
        caller's normal per-attempt bookkeeping owns it.
        """
        p = {"inst": instance, "stream": stream, "it": it, "ctx": sub_ctx,
             "t0": t0, "span": None,
             "task": asyncio.ensure_future(it.__anext__())}
        try:
            return await self._hedge_race_inner(p, req, ctx, qos)
        except asyncio.CancelledError:
            # caller abort mid-race: settle both attempts' tasks, fully
            # close the hedge (the outer finally only knows the
            # primary), then stay cancelled
            hedge = p.get("_hedge")
            await self._cancel_task(p)
            if hedge is not None:
                await self._abandon(hedge, record_failure=False)
            raise

    async def _hedge_race_inner(self, p: dict, req: PreprocessedRequest,
                                ctx: Context, qos: str):
        p0 = p                      # for the unreachable-guard return
        h: Optional[dict] = None
        stall_deadline = p["t0"] + self.policy.stall_timeout_s

        def _ret(slot, frame=None, error=None, deadline=False):
            return (frame, slot["inst"], slot["stream"], slot["it"],
                    slot["ctx"], slot["t0"], error, deadline)

        # phase 1: primary alone, up to the hedge delay
        delay = self._hedge_delay(qos)
        bound = min(delay, max(0.0, self._race_bound(ctx, stall_deadline)))
        done, _ = await asyncio.wait({p["task"]}, timeout=bound)
        if p["task"] in done:
            try:
                return _ret(p, frame=p["task"].result())
            except StopAsyncIteration:
                return _ret(p, error="stream ended without finish frame")
            except Exception as e:
                return _ret(p, error=f"{type(e).__name__}: {e}")
        if ctx.is_stopped or ctx.deadline_expired:
            await self._cancel_task(p)
            return _ret(p, error="abandoned before first frame",
                        deadline=ctx.deadline_expired)

        # phase 2: fire the hedge (budgeted; next-best healthy instance)
        if not self._hedge_budget.try_fire(qos):
            HEDGE_STATS.budget_denied += 1
        else:
            h_inst = await self._pick_hedge_instance(
                req, ctx, self.breaker.blocked() | {p["inst"]})
            if h_inst is None:
                HEDGE_STATS.no_candidate += 1
            else:
                self.breaker.on_dispatch(h_inst)
                try:
                    h_stream, h_it, h_ctx, hspan = await self._start_hedge(
                        req, ctx, h_inst)
                    h = {"inst": h_inst, "stream": h_stream, "it": h_it,
                         "ctx": h_ctx, "t0": time.monotonic(),
                         "span": hspan,
                         "task": asyncio.ensure_future(h_it.__anext__())}
                    p["_hedge"] = h      # visible to the cancel handler
                    HEDGE_STATS.fired += 1
                    HEDGE_STATS.fired_by_class[qos] = \
                        HEDGE_STATS.fired_by_class.get(qos, 0) + 1
                except DeadlineExceeded:
                    self.breaker.release_probe(h_inst)
                except asyncio.CancelledError:
                    self.breaker.release_probe(h_inst)
                    raise
                except Exception as e:
                    self.breaker.record_failure(h_inst)
                    log.warning("hedge dispatch to %s failed: %s",
                                h_inst, e)

        # phase 3: first frame wins
        while True:
            live = [s for s in (p, h) if s is not None]
            if not live:
                # unreachable by construction (the last failing slot
                # returns instead of being closed out), kept as a guard
                return _ret(p0, error="all hedge attempts died")
            bound = self._race_bound(ctx, stall_deadline)
            if bound <= 0 or ctx.is_stopped or ctx.deadline_expired:
                deadline = ctx.deadline_expired
                stalled = not deadline and not ctx.is_stopped
                if stalled:
                    self.metrics.stall_fires.inc()
                # settle every slot but the one we hand back
                for s in live[1:]:
                    await self._abandon(s, record_failure=stalled)
                await self._cancel_task(live[0])
                return _ret(
                    live[0],
                    error=(f"stream stalled "
                           f">{self.policy.stall_timeout_s:.1f}s"
                           if stalled else "abandoned before first frame"),
                    deadline=deadline)
            done, _ = await asyncio.wait(
                {s["task"] for s in live}, timeout=bound,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:
                continue
            # deterministic tie-break: the primary wins a photo finish
            # (keeps cache affinity; the hedge is cancelled pre-commit)
            winner = None
            for s in (p, h):
                if s is None or s["task"] not in done:
                    continue
                try:
                    s["frame"] = s["task"].result()
                    if winner is None:
                        winner = s
                except StopAsyncIteration:
                    s["error"] = "stream ended without finish frame"
                except Exception as e:
                    s["error"] = f"{type(e).__name__}: {e}"
            if winner is not None:
                loser = h if winner is p else p
                if loser is not None:
                    if winner is h:
                        # censored evidence for the abandoned primary:
                        # it was at least this slow before losing
                        self.health.observe(
                            loser["inst"],
                            time.monotonic() - loser["t0"])
                        HEDGE_STATS.wins += 1
                    elif h is not None:
                        HEDGE_STATS.losses += 1
                    await self._abandon(
                        loser, record_failure="error" in loser)
                    if loser is h:
                        p["_hedge"] = None
                if winner is h and winner.get("span") is not None:
                    TRACER.end_span(winner["span"], outcome="hedge_won")
                    winner["span"] = None
                return _ret(winner, frame=winner["frame"])
            # no winner: every completed slot errored; drop the dead,
            # keep racing any survivor
            for name, s in (("p", p), ("h", h)):
                if s is not None and "error" in s:
                    survivors = [o for o in (p, h)
                                 if o is not None and o is not s]
                    if not survivors:
                        return _ret(s, error=s["error"])
                    await self._abandon(s, record_failure=True)
                    if name == "p":
                        p = None
                    else:
                        h = None

    @staticmethod
    async def _cancel_task(slot: dict) -> None:
        task = slot.get("task")
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            # dynalint: swallow-ok=we-cancelled-it-a-real-error-settled-the-race-already
            except (asyncio.CancelledError, Exception):
                pass

    # -- the state machine ----------------------------------------------------

    async def generate(self, request, context: Optional[Context] = None):
        """Yields EngineOutput frame dicts; the stream only ever ends with
        a finish frame (never an exception) unless the caller cancels."""
        pre = (request if isinstance(request, PreprocessedRequest)
               else preprocessed_from_wire(request))
        ctx = context or Context()
        if ctx.trace is None:
            # direct API callers (no HTTP frontend — chaos scenarios,
            # embedders) still get a per-request trace root when tracing
            # is enabled; None (one branch) otherwise
            ctx.trace = TRACER.start_trace()
        if ctx.time_remaining() is None \
                and self.policy.request_deadline_s is not None:
            ctx.set_deadline(self.policy.request_deadline_s)

        # fail-slow plane: periodic fleet-relative scoring (SLOW trips)
        # and the per-class hedge budget's request accounting
        self._health_tick()
        qos_cls = qos_of(ctx.baggage)
        if self.policy.hedge_enabled:
            self._hedge_budget.on_request(qos_cls)

        committed: list = []
        max_toks = pre.stop.max_tokens
        failures = 0          # consecutive attempts without progress
        attempt_no = 0        # total dispatches (unique engine-level ids)
        last_error = "no instances"

        while True:
            if ctx.is_stopped:
                yield _frame(FinishReason.CANCELLED)
                return
            if max_toks is not None and committed \
                    and len(committed) >= max_toks:
                # the dead worker delivered the full budget but not its
                # finish frame; nothing left to resume
                yield _frame(FinishReason.LENGTH)
                return
            if ctx.deadline_expired:
                self.metrics.deadline_exceeded.inc()
                yield _frame(FinishReason.ERROR,
                             text=f"deadline exceeded ({last_error})")
                return

            attempt_no += 1
            req = self._attempt_request(pre, committed, attempt_no)
            sub_ctx = ctx.child()
            instance = None
            # attempt span: retry/migration clones ({id}~a{n}) carry the
            # PARENT request's trace — the attempt span nests under the
            # request root, and everything the worker records for this
            # dispatch nests under the attempt (sub_ctx's baggage ships
            # the attempt's span id). `outcome` must agree with the
            # counters below (migrated<->migrations, retried<->retries).
            aspan = TRACER.begin_span(
                "attempt", ctx.trace, attempt=attempt_no,
                engine_request_id=req.request_id,
                resumed_tokens=len(committed))
            if aspan is not None:
                sub_ctx.trace = aspan.context()
                sub_ctx.baggage[TRACE_KEY] = sub_ctx.trace.to_wire()
            outcome = "abandoned"
            # breaker bookkeeping: every attempt must end in exactly one of
            # record_success / record_failure / release_probe — an attempt
            # abandoned for reasons unrelated to the instance (caller
            # cancel, request deadline) must neither poison the breaker nor
            # leak the half-open probe slot
            outcome_recorded = False
            try:
                t0 = time.monotonic()
                try:
                    instance = await self._pick_instance(req, ctx)
                    stream = await with_deadline(
                        self.client.generate(
                            to_wire(req), sub_ctx, instance=instance),
                        self.policy.dispatch_timeout_s, ctx)
                except asyncio.CancelledError:
                    raise
                except DeadlineExceeded:
                    outcome = "deadline"
                    continue      # loop head reports deadline_exceeded
                except Exception as e:
                    last_error = f"dispatch to {instance}: {e}"
                    if instance is not None:
                        self.breaker.record_failure(instance)
                        outcome_recorded = True
                    failures += 1
                    if failures >= self.policy.max_attempts:
                        outcome = "gave_up"
                        yield _frame(
                            FinishReason.ERROR,
                            text=f"gave up after {failures} attempts: "
                                 f"{last_error}")
                        return
                    outcome = "retried"
                    self.metrics.retries.inc()
                    await self._backoff(failures, ctx)
                    continue

                error: Optional[str] = None
                deadline_hit = False
                first_frame: Optional[dict] = None
                ttfb_seen = False
                try:
                    it = stream.__aiter__()
                    if self.policy.hedge_enabled and committed:
                        # pre-commit exactness guard: a resumed stream
                        # already holds committed tokens, so the hedge
                        # window never opens for it (the invariant made
                        # visible as a counter)
                        HEDGE_STATS.suppressed_commit += 1
                    if self.policy.hedge_enabled and not committed \
                            and not ctx.is_stopped:
                        # pre-commit hedge window: _hedge_race returns
                        # exactly one surviving attempt (first frame
                        # wins, loser cancelled through the abort path
                        # with nothing committed yet)
                        (first_frame, instance, stream, it, sub_ctx, t0,
                         error, deadline_hit) = await self._hedge_race(
                            req, ctx, instance, stream, it, sub_ctx,
                            t0, qos_cls)
                    while error is None and not deadline_hit:
                        if first_frame is not None:
                            frame, first_frame = first_frame, None
                        else:
                            try:
                                frame = await with_deadline(
                                    it.__anext__(),
                                    self.policy.stall_timeout_s, ctx)
                            except StopAsyncIteration:
                                error = "stream ended without finish frame"
                                break
                            except DeadlineExceeded:
                                deadline_hit = True
                                break
                            except asyncio.TimeoutError:
                                self.metrics.stall_fires.inc()
                                error = (f"stream stalled >"
                                         f"{self.policy.stall_timeout_s:.1f}s")
                                break
                        if not ttfb_seen:
                            ttfb_seen = True
                            # per-attempt first-frame latency is the
                            # gray-failure evidence stream
                            self.health.observe(instance,
                                                time.monotonic() - t0)
                        fr = frame.get("finish_reason")
                        if fr == FinishReason.ERROR.value:
                            if frame.get("retryable") is False:
                                # deterministic per-REQUEST rejection
                                # (admission/validation): retrying elsewhere
                                # fails identically, and it is not the
                                # instance's fault — forward it
                                self.breaker.record_success(instance)
                                outcome_recorded = True
                                outcome = "rejected_final"
                                yield frame
                                return
                            error = frame.get("text") or "worker error frame"
                            break
                        if fr == FinishReason.CANCELLED.value \
                                and not ctx.is_stopped:
                            # responder-side teardown the CLIENT never asked
                            # for (e.g. graceful drain escalated): migrate
                            error = "worker cancelled the stream"
                            break
                        toks = frame.get("token_ids") or ()
                        if toks:
                            committed.extend(toks)
                            failures = 0  # progress is evidence of health
                        yield frame
                        if fr is not None:
                            self.breaker.record_success(instance)
                            outcome_recorded = True
                            outcome = "success"
                            return
                except asyncio.CancelledError:
                    raise
                except Exception as e:   # transport error mid-stream
                    error = f"{type(e).__name__}: {e}"
                finally:
                    # abandon this attempt cleanly: stop the (possibly
                    # still live) responder, release the data-plane stream
                    sub_ctx.stop_generating()
                    aclose = getattr(stream, "aclose", None)
                    if aclose is not None:
                        try:
                            await aclose()
                        except Exception:  # dynalint: swallow-ok=best-effort-stream-close
                            pass

                if deadline_hit:
                    outcome = "deadline"
                    continue      # loop head reports deadline_exceeded
                if ctx.is_stopped:
                    outcome = "cancelled"
                    yield _frame(FinishReason.CANCELLED)
                    return
                last_error = f"{instance}: {error}"
                self.breaker.record_failure(instance)
                outcome_recorded = True
                failures += 1
                if failures >= self.policy.max_attempts:
                    outcome = "gave_up"
                    yield _frame(
                        FinishReason.ERROR,
                        text=f"gave up after {failures} attempts "
                             f"without progress: {last_error}")
                    return
                if committed:
                    outcome = "migrated"
                    self.metrics.migrations.inc()
                    log.warning("migrating %s (%d tokens committed): %s",
                                ctx.id, len(committed), last_error)
                else:
                    outcome = "retried"
                    self.metrics.retries.inc()
                    log.warning("retrying %s: %s", ctx.id, last_error)
                await self._backoff(failures, ctx)
            finally:
                if instance is not None and not outcome_recorded:
                    self.breaker.release_probe(instance)
                TRACER.end_span(
                    aspan, outcome=outcome, instance=instance,
                    error=outcome in ("gave_up", "deadline"))


def _frame(reason: FinishReason, text: Optional[str] = None) -> dict:
    return to_wire(EngineOutput(finish_reason=reason, text=text))
