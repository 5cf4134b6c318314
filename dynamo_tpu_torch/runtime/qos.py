"""Multi-tenant QoS: priority classes, weighted-fair admission, the
engine's preemption policy.

Copied from dynamo_tpu/runtime/qos.py (:1-485): the class table
(QosClass / QosPolicy / DEFAULT_POLICY), the baggage accessors (`qos_of`,
`qos_label`, `set_qos`), the admission half (`STRIDE_K`, `StridePicker`,
`TokenBucket`, `AdmissionDecision`, `AdmissionState`, `now_monotonic`),
the engine scheduler's `select_victim` and the process-wide QOS_STATS
counters.

- The class name rides `Context.baggage[QOS_KEY]`, as the trace context
  rides `baggage["trace"]`: the dispatch envelope ships baggage verbatim
  over every wire hop (runtime/component.py), so admission and the engine
  scheduler see the same class.
- StridePicker: deterministic weighted-fair ordering (stride scheduling;
  each service advances a class's virtual pass by K / weight) with a
  bounded-aging no-starvation guarantee: a backlogged class skipped
  `aging_limit` consecutive picks is served next.
- AdmissionState: the synchronous core of weighted-fair admission
  (per-class token-bucket rate budgets, optional per-class concurrency
  caps, class-aware shed with batch-first displacement, Retry-After
  scaled by the shedder's class queue depth). The async
  frontend/reliability.AdmissionControl wraps it with futures.
- select_victim: lowest QoS priority first, youngest (fewest computed
  tokens) within a class.

Pure stdlib: the engine scheduler, the frontend and the reliability layer
all import it. The router scales its transfer cost by the class's
`latency_weight` (kv_router/router.KvRouter.schedule), and the SLO
watchdog's per-class specs take the class targets. The class-weighted
prefill queue (dynamo_tpu/disagg/queue.py:118-163) waits for ROADMAP A9.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Context.baggage key the class name rides under (the TRACE_KEY twin)
QOS_KEY = "qos"

# stride constant: pass increments are STRIDE_K / weight, so integer-ish
# weights keep ratios exact in float arithmetic at any realistic scale
STRIDE_K = 10_000.0


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One tenant class and its budgets and targets.

    `priority` orders classes for preemption and queue bypass (higher
    preempts lower); `weight` sets the weighted-fair admission share;
    `rate_per_s`/`burst` are the admission token bucket (0 = unlimited);
    `max_concurrency` caps simultaneously admitted requests of this class
    (0 = no cap); `ttft_target_s`/`itl_target_s` feed the per-class
    SloSpecs the watchdog pages on (observability/slo.qos_slo_specs);
    `preempt_budget` bounds OUTSTANDING cross-class preemptions this
    class may cause (debt repaid when a victim resumes — 0 means the
    class may never preempt anyone); `latency_weight` scales the router's
    transfer / backlog cost term (kv_router/scheduler.py
    TransferAwareSelector: latency-sensitive classes avoid backlogged
    links first)."""

    name: str
    priority: int
    weight: float = 1.0
    rate_per_s: float = 0.0
    burst: float = 0.0
    max_concurrency: int = 0
    ttft_target_s: float = 2.0
    itl_target_s: float = 0.25
    preempt_budget: int = 0
    latency_weight: float = 1.0


DEFAULT_CLASSES: Tuple[QosClass, ...] = (
    QosClass("interactive", priority=2, weight=8.0, ttft_target_s=0.5,
             itl_target_s=0.1, preempt_budget=4, latency_weight=2.0),
    QosClass("standard", priority=1, weight=3.0, ttft_target_s=2.0,
             itl_target_s=0.25, preempt_budget=1, latency_weight=1.0),
    # the batch TTFT target sits inside the serving histogram's bucket
    # ladder (top finite bound 30 s): the bucket quantile cannot exceed
    # the largest finite bound, so a target at the top could never fire
    QosClass("batch", priority=0, weight=1.0, ttft_target_s=20.0,
             itl_target_s=1.0, preempt_budget=0, latency_weight=0.5),
)


class QosPolicy:
    """The class table + the bounds every consumer shares.

    `aging_limit` is THE no-starvation bound: any
    weighted-fair or priority-ordered consumer (admission grants,
    prefill-queue dequeue, scheduler queue bypass) may skip a
    backlogged lower class at most `aging_limit` consecutive times
    before it MUST be served/pinned. Unknown class names resolve to
    `default` — a misconfigured client degrades to standard service,
    never to an error or to accidental priority."""

    def __init__(self, classes: Sequence[QosClass] = DEFAULT_CLASSES,
                 default: str = "standard", aging_limit: int = 16):
        if not classes:
            raise ValueError("QosPolicy needs at least one class")
        self.classes: Dict[str, QosClass] = {c.name: c for c in classes}
        if default not in self.classes:
            default = next(iter(self.classes))
        self.default = default
        if aging_limit < 1:
            raise ValueError("aging_limit must be >= 1")
        self.aging_limit = aging_limit

    def resolve(self, name: Optional[str]) -> QosClass:
        return self.classes.get(name or "", self.classes[self.default])

    def names(self) -> List[str]:
        """Class names, highest priority first."""
        return sorted(self.classes,
                      key=lambda n: -self.classes[n].priority)

    def priority_of(self, name: Optional[str]) -> int:
        return self.resolve(name).priority


DEFAULT_POLICY = QosPolicy()


# -- baggage carriage ----------------------------------------------------------


def qos_of(baggage: Optional[dict]) -> str:
    """Class name riding the request baggage ('' when unclassed)."""
    if not baggage:
        return ""
    v = baggage.get(QOS_KEY)
    return v if isinstance(v, str) else ""


def qos_label(baggage: Optional[dict],
              policy: Optional[QosPolicy] = None) -> str:
    """Metrics label for the request's class: the resolved class name
    (unknown/unclassed requests label as the policy default, so the
    per-class histograms partition every request exactly once)."""
    return (policy or DEFAULT_POLICY).resolve(qos_of(baggage)).name


def set_qos(baggage: dict, name: str) -> dict:
    baggage[QOS_KEY] = name
    return baggage


# -- weighted-fair ordering with bounded aging ---------------------------------


class StridePicker:
    """Deterministic weighted-fair class ordering (stride scheduling)
    with the policy's bounded-aging no-starvation guarantee.

    Service ratios converge to the class weight ratios; a backlogged
    class skipped `aging_limit` consecutive `charge()` rounds jumps the
    order regardless of its pass value (`aging_promotions` counts the
    jumps: the evidence that batch was not starved). Pure state
    machine: no clocks, no randomness — replay-identical."""

    def __init__(self, policy: QosPolicy):
        self.policy = policy
        self._pass: Dict[str, float] = {}
        self._skipped: Dict[str, int] = {}
        self.aging_promotions = 0
        self.served: Dict[str, int] = {}

    def _stride(self, cls: str) -> float:
        return STRIDE_K / max(1e-6, self.policy.resolve(cls).weight)

    def order(self, backlogged: Iterable[str]) -> List[str]:
        """Service order over the currently-backlogged classes: aged
        classes first (no-starvation), then ascending virtual pass,
        priority then name as deterministic tie-breaks."""
        classes = [c for c in backlogged]
        if not classes:
            return []
        base = min(self._pass.values()) if self._pass else 0.0
        for c in classes:
            # a newly-backlogged class starts at the current floor, so
            # an idle class can't bank unbounded credit and then burst
            self._pass.setdefault(c, base)
            self._pass[c] = max(self._pass[c], base)
            self._skipped.setdefault(c, 0)
        aged = [c for c in classes
                if self._skipped[c] >= self.policy.aging_limit]

        def key(c: str):
            return (self._pass[c], -self.policy.priority_of(c), c)

        rest = sorted((c for c in classes if c not in aged), key=key)
        return sorted(aged, key=key) + rest

    def charge(self, served: str,
               backlogged: Iterable[str] = ()) -> None:
        """Account one service of `served`; every OTHER backlogged
        class's skip counter advances (the aging clock)."""
        if self._skipped.get(served, 0) >= self.policy.aging_limit:
            self.aging_promotions += 1
        self._pass[served] = self._pass.get(served, 0.0) \
            + self._stride(served)
        self._skipped[served] = 0
        self.served[served] = self.served.get(served, 0) + 1
        for c in backlogged:
            if c != served:
                self._skipped[c] = self._skipped.get(c, 0) + 1


# -- admission core ------------------------------------------------------------


class TokenBucket:
    """Per-class admission rate budget (clock-injectable)."""

    def __init__(self, rate_per_s: float, burst: float):
        self.rate = max(0.0, rate_per_s)
        self.burst = max(burst, self.rate) if self.rate else 0.0
        self._tokens = self.burst
        self._last: Optional[float] = None

    def take(self, now: float, n: float = 1.0) -> bool:
        if self.rate <= 0.0:
            return True       # unlimited
        if self._last is None:
            self._last = now
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


@dataclasses.dataclass
class AdmissionDecision:
    """One try_admit outcome. kind: "admit" | "queue" | "shed" |
    "displace" (shed the newest queued request of `victim_class` —
    always the lowest-priority backlogged class, so batch sheds first —
    then queue the arrival)."""

    kind: str
    retry_after_s: int = 0
    victim_class: str = ""


class AdmissionState:
    """Synchronous core of weighted-fair admission.

    Work-conserving: any class may use free inflight slots (a lone
    batch tenant gets the whole box); fairness bites only under
    contention — freed slots grant to queued classes in StridePicker
    order (weighted-fair + bounded aging), over-cap arrivals shed the
    LOWEST-priority queued work first (displacement), and each class's
    token-bucket rate budget and optional concurrency cap bound what
    it can claim at all. Retry-After scales with the shedder's own
    class queue depth (a deep batch backlog tells batch clients to
    back off longer; it says nothing to interactive clients).

    Clock-injectable and future-free: the async AdmissionControl
    manages waiter futures; tests drive this directly on a virtual
    clock."""

    def __init__(self, policy: QosPolicy, max_inflight: int,
                 max_queued: int = 0, retry_after_s: int = 1):
        self.policy = policy
        self.max_inflight = max_inflight
        self.max_queued = max_queued
        self.retry_after_s = retry_after_s
        self.picker = StridePicker(policy)
        self.active: Dict[str, int] = {}
        self.queued: Dict[str, int] = {}
        self.buckets: Dict[str, TokenBucket] = {
            name: TokenBucket(c.rate_per_s, c.burst)
            for name, c in policy.classes.items()}
        self.displaced = 0

    # -- helpers --------------------------------------------------------------

    def _cls(self, name: Optional[str]) -> QosClass:
        return self.policy.resolve(name)

    def active_total(self) -> int:
        return sum(self.active.values())

    def queued_total(self) -> int:
        return sum(self.queued.values())

    def retry_after(self, cls_name: str) -> int:
        """Class-aware Retry-After: base scaled by the shedder's OWN
        class queue depth (a constant hint makes every shed client retry
        into the same wall)."""
        depth = self.queued.get(cls_name, 0)
        return max(1, int(self.retry_after_s * (1 + depth)))

    # -- transitions ----------------------------------------------------------

    def try_admit(self, qos: Optional[str], now: float
                  ) -> AdmissionDecision:
        c = self._cls(qos)
        if not self.buckets[c.name].take(now):
            # over the class rate budget: shed THIS request, whatever
            # its priority — budgets are the inter-tenant contract
            return AdmissionDecision("shed",
                                     retry_after_s=self.retry_after(c.name))
        over_cap = (c.max_concurrency
                    and self.active.get(c.name, 0) >= c.max_concurrency)
        if self.active_total() < self.max_inflight and not over_cap:
            self.active[c.name] = self.active.get(c.name, 0) + 1
            return AdmissionDecision("admit")
        if self.queued_total() < self.max_queued:
            self.queued[c.name] = self.queued.get(c.name, 0) + 1
            return AdmissionDecision("queue")
        # queue full: batch-class work sheds FIRST — displace the
        # newest queued request of the lowest-priority backlogged
        # class when the arrival outranks it; otherwise shed self
        victim = self._displacement_victim(c)
        if victim is not None:
            self.displaced += 1
            self.queued[victim] -= 1
            if not self.queued[victim]:
                del self.queued[victim]
            self.queued[c.name] = self.queued.get(c.name, 0) + 1
            return AdmissionDecision("displace", victim_class=victim,
                                     retry_after_s=self.retry_after(victim))
        return AdmissionDecision("shed",
                                 retry_after_s=self.retry_after(c.name))

    def _displacement_victim(self, arriving: QosClass) -> Optional[str]:
        lowest: Optional[str] = None
        for name, n in self.queued.items():
            if n <= 0:
                continue
            if lowest is None or (self.policy.priority_of(name)
                                  < self.policy.priority_of(lowest)):
                lowest = name
        if lowest is not None \
                and self.policy.priority_of(lowest) < arriving.priority:
            return lowest
        return None

    def grant(self) -> Optional[str]:
        """A slot freed: which queued class runs next? Weighted-fair
        with the bounded-aging guarantee (StridePicker.order); the
        caller moves one waiter of the returned class to active via
        note_granted()."""
        backlogged = [n for n, v in self.queued.items() if v > 0]
        order = self.picker.order(backlogged)
        if not order:
            return None
        cls = order[0]
        self.picker.charge(cls, backlogged)
        return cls

    def note_granted(self, cls_name: str) -> None:
        self.queued[cls_name] -= 1
        if not self.queued[cls_name]:
            del self.queued[cls_name]
        self.active[cls_name] = self.active.get(cls_name, 0) + 1

    def note_abandoned(self, cls_name: str) -> None:
        """A queued waiter gave up (timeout / displaced / cancelled)."""
        n = self.queued.get(cls_name, 0)
        if n > 1:
            self.queued[cls_name] = n - 1
        else:
            self.queued.pop(cls_name, None)

    def note_released(self, cls_name: str) -> None:
        n = self.active.get(cls_name, 0)
        if n > 1:
            self.active[cls_name] = n - 1
        else:
            self.active.pop(cls_name, None)


# -- engine preemption policy --------------------------------------------------


def seq_priority(seq, policy: QosPolicy = DEFAULT_POLICY) -> int:
    """QoS priority of a scheduler sequence (unclassed sequences rank
    at the policy default, so a class-free deployment keeps today's
    single-band youngest-first behavior everywhere)."""
    return policy.priority_of(getattr(seq, "qos", "") or None)


def select_victim(running: Iterable, policy: QosPolicy = DEFAULT_POLICY,
                  below_prio: Optional[int] = None):
    """Policy-driven preemption victim: the LOWEST-QoS-priority running
    sequence, youngest (fewest computed tokens) within that class — so
    same-class pressure keeps the historical youngest-first pick
    bit-for-bit. `below_prio` restricts candidates to classes strictly
    below it (cross-class preemption only; None = any victim, the
    memory-pressure fallback).

    No-starvation: victims requeue at the head of their class band and
    the waiting queue's bypass counter is bounded by
    `QosPolicy.aging_limit`, so a preempted batch request is skipped at
    most aging_limit times before it pins to the front;
    cross-class preemptions are additionally bounded by the
    preemptor's class `preempt_budget`."""
    victim = None
    vkey = None
    for seq in running:
        if seq is None:
            continue
        prio = seq_priority(seq, policy)
        if below_prio is not None and prio >= below_prio:
            continue
        key = (prio, seq.num_computed)
        if vkey is None or key < vkey:
            victim, vkey = seq, key
    return victim


# -- process-global stats (render-time /metrics fold) --------------------------


class QosStats:
    """Process-global QoS counters, folded into llm_qos_* gauges at
    /metrics render time (the XFER_STATS pattern). Scalars in FIELDS;
    the per-class dicts fold into labeled gauges."""

    FIELDS = ("preemptions_total", "preempt_denied_budget",
              "sched_bypasses", "sched_aging_pins",
              "queue_aging_promotions", "admission_displaced",
              "admission_aging_promotions")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.preemptions_total = 0       # cross-class scheduler preempts
        self.preempt_denied_budget = 0   # refused: class debt exhausted
        self.sched_bypasses = 0          # waiting-queue class bypasses
        self.sched_aging_pins = 0        # seqs pinned by the aging bound
        self.queue_aging_promotions = 0  # prefill-queue aging services
        self.admission_displaced = 0     # batch-first queue displacement
        self.admission_aging_promotions = 0
        self.shed_by_class: Dict[str, int] = {}
        self.preempt_by_class: Dict[str, int] = {}   # preemptOR class
        self.preempted_by_class: Dict[str, int] = {}  # victim class

    def snapshot(self) -> Dict[str, float]:
        return {name: float(getattr(self, name)) for name in self.FIELDS}

    def note_shed(self, cls_name: str) -> None:
        self.shed_by_class[cls_name] = \
            self.shed_by_class.get(cls_name, 0) + 1

    def note_preempt(self, preemptor_cls: str, victim_cls: str) -> None:
        self.preemptions_total += 1
        self.preempt_by_class[preemptor_cls] = \
            self.preempt_by_class.get(preemptor_cls, 0) + 1
        self.preempted_by_class[victim_cls] = \
            self.preempted_by_class.get(victim_cls, 0) + 1


QOS_STATS = QosStats()


# -- misc ----------------------------------------------------------------------


def now_monotonic() -> float:
    return time.monotonic()
