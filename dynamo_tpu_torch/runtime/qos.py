"""Multi-tenant QoS: the class table and the engine's preemption policy.

Copied from dynamo_tpu/runtime/qos.py, trimmed to what the engine scheduler,
the worker and the serving histograms call: QosClass / QosPolicy /
DEFAULT_POLICY, the baggage accessors `qos_of` and `qos_label`,
`select_victim`, and the process-wide QOS_STATS counters. Admission
control, weighted-fair ordering and the x-qos-class header come with the
admission slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

# Context.baggage key the class name rides under
QOS_KEY = "qos"


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One tenant class as the engine scheduler sees it: `priority` orders
    classes for preemption and queue bypass (higher preempts lower);
    `preempt_budget` bounds OUTSTANDING cross-class preemptions this class
    may cause (0 = never preempts). The JAX table's admission and SLO
    budgets come with the admission slice."""

    name: str
    priority: int
    preempt_budget: int = 0


DEFAULT_CLASSES: Tuple[QosClass, ...] = (
    QosClass("interactive", priority=2, preempt_budget=4),
    QosClass("standard", priority=1, preempt_budget=1),
    QosClass("batch", priority=0, preempt_budget=0),
)


class QosPolicy:
    """The class table + the aging bound every consumer shares: a
    priority-ordered consumer may skip a backlogged lower class at most
    `aging_limit` times before it must be served. Unknown class names
    resolve to `default`."""

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

    def priority_of(self, name: Optional[str]) -> int:
        return self.resolve(name).priority


DEFAULT_POLICY = QosPolicy()


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


def seq_priority(seq, policy: QosPolicy = DEFAULT_POLICY) -> int:
    """QoS priority of a scheduler sequence (unclassed sequences rank at
    the policy default)."""
    return policy.priority_of(getattr(seq, "qos", "") or None)


def select_victim(running: Iterable, policy: QosPolicy = DEFAULT_POLICY,
                  below_prio: Optional[int] = None):
    """Preemption victim: the LOWEST-priority running sequence, youngest
    (fewest computed tokens) within that class. `below_prio` restricts
    candidates to classes strictly below it (cross-class preemption only;
    None = any victim, the memory-pressure fallback)."""
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


class QosStats:
    """Process-global scheduler QoS counters."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.preemptions_total = 0       # cross-class scheduler preempts
        self.preempt_denied_budget = 0   # refused: class debt exhausted
        self.sched_bypasses = 0          # waiting-queue class bypasses
        self.sched_aging_pins = 0        # seqs pinned by the aging bound
        self.preempt_by_class: Dict[str, int] = {}   # preemptOR class
        self.preempted_by_class: Dict[str, int] = {}  # victim class

    def note_preempt(self, preemptor_cls: str, victim_cls: str) -> None:
        self.preemptions_total += 1
        self.preempt_by_class[preemptor_cls] = \
            self.preempt_by_class.get(preemptor_cls, 0) + 1
        self.preempted_by_class[victim_cls] = \
            self.preempted_by_class.get(victim_cls, 0) + 1


QOS_STATS = QosStats()
