"""Host-time attribution for the engine's decode loop, and a minimal
Prometheus-compatible metrics registry.

Copied from dynamo_tpu/observability/metrics.py: `PhaseTimer`, and
`Counter`, `Gauge`, `Histogram` (with the promql-style `quantile`) and
`MetricsRegistry` with the text exposition format the HTTP frontend serves
on GET /metrics. Stdlib only. The port has no tracer yet, so the JAX
copy's `trace_scope` hook, which also records each phase as a span, is left
out.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[str, ...]


class PhaseTimer:
    """Cumulative wall-time attribution across named phases.

    The engine wraps each host leg of a decode window in
    `with timer.phase(name):` (plan, upload, dispatch, device under
    profile_sync, fetch, commit); tools/torch_decode_profile.py reads the
    accumulated split. Overhead is two perf_counter() calls per phase,
    always on.

    With `trace_scope` set (the engine sets "engine"), each phase is also
    recorded as a span through the tracer's deferred recorder
    (runtime/tracing.py `defer_phase`): one branch when tracing is off,
    one tuple append when on. Host-only: it reads no device value and
    records nothing inside a captured graph."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.trace_scope: Optional[str] = None

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(name, dt)
            if self.trace_scope is not None:
                from dynamo_tpu_torch.runtime.tracing import TRACER
                TRACER.defer_phase(self.trace_scope, name, dt)

    def reset(self) -> None:
        self.seconds.clear()
        self.counts.clear()

    def split(self) -> Dict[str, dict]:
        """Per-phase {seconds, count, fraction} over the accumulated total."""
        total = sum(self.seconds.values()) or 1.0
        return {
            name: {"seconds": round(s, 6),
                   "count": self.counts.get(name, 0),
                   "fraction": round(s / total, 4)}
            for name, s in sorted(self.seconds.items())
        }


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _esc(v: str) -> str:
    """Escape a label value per the Prometheus exposition format."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: LabelKey,
                extra: Optional[Dict[str, str]] = None) -> str:
    parts = [f'{n}="{_esc(v)}"' for n, v in zip(names, values)]
    if extra:
        parts += [f'{n}="{_esc(v)}"' for n, v in extra.items()]
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def _check(self, labels: LabelKey):
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {labels}")

    def remove(self, *labels: str) -> None:
        """Drop one label series (e.g. a departed worker instance)."""
        self._check(labels)
        with self._lock:
            self._values.pop(labels, None)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        for labels, v in sorted(self._values.items()):
            out.append(f"{self.name}"
                       f"{_fmt_labels(self.label_names, labels)} {_fmt_value(v)}")
        if not self._values and not self.label_names:
            out.append(f"{self.name} 0")
        return out


class Counter(_Metric):
    kind = "counter"

    def inc(self, *labels: str, value: float = 1.0) -> None:
        self._check(labels)
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + value

    def get(self, *labels: str) -> float:
        return self._values.get(labels, 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, *labels: str, value: float) -> None:
        self._check(labels)
        with self._lock:
            self._values[labels] = float(value)

    def inc(self, *labels: str, value: float = 1.0) -> None:
        self._check(labels)
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + value

    def dec(self, *labels: str, value: float = 1.0) -> None:
        self.inc(*labels, value=-value)

    def get(self, *labels: str) -> float:
        return self._values.get(labels, 0.0)


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0, float("inf"))


def _bucket_quantile(buckets, counts, total: int, q: float) -> float:
    """Shared estimator under Histogram.quantile/quantile_all; see
    quantile() for semantics. `counts` are per-bucket (not cumulative)."""
    if total <= 0 or not counts:
        return float("nan")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile q must be in (0, 1], got {q}")
    target = q * total
    cum = 0.0
    for i, hi in enumerate(buckets):
        prev = cum
        cum += counts[i]
        if cum >= target:
            if hi == float("inf"):
                # cannot extrapolate: largest finite bound (or NaN when
                # the ladder somehow has no finite rung)
                return buckets[i - 1] if i else float("nan")
            lo = buckets[i - 1] if i else 0.0
            if counts[i] <= 0:
                return hi
            return lo + (hi - lo) * (target - prev) / counts[i]
    return float("nan")   # unreachable: last bucket is +Inf


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        bl = sorted(set(buckets))
        if bl[-1] != float("inf"):
            bl.append(float("inf"))
        self.buckets = tuple(bl)
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}

    def observe(self, *labels: str, value: float) -> None:
        self._check(labels)
        with self._lock:
            counts = self._counts.setdefault(labels, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            self._sums[labels] = self._sums.get(labels, 0.0) + value
            self._totals[labels] = self._totals.get(labels, 0) + 1

    def count(self, *labels: str) -> int:
        return self._totals.get(labels, 0)

    def quantile(self, q: float, *labels: str) -> float:
        """Estimate the q-quantile (0 < q <= 1) from the bucket counts —
        the promql `histogram_quantile` estimator: find the bucket the
        rank lands in, interpolate linearly inside it. Exact at bucket
        boundaries (a rank landing exactly on a bucket's cumulative
        count returns that bucket's upper bound); a rank inside the
        +Inf bucket returns the largest finite bound (the estimator
        cannot extrapolate past the ladder). NaN with no observations.
        Used by the SLO evaluator (observability/slo.py), the fleet
        rollup's serving/* series, and trace_explain --summary."""
        self._check(labels)
        with self._lock:
            counts = list(self._counts.get(labels, ()))
            total = self._totals.get(labels, 0)
        return _bucket_quantile(self.buckets, counts, total, q)

    def quantile_all(self, q: float) -> float:
        """quantile() over the SUM of every label series' buckets (the
        per-model TTFT histogram viewed fleet-wide)."""
        with self._lock:
            agg = [0] * len(self.buckets)
            for counts in self._counts.values():
                for i, c in enumerate(counts):
                    agg[i] += c
            total = sum(self._totals.values())
        return _bucket_quantile(self.buckets, agg, total, q)

    def label_values(self, label_name: str) -> List[str]:
        """Distinct observed values of one label dimension (e.g. the
        QoS classes llm_ttft_seconds has series for)."""
        i = self.label_names.index(label_name)
        with self._lock:
            return sorted({key[i] for key in self._counts})

    def quantile_label(self, q: float, label_name: str,
                       label_value: str) -> float:
        """quantile() over the sum of every series matching ONE label
        value (the per-QoS-class view of a {model, qos} histogram —
        what the fleet rollup's qos/{class}/... series record)."""
        i = self.label_names.index(label_name)
        with self._lock:
            agg = [0] * len(self.buckets)
            total = 0
            for key, counts in self._counts.items():
                if key[i] != label_value:
                    continue
                for j, c in enumerate(counts):
                    agg[j] += c
                total += self._totals.get(key, 0)
        return _bucket_quantile(self.buckets, agg, total, q)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        for labels in sorted(self._counts):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[labels][i]
                lab = _fmt_labels(self.label_names, labels,
                                  {"le": _fmt_value(b)})
                out.append(f"{self.name}_bucket{lab} {cum}")
            plain = _fmt_labels(self.label_names, labels)
            out.append(f"{self.name}_sum{plain} "
                       f"{_fmt_value(self._sums[labels])}")
            out.append(f"{self.name}_count{plain} {self._totals[labels]}")
        return out


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "", label_names=()) -> Counter:
        return self._get_or_make(Counter, name, help_, label_names)

    def gauge(self, name: str, help_: str = "", label_names=()) -> Gauge:
        return self._get_or_make(Gauge, name, help_, label_names)

    def histogram(self, name: str, help_: str = "", label_names=(),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help_, label_names, buckets)

    def _get_or_make(self, cls, name, help_, label_names, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, label_names, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"{name} already registered as {m.kind}")
            return m

    def render(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"
