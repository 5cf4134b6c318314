"""Fixed-interval ring-buffer time series: history behind the gauges.

Copied from dynamo_tpu/observability/timeseries.py. Every /metrics render
is a point-in-time snapshot; this module is the history the fleet rollup
(observability/fleet.py) and the SLO burn-rate watchdog
(observability/slo.py) sit on: bounded memory, O(1) record, explicit
timestamps everywhere so evaluation can run on a virtual clock.

- `TimeSeries`: capacity x interval ring. A sample lands in the bucket
  `ts // interval_s`; within one bucket the reduction is "last" (gauge
  semantics), "max" or "sum". Old buckets are overwritten implicitly
  (the ring slot's bucket id no longer matches), so gaps cost nothing
  and a series never grows.
- `SeriesStore`: named get-or-make registry of series (one per worker
  field, per link, per fleet aggregate).
- `Ewma`: the bandwidth smoother the TransferCostModel uses.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class Ewma:
    """Exponentially-weighted moving average; `value` is None until the
    first update (consumers can distinguish 'no data' from 0)."""

    __slots__ = ("alpha", "value", "samples")

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.value: Optional[float] = None
        self.samples = 0

    def update(self, v: float) -> float:
        if self.value is None:
            self.value = float(v)
        else:
            self.value += self.alpha * (float(v) - self.value)
        self.samples += 1
        return self.value


class TimeSeries:
    """Fixed-interval ring of `capacity` buckets, `interval_s` wide.

    Explicit-`ts` API: callers pass their own clock (time.time() live,
    a virtual clock in tests/seeded plans). Reading a window only
    returns buckets whose stored id matches — stale ring slots from a
    previous wrap are invisible, so no eviction pass is ever needed."""

    __slots__ = ("interval_s", "capacity", "reduce", "_ids", "_vals",
                 "_last_bucket")

    def __init__(self, interval_s: float = 1.0, capacity: int = 600,
                 reduce: str = "last"):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if reduce not in ("last", "max", "sum"):
            raise ValueError(f"unknown reduce {reduce!r}")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.reduce = reduce
        self._ids = [-1] * self.capacity
        self._vals = [0.0] * self.capacity
        self._last_bucket = -1

    def _bucket(self, ts: float) -> int:
        return int(ts // self.interval_s)

    def record(self, value: float, ts: float) -> None:
        b = self._bucket(ts)
        i = b % self.capacity
        if self._ids[i] == b:
            if self.reduce == "sum":
                self._vals[i] += value
            elif self.reduce == "max":
                self._vals[i] = max(self._vals[i], value)
            else:
                self._vals[i] = value
        else:
            self._ids[i] = b
            self._vals[i] = float(value)
        self._last_bucket = max(self._last_bucket, b)

    def latest(self) -> Optional[float]:
        b = self._last_bucket
        if b < 0:
            return None
        i = b % self.capacity
        return self._vals[i] if self._ids[i] == b else None

    def window(self, seconds: float, ts: float) -> List[float]:
        """Values of the buckets covering [ts - seconds, ts], oldest
        first; buckets never written (gaps) are absent, not zero."""
        b1 = self._bucket(ts)
        n = max(1, int(round(seconds / self.interval_s)))
        b0 = b1 - n + 1
        out: List[float] = []
        for b in range(max(0, b0), b1 + 1):
            i = b % self.capacity
            if self._ids[i] == b:
                out.append(self._vals[i])
        return out

    def avg(self, seconds: float, ts: float) -> Optional[float]:
        vals = self.window(seconds, ts)
        return sum(vals) / len(vals) if vals else None

    def max(self, seconds: float, ts: float) -> Optional[float]:
        vals = self.window(seconds, ts)
        return max(vals) if vals else None

    def frac_where(self, pred, seconds: float, ts: float,
                   min_samples: int = 1) -> Optional[float]:
        """Fraction of window samples where pred(value) is true; None
        when fewer than `min_samples` buckets carry data (the SLO
        evaluator treats None as 'cannot judge', never as 'good')."""
        vals = self.window(seconds, ts)
        if len(vals) < min_samples:
            return None
        return sum(1 for v in vals if pred(v)) / len(vals)


class SeriesStore:
    """Named series registry: `record(name, v, ts)` get-or-makes the
    series. Names are slash paths by convention ("fleet/workers_live",
    "worker/w0001/kv_usage", "link/w0001/bytes_per_s")."""

    def __init__(self, interval_s: float = 1.0, capacity: int = 600):
        self.interval_s = interval_s
        self.capacity = capacity
        self._series: Dict[str, TimeSeries] = {}

    def series(self, name: str, reduce: str = "last") -> TimeSeries:
        s = self._series.get(name)
        if s is None:
            s = TimeSeries(self.interval_s, self.capacity, reduce)
            self._series[name] = s
        return s

    def record(self, name: str, value: float, ts: float,
               reduce: str = "last") -> None:
        self.series(name, reduce).record(value, ts)

    def get(self, name: str) -> Optional[TimeSeries]:
        return self._series.get(name)

    def names(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self._series if n.startswith(prefix))

    def __len__(self) -> int:
        return len(self._series)
