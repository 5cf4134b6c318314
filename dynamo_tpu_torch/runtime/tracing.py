"""Per-request tracing: spans recorded into bounded per-thread rings.

Copied from dynamo_tpu/runtime/tracing.py: `TRACE_KEY`, `TraceContext`
with its wire form, the bounded ring, the no-op span, `Tracer` and the
chrome-trace export. One process-global `TRACER` owns per-thread
append-only rings: recording takes no lock and never syncs a device;
export (`drain()` + `chrome_trace()`) runs off the serving path, and
tools/torch_trace_explain.py renders a drained file
(tests/test_torch_tracing.py holds the spans against the JAX tracer's).

- Disabled (the default; `DYN_TRACE=1` or `configure(enabled=True)`
  enables; `DYN_TRACE_SAMPLE`, `DYN_TRACE_SEED` and `DYN_TRACE_RING` set
  the sample rate, its seed and the ring size): every recording entry
  point is one branch, and `span()` returns a shared no-op object.
- Enabled, trace sampled out: spans run but record only when they
  errored.
- Enabled and sampled: one small object and one tuple appended to the
  thread's ring; rings are bounded (oldest records overwritten, `dropped`
  counted).
- Hot-path regions: `defer_phase()` appends an already-measured (scope,
  name, duration) with no span object; the engine's PhaseTimer legs
  become spans of the pseudo-trace `scope:engine` this way. Spans off
  any request (pool fetches, rebalances, the simulated router) are
  `scope_span`s.

The trace context rides `runtime.engine.Context.baggage` under
`TRACE_KEY`, so it crosses the wire with every dispatch envelope. Sampling
is a pure function of (seed, trace_id).

Span schema (one record per span after `drain()`): {"trace_id",
"span_id", "parent_id", "name", "ts", "dur", "attrs", "error", "thread"};
`ts` is the process-local time.monotonic() start in seconds, `dur` in
seconds.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional

# baggage / wire-frame key the serialized context travels under
TRACE_KEY = "trace"

_span_ids = itertools.count(1)   # CPython next() is atomic
# span ids must be unique across PROCESSES: a disagg trace merges span
# files from the frontend, decode and prefill processes, and a bare
# counter would collide (same "s1" everywhere) — corrupting parent
# links into cycles. One random prefix per process keeps id generation
# a counter bump + f-string.
_ID_PREFIX = uuid.uuid4().hex[:6]


def _new_span_id() -> str:
    return f"{_ID_PREFIX}-{next(_span_ids):x}"


class TraceContext:
    """The propagated triplet: which trace, which span children parent
    to, and the (root-decided) sampling verdict."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str = "", sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_wire(self) -> Dict[str, Any]:
        return {"tid": self.trace_id, "sid": self.span_id,
                "s": 1 if self.sampled else 0}

    @classmethod
    def from_wire(cls, d: Optional[Dict[str, Any]]) -> Optional["TraceContext"]:
        if not d or "tid" not in d:
            return None
        return cls(str(d["tid"]), str(d.get("sid", "")), bool(d.get("s", 1)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"sampled={self.sampled})")


class _Ring:
    """Bounded append-only record buffer; single-writer (its thread)."""

    __slots__ = ("recs", "cap", "pos", "dropped")

    def __init__(self, cap: int):
        self.recs: List[tuple] = []
        self.cap = cap
        self.pos = 0
        self.dropped = 0

    def append(self, rec: tuple) -> None:
        if len(self.recs) < self.cap:
            self.recs.append(rec)
        else:
            self.recs[self.pos] = rec
            self.pos = (self.pos + 1) % self.cap
            self.dropped += 1

    def snapshot(self) -> List[tuple]:
        return self.recs[self.pos:] + self.recs[:self.pos]

    def clear(self) -> None:
        self.recs = []
        self.pos = 0


class _NoopSpan:
    """The disabled-path singleton: every method is a no-op, `with`
    compatible, zero allocations per use."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def context(self):
        return None


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "trace", "parent_id", "span_id", "t0",
                 "attrs", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace: TraceContext,
                 attrs: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.trace = trace
        self.parent_id = trace.span_id
        self.span_id = _new_span_id()
        self.t0 = time.monotonic()
        self.attrs = attrs
        self._done = False

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def context(self) -> TraceContext:
        """A child context: same trace, this span as the parent."""
        return TraceContext(self.trace.trace_id, self.span_id,
                            self.trace.sampled)

    def finish(self, error: bool = False) -> None:
        if self._done:
            return
        self._done = True
        self._tracer._record(self.trace, self.span_id, self.parent_id,
                             self.name, self.t0, time.monotonic(),
                             self.attrs, error)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.finish(error=exc_type is not None)
        return False


class Tracer:
    """Process-global span recorder. See the module docstring for the
    overhead contract; knobs via env (DYN_TRACE / DYN_TRACE_SAMPLE /
    DYN_TRACE_SEED / DYN_TRACE_RING) or `configure()`."""

    def __init__(self):
        self.enabled = os.environ.get("DYN_TRACE", "") not in ("", "0")
        self.sample_rate = float(os.environ.get("DYN_TRACE_SAMPLE", "1.0"))
        self.seed = int(os.environ.get("DYN_TRACE_SEED", "0"))
        self.ring_capacity = int(os.environ.get("DYN_TRACE_RING", "65536"))
        self._local = threading.local()
        self._rings: List[tuple] = []        # (thread_name, _Ring)
        self._rings_lock = threading.Lock()

    # -- configuration --------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  sample_rate: Optional[float] = None,
                  seed: Optional[int] = None,
                  ring_capacity: Optional[int] = None) -> "Tracer":
        if enabled is not None:
            self.enabled = enabled
        if sample_rate is not None:
            self.sample_rate = sample_rate
        if seed is not None:
            self.seed = seed
        if ring_capacity is not None:
            self.ring_capacity = ring_capacity
        return self

    def reset(self) -> None:
        """Drop every recorded span (all threads' rings). Rings stay
        registered, so live threads keep their fast path."""
        with self._rings_lock:
            for _name, ring in self._rings:
                ring.clear()

    # -- sampling -------------------------------------------------------------

    def sampled(self, trace_id: str) -> bool:
        """Pure function of (seed, trace_id): deterministic across
        processes and runs, no coordination needed."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        h = zlib.crc32(trace_id.encode(), self.seed) & 0xFFFFFFFF
        return h / 4294967296.0 < self.sample_rate

    def start_trace(self, trace_id: Optional[str] = None
                    ) -> Optional[TraceContext]:
        """Root a new trace (frontend ingest). None when disabled — the
        branch-only fast path."""
        if not self.enabled:
            return None
        tid = trace_id or uuid.uuid4().hex
        return TraceContext(tid, "", self.sampled(tid))

    # -- recording ------------------------------------------------------------

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self.ring_capacity)
            self._local.ring = ring
            with self._rings_lock:
                self._rings.append((threading.current_thread().name, ring))
        return ring

    def _record(self, trace: TraceContext, span_id: str, parent_id: str,
                name: str, t0: float, t1: float, attrs: Optional[dict],
                error: bool) -> None:
        if not (trace.sampled or error):
            return          # sampled out, but errors always survive
        self._ring().append((trace.trace_id, span_id, parent_id, name,
                             t0, t1, attrs, error))

    def span(self, name: str, trace: Optional[TraceContext],
             **attrs) -> "_Span | _NoopSpan":
        """Context-manager span. Disabled or trace-less: the shared
        no-op singleton (no allocation)."""
        if not self.enabled or trace is None:
            return NOOP_SPAN
        return _Span(self, name, trace, attrs or None)

    def scope_span(self, name: str, scope: str, **attrs) -> "_Span | _NoopSpan":
        """A span outside any request trace (pool fetches, rebalances, the
        simulated router): recorded under the pseudo-trace
        `scope:<scope>`."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, TraceContext(f"scope:{scope}"),
                     attrs or None)

    def begin_span(self, name: str, trace: Optional[TraceContext],
                   **attrs) -> Optional[_Span]:
        """Manual-lifecycle span: MUST be paired with `end_span` on every
        path (try/finally)."""
        if not self.enabled or trace is None:
            return None
        return _Span(self, name, trace, attrs or None)

    def end_span(self, span: Optional[_Span], error: bool = False,
                 **attrs) -> None:
        if span is None:
            return
        if attrs:
            span.set(**attrs)
        span.finish(error=error)

    def event(self, name: str, trace: Optional[TraceContext],
              **attrs) -> None:
        """Zero-duration instant record (decode emits, injects)."""
        if not self.enabled or trace is None or not trace.sampled:
            return
        now = time.monotonic()
        self._ring().append((trace.trace_id, _new_span_id(),
                             trace.span_id, name, now, now,
                             attrs or None, False))

    def record_span(self, name: str, trace: Optional[TraceContext],
                    duration_s: float, **attrs) -> None:
        """Record an already-measured span ending now (e.g. a queue wait
        carried as a wall-clock delta across processes)."""
        if not self.enabled or trace is None or not trace.sampled:
            return
        now = time.monotonic()
        self._ring().append((trace.trace_id, _new_span_id(),
                             trace.span_id, name, now - max(0.0, duration_s),
                             now, attrs or None, False))

    def defer_phase(self, scope: str, name: str, dt_s: float) -> None:
        """The hot-path deferred recorder: the caller already measured the
        phase (PhaseTimer), and this appends (scope, name, dt) with no
        span object and no trace lookup."""
        if not self.enabled:
            return
        now = time.monotonic()
        self._ring().append((f"scope:{scope}", _new_span_id(), "",
                             name, now - dt_s, now, None, False))

    # -- export (off the serving path) ----------------------------------------

    def dropped(self) -> int:
        with self._rings_lock:
            return sum(ring.dropped for _n, ring in self._rings)

    def drain(self, clear: bool = True) -> List[Dict[str, Any]]:
        """Collect every recorded span from every thread's ring, oldest
        first. `clear=True` empties the rings (one capture per storm)."""
        with self._rings_lock:
            rings = list(self._rings)
        recs: List[tuple] = []
        for tname, ring in rings:
            for rec in ring.snapshot():
                recs.append(rec + (tname,))
            if clear:
                ring.clear()
        recs.sort(key=lambda r: r[4])
        return [{"trace_id": r[0], "span_id": r[1], "parent_id": r[2],
                 "name": r[3], "ts": r[4], "dur": r[5] - r[4],
                 "attrs": r[6], "error": r[7], "thread": r[8]}
                for r in recs]


def chrome_trace(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Drained spans as a chrome://tracing / Perfetto trace (JSON object
    format, "X" complete events and "i" instants). Threads map to tids;
    the trace id rides in args."""
    if not spans:
        return {"traceEvents": []}
    t_base = min(s["ts"] for s in spans)
    tids: Dict[str, int] = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s.get("thread", "main"), len(tids) + 1)
        args = dict(s.get("attrs") or {})
        args["trace_id"] = s["trace_id"]
        args["span_id"] = s["span_id"]
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        if s.get("error"):
            args["error"] = True
        ev = {"name": s["name"], "pid": 1, "tid": tid,
              "ts": round((s["ts"] - t_base) * 1e6, 3), "args": args}
        if s["dur"] <= 0.0:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=round(s["dur"] * 1e6, 3))
        events.append(ev)
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"source": "dynamo_tpu_torch.runtime.tracing"}}


TRACER = Tracer()
