"""Host-time attribution for the engine's decode loop.

Copied from dynamo_tpu/observability/metrics.py (`PhaseTimer` only; the
Prometheus registry comes with the runtime slice). The port has no tracer
yet, so the JAX copy's `trace_scope` hook, which also records each phase as
a span, is left out.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseTimer:
    """Cumulative wall-time attribution across named phases.

    The engine wraps each host leg of a decode window in
    `with timer.phase(name):` (plan, upload, dispatch, device under
    profile_sync, fetch, commit); tools/torch_decode_profile.py reads the
    accumulated split. Overhead is two perf_counter() calls per phase,
    always on."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

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
