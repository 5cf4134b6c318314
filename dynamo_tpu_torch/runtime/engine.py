"""Core engine abstraction: streaming generate with a controllable context.

Copied from dynamo_tpu/runtime/engine.py, trimmed to the slice:
`generate(request, Context) -> AsyncIterator`, where the Context carries
the request id, baggage, a cooperative stop signal, an optional
end-to-end deadline (it crosses process boundaries as remaining seconds:
runtime/component.py), the trace context (runtime/tracing.py; it rides
the baggage under TRACE_KEY, :40-44) and child contexts with linked
cancellation (:106-107), which the reliability layer gives each dispatch
attempt. Kill is left out: nothing in the port abandons a stream without
its stop.
"""
from __future__ import annotations

import abc
import asyncio
import time
import uuid
import weakref
from typing import Any, AsyncIterator, Dict, Optional

from dynamo_tpu_torch.runtime.tracing import TRACE_KEY, TraceContext


class Context:
    """Request envelope: id, typed baggage, a cooperative stop signal
    ("finish the current response gracefully and end the stream"), an
    optional deadline and the trace context (None when untraced)."""

    def __init__(self, request_id: Optional[str] = None,
                 baggage: Optional[Dict[str, Any]] = None):
        self.id = request_id or uuid.uuid4().hex
        self.baggage: Dict[str, Any] = dict(baggage or {})
        # the serving side re-hydrates the trace from the wire baggage
        self.trace: Optional[TraceContext] = (
            TraceContext.from_wire(self.baggage.get(TRACE_KEY))
            if self.baggage else None)
        self._stopped = asyncio.Event()
        self._deadline: Optional[float] = None
        self._children: "weakref.WeakSet[Context]" = weakref.WeakSet()

    def stop_generating(self) -> None:
        self._stopped.set()
        for c in list(self._children):
            c.stop_generating()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    async def wait_stopped(self) -> None:
        await self._stopped.wait()

    # -- deadline ------------------------------------------------------------
    def set_deadline(self, timeout_s: float) -> None:
        """Arm (or tighten) the end-to-end deadline: timeout_s from now."""
        dl = time.monotonic() + timeout_s
        if self._deadline is None or dl < self._deadline:
            self._deadline = dl

    def time_remaining(self) -> Optional[float]:
        """Seconds left before the deadline (>= 0), None when unbounded."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    @property
    def deadline_expired(self) -> bool:
        return self._deadline is not None \
            and time.monotonic() >= self._deadline

    def child(self) -> "Context":
        """Same id, baggage and deadline; a parent stop cascades into every
        live child (children are held weakly, so an abandoned one never
        leaks)."""
        c = Context(self.id, self.baggage)
        c._deadline = self._deadline
        if c.trace is None:
            c.trace = self.trace  # a trace not yet in the baggage
        if self.is_stopped:
            c._stopped.set()
        self._children.add(c)
        return c


class AsyncEngine(abc.ABC):
    """A streaming request->response engine."""

    @abc.abstractmethod
    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        """Return an async iterator of response frames."""


class FnEngine(AsyncEngine):
    """Wrap an async generator function as an engine."""

    def __init__(self, fn):
        self._fn = fn

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        return self._fn(request, context)
