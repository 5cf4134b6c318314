"""Core engine abstraction: streaming generate with a controllable context.

Copied from dynamo_tpu/runtime/engine.py, trimmed to the slice:
`generate(request, Context) -> AsyncIterator`, where the Context carries
the request id, baggage and a cooperative stop signal. Kill, deadlines,
child contexts and the trace context come with the runtime and
reliability slices.
"""
from __future__ import annotations

import abc
import asyncio
import uuid
from typing import Any, AsyncIterator, Dict, Optional


class Context:
    """Request envelope: id, typed baggage, and a cooperative stop signal
    ("finish the current response gracefully and end the stream")."""

    def __init__(self, request_id: Optional[str] = None,
                 baggage: Optional[Dict[str, Any]] = None):
        self.id = request_id or uuid.uuid4().hex
        self.baggage: Dict[str, Any] = dict(baggage or {})
        self._stopped = asyncio.Event()

    def stop_generating(self) -> None:
        self._stopped.set()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    async def wait_stopped(self) -> None:
        await self._stopped.wait()


class AsyncEngine(abc.ABC):
    """A streaming request->response engine."""

    @abc.abstractmethod
    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        """Return an async iterator of response frames."""
