"""Deadline helper: bound awaits by explicit timeouts and Context deadlines.

Copied whole from dynamo_tpu/runtime/deadline.py.

Every control-plane or transport await in the serving path must be bounded
(dynalint R7): an unbounded await on a dead peer turns one lost worker into
a wedged frontend. `with_deadline` is the sanctioned wrapper — it combines
an operation-level timeout with whatever remains of the request's
end-to-end deadline (runtime/engine.Context.set_deadline), whichever is
tighter, and raises DeadlineExceeded when the request-level budget is
already spent.
"""
from __future__ import annotations

import asyncio
from typing import Optional


class DeadlineExceeded(asyncio.TimeoutError):
    """The request's end-to-end deadline expired (distinct from a single
    operation timing out, which may be retried within the deadline)."""


def effective_timeout(timeout_s: Optional[float],
                      context=None) -> Optional[float]:
    """Tighter of an operation timeout and the context's remaining budget.

    Returns None when neither bounds the await. Raises DeadlineExceeded
    when the context deadline is already spent — callers should not start
    work they have no budget to finish.
    """
    remaining = context.time_remaining() if context is not None else None
    if remaining is not None and remaining <= 0:
        raise DeadlineExceeded("request deadline exceeded")
    candidates = [t for t in (timeout_s, remaining) if t is not None]
    return min(candidates) if candidates else None


async def with_deadline(awaitable, timeout_s: Optional[float] = None,
                        context=None):
    """Await `awaitable` bounded by timeout_s and/or the context deadline.

    asyncio.TimeoutError propagates from the operation timeout;
    DeadlineExceeded (a TimeoutError subclass) when the request-level
    deadline is what expired.
    """
    try:
        eff = effective_timeout(timeout_s, context)
    except DeadlineExceeded:
        # callers build the coroutine as an argument; close it so an
        # already-spent deadline doesn't spam "never awaited" warnings
        if asyncio.iscoroutine(awaitable):
            awaitable.close()
        raise
    if eff is None:
        return await awaitable
    try:
        return await asyncio.wait_for(awaitable, eff)
    except asyncio.TimeoutError:
        if context is not None and context.deadline_expired:
            raise DeadlineExceeded("request deadline exceeded") from None
        raise
