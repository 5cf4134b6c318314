"""Control-plane transport interfaces: KVStore (the etcd role) and
Messaging (the NATS role).

Copied from dynamo_tpu/runtime/transports/base.py. Two implementations sit
behind them, as in the JAX package: the in-process memory plane
(transports/memory.py) and the TCP client of the standalone control-plane
server (transports/tcp.py, transports/server.py). A delivery stream may
carry a fault-injection failpoint (`QueueStream(failpoint=...)`,
runtime/faults.py, :88-90): watches deliver through `WatchStream`, whose
`watch.stream` site (:143) models the watch stream disconnecting;
subscriptions deliver through a plain `QueueStream` (their faults are
injected on the publish side, memory.py's `event.plane`).
"""
from __future__ import annotations

import abc
import asyncio
import dataclasses
import inspect
from typing import Awaitable, Callable, List, Optional, Tuple


@dataclasses.dataclass
class WatchEvent:
    kind: str          # "put" | "delete"
    key: str
    value: Optional[bytes] = None


@dataclasses.dataclass
class KVEntry:
    key: str
    value: bytes
    lease_id: int = 0


class Lease:
    """A TTL lease; keys attached to it vanish when it expires or is
    revoked. Lease lost => runtime shutdown; shutdown => lease revoked."""

    def __init__(self, lease_id: int, revoke_cb):
        self.id = lease_id
        self._revoke_cb = revoke_cb
        self.lost = None  # set by transport: asyncio.Event fired on expiry

    async def revoke(self):
        await self._revoke_cb(self.id)


class QueueStream:
    """Async-iterable delivery stream over a transport queue.

    `next_batch()` awaits the first item and drains what is already queued
    (one consumer wake-up per tick of a churn storm), `depth()` is the live
    backlog, `aclose()` tears the stream down deterministically.

    `failpoint`: a faults.py site evaluated once per delivery; an injected
    drop raises FaultInjected into the consumer (the stream-disconnect
    model). The watch pumps resume with backoff and a snapshot resync."""

    def __init__(self, queue: asyncio.Queue,
                 on_close: Optional[Callable] = None,
                 failpoint: Optional[str] = None):
        self._q = queue
        self._on_close = on_close
        self._closed = False
        self._failpoint = failpoint

    def _fire(self) -> None:
        if self._failpoint is None:
            return
        from dynamo_tpu_torch.runtime import faults
        if not faults.REGISTRY.enabled:
            return
        out = faults.REGISTRY.decide(self._failpoint)
        if out is not None and out.drop:
            raise faults.FaultInjected(self._failpoint)

    def __aiter__(self):
        return self

    async def __anext__(self):
        item = await self._q.get()
        self._fire()
        return item

    async def next_batch(self, max_items: int = 4096,
                         timeout: Optional[float] = None) -> list:
        """Await the first item, then drain whatever is already queued (up
        to `max_items`). Returns [] on timeout when one is given."""
        try:
            if timeout is None:
                first = await self._q.get()
            else:
                first = await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return []
        batch = [first]
        while len(batch) < max_items:
            try:
                batch.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        self._fire()
        return batch

    def depth(self) -> int:
        return self._q.qsize()

    async def aclose(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._on_close is not None:
            res = self._on_close()
            if inspect.isawaitable(res):
                await res


class WatchStream(QueueStream):
    """KV watch-event delivery; carries the `watch.stream` failpoint (an
    injected drop is the watch stream disconnecting mid-flight)."""

    def __init__(self, queue: asyncio.Queue,
                 on_close: Optional[Callable] = None):
        super().__init__(queue, on_close, failpoint="watch.stream")


class KVStore(abc.ABC):
    """etcd role: consistent KV with atomic create, prefix watch, leases."""

    @abc.abstractmethod
    async def put(self, key: str, value: bytes, lease_id: int = 0) -> None: ...

    @abc.abstractmethod
    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        """Atomic create; False if the key already exists."""

    @abc.abstractmethod
    async def get(self, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    async def get_prefix(self, prefix: str) -> List[KVEntry]: ...

    @abc.abstractmethod
    async def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    async def grant_lease(self, ttl: float = 10.0) -> Lease: ...

    @abc.abstractmethod
    async def watch_prefix(
        self, prefix: str) -> Tuple[List[KVEntry], QueueStream]:
        """Snapshot + a stream of the WatchEvents that follow it."""


class Messaging(abc.ABC):
    """NATS role: addressed request/reply, pub/sub events, durable queue."""

    @abc.abstractmethod
    async def serve(self, subject: str,
                    handler: Callable[[bytes], Awaitable[bytes]]) -> Callable:
        """Register a request handler; returns an async unsubscribe fn."""

    @abc.abstractmethod
    async def request(self, subject: str, payload: bytes,
                      timeout: float = 30.0) -> bytes: ...

    @abc.abstractmethod
    async def publish(self, subject: str, payload: bytes) -> None: ...

    @abc.abstractmethod
    async def subscribe(self, subject: str) -> QueueStream:
        """A stream of (subject, payload) pairs published to `subject`
        (trailing '>' wildcard supported)."""

    @abc.abstractmethod
    async def queue_push(self, queue: str, payload: bytes) -> None: ...

    @abc.abstractmethod
    async def queue_pop(self, queue: str,
                        timeout: Optional[float] = None) -> Optional[bytes]:
        """Work-queue pop."""

    @abc.abstractmethod
    async def queue_depth(self, queue: str) -> int: ...

    # -- leased consumption (ack / redelivery semantics) ---------------------

    @abc.abstractmethod
    async def queue_pop_leased(
            self, queue: str, timeout: Optional[float] = None,
            lease_s: float = 30.0) -> Optional[Tuple[bytes, str]]:
        """Pop one item under a redelivery lease: (payload, lease_token),
        or None on timeout. An item not acked within lease_s is
        re-enqueued, up to a backend-defined redelivery cap."""

    @abc.abstractmethod
    async def queue_ack(self, queue: str, token: str) -> None:
        """Settle a leased item: it must not be redelivered."""

    @abc.abstractmethod
    async def queue_touch(self, queue: str, token: str,
                          lease_s: float = 30.0) -> bool:
        """Extend a leased item's redelivery deadline to now + lease_s;
        False when the lease is unknown (already redelivered)."""


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style: '>' matches any suffix."""
    if pattern.endswith(">"):
        return subject.startswith(pattern[:-1])
    return pattern == subject
