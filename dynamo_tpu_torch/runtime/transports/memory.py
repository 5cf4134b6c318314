"""In-process control plane: KVStore + Messaging backed by plain dicts.

Copied from dynamo_tpu/runtime/transports/memory.py. The control-plane
server (transports/server.py) holds its state in the same objects, so the
semantics are the same in one process and across processes.

Fault injection (runtime/faults.py; :18-37, :73-147, :208-243): every KV op
fires `transport.send` and `discovery.store`, a lease keep-alive
`discovery.heartbeat`, the lease watchdog `lease.expiry` (a drop
force-expires the lease), a request `transport.send`, and a publish
`transport.send` once and, for each subscriber, `transport.recv` and
`event.plane` (a delay there reorders, a drop loses the event, a duplicate
doubles it). Disarmed, each site costs one attribute read.

`LatencyModel` (:37) is the injected delay of a simulated network hop: the
stores await it before each KV op (put, create, get, get_prefix, delete;
create awaits it again through put), request, publish and queue push, as
the JAX plane does. Neither package sets a delay outside the tests. `_data_restore` / `_data_drop` are the journal's recovery
path (transports/journal.py): no journaling, no watcher notify.
"""
from __future__ import annotations

import asyncio
import itertools
import logging
import time
import uuid
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.transports.base import (
    KVEntry, KVStore, Lease, Messaging, QueueStream, WatchEvent,
    WatchStream, subject_matches,
)

log = logging.getLogger("dynamo_tpu_torch.memory_plane")


async def _lossy_fire(site: str):
    """Failpoint of a fire-and-forget delivery: a drop loses the message
    instead of raising (pub/sub has no error channel). None when the
    message is lost, else the Outcome."""
    try:
        return await faults.REGISTRY.fire(site)
    except faults.FaultInjected:
        return None


class LatencyModel:
    """Optional injected delay for simulating network hops in tests."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    async def apply(self) -> None:
        if self.delay_s > 0:
            await asyncio.sleep(self.delay_s)


class MemoryKVStore(KVStore):
    def __init__(self, latency: Optional[LatencyModel] = None):
        self._data: Dict[str, KVEntry] = {}
        self._watchers: List[Tuple[str, asyncio.Queue]] = []
        self._lease_seq = itertools.count(1)
        self._lease_keys: Dict[int, set] = defaultdict(set)
        self._lease_tasks: Dict[int, asyncio.Task] = {}
        self._lease_deadline: Dict[int, float] = {}
        self._latency = latency or LatencyModel()

    def _data_restore(self, key: str, value: bytes) -> None:
        """Recovery-path set: no journaling, no watcher notify (recovery
        runs before any watcher can exist)."""
        self._data[key] = KVEntry(key, value, 0)

    def _data_drop(self, key: str) -> None:
        self._data.pop(key, None)

    def _notify(self, ev: WatchEvent) -> None:
        for prefix, q in list(self._watchers):
            if ev.key.startswith(prefix):
                q.put_nowait(ev)

    async def _op(self) -> None:
        """The injected delay and the failpoints of one KV op (a drop
        raises a ConnectionError into the caller)."""
        await self._latency.apply()
        if faults.REGISTRY.enabled:
            await faults.REGISTRY.fire("transport.send")
            await faults.REGISTRY.fire("discovery.store")

    async def put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self._op()
        self._data[key] = KVEntry(key, value, lease_id)
        if lease_id:
            self._lease_keys[lease_id].add(key)
        self._notify(WatchEvent("put", key, value))

    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        await self._latency.apply()
        if key in self._data:
            return False
        await self.put(key, value, lease_id)
        return True

    async def get(self, key: str):
        await self._op()
        e = self._data.get(key)
        return e.value if e else None

    async def get_prefix(self, prefix: str) -> List[KVEntry]:
        await self._op()
        return [e for k, e in sorted(self._data.items()) if k.startswith(prefix)]

    async def delete(self, key: str) -> None:
        await self._op()
        e = self._data.pop(key, None)
        if e is not None:
            if e.lease_id:
                self._lease_keys[e.lease_id].discard(key)
            self._notify(WatchEvent("delete", key))

    # -- leases --------------------------------------------------------------

    async def grant_lease(self, ttl: float = 10.0) -> Lease:
        lease_id = next(self._lease_seq)
        lease = Lease(lease_id, self._revoke)
        lease.lost = asyncio.Event()
        self._lease_deadline[lease_id] = time.monotonic() + ttl
        self._lease_tasks[lease_id] = asyncio.create_task(
            self._lease_watchdog(lease_id, ttl, lease))
        lease.keep_alive = lambda: self._keep_alive(lease_id, ttl)
        return lease

    def _keep_alive(self, lease_id: int, ttl: float) -> None:
        if faults.REGISTRY.enabled:
            try:
                faults.REGISTRY.fire_sync("discovery.heartbeat")
            except faults.FaultInjected:
                return  # this heartbeat is lost: the deadline stays
        if lease_id in self._lease_deadline:
            self._lease_deadline[lease_id] = time.monotonic() + ttl

    async def _lease_watchdog(self, lease_id: int, ttl: float, lease: Lease):
        while True:
            deadline = self._lease_deadline.get(lease_id)
            if deadline is None:
                return
            now = time.monotonic()
            forced = False
            if faults.REGISTRY.enabled \
                    and faults.REGISTRY.armed("lease.expiry"):
                # a drop force-expires THIS lease now: armed with p over a
                # fleet, each tick expires about p of the leases it visits
                out = faults.REGISTRY.decide("lease.expiry")
                forced = out is not None and out.drop
            if now >= deadline or forced:
                await self._expire(lease_id)
                lease.lost.set()
                return
            await asyncio.sleep(min(deadline - now, ttl / 3))

    async def _expire(self, lease_id: int) -> None:
        self._lease_deadline.pop(lease_id, None)
        for key in list(self._lease_keys.pop(lease_id, ())):
            await self.delete(key)

    async def _revoke(self, lease_id: int) -> None:
        task = self._lease_tasks.pop(lease_id, None)
        if task:
            task.cancel()
        await self._expire(lease_id)

    # -- watch ---------------------------------------------------------------

    async def watch_prefix(self, prefix: str):
        snapshot = await self.get_prefix(prefix)
        q: asyncio.Queue = asyncio.Queue()
        entry = (prefix, q)
        self._watchers.append(entry)

        def on_close():
            if entry in self._watchers:
                self._watchers.remove(entry)

        return snapshot, WatchStream(q, on_close=on_close)


class MemoryMessaging(Messaging):
    # redeliveries per item before it is dropped as poison
    MAX_REDELIVERIES = 5

    def __init__(self, latency: Optional[LatencyModel] = None):
        self._handlers: Dict[str, callable] = {}
        self._subs: List[Tuple[str, asyncio.Queue]] = []
        self._queues: Dict[str, asyncio.Queue] = defaultdict(asyncio.Queue)
        # lease token -> (queue, payload, expiry_monotonic, prior_deliveries)
        self._leased: Dict[str, Tuple[str, bytes, float, int]] = {}
        # (queue, payload) -> redeliveries so far; survives pop/lease cycles
        self._delivery_counts: Dict[Tuple[str, bytes], int] = {}
        self.redeliveries = 0
        self._latency = latency or LatencyModel()

    async def serve(self, subject, handler):
        self._handlers[subject] = handler

        async def unsubscribe():
            if self._handlers.get(subject) is handler:
                del self._handlers[subject]

        return unsubscribe

    async def request(self, subject, payload, timeout: float = 30.0):
        await self._latency.apply()
        if faults.REGISTRY.enabled:   # a drop: ConnectionError, retried by
            await faults.REGISTRY.fire("transport.send")  # the reliability layer
        handler = self._handlers.get(subject)
        if handler is None:
            raise ConnectionError(f"no responder on subject {subject!r}")
        return await asyncio.wait_for(handler(payload), timeout)

    async def publish(self, subject, payload):
        await self._latency.apply()
        send_dup = False
        if faults.REGISTRY.enabled:
            out = await _lossy_fire("transport.send")
            if out is None:
                return  # lost on the wire: fire-and-forget
            send_dup = out.duplicate
        for pattern, q in list(self._subs):
            if subject_matches(pattern, subject):
                if faults.REGISTRY.enabled:
                    out = await _lossy_fire("transport.recv")
                    if out is None:
                        continue  # lost for THIS subscriber only
                    self._deliver_event_plane(q, subject, payload,
                                              out.duplicate or send_dup)
                else:
                    q.put_nowait((subject, payload))

    @staticmethod
    def _deliver_event_plane(q, subject, payload, dup: bool) -> bool:
        """One subscriber's delivery through the event.plane failpoint: a
        delay is applied with call_later, so the delayed event arrives late
        AND after later undelayed ones (lag makes reorder); a drop loses
        it; a duplicate doubles it. False when the event was dropped."""
        out = (faults.REGISTRY.decide("event.plane")
               if faults.REGISTRY.armed("event.plane") else None)
        if out is not None and out.drop:
            return False
        copies = 2 if (dup or (out is not None and out.duplicate)) else 1
        if out is not None and out.delay_s > 0:
            loop = asyncio.get_running_loop()
            for _ in range(copies):
                loop.call_later(out.delay_s, q.put_nowait,
                                (subject, payload))
        else:
            for _ in range(copies):
                q.put_nowait((subject, payload))
        return True

    async def subscribe(self, subject):
        q: asyncio.Queue = asyncio.Queue()
        entry = (subject, q)
        self._subs.append(entry)

        def on_close():
            if entry in self._subs:
                self._subs.remove(entry)

        return QueueStream(q, on_close=on_close)

    async def queue_push(self, queue, payload):
        await self._latency.apply()
        self._queues[queue].put_nowait(payload)

    async def queue_pop(self, queue, timeout=None):
        await self._sweep_leases()
        try:
            if timeout is None:
                return await self._queues[queue].get()
            return await asyncio.wait_for(self._queues[queue].get(), timeout)
        except asyncio.TimeoutError:
            return None

    async def queue_depth(self, queue):
        await self._sweep_leases()
        return self._queues[queue].qsize()

    # -- leases: dequeued-but-unacked items become visible again --------------
    # Expiry is swept on every queue touch (no background task).

    async def _sweep_leases(self) -> None:
        if not self._leased:
            return
        now = time.monotonic()
        expired = [t for t, (_q, _p, dl, _n) in self._leased.items()
                   if dl <= now]
        for token in expired:
            queue, payload, _dl, n = self._leased.pop(token)
            if n + 1 > self.MAX_REDELIVERIES:
                log.error("queue %s: item dropped after %d redeliveries "
                          "(poison)", queue, n)
                self._delivery_counts.pop((queue, payload), None)
                continue
            self._delivery_counts[(queue, payload)] = n + 1
            self.redeliveries += 1
            log.warning("queue %s: lease expired, redelivering item "
                        "(delivery %d)", queue, n + 2)
            await self.queue_push(queue, payload)

    async def queue_pop_leased(self, queue, timeout=None, lease_s=30.0):
        if timeout is None:
            # bounded slices: each re-runs the lease sweep, so a lone
            # blocked consumer still sees items whose lease expired
            payload = None
            while payload is None:
                payload = await self.queue_pop(queue, timeout=1.0)
        else:
            payload = await self.queue_pop(queue, timeout=timeout)
        if payload is None:
            return None
        token = uuid.uuid4().hex
        self._leased[token] = (queue, payload,
                               time.monotonic() + lease_s,
                               self._delivery_counts.get((queue, payload), 0))
        return payload, token

    async def queue_ack(self, queue, token):
        item = self._leased.pop(token, None)
        if item is not None:
            self._delivery_counts.pop((item[0], item[1]), None)

    async def queue_touch(self, queue, token, lease_s: float = 30.0):
        item = self._leased.get(token)
        if item is None:
            return False
        q, payload, _deadline, n = item
        self._leased[token] = (q, payload, time.monotonic() + lease_s, n)
        return True


class MemoryPlane:
    """Bundle of both planes, shared by components within one process."""

    def __init__(self, latency: Optional[LatencyModel] = None):
        self.kv = MemoryKVStore(latency)
        self.messaging = MemoryMessaging(latency)
