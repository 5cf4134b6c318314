"""Durable prefill work queue.

Copied from dynamo_tpu/disagg/queue.py: decode workers enqueue
RemotePrefillRequests and any prefill worker dequeues them, over the
runtime's leased queues (the memory plane in one process, the control-plane
server across processes). `dequeue_leased` hands an item out under a
redelivery lease and `ack` settles it, so an item whose prefill worker dies
before the ack is redelivered to another. Payloads are MessagePack, as in
the JAX package. The `queue.dequeue` failpoint fires before the pop in
`dequeue` and `dequeue_leased` (JAX :84-107), so an injected drop or delay
never loses an item.

Constructed with a `QosPolicy` (JAX :45-192), the queue is class-aware:
`enqueue` routes each item to the sub-queue `{name}.q.{class}` of its
`RemotePrefillRequest.qos`, and `dequeue_leased` serves the backlogged
classes by weighted deficit (runtime/qos.StridePicker) with the policy's
bounded aging: a class skipped `aging_limit` consecutive dequeues is served
next (counted on QOS_STATS.queue_aging_promotions). Each sub-queue is an
ordinary leased queue; `ack` and `touch` resolve to the sub-queue the token
was leased from, and the base queue still counts as the default class (for
enqueuers without a policy). Without a policy the queue is the FIFO above.
"""
from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional, Tuple

from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.qos import QOS_STATS, QosPolicy, StridePicker
from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb


def queue_name(namespace: str, model: str) -> str:
    return f"{namespace}.prefill_queue.{model or 'default'}"


# the poll slice while every class sub-queue is empty (class-aware only)
_POLL_SLICE_S = 0.05
# a sub-queue pop's grab: long enough to win against a push the depth probe
# just saw, short enough not to stall the scan
_GRAB_S = 0.02


class PrefillQueue:
    def __init__(self, messaging, namespace: str, model: str = "",
                 qos_policy: Optional[QosPolicy] = None):
        self.messaging = messaging
        self.name = queue_name(namespace, model)
        self.qos_policy = qos_policy
        self._picker = StridePicker(qos_policy) if qos_policy else None
        # lease token -> the sub-queue it was popped from (a token from
        # another process falls back to the base name)
        self._lease_queues: Dict[str, str] = {}

    def _class_queue(self, cls: str) -> str:
        return f"{self.name}.q.{cls}"

    async def enqueue(self, req: RemotePrefillRequest) -> None:
        name = self.name
        if self.qos_policy is not None:
            name = self._class_queue(
                self.qos_policy.resolve(req.qos or None).name)
        await self.messaging.queue_push(name, packb(req.to_json()))

    async def dequeue(self, timeout: Optional[float] = None
                      ) -> Optional[RemotePrefillRequest]:
        """At-most-once dequeue (no lease)."""
        if faults.REGISTRY.enabled:  # before the pop: a fault loses nothing
            await faults.REGISTRY.fire("queue.dequeue")
        payload = await self.messaging.queue_pop(self.name, timeout=timeout)
        if payload is None:
            return None
        return RemotePrefillRequest.from_json(unpackb(payload))

    async def dequeue_leased(
            self, timeout: Optional[float] = None, lease_s: float = 30.0
    ) -> Optional[Tuple[RemotePrefillRequest, str]]:
        """Dequeue under a redelivery lease: (request, lease token). The
        item is queued again unless `ack(token)` arrives within lease_s.
        Class-aware, the backlogged classes are served by weighted deficit
        with the policy's bounded aging."""
        if faults.REGISTRY.enabled:  # before the pop: a fault loses nothing
            await faults.REGISTRY.fire("queue.dequeue")
        if self.qos_policy is None:
            got = await self.messaging.queue_pop_leased(
                self.name, timeout=timeout, lease_s=lease_s)
            if got is None:
                return None
            payload, token = got
            return RemotePrefillRequest.from_json(unpackb(payload)), token
        return await self._dequeue_leased_classed(timeout, lease_s)

    async def _dequeue_leased_classed(
            self, timeout: Optional[float], lease_s: float
    ) -> Optional[Tuple[RemotePrefillRequest, str]]:
        policy = self.qos_policy
        default = policy.resolve(None).name
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # each class's depth; the base queue is default-class backlog
            depths: Dict[str, int] = {}
            for cls in policy.names():
                d = await self.messaging.queue_depth(self._class_queue(cls))
                if d:
                    depths[cls] = d
            base_depth = await self.messaging.queue_depth(self.name)
            if base_depth:
                depths[default] = depths.get(default, 0) + base_depth
            for cls in self._picker.order(list(depths)):
                names = [self._class_queue(cls)]
                if cls == default and base_depth:
                    names.append(self.name)
                for name in names:
                    got = await self.messaging.queue_pop_leased(
                        name, timeout=_GRAB_S, lease_s=lease_s)
                    if got is None:
                        continue
                    before = self._picker.aging_promotions
                    self._picker.charge(cls, list(depths))
                    QOS_STATS.queue_aging_promotions += \
                        self._picker.aging_promotions - before
                    payload, token = got
                    self._lease_queues[token] = name
                    return RemotePrefillRequest.from_json(
                        unpackb(payload)), token
            # every sub-queue empty (or raced away): a bounded poll slice
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                await asyncio.sleep(min(_POLL_SLICE_S, left))
            else:
                await asyncio.sleep(_POLL_SLICE_S)

    async def ack(self, token: str) -> None:
        """Settle a leased item (done or failed for good), on the sub-queue
        it was leased from."""
        await self.messaging.queue_ack(
            self._lease_queues.pop(token, self.name), token)

    async def touch(self, token: str, lease_s: float = 30.0) -> bool:
        """Re-arm a leased item's redelivery deadline (the transfer leg may
        outlast the dequeue lease). False when the lease had expired: the
        item was redelivered, and the decode side's idempotent chunk
        commits absorb the duplicate sender."""
        return await self.messaging.queue_touch(
            self._lease_queues.get(token, self.name), token,
            lease_s=lease_s)

    async def depth(self) -> int:
        total = await self.messaging.queue_depth(self.name)
        if self.qos_policy is not None:
            for cls in self.qos_policy.classes:
                total += await self.messaging.queue_depth(
                    self._class_queue(cls))
        return total
