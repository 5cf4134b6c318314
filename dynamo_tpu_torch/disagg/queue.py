"""Durable prefill work queue.

Copied from dynamo_tpu/disagg/queue.py: decode workers enqueue
RemotePrefillRequests and any prefill worker dequeues them, over the
runtime's leased queues (the memory plane in one process, the control-plane
server across processes). `dequeue_leased` hands an item out under a
redelivery lease and `ack` settles it, so an item whose prefill worker dies
before the ack is redelivered to another. Payloads are MessagePack, as in
the JAX package. The `queue.dequeue` failpoint fires before the pop in
`dequeue` and `dequeue_leased` (JAX :84-107), so an injected drop or delay
never loses an item. The class-aware QoS sub-queues wait for ROADMAP A9;
without a policy the JAX queue is this FIFO.
"""
from __future__ import annotations

from typing import Optional, Tuple

from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb


def queue_name(namespace: str, model: str) -> str:
    return f"{namespace}.prefill_queue.{model or 'default'}"


class PrefillQueue:
    def __init__(self, messaging, namespace: str, model: str = ""):
        self.messaging = messaging
        self.name = queue_name(namespace, model)

    async def enqueue(self, req: RemotePrefillRequest) -> None:
        await self.messaging.queue_push(self.name, packb(req.to_json()))

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
        item is queued again unless `ack(token)` arrives within lease_s."""
        if faults.REGISTRY.enabled:  # before the pop: a fault loses nothing
            await faults.REGISTRY.fire("queue.dequeue")
        got = await self.messaging.queue_pop_leased(
            self.name, timeout=timeout, lease_s=lease_s)
        if got is None:
            return None
        payload, token = got
        return RemotePrefillRequest.from_json(unpackb(payload)), token

    async def ack(self, token: str) -> None:
        """Settle a leased item (done or failed for good)."""
        await self.messaging.queue_ack(self.name, token)

    async def touch(self, token: str, lease_s: float = 30.0) -> bool:
        """Re-arm a leased item's redelivery deadline (the transfer leg may
        outlast the dequeue lease). False when the lease had expired: the
        item was redelivered, and the decode side's idempotent chunk
        commits absorb the duplicate sender."""
        return await self.messaging.queue_touch(self.name, token,
                                                lease_s=lease_s)

    async def depth(self) -> int:
        return await self.messaging.queue_depth(self.name)
