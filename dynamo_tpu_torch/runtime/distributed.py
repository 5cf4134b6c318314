"""DistributedRuntime: the per-process cluster handle.

Copied from dynamo_tpu/runtime/distributed.py: the control-plane clients
(KV + messaging), a worker id, the primary lease (lease lost => runtime
shutdown, shutdown => lease revoked), a lazily started data-plane server
for call-home response streams, and the namespace registry.
`create_local` (:51) runs on an in-process memory plane, `connect` (:62)
on the standalone server (transports/server.py), or on an HA pair given as
`addrs=[(h1, p1), (h2, p2)]` or as the comma form "h1:p1,h2:p2" in `host`
(:61-80). As in JAX (:84-91), a lost lease shuts the runtime down: leases
are not replicated, so after a standby's promotion every runtime that held
a lease on the dead primary ends (its process restarts and enrolls anew).

The lease TTL is read from DYN_LEASE_TTL_S when a runtime is made (default
10 s): a heavily loaded host can starve the heartbeat task past TTL/3, so
tests and shared machines raise it.
"""
from __future__ import annotations

import asyncio
import logging
import os
import uuid
from typing import Dict, List, Optional

from dynamo_tpu_torch.runtime.component import Namespace
from dynamo_tpu_torch.runtime.dataplane import DataPlaneServer
from dynamo_tpu_torch.runtime.transports.base import KVStore, Lease, Messaging
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

log = logging.getLogger("dynamo_tpu_torch.runtime")


async def connect_coordinator(text: str, worker_id: Optional[str] = None
                              ) -> "DistributedRuntime":
    """A runtime on the control plane named by a `--coordinator` flag:
    "host:port", or an HA pair "h1:p1,h2:p2"."""
    from dynamo_tpu_torch.runtime.transports.tcp import parse_addrs
    addrs = parse_addrs(text)
    host, port = addrs[0]
    return await DistributedRuntime.connect(
        host, port, worker_id, addrs=addrs if len(addrs) > 1 else None)


def lease_ttl_s() -> float:
    return float(os.environ.get("DYN_LEASE_TTL_S", "10.0"))


class DistributedRuntime:
    def __init__(self, kv: KVStore, messaging: Messaging,
                 worker_id: Optional[str] = None,
                 advertise_host: str = "127.0.0.1"):
        self.kv = kv
        self.messaging = messaging
        self.worker_id = worker_id or uuid.uuid4().hex[:16]
        self.lease: Optional[Lease] = None
        self.shutdown_event = asyncio.Event()
        self._data_plane: Optional[DataPlaneServer] = None
        self._data_plane_lock = asyncio.Lock()
        self._served: List[object] = []
        self._advertise_host = advertise_host
        self._tasks: List[asyncio.Task] = []
        self._namespaces: Dict[str, Namespace] = {}
        self._client = None
        self._shutting_down = False
        # set when the lease watch ended the runtime (not a caller)
        self.lease_lost = False

    # -- constructors --------------------------------------------------------

    @classmethod
    async def create_local(cls, plane: Optional[MemoryPlane] = None,
                           worker_id: Optional[str] = None
                           ) -> "DistributedRuntime":
        """In-process control plane (tests, single-process serving)."""
        plane = plane or MemoryPlane()
        rt = cls(plane.kv, plane.messaging, worker_id)
        await rt._init_lease()
        return rt

    @classmethod
    async def connect(cls, host: str = "127.0.0.1", port: int = 6230,
                      worker_id: Optional[str] = None,
                      advertise_host: str = "127.0.0.1",
                      addrs=None) -> "DistributedRuntime":
        """Connect to a standalone control-plane server, or to the primary
        of an HA pair (`addrs`, or a comma list "h1:p1,h2:p2" in `host`),
        riding out a failover window."""
        from dynamo_tpu_torch.runtime.transports.tcp import (
            ControlPlaneClient, parse_addrs,
        )
        if addrs is None and "," in host:
            addrs = parse_addrs(host, port)
        client = await ControlPlaneClient(host, port, addrs=addrs).connect()
        log.debug("connected to the control plane at %s:%s", host, port)
        rt = cls(client, client, worker_id, advertise_host)
        rt._client = client
        await rt._init_lease()
        return rt

    async def _init_lease(self):
        ttl = lease_ttl_s()
        self.lease = await self.kv.grant_lease(ttl)
        log.debug("runtime %s holds lease %s (ttl %.1f s)", self.worker_id,
                  self.lease.id, ttl)

        async def watch():
            await self.lease.lost.wait()
            log.warning("primary lease lost; shutting down runtime %s",
                        self.worker_id)
            self.lease_lost = True
            await self.shutdown()

        self._tasks.append(asyncio.create_task(watch()))
        # heartbeat for planes whose Lease exposes a direct keep_alive hook
        # (memory plane); the TCP client runs its own keep-alive loop
        keep_alive = getattr(self.lease, "keep_alive", None)
        if callable(keep_alive):
            async def heartbeat():
                while not self.shutdown_event.is_set():
                    await asyncio.sleep(ttl / 3)
                    keep_alive()

            self._tasks.append(asyncio.create_task(heartbeat()))

    # -- accessors -----------------------------------------------------------

    def namespace(self, name: str) -> Namespace:
        if name not in self._namespaces:
            self._namespaces[name] = Namespace(self, name)
        return self._namespaces[name]

    @property
    def epoch(self) -> Optional[int]:
        """The fencing epoch of the control-plane member this runtime
        enrolled with (None on an in-process plane)."""
        return getattr(self._client, "epoch", None)

    async def data_plane(self) -> DataPlaneServer:
        # lock: a concurrent caller must not see the server pre-start (its
        # advertised port would still be 0)
        async with self._data_plane_lock:
            if self._data_plane is None:
                server = DataPlaneServer(advertise_host=self._advertise_host)
                await server.start()
                self._data_plane = server
        return self._data_plane

    def register_served(self, served) -> None:
        self._served.append(served)

    # -- lifecycle -----------------------------------------------------------

    async def shutdown(self):
        # re-entrancy has its own flag; the EVENT is set LAST: a caller
        # awaiting shutdown_event may exit the process the moment it fires
        if self._shutting_down:
            return
        self._shutting_down = True
        for served in self._served:
            try:
                await served.shutdown()
            except Exception:  # dynalint: swallow-ok=the-sweep-continues
                log.exception("shutdown of a served endpoint failed")
        current = asyncio.current_task()
        for task in self._tasks:
            if task is not current:
                task.cancel()
        if self.lease is not None:
            try:
                await self.lease.revoke()
            except Exception:  # dynalint: swallow-ok=lease-expiry-covers-it
                log.warning("lease revoke failed; it expires on its TTL")
        if self._data_plane is not None:
            await self._data_plane.stop()
        if self._client is not None:
            await self._client.close()
        self.shutdown_event.set()
