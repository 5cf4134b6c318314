"""TCP client of the control-plane server: KVStore + Messaging over one
socket.

Copied from dynamo_tpu/runtime/transports/tcp.py (`ControlPlaneClient`,
:26): one multiplexed connection carries KV ops, watches, leases with
keep-alive, addressed request/reply, pub/sub and queue ops. The frames are
the JAX package's, so this client also talks to the JAX server.

HA (:26-110): `addrs` lists the members of a control-plane pair. `connect`
probes each member's role (wire.oneshot_request), enrolls with the primary
of the HIGHEST fencing epoch (a deposed primary that survived a partition
is never chosen), adopts the probe's connection, and retries every 0.5 s
until its deadline, so a standby that still refuses (mid-failover) or a
member that is not up yet is ridden out. Every op then echoes the enrolled
epoch: the server refuses an older one and steps down on a newer one.
Once the read loop has seen the connection end, every op raises a
ConnectionError at once (JAX sends it and waits out its timeout), so a
lease keep-alive finds a dead primary within one keep-alive interval
(TTL / 3), not TTL / 3 + TTL.

Fault injection (runtime/faults.py): every frame sent fires
`transport.send` (a drop raises a ConnectionError into the caller;
tcp.py:99-110), every keep-alive round `discovery.heartbeat` (a drop loses
the round; :214-226), and watches deliver through `WatchStream`
(`watch.stream`).

Every task the client starts is held in `self._tasks` until it ends: the
loop keeps tasks only weakly, and a request handler waiting on a
call-home stream is otherwise reachable from nothing but a reference
cycle (Python 3.12's StreamReaderProtocol holds its reader weakly), which
a cyclic garbage collection destroys mid-await.
"""
from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Dict, Optional

from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.transports.base import (
    KVEntry, KVStore, Lease, Messaging, QueueStream, WatchEvent, WatchStream,
)
from dynamo_tpu_torch.runtime.transports.wire import (
    oneshot_request, read_frame, write_frame,
)

log = logging.getLogger("dynamo_tpu_torch.transports.tcp")


def parse_addrs(text: str, default_port: int = 6230) -> list:
    """"h1:p1,h2:p2" as [(h1, p1), (h2, p2)] (the comma form of an HA
    pair); a part without a port takes `default_port`, ":p" the host
    127.0.0.1."""
    addrs = []
    for part in text.split(","):
        h, sep, p = part.strip().rpartition(":")
        if not sep:
            h, p = p, ""
        addrs.append((h or "127.0.0.1", int(p) if p else default_port))
    return addrs


class ControlPlaneClient(KVStore, Messaging):
    def __init__(self, host: str = "127.0.0.1", port: int = 6230,
                 addrs=None):
        """addrs: optional [(host, port), ...], an HA control-plane pair;
        connect() follows whichever member is primary at the highest
        epoch."""
        self.host, self.port = host, port
        self.addrs = list(addrs) if addrs else [(host, port)]
        self.epoch: Optional[int] = None
        self._reader = None
        self._writer = None
        self._ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watch_queues: Dict[int, asyncio.Queue] = {}
        self._sub_queues: Dict[int, asyncio.Queue] = {}
        self._handlers: Dict[str, callable] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._keepalive_tasks: Dict[int, asyncio.Task] = {}
        self._tasks: set = set()
        self._write_lock = asyncio.Lock()
        self.closed = asyncio.Event()

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def connect(self, timeout_s: float = 20.0) -> "ControlPlaneClient":
        """Connect to the primary member of `addrs`, retrying until the
        deadline: a dead member is skipped, a standby is probed and
        skipped, and a mid-failover window (old primary dead, standby not
        yet promoted) is ridden out by the retry loop. With several
        primaries visible the HIGHEST promotion epoch wins. The winning
        probe connection is adopted as the client connection."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        last_err: Optional[Exception] = None
        while True:
            best = None  # (epoch, host, port, reader, writer)
            for host, port in self.addrs:
                try:
                    info, reader, writer = await oneshot_request(
                        host, port, {"op": "role"}, 5.0, keep_open=True)
                except Exception as e:  # noqa: BLE001 — try the next member
                    last_err = e
                    continue
                role = info.get("role", "primary")
                if role == "primary":
                    cand = (info.get("epoch", 1), host, port, reader, writer)
                    if best is None or cand[0] > best[0]:
                        if best is not None:
                            best[4].close()
                        best = cand
                        continue
                else:
                    last_err = ConnectionError(f"{host}:{port} is {role}")
                writer.close()
            if best is not None:
                epoch, host, port, reader, writer = best
                self._reader, self._writer = reader, writer
                self._reader_task = self._spawn(self._read_loop())
                self.host, self.port, self.epoch = host, port, epoch
                return self
            if loop.time() >= deadline:
                raise ConnectionError(
                    f"no primary control plane among {self.addrs}"
                ) from last_err
            await asyncio.sleep(0.5)

    async def close(self):
        for t in self._keepalive_tasks.values():
            t.cancel()
        for t in list(self._tasks):
            t.cancel()
        if self._writer:
            self._writer.close()
        self.closed.set()

    # -- plumbing ------------------------------------------------------------

    async def _send(self, msg):
        if faults.REGISTRY.enabled:   # a drop: ConnectionError (FaultInjected)
            await faults.REGISTRY.fire("transport.send")
        async with self._write_lock:
            write_frame(self._writer, msg)
            # bounded: a peer that stops reading must not wedge every sender
            # behind the write lock (TimeoutError is an OSError)
            await asyncio.wait_for(self._writer.drain(), 30.0)

    async def _rpc(self, msg, timeout: float = 60.0):
        if self.closed.is_set():
            # the read loop saw the connection end: a frame written now may
            # still land in the socket's buffer without an error, and its
            # reply would never come (JAX waits out `timeout` here)
            raise ConnectionError("control plane lost")
        rid = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            # every op echoes the enrolled promotion epoch (fencing): the
            # server refuses older-epoch ops and steps down on newer ones
            if self.epoch is not None and "epoch" not in msg:
                msg = {"epoch": self.epoch, **msg}
            await self._send({"id": rid, **msg})
            reply = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)
        if reply.get("error"):
            raise RuntimeError(reply["error"])
        return reply

    async def _read_loop(self):
        try:
            while True:
                # dynalint: unbounded-io-ok=idle-is-legal-here — the server
                # pushes watch and event frames at any time; death
                # surfaces as EOF
                msg = await read_frame(self._reader)
                op = msg.get("op")
                if op is None:
                    fut = self._pending.get(msg.get("id"))
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
                elif op == "watch_event":
                    q = self._watch_queues.get(msg["watch_id"])
                    if q:
                        q.put_nowait(WatchEvent(msg["kind"], msg["key"],
                                                msg.get("value")))
                elif op == "event":
                    q = self._sub_queues.get(msg["sub_id"])
                    if q:
                        q.put_nowait((msg["subject"], msg["payload"]))
                elif op == "handle":
                    self._spawn(self._handle_request(msg))
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError):
            pass
        finally:
            self.closed.set()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("control plane lost"))

    async def _handle_request(self, msg):
        handler = self._handlers.get(msg["subject"])
        reply = {"op": "reply", "handle_id": msg["handle_id"]}
        if handler is None:
            reply["error"] = f"no local handler for {msg['subject']!r}"
        else:
            try:
                reply["payload"] = await handler(msg["payload"])
            except Exception as e:  # noqa: BLE001 — reported to the caller
                reply["error"] = f"{type(e).__name__}: {e}"
        await self._send(reply)

    # -- KVStore -------------------------------------------------------------

    async def put(self, key, value, lease_id: int = 0):
        await self._rpc({"op": "put", "key": key, "value": value,
                         "lease": lease_id})

    async def create(self, key, value, lease_id: int = 0) -> bool:
        return (await self._rpc({"op": "create", "key": key, "value": value,
                                 "lease": lease_id}))["ok"]

    async def get(self, key):
        return (await self._rpc({"op": "get", "key": key}))["value"]

    async def get_prefix(self, prefix):
        reply = await self._rpc({"op": "get_prefix", "prefix": prefix})
        return [KVEntry(k, v, l) for k, v, l in reply["entries"]]

    async def delete(self, key):
        await self._rpc({"op": "delete", "key": key})

    async def grant_lease(self, ttl: float = 10.0) -> Lease:
        reply = await self._rpc({"op": "lease_grant", "ttl": ttl})
        lease_id = reply["lease"]
        lease = Lease(lease_id, self._revoke_lease)
        lease.lost = asyncio.Event()
        self._keepalive_tasks[lease_id] = self._spawn(
            self._keepalive_loop(lease_id, ttl, lease))
        return lease

    async def _revoke_lease(self, lease_id: int):
        t = self._keepalive_tasks.pop(lease_id, None)
        if t:
            t.cancel()
        await self._rpc({"op": "lease_revoke", "lease": lease_id})

    async def _keepalive_loop(self, lease_id: int, ttl: float, lease: Lease):
        """Heartbeat at ttl/3; a lost lease fires lease.lost (the runtime
        couples that to shutdown)."""
        try:
            # dynalint: backoff-ok=TTL-paced lease renewal; a failed keepalive ends the loop (lease lost) instead of retrying
            while True:
                await asyncio.sleep(ttl / 3)
                if faults.REGISTRY.enabled:
                    try:
                        await faults.REGISTRY.fire("discovery.heartbeat")
                    except faults.FaultInjected:
                        continue  # this heartbeat round is lost
                try:
                    ok = (await self._rpc({"op": "lease_keepalive",
                                           "lease": lease_id},
                                          timeout=ttl))["ok"]
                except Exception:  # noqa: BLE001 — any failure loses it
                    ok = False
                if not ok:
                    lease.lost.set()
                    return
        except asyncio.CancelledError:
            pass

    async def watch_prefix(self, prefix):
        reply = await self._rpc({"op": "watch", "prefix": prefix})
        wid = reply["watch_id"]
        q: asyncio.Queue = asyncio.Queue()
        self._watch_queues[wid] = q
        snapshot = [KVEntry(k, v, l) for k, v, l in reply["entries"]]

        async def on_close():
            self._watch_queues.pop(wid, None)
            try:
                await self._rpc({"op": "unwatch", "watch_id": wid}, 5.0)
            except Exception:  # dynalint: swallow-ok=best-effort-unwatch
                pass

        return snapshot, WatchStream(q, on_close=on_close)

    # -- Messaging -----------------------------------------------------------

    async def serve(self, subject, handler):
        self._handlers[subject] = handler
        await self._rpc({"op": "serve", "subject": subject})

        async def unsubscribe():
            self._handlers.pop(subject, None)
            await self._rpc({"op": "unserve", "subject": subject})

        return unsubscribe

    async def request(self, subject, payload, timeout: float = 30.0):
        reply = await self._rpc({"op": "request", "subject": subject,
                                 "payload": payload, "timeout": timeout},
                                timeout=timeout + 5)
        return reply["payload"]

    async def publish(self, subject, payload):
        await self._rpc({"op": "publish", "subject": subject,
                         "payload": payload})

    async def subscribe(self, subject):
        reply = await self._rpc({"op": "subscribe", "subject": subject})
        sid = reply["sub_id"]
        q: asyncio.Queue = asyncio.Queue()
        self._sub_queues[sid] = q

        async def on_close():
            self._sub_queues.pop(sid, None)
            try:
                await self._rpc({"op": "unsubscribe", "sub_id": sid}, 5.0)
            except Exception:  # dynalint: swallow-ok=best-effort-unsubscribe
                pass

        return QueueStream(q, on_close=on_close)

    async def queue_push(self, queue, payload):
        await self._rpc({"op": "queue_push", "queue": queue,
                         "payload": payload})

    async def queue_pop(self, queue, timeout=None):
        rpc_timeout = (timeout + 5) if timeout is not None else 3600.0
        reply = await self._rpc({"op": "queue_pop", "queue": queue,
                                 "timeout": timeout}, timeout=rpc_timeout)
        return reply["payload"]

    async def queue_pop_leased(self, queue, timeout=None, lease_s=30.0):
        rpc_timeout = (timeout + 5) if timeout is not None else 3600.0
        reply = await self._rpc(
            {"op": "queue_pop_leased", "queue": queue, "timeout": timeout,
             "lease_s": lease_s}, timeout=rpc_timeout)
        if reply.get("payload") is None:
            return None
        return reply["payload"], reply["token"]

    async def queue_ack(self, queue, token):
        await self._rpc({"op": "queue_ack", "queue": queue, "token": token})

    async def queue_touch(self, queue, token, lease_s: float = 30.0):
        reply = await self._rpc({"op": "queue_touch", "queue": queue,
                                 "token": token, "lease_s": lease_s})
        return bool(reply.get("alive", True))

    async def queue_depth(self, queue):
        return (await self._rpc({"op": "queue_depth",
                                 "queue": queue}))["depth"]
