"""Standalone control-plane server: the etcd + NATS roles in one process.

Copied from dynamo_tpu/runtime/transports/server.py (`ControlPlaneServer`,
:355; CLI `main`, :667): one asyncio TCP server for discovery KV (leases,
prefix watches), the request plane (addressed request/reply routed to
registered responders), the event plane (pub/sub) and work queues. State is
held in the in-process memory plane (transports/memory.py), so the
semantics are the same in one process and across processes. The frames are
the JAX package's: the JAX client talks to this server too. Its `role` op
answers "primary" at epoch 1, which is what the JAX client's probe reads.

Left out, for a later slice: the durable journal (`--data-dir`,
transports/journal.py), the hot standby and its promotion, fencing epochs
and replication (server.py:283-305, :358-660, `--standby-of` :683), and
the layered settings file. Every task the server starts is held until it
ends (see transports/tcp.py on why).

Run: python -m dynamo_tpu_torch.runtime.transports.server --port 0
(prints `READY control-plane=:<port>`).
"""
from __future__ import annotations

import argparse
import asyncio
import itertools
import logging
from typing import Dict

from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from dynamo_tpu_torch.runtime.transports.wire import read_frame, write_frame

log = logging.getLogger("dynamo_tpu_torch.controlplane")

DEFAULT_PORT = 6230


class _Conn:
    def __init__(self, server: "ControlPlaneServer", reader, writer):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.watch_tasks: Dict[int, asyncio.Task] = {}
        self.sub_tasks: Dict[int, asyncio.Task] = {}
        self.responders: Dict[str, None] = {}
        self.pending_handles: Dict[int, asyncio.Future] = {}
        self.tasks: set = set()
        self._write_lock = asyncio.Lock()

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.create_task(coro)
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)
        return task

    async def send(self, msg):
        async with self._write_lock:
            write_frame(self.writer, msg)
            # bounded: one client that stops reading must not wedge every
            # send to its connection behind the write lock
            await asyncio.wait_for(self.writer.drain(), 30.0)

    async def run(self):
        try:
            while True:
                # dynalint: unbounded-io-ok=idle-client-connections-are-legal
                msg = await read_frame(self.reader)
                self.spawn(self._dispatch(msg))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self.cleanup()

    def cleanup(self):
        for t in list(self.tasks):
            t.cancel()
        for subject in list(self.responders):
            # only deregister if WE are still the registered responder — a
            # reconnected worker may have re-registered the same subject
            if self.server.responders.get(subject) is self:
                del self.server.responders[subject]
        for fut in self.pending_handles.values():
            if not fut.done():
                fut.set_exception(ConnectionError("responder disconnected"))
        self.writer.close()

    async def _dispatch(self, msg):
        op = msg.get("op")
        rid = msg.get("id")
        try:
            handler = getattr(self, f"_op_{op}", None)
            if handler is None:
                raise ValueError(f"unknown op {op!r}")
            result = await handler(msg)
            if rid is not None:
                await self.send({"id": rid, **(result or {})})
        except Exception as e:  # noqa: BLE001 — reported to the peer
            if rid is not None:
                try:
                    await self.send({"id": rid,
                                     "error": f"{type(e).__name__}: {e}"})
                except (OSError, ConnectionError):
                    pass  # the peer is gone; its cleanup runs in run()
            else:
                log.exception("error handling %s", op)

    # -- KV ------------------------------------------------------------------

    async def _op_put(self, m):
        await self.server.plane.kv.put(m["key"], m["value"], m.get("lease", 0))
        return {}

    async def _op_create(self, m):
        ok = await self.server.plane.kv.create(m["key"], m["value"],
                                               m.get("lease", 0))
        return {"ok": ok}

    async def _op_get(self, m):
        return {"value": await self.server.plane.kv.get(m["key"])}

    async def _op_get_prefix(self, m):
        entries = await self.server.plane.kv.get_prefix(m["prefix"])
        return {"entries": [[e.key, e.value, e.lease_id] for e in entries]}

    async def _op_delete(self, m):
        await self.server.plane.kv.delete(m["key"])
        return {}

    async def _op_lease_grant(self, m):
        lease = await self.server.plane.kv.grant_lease(m.get("ttl", 10.0))
        self.server.leases[lease.id] = lease
        return {"lease": lease.id}

    async def _op_lease_keepalive(self, m):
        lease = self.server.leases.get(m["lease"])
        if lease is None or lease.lost.is_set():
            return {"ok": False}
        lease.keep_alive()
        return {"ok": True}

    async def _op_lease_revoke(self, m):
        lease = self.server.leases.pop(m["lease"], None)
        if lease is not None:
            await lease.revoke()
        return {}

    async def _op_watch(self, m):
        wid = next(self.server.ids)
        snapshot, events = await self.server.plane.kv.watch_prefix(m["prefix"])

        async def pump():
            try:
                async for ev in events:
                    await self.send({"op": "watch_event", "watch_id": wid,
                                     "kind": ev.kind, "key": ev.key,
                                     "value": ev.value})
            finally:
                await events.aclose()

        self.watch_tasks[wid] = self.spawn(pump())
        return {"watch_id": wid,
                "entries": [[e.key, e.value, e.lease_id] for e in snapshot]}

    async def _op_unwatch(self, m):
        t = self.watch_tasks.pop(m["watch_id"], None)
        if t:
            t.cancel()
        return {}

    # -- request plane -------------------------------------------------------

    async def _op_serve(self, m):
        subject = m["subject"]
        self.server.responders[subject] = self
        self.responders[subject] = None
        return {}

    async def _op_unserve(self, m):
        subject = m["subject"]
        if self.server.responders.get(subject) is self:
            del self.server.responders[subject]
        self.responders.pop(subject, None)
        return {}

    async def _op_request(self, m):
        responder = self.server.responders.get(m["subject"])
        if responder is None:
            raise ConnectionError(f"no responder on {m['subject']!r}")
        hid = next(self.server.ids)
        fut = asyncio.get_running_loop().create_future()
        responder.pending_handles[hid] = fut
        try:
            await responder.send({"op": "handle", "handle_id": hid,
                                  "subject": m["subject"],
                                  "payload": m["payload"]})
            payload = await asyncio.wait_for(fut, m.get("timeout", 30.0))
        finally:
            responder.pending_handles.pop(hid, None)
        return {"payload": payload}

    async def _op_reply(self, m):
        fut = self.pending_handles.get(m["handle_id"])
        if fut is not None and not fut.done():
            if m.get("error"):
                fut.set_exception(RuntimeError(m["error"]))
            else:
                fut.set_result(m["payload"])
        return None

    # -- events --------------------------------------------------------------

    async def _op_publish(self, m):
        await self.server.plane.messaging.publish(m["subject"], m["payload"])
        return {}

    async def _op_subscribe(self, m):
        sid = next(self.server.ids)
        stream = await self.server.plane.messaging.subscribe(m["subject"])

        async def pump():
            try:
                async for subject, payload in stream:
                    await self.send({"op": "event", "sub_id": sid,
                                     "subject": subject, "payload": payload})
            finally:
                await stream.aclose()

        self.sub_tasks[sid] = self.spawn(pump())
        return {"sub_id": sid}

    async def _op_unsubscribe(self, m):
        t = self.sub_tasks.pop(m["sub_id"], None)
        if t:
            t.cancel()
        return {}

    # -- queues --------------------------------------------------------------

    async def _op_queue_push(self, m):
        await self.server.plane.messaging.queue_push(m["queue"], m["payload"])
        return {}

    async def _op_queue_pop(self, m):
        payload = await self.server.plane.messaging.queue_pop(
            m["queue"], timeout=m.get("timeout"))
        return {"payload": payload}

    async def _op_queue_pop_leased(self, m):
        got = await self.server.plane.messaging.queue_pop_leased(
            m["queue"], timeout=m.get("timeout"),
            lease_s=m.get("lease_s") or 30.0)
        if got is None:
            return {"payload": None, "token": None}
        return {"payload": got[0], "token": got[1]}

    async def _op_queue_ack(self, m):
        await self.server.plane.messaging.queue_ack(m["queue"], m["token"])
        return {}

    async def _op_queue_touch(self, m):
        alive = await self.server.plane.messaging.queue_touch(
            m["queue"], m["token"], lease_s=m.get("lease_s") or 30.0)
        return {"alive": bool(alive)}

    async def _op_queue_depth(self, m):
        return {"depth": await self.server.plane.messaging.queue_depth(
            m["queue"])}

    async def _op_role(self, m):
        # a single primary: the JAX client's connect probe reads this
        return {"role": "primary", "synced": False, "epoch": 1}


class ControlPlaneServer:
    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.host, self.port = host, port
        self.plane = MemoryPlane()
        self.responders: Dict[str, _Conn] = {}
        self.leases: Dict[int, object] = {}
        self.ids = itertools.count(1)
        self._server: asyncio.AbstractServer = None
        self._conns: set = set()

    async def start(self) -> "ControlPlaneServer":
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def _on_connect(self, reader, writer):
        conn = _Conn(self, reader, writer)
        self._conns.add(conn)
        try:
            await conn.run()
        finally:
            self._conns.discard(conn)

    async def stop(self):
        if self._server:
            self._server.close()
            # 3.12 wait_closed() waits for every open connection: close
            # them actively (their handlers then run cleanup())
            for conn in list(self._conns):
                conn.writer.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self):
        await self.start()
        log.info("control plane listening on %s:%d", self.host, self.port)
        print(f"READY control-plane=:{self.port}", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await self.stop()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="dynamo_tpu_torch control-plane server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT,
                    help="0 picks a free port (printed on the READY line)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        asyncio.run(ControlPlaneServer(args.host, args.port).serve_forever())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
