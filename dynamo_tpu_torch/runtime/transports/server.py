"""Standalone control-plane server: the etcd + NATS roles in one process.

Copied from dynamo_tpu/runtime/transports/server.py (`ControlPlaneServer`,
:355; CLI `main`, :667): one asyncio TCP server for discovery KV (leases,
prefix watches), the request plane (addressed request/reply routed to
registered responders), the event plane (pub/sub) and work queues. State is
held in the in-process memory plane (transports/memory.py), so the
semantics are the same in one process and across processes. The frames are
the JAX package's: the JAX client talks to this server too.

Durability and HA (:279-353, :355-660): `--data-dir` journals unleased KV
and queue contents (transports/journal.py); `--standby-of HOST:PORT` runs
a hot standby that bootstraps from the primary's snapshot, streams its
journal records, and promotes itself at a bumped fencing epoch when the
replication link drops and the primary no longer answers its role probe.
Clients echo the epoch they enrolled at on every op (transports/tcp.py):
an older epoch is refused, a newer one deposes this member; the promoted
member's fence loop deposes the old primary, which, being durable, rejoins
as its standby. Replication is asynchronous: a write acknowledged just
before the primary dies may not have reached the standby. Leases are not
replicated, so every client of a dead primary loses its lease (and its
runtime: runtime/distributed.py). Left out: the layered settings file
(utils/settings.py); the flags take its defaults. Every task the server
starts is held until it ends (see transports/tcp.py on why).

Run: python -m dynamo_tpu_torch.runtime.transports.server --port 0
  [--data-dir DIR [--no-fsync] [--standby-of HOST:PORT]]
(prints `READY control-plane=:<port>`, and `PROMOTED control-plane=:<port>`
when a standby takes over).
"""
from __future__ import annotations

import argparse
import asyncio
import itertools
import logging
import uuid
from typing import Dict

from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from dynamo_tpu_torch.runtime.transports.tcp import parse_addrs
from dynamo_tpu_torch.runtime.transports.wire import (
    oneshot_request, read_frame, write_frame,
)

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
            if self.server.role != "primary" and op not in ("role", "ping",
                                                            "fence"):
                # standby / deposed: replicate-only until promoted; clients
                # fail over by probing `role` (tcp.ControlPlaneClient)
                raise ConnectionError(
                    f"{self.server.role} control plane; not serving")
            ep = msg.get("epoch")
            if ep is not None and op not in ("role", "ping"):
                # fencing: clients echo the epoch of the primary they
                # enrolled with on every op. A NEWER epoch proves a later
                # promotion happened somewhere we can't see (partition):
                # step down rather than keep acknowledging divergent
                # writes. An OLDER epoch is a client still enrolled with a
                # deposed primary: refuse it so it re-probes.
                if ep > self.server.epoch:
                    self.server.depose(ep)
                    raise ConnectionError(
                        f"fenced: op epoch {ep} > ours; stepping down")
                if ep < self.server.epoch:
                    raise ConnectionError(
                        f"stale epoch {ep} (primary epoch is "
                        f"{self.server.epoch}); re-probe the control plane")
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

    async def _op_ping(self, m):
        return {"pong": True}

    # -- HA replication ------------------------------------------------------

    async def _op_role(self, m):
        return {"role": self.server.role, "synced": self.server.synced,
                "epoch": self.server.epoch}

    async def _op_fence(self, m):
        """A promoted member announces its epoch; a PRIMARY carrying an
        older epoch steps down and, when the fence names the winner's
        port, REJOINS as its hot standby (self-healing pair). Carried in
        `fence_epoch` (not `epoch`) so it bypasses the client-echo gate.
        A standby only tracks the newer epoch: deposing it would kill its
        replication loop and leave the pair with no replication at all."""
        ep = m["fence_epoch"]
        rejoin = None
        if m.get("port"):
            # the winner as seen from THIS member: the fencing
            # connection's source host + its advertised port
            peer = self.writer.get_extra_info("peername")
            if peer:
                rejoin = (peer[0], int(m["port"]))
        # equal-epoch tie-break on the per-promotion id: covers a reborn
        # member whose journal carries the same epoch the winner holds
        loses_tie = (ep == self.server.epoch
                     and m.get("promo_id", "") > self.server.promo_id)
        if ep > self.server.epoch or loses_tie:
            if self.server.role == "primary":
                self.server.depose(ep, rejoin=rejoin)
            else:
                self.server.epoch = ep
        elif (ep >= self.server.epoch and rejoin
                and self.server.role == "deposed"):
            # deposed earlier by a client op (which carries no address);
            # the winner's fence now names one: late self-heal
            self.server.depose(ep, rejoin=rejoin)
        return {"role": self.server.role, "epoch": self.server.epoch}

    async def _op_repl_subscribe(self, m):
        """Standby bootstrap: a consistent snapshot of persistent state,
        then every journal record streamed in append order. Snapshot
        capture and subscriber registration happen in one event-loop step
        (no awaits), so no record can fall in the gap."""
        plane = self.server.plane
        if not hasattr(plane, "snapshot_state"):
            raise ValueError("replication requires a durable primary "
                             "(start it with --data-dir)")
        if self.server.role != "primary":
            raise ValueError("cannot replicate from a standby")
        sid = next(self.server.ids)
        # bounded: a standby that stops draining must not grow primary
        # memory without limit; on overflow the subscriber is evicted and
        # its connection closed, so it re-bootstraps from a snapshot
        q: asyncio.Queue = asyncio.Queue(maxsize=self.server.repl_backlog)
        snap = plane.snapshot_state()
        self.server.repl_subs[sid] = (q, self)

        async def pump():
            try:
                while True:
                    rec = await q.get()
                    await self.send({"op": "repl_rec", "rec": rec})
            except OSError:
                pass  # evicted mid-send or link dropped: it re-bootstraps
            finally:
                self.server.repl_subs.pop(sid, None)

        self.sub_tasks[sid] = self.spawn(pump())
        return {"snapshot": snap}


class ControlPlaneServer:
    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 data_dir: str = None, fsync: bool = True,
                 standby_of: tuple = None):
        """data_dir enables durability: unleased KV state and work-queue
        contents journal to disk and survive a server restart. fsync=True
        (default) group-commits journal batches to stable storage and acks
        queue_push only after the fsync; False trades that for lower push
        latency (flush only).

        standby_of=(host, port) runs this server as a HOT STANDBY of a
        durable primary: it bootstraps from the primary's snapshot, applies
        its journal record stream (journaling everything locally, so the
        standby is itself restartable), refuses client ops, and PROMOTES
        itself when the replication link drops after a successful sync and
        the primary no longer answers as primary. Every promotion bumps a
        monotonic fencing epoch, persisted in the journal and returned by
        `role`. What this is NOT: raft. A client that can reach ONLY the
        old primary keeps writing at the old epoch until newer-epoch
        traffic arrives; the fence guarantees acknowledged writes never
        interleave across epochs on one member. Known limitation: TWO
        standbys of one primary that promote concurrently reach the same
        epoch and never fence each other: run the pair topology."""
        self.host, self.port = host, port
        if data_dir:
            from dynamo_tpu_torch.runtime.transports.journal import (
                DurablePlane,
            )
            self.plane = DurablePlane(data_dir, fsync=fsync)
        else:
            self.plane = MemoryPlane()
        self.responders: Dict[str, _Conn] = {}
        self.leases: Dict[int, object] = {}
        self.ids = itertools.count(1)
        self._server: asyncio.AbstractServer = None
        self._conns: set = set()
        self.standby_of = standby_of
        self.role = "standby" if standby_of else "primary"
        self.synced = False
        self.repl_subs: Dict[int, tuple] = {}  # sid -> (queue, conn)
        self.repl_backlog = 10_000
        self._repl_task: asyncio.Task = None
        self._fence_task: asyncio.Task = None
        journal = getattr(self.plane, "journal", None)
        if journal is not None:
            journal.on_record = self._fanout_record
        # fencing epoch: recovered from the journal if durable (a restarted
        # member rejoins at the epoch it held); a fresh primary starts at 1
        self.epoch = max(1, journal.epoch) if journal is not None else 1
        if journal is not None:
            journal.epoch = self.epoch
        # per-promotion id, the equal-epoch fence tie-break
        self.promo_id = ""

    def depose(self, newer_epoch: int, rejoin: tuple = None) -> None:
        """Step down: a peer proved a newer promotion epoch exists (we are
        the stale side of a partition). Refuse all further ops so our
        clients fail over; remember the newer epoch so `role` reports it.
        Deliberately NOT journaled: a deposed member restarting comes back
        as primary at its OLD epoch and is re-fenced by the first
        epoch-tagged op or fence. With `rejoin` (the winner's address, from
        its fence message) a DURABLE member re-enters the pair as the
        winner's hot standby, bootstrapping from its snapshot (which
        discards our divergent stale-epoch tail)."""
        if self.role == "primary":
            log.warning("DEPOSED: op carried epoch %d >= ours %d; refusing "
                        "all ops on :%d", newer_epoch, self.epoch, self.port)
        self.role = "deposed"
        self.epoch = max(self.epoch, newer_epoch)
        # our own fencing loop (from a past promotion) dies with the
        # primacy it defended: left running it would fence the winner
        if self._fence_task is not None:
            self._fence_task.cancel()
            self._fence_task = None
        if rejoin and hasattr(self.plane, "snapshot_state"):
            log.warning("rejoining as hot standby of %s:%d", *rejoin)
            self.standby_of = rejoin
            self.synced = False
            self.role = "standby"
            if self._repl_task is None or self._repl_task.done():
                self._repl_task = asyncio.create_task(self._replicate())

    def _fanout_record(self, rec: dict) -> None:
        for sid, (q, conn) in list(self.repl_subs.items()):
            try:
                q.put_nowait(rec)
            except asyncio.QueueFull:
                log.warning("replication subscriber %d fell %d records "
                            "behind; evicting (it will re-bootstrap from "
                            "a snapshot)", sid, self.repl_backlog)
                self.repl_subs.pop(sid, None)
                # the standby tells this eviction from primary death by
                # probing our role before promoting (_replicate)
                conn.writer.close()

    async def start(self) -> "ControlPlaneServer":
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.standby_of is not None:
            if not hasattr(self.plane, "snapshot_state"):
                raise ValueError("a standby needs --data-dir (it journals "
                                 "the replicated state locally)")
            self._repl_task = asyncio.create_task(self._replicate())
        return self

    def _promote(self) -> None:
        self.promo_id = uuid.uuid4().hex
        self.role = "primary"
        print(f"PROMOTED control-plane=:{self.port}", flush=True)

    async def _replicate(self):
        """Standby loop: sync from the primary until the link dies, then
        promote. Connection refused BEFORE any successful sync keeps
        retrying (the primary may simply not be up yet)."""
        from dynamo_tpu_torch.runtime.transports.journal import (
            apply_replicated,
        )
        host, port = self.standby_of
        while self.role == "standby":
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), 5.0)
            except (OSError, asyncio.TimeoutError):
                await asyncio.sleep(0.5)
                continue
            try:
                write_frame(writer, {"op": "repl_subscribe", "id": 1})
                await asyncio.wait_for(writer.drain(), 30.0)
                while True:
                    # dynalint: unbounded-io-ok=replication-stream-is-push —
                    # link death surfaces as EOF and the loop re-dials
                    m = await read_frame(reader)
                    if m.get("id") == 1:
                        if m.get("error"):
                            raise ConnectionError(m["error"])
                        snap_ep = m["snapshot"].get("epoch", 1)
                        my_ep = self.plane.journal.epoch
                        if snap_ep < my_ep:
                            # the "primary" we were pointed at is STALE:
                            # our own journal carries a higher promotion
                            # epoch (we acknowledged writes at it). Syncing
                            # would destroy that history: refuse, resume
                            # primacy at our epoch, and fence the peer
                            log.error(
                                "peer %s:%d offers snapshot epoch %d "
                                "below our journaled epoch %d; refusing "
                                "to sync, resuming primacy and fencing "
                                "it", host, port, snap_ep, my_ep)
                            self.epoch = my_ep
                            self._promote()
                            self._arm_fence(host, port)
                            return
                        await self.plane.load_snapshot(m["snapshot"])
                        # track the primary's epoch so promotion bumps
                        # PAST it
                        self.epoch = max(self.epoch, snap_ep)
                        self.synced = True
                        log.info("standby synced from %s:%d (epoch %d)",
                                 host, port, self.epoch)
                    elif m.get("op") == "repl_rec":
                        await apply_replicated(self.plane, m["rec"])
                        if m["rec"].get("op") == "epoch":
                            self.epoch = max(self.epoch, m["rec"]["epoch"])
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                pass
            finally:
                writer.close()
            if self.synced and await self._primary_alive(host, port):
                # link lost but the primary still answers as primary: we
                # were EVICTED (fell behind the bounded replication queue)
                # or hit a transient close; promoting would fence a healthy
                # primary off a replica missing records. Re-bootstrap.
                log.warning("replication link lost but primary %s:%d is "
                            "alive; re-bootstrapping instead of promoting",
                            host, port)
                self.synced = False
                await asyncio.sleep(0.5)
                continue
            if self.synced:
                self.epoch += 1
                self.plane.journal.record_epoch(self.epoch)
                log.warning("replication link to %s:%d lost; PROMOTED to "
                            "primary on :%d at epoch %d", host, port,
                            self.port, self.epoch)
                self._promote()
                # keep fencing the old primary: if the link loss was a
                # partition or it later restarts from its data dir, it
                # must learn the newer epoch and step down
                self._arm_fence(host, port)
                return
            await asyncio.sleep(0.5)

    async def _primary_alive(self, host, port) -> bool:
        """One role probe with a hard timeout: does the peer still answer
        as a primary? Tells eviction / transient closes (re-bootstrap)
        from primary death or a partition (promote)."""
        try:
            m = await oneshot_request(host, port, {"op": "role"}, 3.0)
            return m.get("role") == "primary"
        except (OSError, ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            return False

    def _arm_fence(self, host, port):
        """(Re)start the fencing loop toward the peer we superseded; any
        loop from an earlier promotion is cancelled first."""
        if self._fence_task is not None:
            self._fence_task.cancel()
        self._fence_task = asyncio.create_task(self._fence_peer(host, port))

    async def _fence_peer(self, host, port):
        # runs for the promoted member's whole life: a deposed peer that
        # RESTARTS from its data dir comes back as primary at its old
        # epoch (deposition is not journaled) and must be re-fenced
        fenced = False
        while True:
            try:
                m = await oneshot_request(
                    host, port,
                    {"op": "fence", "fence_epoch": self.epoch,
                     "port": self.port, "promo_id": self.promo_id},
                    5.0)
                now_fenced = m.get("role") != "primary"
                if now_fenced and not fenced:
                    log.info("old primary %s:%d fenced (role=%s)",
                             host, port, m.get("role"))
                fenced = now_fenced
            except (OSError, ConnectionError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError):
                fenced = False  # dead or still partitioned; keep trying
            await asyncio.sleep(2.0)

    async def _on_connect(self, reader, writer):
        conn = _Conn(self, reader, writer)
        self._conns.add(conn)
        try:
            await conn.run()
        finally:
            self._conns.discard(conn)

    async def stop(self):
        for task in (self._repl_task, self._fence_task):
            if task is not None:
                task.cancel()
        if self._server:
            self._server.close()
            # 3.12 wait_closed() waits for every open connection (a hot
            # standby holds its replication stream open): close them
            # actively (their handlers then run cleanup())
            for conn in list(self._conns):
                conn.writer.close()
            await self._server.wait_closed()
            self._server = None
        close = getattr(self.plane, "close", None)
        if close:
            close()

    async def serve_forever(self):
        await self.start()
        log.info("control plane listening on %s:%d (%s)", self.host,
                 self.port, self.role)
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
    ap.add_argument("--data-dir", default=None,
                    help="enable durability: journal KV + queues here")
    ap.add_argument("--no-fsync", action="store_true",
                    help="flush-only journal (faster pushes; an OS crash "
                         "may lose acknowledged writes)")
    ap.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                    help="run as a hot standby replicating this primary; "
                         "promotes itself when the link drops (needs "
                         "--data-dir)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    standby = parse_addrs(args.standby_of)[0] if args.standby_of else None
    try:
        asyncio.run(ControlPlaneServer(
            args.host, args.port, data_dir=args.data_dir,
            fsync=not args.no_fsync, standby_of=standby).serve_forever())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
