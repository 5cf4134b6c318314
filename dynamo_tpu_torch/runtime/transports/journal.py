"""Durability for the control-plane server: write-ahead journal + snapshot.

Copied from dynamo_tpu/runtime/transports/journal.py (all of it): the
file-backed layer that takes the etcd / JetStream file-store role.

- DurablePlane wraps the in-memory plane and appends every *persistent*
  mutation to an append-only journal: unleased KV puts/deletes and work-queue
  push/pop. Lease-scoped keys are deliberately NOT persisted — as in etcd,
  a lease cannot outlive the server that granted it, so a lease granted by
  a primary is gone after a standby's promotion too (the client's runtime
  then shuts down: runtime/distributed.py).
- Pub/sub events are fire-and-forget, never journaled.
- On open, state is rebuilt from the latest snapshot plus journal replay;
  when the journal exceeds `compact_every` records a fresh snapshot is
  written and the journal truncated.

Records are length-prefixed (4 bytes, little-endian) MessagePack maps,
crash-truncation-tolerant: a torn tail record is discarded on replay. They
are encoded with the port's codec (transports/codec.py `packb`, the bytes
of `msgpack.packb`), so a data directory written by either package is read
by the other.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import io
import logging
import os
import struct
from typing import Optional

from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb
from dynamo_tpu_torch.runtime.transports.memory import (
    LatencyModel, MemoryKVStore, MemoryMessaging, MemoryPlane,
)

log = logging.getLogger("dynamo_tpu_torch.journal")

_LEN = struct.Struct("<I")


def _append_record(f: io.BufferedWriter, rec: dict) -> None:
    payload = packb(rec)
    f.write(_LEN.pack(len(payload)))
    f.write(payload)
    f.flush()


def _read_records(path: str):
    """Yield records; stop silently at a torn tail (crash mid-append)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(_LEN.size)
            if len(head) < _LEN.size:
                return
            (n,) = _LEN.unpack(head)
            payload = f.read(n)
            if len(payload) < n:
                log.warning("journal %s: torn tail record dropped", path)
                return
            yield unpackb(payload)


class DurableKVStore(MemoryKVStore):
    def __init__(self, journal: "Journal",
                 latency: Optional[LatencyModel] = None):
        super().__init__(latency)
        self._journal = journal

    async def put(self, key, value, lease_id: int = 0):
        prev = self._data.get(key)
        await super().put(key, value, lease_id)
        if not lease_id:  # lease-scoped keys die with the server, as in etcd
            self._journal.append({"op": "put", "key": key, "value": value})
        elif prev is not None and not prev.lease_id:
            # a leased put shadowing a journaled unleased value: the old
            # value is gone for good (the key now dies with the lease), so
            # it must not resurrect from the journal after a restart
            self._journal.append({"op": "del", "key": key})

    async def delete(self, key):
        existed = key in self._data
        was_leased = existed and self._data[key].lease_id
        await super().delete(key)
        if existed and not was_leased:
            self._journal.append({"op": "del", "key": key})


class DurableMessaging(MemoryMessaging):
    def __init__(self, journal: "Journal",
                 latency: Optional[LatencyModel] = None):
        super().__init__(latency)
        self._journal = journal

    async def queue_push(self, queue, payload):
        await super().queue_push(queue, payload)
        # ack-after-durable: the server replies to queue_push only when
        # this coroutine returns, so awaiting the group-commit makes an
        # acknowledged push survive even a machine crash (JetStream
        # file-store semantics). Concurrent pushes
        # share one fsync via the writer thread's batch commit.
        fut = self._journal.append(
            {"op": "qpush", "queue": queue, "payload": payload}, ack=True)
        if fut is not None:
            await asyncio.wrap_future(fut)

    async def queue_pop(self, queue, timeout=None):
        item = await super().queue_pop(queue, timeout=timeout)
        if item is not None:
            # logged post-hoc: replay drops one head per qpop, so only the
            # surviving-queue *contents* must match, which FIFO guarantees
            self._journal.append({"op": "qpop", "queue": queue})
        return item


class Journal:
    """Append-only journal with snapshot compaction.

    Crash-atomicity across compaction: queue replay is not
    idempotent, so a crash between the snapshot rename and the journal
    truncation must not replay pre-compaction records on top of the new
    snapshot. Every fresh journal opens with a {"op": "jhead", "gen": G}
    record and the snapshot stores the generation it expects; recovery
    discards a journal whose generation doesn't match (it was already
    folded into the snapshot).

    Flush-behind writer thread: append() and compact()
    run on the control-plane event loop, so all file I/O — including the
    full snapshot rewrite — happens on a dedicated writer thread, in
    order. The loop only packs bytes and enqueues; a compaction never
    stalls leases/watches.

    Group-commit fsync: with fsync=True (default) the
    writer drains every queued record, writes them, and fsyncs ONCE per
    batch — bounded latency under load, JetStream-file-store durability.
    append(rec, ack=True) returns a Future resolved only after that
    fsync, which queue_push awaits before the server acks: an
    acknowledged push survives OS/power crash, not just process crash.
    Fire-and-forget appends (KV puts) ride the same batches, so they are
    fsync'd too; only the ack path waits. A process crash can still lose
    enqueued-but-unwritten *unacked* records (never corrupting or
    reordering) — the same window the reference accepts via
    etcd/JetStream client-side buffering."""

    def __init__(self, data_dir: str, compact_every: int = 10_000,
                 fsync: bool = True):
        os.makedirs(data_dir, exist_ok=True)
        self.snap_path = os.path.join(data_dir, "snapshot.bin")
        self.journal_path = os.path.join(data_dir, "journal.bin")
        self.compact_every = compact_every
        self.fsync = fsync
        self._closed = False
        self._since_compact = 0
        self._gen = 0
        # fencing epoch (transports/server.py): bumped on every standby promotion,
        # persisted here so a restarted member rejoins at the epoch it held.
        # 0 = never recorded (fresh data dir); the server treats that as 1.
        self.epoch = 0
        self._file: Optional[io.BufferedWriter] = None
        self._plane: Optional[MemoryPlane] = None
        import queue as _queue
        import threading as _threading
        self._q: "_queue.Queue" = _queue.Queue()
        # serializes append() against close(): without it a record can be
        # enqueued after the None sentinel (writer already stopping) and
        # silently never hit disk — with an ack future that never resolves
        self._close_lock = _threading.Lock()
        self._writer = _threading.Thread(
            target=self._writer_loop, name="cp-journal", daemon=True)
        self._writer.start()

    def attach(self, plane: MemoryPlane) -> None:
        self._plane = plane
        # replication tee (transports/server.py): called on the event-loop
        # side with every persistent-mutation record, in append order —
        # the hot-standby fanout point (server._fanout_record)
        self.on_record = None

    def append(self, rec: dict, ack: bool = False
               ) -> Optional[concurrent.futures.Future]:
        # the record carries the generation current at ENQUEUE time: the
        # writer stamps a fresh journal's jhead from it, so records
        # enqueued before a pending compaction never land under the new
        # generation (which would discard them on recovery)
        fut = concurrent.futures.Future() if ack else None
        with self._close_lock:
            # checked and enqueued under the same lock close() takes, so a
            # record can never slip in behind the shutdown sentinel (where
            # it would silently vanish and an ack future would never
            # resolve). The replication tee lives under the
            # same gate: a record the closed journal refuses must not be
            # streamed to standbys either (they would journal a write the
            # primary never persisted — divergent histories).
            if self._closed:
                if fut is not None:
                    fut.set_exception(RuntimeError("journal is closed"))
                return fut
            tee = getattr(self, "on_record", None)
            if tee is not None:
                tee(rec)
            self._q.put(("rec", (packb(rec), self._gen, fut)))
        self._since_compact += 1
        if self._since_compact >= self.compact_every:
            self.compact()
        return fut

    def sync(self) -> None:
        """Block until every enqueued write has reached the filesystem."""
        self._q.join()

    # -- writer thread --------------------------------------------------------

    def _writer_loop(self) -> None:
        import queue as _queue
        stop = False
        while not stop:
            # group-commit: take one item, then drain every immediately
            # available record so a burst shares a single fsync
            items = [self._q.get()]
            while items[-1] is not None and items[-1][0] == "rec":
                try:
                    items.append(self._q.get_nowait())
                except _queue.Empty:
                    break
            recs = [it[1] for it in items
                    if it is not None and it[0] == "rec"]
            tail = [it for it in items
                    if it is None or it[0] != "rec"]  # <=1 by construction
            if recs:
                try:
                    for payload, gen, _fut in recs:
                        self._write_record(payload, gen)
                    self._commit()
                    for _, _, fut in recs:
                        if fut is not None and not fut.done():
                            fut.set_result(None)
                except Exception as e:  # pragma: no cover — keep draining
                    log.exception("journal write failed")
                    for _, _, fut in recs:
                        if fut is not None and not fut.done():
                            fut.set_exception(e)
                finally:
                    for _ in recs:
                        self._q.task_done()
            for it in tail:
                try:
                    if it is None:
                        if self._file is not None:
                            self._file.close()
                            self._file = None
                        stop = True
                    else:  # ("snap", (gen, snapshot_bytes))
                        self._write_snapshot(*it[1])
                except Exception:  # pragma: no cover — keep draining  # dynalint: swallow-ok=writer-thread-must-keep-draining
                    log.exception("journal write failed")
                finally:
                    self._q.task_done()

    def _write_record(self, payload: bytes, gen: int) -> None:
        if self._file is None:
            self._file = open(self.journal_path, "ab")
            if os.path.getsize(self.journal_path) == 0:
                _append_record(self._file, {"op": "jhead", "gen": gen})
        self._file.write(_LEN.pack(len(payload)))
        self._file.write(payload)

    def _commit(self) -> None:
        """Flush (and, in durable mode, fsync) the current journal batch."""
        if self._file is not None:
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())

    def _write_snapshot(self, new_gen: int, snap_bytes: bytes) -> None:
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_LEN.pack(len(snap_bytes)))
            f.write(snap_bytes)
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        if self.fsync:
            # make the rename itself durable (directory entry update)
            try:
                dfd = os.open(os.path.dirname(self.snap_path), os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:  # pragma: no cover — platform-dependent
                pass
        # crash window here: old journal still on disk, but its jhead gen
        # no longer matches the snapshot, so recovery discards it
        if self._file is not None:
            self._file.close()
            self._file = None
        with open(self.journal_path, "wb") as f:
            _append_record(f, {"op": "jhead", "gen": new_gen})
            if self.fsync:
                os.fsync(f.fileno())

    # -- recovery -------------------------------------------------------------

    def recover_into(self, kv: MemoryKVStore, mq: MemoryMessaging) -> int:
        """Rebuild state from snapshot + journal. Returns records replayed."""
        n = 0
        snap_gen = 0
        if os.path.exists(self.snap_path):
            for rec in _read_records(self.snap_path):
                snap_gen = rec.get("gen", 0)
                self.epoch = rec.get("epoch", 0)
                for key, value in rec.get("kv", []):
                    kv._data_restore(key, value)
                for queue, items in rec.get("queues", []):
                    for item in items:
                        mq._queues[queue].put_nowait(item)
        self._gen = snap_gen
        if os.path.exists(self.journal_path):
            records = _read_records(self.journal_path)
            for rec in records:
                if rec["op"] == "jhead":
                    if rec["gen"] != snap_gen:
                        # journal predates the snapshot: compaction crashed
                        # after the snapshot rename but before truncation —
                        # everything here is already in the snapshot
                        log.warning("discarding stale journal (gen %s, "
                                    "snapshot gen %s)", rec["gen"], snap_gen)
                        open(self.journal_path, "wb").close()
                        break
                    continue
                n += 1
                op = rec["op"]
                if op == "put":
                    kv._data_restore(rec["key"], rec["value"])
                elif op == "del":
                    kv._data_drop(rec["key"])
                elif op == "qpush":
                    mq._queues[rec["queue"]].put_nowait(rec["payload"])
                elif op == "qpop":
                    q = mq._queues[rec["queue"]]
                    if not q.empty():
                        q.get_nowait()
                elif op == "epoch":
                    self.epoch = max(self.epoch, rec["epoch"])
        # seed the compaction counter so repeated crash/restart cycles can't
        # grow the journal past compact_every forever
        self._since_compact = n
        return n

    def compact(self) -> None:
        """Snapshot current persistent state, truncate the journal.

        The state capture (pure in-memory walk + packb) happens here, on
        the caller's thread, so it is consistent with the mutation order;
        the file rewrite happens on the writer thread behind any records
        already enqueued."""
        if self._plane is None:
            return
        self._gen += 1
        # one persistent-state function (snapshot_state) serves both the
        # compaction snapshot and the replication bootstrap — a field
        # added to one cannot silently miss the other
        snap = {"gen": self._gen, **self._plane.snapshot_state()}
        self._q.put(("snap", (self._gen, packb(snap))))
        self._since_compact = 0

    def record_epoch(self, epoch: int) -> None:
        """Persist a fencing-epoch change (standby promotion). The record
        rides the normal append path, so it is replicated to any standbys
        and survives restarts; compaction folds it into the snapshot."""
        self.epoch = epoch
        self.append({"op": "epoch", "epoch": epoch})

    def close(self) -> None:
        """Drain all pending writes and stop the writer thread."""
        with self._close_lock:
            self._closed = True
            self._q.put(None)
        self._writer.join(timeout=30)


async def apply_replicated(plane: "DurablePlane", rec: dict) -> None:
    """Apply one replicated journal record through the plane's DURABLE
    write paths, so a standby journals (and fsyncs) everything it applies
    and can itself be restarted or promoted with no loss (transports/server.py).
    """
    op = rec["op"]
    if op == "put":
        await plane.kv.put(rec["key"], rec["value"])
    elif op == "del":
        await plane.kv.delete(rec["key"])
    elif op == "qpush":
        await plane.messaging.queue_push(rec["queue"], rec["payload"])
    elif op == "qpop":
        q = plane.messaging._queues[rec["queue"]]
        if not q.empty():
            q.get_nowait()
            plane.journal.append({"op": "qpop", "queue": rec["queue"]})
    elif op == "epoch":
        # the primary's fencing epoch advanced (it was itself promoted at
        # some point): persist it so this standby rejoins at >= that epoch
        plane.journal.record_epoch(max(plane.journal.epoch, rec["epoch"]))
    # jhead/unknown ops: compaction artifacts of the PRIMARY's journal —
    # meaningless on the standby's own journal, skipped


class DurablePlane(MemoryPlane):
    """MemoryPlane + write-ahead journal; state survives server restarts."""

    def __init__(self, data_dir: str, latency: Optional[LatencyModel] = None,
                 compact_every: int = 10_000, fsync: bool = True):
        self.journal = Journal(data_dir, compact_every, fsync=fsync)
        self.kv = DurableKVStore(self.journal, latency)
        self.messaging = DurableMessaging(self.journal, latency)
        self.journal.attach(self)
        n = self.journal.recover_into(self.kv, self.messaging)
        if n or os.path.exists(self.journal.snap_path):
            log.info("control-plane state recovered (%d journal records)", n)

    def snapshot_state(self) -> dict:
        """Persistent state as one transferable dict (replication bootstrap:
        what a freshly-subscribed standby loads before streaming records).
        Same content as the compaction snapshot: unleased KV + queues."""
        return {
            "epoch": self.journal.epoch,
            "kv": [[k, e.value] for k, e in sorted(self.kv._data.items())
                   if not e.lease_id],
            "queues": [[name, list(q._queue)]
                       for name, q in self.messaging._queues.items()
                       if q.qsize()],
        }

    async def load_snapshot(self, snap: dict) -> None:
        """Replace persistent state with a primary's snapshot (standby
        bootstrap), writing it through the durable paths so the standby's
        own journal captures it."""
        for key in [k for k, e in self.kv._data.items() if not e.lease_id]:
            await self.kv.delete(key)
        for name in list(self.messaging._queues):
            q = self.messaging._queues[name]
            while not q.empty():
                q.get_nowait()
                self.journal.append({"op": "qpop", "queue": name})
        for key, value in snap.get("kv", []):
            await self.kv.put(key, value)
        for name, items in snap.get("queues", []):
            for item in items:
                await self.messaging.queue_push(name, item)

    def close(self) -> None:
        self.journal.close()
