"""Cross-process KV transfer: the chunk-committed transfer plane.

Copied from dynamo_tpu/disagg/remote_transfer.py:98-547 and :639-1278.

- Decode side: `KvTransferServer`, a TCP listener per decode worker beside
  the request plane. Pages arrive in bounded chunks; each chunk's pages are
  verified against the checksums the sender computed at capture, copied to
  the card on a copy stream, and injected into the decode engine's cache
  through `worker.submit` (the engine stream waits on the copy's event),
  then acked. A `TransferSession` per (request_id, alloc_epoch) keeps the
  committed frontier (leading pages verified, injected and acked): chunks
  below it ack as duplicates without touching the cache, a chunk that
  starts past it (one behind a refused chunk in the same window) is refused
  too, so the committed region stays a prefix, and a chunk whose epoch is
  not the pending allocation's is fenced out.
- Prefill side: `RemoteTransferBackend` resolves engine_id -> {host, port}
  from the discovery store (`kv_transfer/{engine_id}`, written under the
  decode worker's lease), keeps one pooled connection per decode engine,
  and streams MessagePack frames of raw page bytes with up to
  `window_chunks` chunks in flight. Each stream opens with a resume
  handshake that returns the committed frontier, so a sender recovering
  from a cut link, or a replacement sender running a re-leased queue item,
  resumes after the last acked chunk. Every socket operation is bounded
  (`io_timeout_s`, and `budget_s` from the request deadline), and a send
  failure drops both the pooled connection and the cached endpoint, so a
  decode worker restarting on a new port is resolved again.

Staging: the sender's chunks leave the card on a copy stream that waits
on the extraction's event, into pinned host buffers, padded to a power of
two pages with zeros (the JAX `_stage_chunk` layout); nothing waits for the
whole device. Frames keep the JAX keys and layout (values [L, Hkv, n, ps,
hd], scales [L, Hkv, n, ps]); bfloat16 pages travel as their raw bytes
under the dtype name "bfloat16", read back with `torch.frombuffer(...)
.view(torch.bfloat16)` (numpy has no bfloat16). The checksums are
BLAKE2b-64 under their own key (runtime/integrity.SUMS_KEY): a chunk that
carries only the JAX key `sums` (xxh3-64) is refused with IntegrityRejected
and never injected unverified.

Left out: the sharded parallel streams (`ShardedKvTransferGroup`, tp and
multi-host), the transfer-cost model's bandwidth feed (router work),
tracing spans and the fault-injection failpoints; `_chunk_gate` stays as
the per-chunk seam that tests override.
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
import warnings
from collections import OrderedDict
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.disagg.transfer import (
    TransferBackend, _page_sums, check_pending, hash_pool,
)
from dynamo_tpu_torch.observability.fleet import TRANSFER_MODEL
from dynamo_tpu_torch.observability.serving import SERVING
from dynamo_tpu_torch.runtime.integrity import (
    CHECKSUM_ALGORITHM, STATS as INTEGRITY, SUMS_KEY, XFER_STATS,
    IntegrityError,
)
from dynamo_tpu_torch.runtime.transports.base import KVStore
from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb
from dynamo_tpu_torch.runtime.transports.wire import read_frame, write_frame

log = logging.getLogger("dynamo_tpu_torch.disagg.transfer")

KV_TRANSFER_PREFIX = "kv_transfer/"

# wire dtype name -> (torch dtype, the numpy dtype of its bytes)
_WIRE = {"float32": (torch.float32, np.float32),
         "float16": (torch.float16, np.float16),
         "bfloat16": (torch.bfloat16, np.int16),
         "int8": (torch.int8, np.int8)}
_NAMES = {t: name for name, (t, _) in _WIRE.items()}


class IntegrityRejected(RuntimeError):
    """The decode side refused a chunk's checksums: a mismatch (retryable:
    the sender still holds the authoritative pages and stages the
    uncommitted tail again) or checksums it cannot verify (final)."""


class StaleEpochError(RuntimeError):
    """A chunk's alloc_epoch is not the pending allocation's: the sender is
    stale. Final: the bytes must never land."""


class TransferBudgetExceeded(RuntimeError):
    """The transfer's wall-clock budget (from the request deadline) is
    spent. Final: the decode side falls back, keeping what committed."""


def transfer_key(engine_id: str) -> str:
    return f"{KV_TRANSFER_PREFIX}{engine_id}"


def _pow2_pad(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def host_view(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a numpy array of the same shape (bfloat16 as
    int16), sharing its memory."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class _Staging:
    """What a side of the transfer stages chunks with: the checksum thread
    pool and one copy stream per device, made at first use and released by
    `close`."""

    def __init__(self):
        self.pool = hash_pool()
        self._streams: Dict[int, "torch.cuda.Stream"] = {}

    def stream(self, device: torch.device) -> "torch.cuda.Stream":
        s = self._streams.get(device.index)
        if s is None:
            s = self._streams[device.index] = torch.cuda.Stream(device)
        return s

    def close(self) -> None:
        self.pool.shutdown(wait=False)


@dataclasses.dataclass
class TransferSession:
    """Decode-side commit state of one transfer, keyed by (request_id,
    alloc_epoch). `committed_pages` is the frontier: the leading pages of
    the transfer list verified, injected and acked. Chunks commit in frame
    order on one connection, so the committed region is a prefix, and a
    resuming sender skips by page count alone."""

    request_id: str
    alloc_epoch: int
    committed_pages: int = 0


class KvTransferServer:
    """Decode-side page-injection listener for one engine worker."""

    MAX_SESSIONS = 1024  # LRU backstop; sessions are also dropped explicitly

    ACK_TIMEOUT_S = 30.0   # a peer that stops reading acks is dropped

    def __init__(self, worker, engine_id: str, host: str = "127.0.0.1",
                 port: int = 0, advertise_host: Optional[str] = None):
        self.worker = worker
        self.engine_id = engine_id
        self.host, self.port = host, port
        self.advertise_host = advertise_host or host
        self._staging = _Staging()
        self._server: Optional[asyncio.AbstractServer] = None
        self._client_writers: Set[asyncio.StreamWriter] = set()
        self._tasks: Set[asyncio.Task] = set()
        self.received_pages = 0
        self._sessions: "OrderedDict[Tuple[str, int], TransferSession]" = \
            OrderedDict()
        # the decode worker reads the committed frontier through this
        # handle (early-decode gate, salvage)
        worker.kv_transfer_server = self

    async def start(self) -> "KvTransferServer":
        if self._server is None:
            # a 16 MiB read buffer: a 128 MiB frame arrives in a few dozen
            # reads instead of pausing the transport every 128 KiB
            self._server = await asyncio.start_server(
                self._on_connect, self.host, self.port, limit=2 ** 24)
            self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # cut established connections too: senders see the reset and
            # resolve again (and wait_closed waits for every handler)
            for w in list(self._client_writers):
                w.close()
            await self._server.wait_closed()
            self._server = None
        self._staging.close()

    @property
    def connection_info(self) -> Dict[str, object]:
        return {"host": self.advertise_host, "port": self.port}

    async def register(self, kv: KVStore, lease_id: int = 0) -> None:
        """Publish engine_id -> connection info in the discovery store,
        under the worker's lease so the key goes with the worker."""
        await kv.put(transfer_key(self.engine_id),
                     packb(self.connection_info), lease_id=lease_id)

    # -- commit/session bookkeeping -------------------------------------------

    def _session(self, request_id: str, alloc_epoch: int) -> TransferSession:
        key = (request_id, alloc_epoch)
        sess = self._sessions.get(key)
        if sess is None:
            # a new epoch supersedes an older session of the same id: its
            # frontier described pages that no longer belong to it
            for old in [k for k in self._sessions if k[0] == request_id]:
                del self._sessions[old]
            sess = TransferSession(request_id, alloc_epoch)
            self._sessions[key] = sess
            while len(self._sessions) > self.MAX_SESSIONS:
                self._sessions.popitem(last=False)
        else:
            self._sessions.move_to_end(key)
        return sess

    def committed_frontier(self, request_id: str, alloc_epoch: int) -> int:
        """Pages of the transfer list committed (verified + injected +
        acked) for this exact allocation; 0 when unknown."""
        sess = self._sessions.get((request_id, alloc_epoch))
        return sess.committed_pages if sess is not None else 0

    def forget(self, request_id: str) -> None:
        """Drop a request's commit state once its fate is settled
        (activated, salvaged or released)."""
        for key in [k for k in self._sessions if k[0] == request_id]:
            del self._sessions[key]

    # -- wire -----------------------------------------------------------------

    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        # the wire receive of chunk i+1 overlaps the inject of chunk i; one
        # consumer keeps the acks in frame order (the sender's window
        # relies on it)
        frames: asyncio.Queue = asyncio.Queue(maxsize=8)

        async def inject_loop():
            # drains until the None sentinel even after the peer is gone,
            # so the producer's bounded put never blocks on a dead consumer
            peer_alive = True
            while True:
                frame = await frames.get()
                if frame is None:
                    return
                if not peer_alive:
                    continue
                if frame.get("op") == "resume":
                    # the committed-frontier handshake of a (re)connecting
                    # or replacement sender
                    write_frame(writer, {
                        "ok": True,
                        "committed": self.committed_frontier(
                            str(frame.get("request_id", "")),
                            int(frame.get("alloc_epoch", 0)))})
                else:
                    try:
                        ack = await self._inject_frame(frame)
                        write_frame(writer, ack)
                    except Exception as e:  # noqa: BLE001 (sent to the peer)
                        log.warning("kv inject rejected: %s", e)
                        write_frame(writer, {
                            "ok": False,
                            "error": f"{type(e).__name__}: {e}",
                            # a checksum mismatch is retryable sender-side;
                            # every other rejection is final
                            "integrity": isinstance(e, IntegrityError),
                            "stale": isinstance(e, StaleEpochError)})
                try:
                    await asyncio.wait_for(writer.drain(),
                                           self.ACK_TIMEOUT_S)
                except (ConnectionError, OSError, RuntimeError,
                        asyncio.TimeoutError):
                    peer_alive = False

        consumer = asyncio.create_task(inject_loop())
        self._tasks.add(consumer)
        consumer.add_done_callback(self._tasks.discard)
        self._client_writers.add(writer)
        try:
            while True:
                # dynalint: unbounded-io-ok=idle-pooled-sender-connections-
                # are-legal; the SENDER bounds its own IO, death is EOF
                frame = await read_frame(reader, zero_copy=True)
                await frames.put(frame)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            while not consumer.done():
                try:
                    frames.put_nowait(None)
                    break
                except asyncio.QueueFull:
                    await asyncio.sleep(0.01)
            await consumer
            self._client_writers.discard(writer)
            writer.close()

    async def _inject_frame(self, frame: Dict) -> Dict:
        rid = frame["request_id"]
        page_ids = list(frame["page_ids"])
        epoch = int(frame.get("alloc_epoch", 0))
        chunk_idx = int(frame.get("chunk_idx", 0))
        base = int(frame.get("base", 0))
        sess = self._session(rid, epoch)
        if base + len(page_ids) <= sess.committed_pages:
            # a re-delivery below the frontier (a lost ack, or a
            # replacement sender's older view): ack, touch nothing
            return {"ok": True, "chunk_idx": chunk_idx, "dup": True,
                    "committed": sess.committed_pages}
        if base > sess.committed_pages:
            # a gap: an earlier chunk of this window was refused (its
            # sender re-stages from the frontier on a new connection), so
            # this one must not commit past it
            raise RuntimeError(
                f"chunk {chunk_idx} of {rid!r} starts at page {base}, past "
                f"the committed frontier {sess.committed_pages}")
        await self._inject_frame_inner(frame, rid, page_ids, epoch)
        # committed only now: verified, on the card, past the guards
        sess.committed_pages = base + len(page_ids)
        # early decode: the step loop's gate polls the frontier; wake it
        # so the advance is seen now, not at its idle timeout
        wake = getattr(self.worker, "_wake", None)
        if wake is not None:
            wake.set()
        return {"ok": True, "chunk_idx": chunk_idx, "dup": False,
                "committed": sess.committed_pages}

    async def _inject_frame_inner(self, frame: Dict, rid: str,
                                  page_ids: list, epoch: int) -> None:
        shape = tuple(int(x) for x in frame["shape"])
        name = frame["dtype"]
        if name not in _WIRE:
            raise ValueError(f"unsupported page dtype {name!r}")
        tdt, ndt = _WIRE[name]
        arrays = {"k": np.frombuffer(frame["k"], ndt).reshape(shape),
                  "v": np.frombuffer(frame["v"], ndt).reshape(shape)}
        if "k_scale" in frame:
            # int8 frames: f32 scale rows beside the values, [L, Hkv, Nb,
            # ps] (the value shape without head_dim)
            for key in ("k_scale", "v_scale"):
                arrays[key] = np.frombuffer(
                    frame[key], np.float32).reshape(shape[:-1])
        payload = sum(a.nbytes for a in arrays.values())
        # verify on fetch, over the representation as shipped: a mismatch
        # never reaches the cache, the sender stages the chunk again
        sums = frame.get(SUMS_KEY)
        if sums is None:
            raise IntegrityRejected(
                f"chunk for {rid!r} carries no {CHECKSUM_ALGORITHM} "
                f"checksums (key {SUMS_KEY!r})"
                + ("; its xxh3-64 sums (key 'sums') cannot be verified "
                   "here" if "sums" in frame else "")
                + ": refused unverified")
        got = await asyncio.to_thread(
            _page_sums, arrays["k"], arrays["v"], arrays.get("k_scale"),
            arrays.get("v_scale"), len(sums), self._staging.pool)
        bad = [page_ids[i] for i, s in enumerate(sums) if got[i] != s]
        if bad:
            INTEGRITY.mismatches += len(bad)
            raise IntegrityError(f"transfer into {self.engine_id!r}", bad)
        INTEGRITY.pages_verified += len(sums)
        eng = self.worker.engine
        tensors, ready = await asyncio.to_thread(
            self._to_device, arrays, tdt, eng)

        def inject(eng):
            check_pending(eng, self.engine_id, rid, epoch, StaleEpochError)
            eng.inject_pages(page_ids, tensors["k"], tensors["v"],
                             tensors.get("k_scale"), tensors.get("v_scale"),
                             ready=ready)

        await self.worker.submit(inject)
        self.received_pages += len(page_ids)
        XFER_STATS.fetches += 1
        XFER_STATS.bytes_fetched += payload

    def _to_device(self, arrays: Dict[str, np.ndarray], value_dtype, eng):
        """Frame arrays -> tensors on the engine's device: on the card
        through pinned memory on the copy stream, with an event the engine's
        stream waits on before it reads them, never during one of the
        engine's graph captures (this runs off the engine thread); on the
        CPU, tensors over the frame's bytes."""
        out = {}
        with warnings.catch_warnings():
            # the frame body is read-only; the tensors are only read
            warnings.simplefilter("ignore", UserWarning)
            for key, a in arrays.items():
                out[key] = torch.frombuffer(
                    a, dtype=torch.float32 if "scale" in key
                    else value_dtype).reshape(a.shape)
        device = eng.device
        if device.type != "cuda":
            return out, None
        stream = self._staging.stream(device)
        with eng.graphs.capture_lock, torch.cuda.stream(stream):
            out = {key: t.pin_memory().to(device, non_blocking=True)
                   for key, t in out.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready


class RemoteTransferBackend(TransferBackend):
    """Prefill-side client shipping pages to remote decode engines."""

    def __init__(self, kv: KVStore, chunk_pages: int = 16,
                 connect_timeout_s: float = 10.0, window_chunks: int = 4,
                 integrity_retries: int = 2, io_timeout_s: float = 30.0,
                 link_retries: int = 3):
        self._kv = kv
        self.chunk_pages = chunk_pages
        # chunks in flight before the oldest ack is awaited: staging, the
        # wire and the inject overlap, and the sender stalls (never
        # buffers) past it
        self.window_chunks = max(1, window_chunks)
        self.connect_timeout_s = connect_timeout_s
        # per read/write deadline: a stalled socket surfaces as a timeout
        # and takes the link-failure resume path
        self.io_timeout_s = io_timeout_s
        # link failures absorbed by reconnecting and resuming from the
        # committed frontier; past them the decode side salvages
        self.link_retries = max(0, link_retries)
        # re-stagings after a decode-side checksum mismatch; past them the
        # decode side prefills locally (latency, never tokens)
        self.integrity_retries = max(0, integrity_retries)
        self._staging = _Staging()
        self._conns: Dict[str, Tuple[asyncio.StreamReader,
                                     asyncio.StreamWriter]] = {}
        self._locks: Dict[str, asyncio.Lock] = {}
        self._meta: Dict[str, Dict] = {}
        self.sent_pages = 0

    # -- connection management ------------------------------------------------

    async def _resolve(self, engine_id: str) -> Dict:
        meta = self._meta.get(engine_id)
        if meta is None:
            raw = await self._kv.get(transfer_key(engine_id))
            if raw is None:
                raise KeyError(
                    f"no kv-transfer metadata for engine {engine_id!r} "
                    "(decode worker gone?)")
            meta = unpackb(raw)
            self._meta[engine_id] = meta
        return meta

    async def _connect(self, engine_id: str, deadline=None):
        conn = self._conns.get(engine_id)
        if conn is not None and not conn[1].is_closing():
            return conn
        meta = await self._resolve(engine_id)
        timeout = min(self.connect_timeout_s, self._io_timeout(deadline))
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(meta["host"], int(meta["port"])),
            timeout)
        self._conns[engine_id] = (reader, writer)
        return reader, writer

    def _drop(self, engine_id: str) -> None:
        """Invalidate the pooled connection and the cached endpoint: the
        next attempt resolves `kv_transfer/{engine_id}` again (the decode
        worker may have restarted on a new port)."""
        conn = self._conns.pop(engine_id, None)
        if conn is not None:
            conn[1].close()
        self._meta.pop(engine_id, None)

    async def close(self) -> None:
        for engine_id in list(self._conns):
            self._drop(engine_id)
        self._meta.clear()
        self._staging.close()

    # -- bounded IO -----------------------------------------------------------

    def _io_timeout(self, deadline) -> float:
        """io_timeout_s clipped to the budget's remaining time; raises once
        the budget is spent."""
        if deadline is None:
            return self.io_timeout_s
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TransferBudgetExceeded(
                "kv transfer budget exhausted (request deadline)")
        return min(self.io_timeout_s, remaining)

    async def _read(self, reader, deadline):
        return await read_frame(reader, timeout=self._io_timeout(deadline))

    async def _write(self, writer, frame, deadline) -> None:
        write_frame(writer, frame)
        await asyncio.wait_for(writer.drain(), self._io_timeout(deadline))

    # -- transfer -------------------------------------------------------------

    async def send_pages(self, engine_id: str, request_id: str, dst_page_ids,
                         k_pages, v_pages, k_scale=None, v_scale=None,
                         alloc_epoch: int = 0, budget_s=None,
                         ready=None) -> None:
        ids = list(dst_page_ids)
        if not ids:
            return
        t0 = time.monotonic()
        deadline = t0 + budget_s if budget_s is not None else None
        # the transfer cost model's feed (JAX :867-929): the pre-send byte
        # estimate is this link's in-flight backlog while the send runs,
        # and a committed send is one delivered-goodput sample of the link
        # (unique payload bytes: a chunk re-sent after a resume counts once)
        est_bytes = self._payload_bytes(k_pages, v_pages, k_scale, len(ids))
        unique_bytes: Dict[int, int] = {}
        failed = True
        TRANSFER_MODEL.note_inflight(engine_id, est_bytes)
        try:
            await self._send_pages_locked(
                engine_id, request_id, ids, k_pages, v_pages, k_scale,
                v_scale, alloc_epoch, deadline, ready, unique_bytes)
            failed = False
        finally:
            TRANSFER_MODEL.note_done(engine_id, est_bytes)
            dt = time.monotonic() - t0
            SERVING.kv_transfer.observe(value=dt)
            if not failed:
                TRANSFER_MODEL.observe(engine_id, sum(unique_bytes.values()),
                                       dt)

    @staticmethod
    def _payload_bytes(k_pages, v_pages, k_scale, n: int) -> int:
        """Approximate unique payload bytes of shipping `n` pages of this
        stack (k + v + scales), for the in-flight backlog term; the exact
        figure lands per chunk."""
        nb = max(1, k_pages.shape[2])
        per_page = (k_pages.numel() * k_pages.element_size()
                    + v_pages.numel() * v_pages.element_size()) / nb
        if k_scale is not None:
            per_page += 2 * k_scale.numel() * k_scale.element_size() / nb
        return int(per_page * n)

    async def _send_pages_locked(self, engine_id: str, request_id: str,
                                 ids, k_pages, v_pages, k_scale, v_scale,
                                 alloc_epoch, deadline, ready,
                                 unique_bytes=None) -> None:
        lock = self._locks.setdefault(engine_id, asyncio.Lock())
        async with lock:
            refetches = resumes = 0
            while True:
                try:
                    await self._send_chunks(
                        engine_id, request_id, ids, k_pages, v_pages,
                        k_scale, v_scale, alloc_epoch, deadline, ready,
                        unique_bytes)
                    return
                except IntegrityRejected:
                    # the connection may hold unread acks of the window:
                    # drop it. Only a mismatch is retried: the committed
                    # frontier survives, the uncommitted tail is staged
                    # again from the authoritative device pages
                    self._drop(engine_id)
                    if refetches >= self.integrity_retries:
                        INTEGRITY.quarantined += len(ids)
                        INTEGRITY.reprefills += 1
                        log.error("kv transfer of %d page(s) for %s keeps "
                                  "failing integrity after %d re-fetch(es)",
                                  len(ids), request_id, refetches)
                        raise
                    refetches += 1
                    INTEGRITY.refetches += 1
                    log.warning("kv transfer integrity mismatch for %s; "
                                "re-fetch %d/%d", request_id, refetches,
                                self.integrity_retries)
                except TransferBudgetExceeded:
                    self._drop(engine_id)
                    raise
                except (ConnectionError, asyncio.IncompleteReadError,
                        asyncio.TimeoutError, OSError) as e:
                    # link death (cut, reset, stall, decode restart): drop
                    # the connection and endpoint, then resume; the
                    # handshake skips every committed chunk
                    if isinstance(e, (TimeoutError, asyncio.TimeoutError)):
                        XFER_STATS.link_timeouts += 1
                    self._drop(engine_id)
                    if resumes >= self.link_retries:
                        log.error("kv transfer for %s lost its link %d "
                                  "time(s); abandoning the remote path",
                                  request_id, resumes + 1)
                        raise
                    resumes += 1
                    log.warning("kv transfer link failure for %s (%s); "
                                "resume %d/%d", request_id,
                                type(e).__name__, resumes,
                                self.link_retries)
                except RuntimeError:
                    # a final rejection (released, stale epoch, refused
                    # checksums): unread acks may remain, drop the socket
                    self._drop(engine_id)
                    raise

    async def _chunk_gate(self, chunk_idx: int) -> None:
        """Per-chunk seam before each chunk is staged (tests override it to
        cut the link or stall the sender at a chosen chunk)."""

    def _stage_chunk(self, k_pages, v_pages, k_scale, v_scale, start: int,
                     count: int, ready=None):
        """One chunk's pages to the host, padded with zero pages to a power
        of two (the JAX `_stage_chunk` layout), with their checksums over
        the representation as shipped. Blocking: runs in a worker thread.
        On the card the copy runs on the copy stream after `ready` (the
        extraction's event) into pinned buffers, and only that stream is
        waited for."""
        nb = _pow2_pad(count)
        leaves = [t for t in (k_pages, v_pages, k_scale, v_scale)
                  if t is not None]
        if k_pages.device.type == "cuda":
            stream = self._staging.stream(k_pages.device)
            with torch.cuda.stream(stream):
                if ready is not None:
                    stream.wait_event(ready)
                host = []
                for t in leaves:
                    shape = (*t.shape[:2], nb, *t.shape[3:])
                    dev = torch.zeros(shape, dtype=t.dtype, device=t.device)
                    dev[:, :, :count].copy_(t[:, :, start:start + count])
                    h = torch.empty(shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(dev, non_blocking=True)
                    host.append(h)
            stream.synchronize()
        else:
            host = []
            for t in leaves:
                shape = (*t.shape[:2], nb, *t.shape[3:])
                h = torch.zeros(shape, dtype=t.dtype)
                h[:, :, :count] = t[:, :, start:start + count]
                host.append(h)
        arrays = [host_view(h) for h in host]
        k_np, v_np = arrays[0], arrays[1]
        ks_np, vs_np = (arrays[2], arrays[3]) if len(arrays) == 4 \
            else (None, None)
        sums = _page_sums(k_np, v_np, ks_np, vs_np, count,
                          self._staging.pool)
        INTEGRITY.pages_hashed += count
        return k_np, v_np, ks_np, vs_np, sums

    async def _send_chunks(self, engine_id: str, request_id: str, ids,
                           k_pages, v_pages, k_scale=None, v_scale=None,
                           alloc_epoch: int = 0, deadline=None,
                           ready=None, unique_bytes=None) -> int:
        """Windowed chunk-committed streaming: up to window_chunks frames in
        flight before the oldest ack is awaited. Opens with the frontier
        handshake and skips every chunk below the frontier, which is both
        the resume after a link failure and the replacement sender's path.
        Returns the payload bytes sent by this attempt; `unique_bytes`
        (chunk index -> payload) collects each chunk once across
        attempts."""
        reader, writer = await self._connect(engine_id, deadline)
        n = len(ids)
        dtype_name = _NAMES[k_pages.dtype]
        await self._write(writer, {"op": "resume", "request_id": request_id,
                                   "alloc_epoch": alloc_epoch}, deadline)
        reply = await self._read(reader, deadline)
        if not reply.get("ok"):
            raise RuntimeError(
                f"kv transfer handshake rejected by {engine_id!r}: "
                f"{reply.get('error', 'unknown error')}")
        committed = int(reply.get("committed", 0))
        if committed > 0:
            XFER_STATS.resumes += 1
            log.info("kv transfer for %s resumes from page %d/%d",
                     request_id, committed, n)
        total_bytes = 0
        in_flight: list = []  # chunk sizes awaiting ack, oldest first

        async def retire_oldest():
            ack = await self._read(reader, deadline)
            if not ack.get("ok"):
                # a checksum mismatch is retried; every other rejection
                # (released, stale epoch, unverifiable checksums) is final
                err = (f"kv inject rejected by {engine_id!r}: "
                       f"{ack.get('error', 'unknown error')}")
                if ack.get("integrity"):
                    raise IntegrityRejected(err)
                raise RuntimeError(err)
            self.sent_pages += in_flight.pop(0)

        for chunk_idx, start in enumerate(range(0, n, self.chunk_pages)):
            count = min(self.chunk_pages, n - start)
            if start + count <= committed:
                continue  # committed decode-side: skip
            await self._chunk_gate(chunk_idx)
            k_np, v_np, ks_np, vs_np, sums = await asyncio.to_thread(
                self._stage_chunk, k_pages, v_pages, k_scale, v_scale,
                start, count, ready)
            frame = {
                "request_id": request_id,
                "alloc_epoch": alloc_epoch,
                "chunk_idx": chunk_idx,
                "base": start,
                "total": n,
                "page_ids": ids[start:start + count],
                "shape": list(k_np.shape),
                "dtype": dtype_name,
                "k": k_np.data,
                "v": v_np.data,
                SUMS_KEY: sums,
            }
            payload = k_np.nbytes + v_np.nbytes
            if ks_np is not None:
                frame["k_scale"] = ks_np.data
                frame["v_scale"] = vs_np.data
                payload += ks_np.nbytes + vs_np.nbytes
            await self._write(writer, frame, deadline)
            XFER_STATS.bytes_sent += payload
            XFER_STATS.pages_sent += count
            if unique_bytes is not None:
                unique_bytes[chunk_idx] = payload
            total_bytes += payload
            in_flight.append(count)
            if len(in_flight) >= self.window_chunks:
                await retire_oldest()
        while in_flight:
            await retire_oldest()
        return total_bytes
