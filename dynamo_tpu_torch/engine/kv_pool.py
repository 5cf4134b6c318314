"""The shared KV pool: content-addressed page reuse across engines.

Copied from dynamo_tpu/engine/kv_pool.py:67-470. The host and disk tiers
(engine/offload.py) belong to one engine, so a prefix prefilled on engine A
is recomputed on engine B. This module adds the namespace above them:

- `SharedKvPool`: sealed full KV pages keyed by the chained page hash
  (engine/kv_cache.page_hash, the key of the allocator's reuse map and the
  router's index). Two engines publishing the same page (same token chain,
  same kv_quant mode) keep ONE copy with both as sources. The capture-time
  checksum travels with the entry and is verified again at every fetch: a
  rotten entry is quarantined (removed, never served) and the page is
  recomputed. An entry carries its kv_quant mode; a fetch from an engine of
  another mode is rejected by name (`PoolQuantMismatch`), never cast.
- `PoolPublishStream`: the publish path, a drain thread (the CopyStream
  shape) that takes freshly sealed pages off the device, checksums them and
  publishes them, off the step loop.
- `AdmissionPrefetcher`: while a request waits for admission, its matched
  pool pages are warmed into the target engine's HBM
  (`NativeEngine.prefetch_pool_pages`), as evictable reusable pages.

What differs from the JAX module: pages are torch CPU tensors (the engine's
stored representation, int8 values + f32 scales on an int8 cache) and
checksums are `runtime/integrity.tensor_checksum`; the publish copies run
on a stream of their own after the extraction's "ready" event, holding the
engine's `capture_lock` for every CUDA call, and a failed publish is
logged and counted (`PoolPublishStream.failed`). The fault-injection
failpoint at the fetch (JAX :331-332) waits for the port's
`runtime/faults.py`; the cross-host pool service (engine/pool_service.py)
and the router's pool sources wait for later slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import torch

from dynamo_tpu_torch.engine.offload import LEAVES
from dynamo_tpu_torch.runtime.integrity import (
    STATS as INTEGRITY, tensor_checksum,
)

log = logging.getLogger("dynamo_tpu_torch.kv_pool")


class PoolQuantMismatch(RuntimeError):
    """A fetch asked for a page under another kv_quant mode than the one it
    was published with: rejected by name, never cast."""

    def __init__(self, seq_hash: int, stored_mode: str, asked_mode: str):
        super().__init__(
            f"shared-pool page {seq_hash:x} was published under kv_quant="
            f"{stored_mode or 'off'!r} but the fetching engine runs "
            f"kv_quant={asked_mode or 'off'!r}; cross-mode fetches are "
            "rejected, never cast")
        self.stored_mode = stored_mode
        self.asked_mode = asked_mode


class KvPoolStats:
    """Process-local shared-pool counters (/metrics: llm_kv_pool_*), folded
    into gauges at render time by frontend/service.py."""

    FIELDS = (
        "entries",          # pages currently resident in the pool
        "bytes",            # bytes those entries occupy (values + scales)
        "publishes",        # new entries published (first copy of a hash)
        "dedup_hits",       # publishes dedup'd against an existing entry
        "dedup_ratio",      # dedup_hits / (publishes + dedup_hits)
        "fetch_hits",       # verified pages served to a prefix walk
        "fetch_misses",     # walk-time fetches that found no entry
        "prefetch_pages",   # pages warmed into HBM by admission prefetch
        "prefetch_hits",    # prefetch ops that warmed pages inside the window
        "prefetch_late",    # prefetch ops that finished after admission
        "quarantined",      # entries dropped on checksum mismatch (rot)
        "quant_rejected",   # cross-kv_quant-mode publishes/fetches refused
        "evicted",          # entries dropped by capacity LRU
        "source_evictions", # dead-source purges (single-source entries dropped)
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        out = {name: getattr(self, name) for name in self.FIELDS}
        attempts = self.publishes + self.dedup_hits
        out["dedup_ratio"] = round(self.dedup_hits / attempts, 4) \
            if attempts else 0.0
        return out


POOL_STATS = KvPoolStats()


def matched_pool_pages(pool, tokens, page_size: int) -> int:
    """Leading full pages of `tokens` resident in `pool` (hash chaining
    only: no bytes move and nothing is verified; the fetch verifies)."""
    from dynamo_tpu_torch.engine.kv_cache import page_hash
    parent, n = 0, 0
    for i in range(len(tokens) // page_size):
        parent = page_hash(parent, tokens[i * page_size:(i + 1) * page_size])
        if parent not in pool:
            break
        n += 1
    return n


@dataclasses.dataclass
class PoolEntry:
    seq_hash: int
    parent: int          # chained hash of the preceding page (0 = root)
    tokens_hash: int     # content-only hash (router radix-tree edge key)
    mode: str            # kv_quant mode the bytes are stored in ("" = off)
    arrays: Tuple[torch.Tensor, ...]   # (k, v) or (k, v, k_scale, v_scale)
    sum_: int            # capture-time checksum (travels with the entry)
    nbytes: int
    sources: Set[str] = dataclasses.field(default_factory=set)


class SharedKvPool:
    """Content-addressed KV page store shared by the engines of a process.

    Thread-safe: publishes arrive from every engine's PoolPublishStream
    while engine threads fetch in their prefix walks. Capacity is bounded in
    pages with LRU eviction; evictions and source purges queue per-source
    removed events (`drain_events`)."""

    def __init__(self, capacity_pages: int = 4096, name: str = "kv-pool"):
        self.capacity_pages = max(1, capacity_pages)
        self.name = name
        self._entries: "OrderedDict[int, PoolEntry]" = OrderedDict()
        # per-source pending router events, in the allocator's tuple shape:
        # (kind, page_id(=0), seq_hash, parent_hash, tokens_hash)
        self._events: Dict[str, List[Tuple[str, int, int, int, int]]] = {}
        self._mu = threading.RLock()

    def __contains__(self, seq_hash: int) -> bool:
        with self._mu:
            return seq_hash in self._entries

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    # -- events ---------------------------------------------------------------

    def _emit(self, source: str, kind: str, e: PoolEntry) -> None:
        """Lock held: queue one router event for `source`."""
        self._events.setdefault(source, []).append(
            (kind, 0, e.seq_hash, e.parent, e.tokens_hash))

    def drain_events(self, source: str) -> List[Tuple[str, int, int, int, int]]:
        """Pending stored / removed events for one source."""
        with self._mu:
            return self._events.pop(source, [])

    # -- publish --------------------------------------------------------------

    def note_source(self, source: str, seq_hash: int, parent: int,
                    tokens_hash: int) -> bool:
        """Record `source` as a holder of an already-resident page (the
        dedup fast path: no bytes move). False when the entry was evicted
        since the caller's containment check."""
        with self._mu:
            e = self._entries.get(seq_hash)
            if e is None:
                return False
            self._entries.move_to_end(seq_hash)
            if source not in e.sources:
                e.sources.add(source)
                self._emit(source, "stored", e)
            POOL_STATS.dedup_hits += 1
            return True

    def publish(self, source: str, seq_hash: int, parent: int,
                tokens_hash: int, arrays, mode: str = "",
                sum_: Optional[int] = None) -> str:
        """Publish one sealed full page: `arrays` (k, v) or (k, v, k_scale,
        v_scale) host tensors or arrays in the engine's stored
        representation, `sum_` its capture-time checksum (computed here when
        the caller has none). Returns "new", "dup" (the existing copy kept)
        or "quant-mismatch" (an entry of this hash under another kv_quant
        mode; the first representation wins)."""
        arrays = tuple(torch.as_tensor(a) for a in arrays)
        if sum_ is None:
            sum_ = tensor_checksum(*arrays)
            INTEGRITY.pages_hashed += 1
        with self._mu:
            e = self._entries.get(seq_hash)
            if e is not None:
                if e.mode != mode:
                    POOL_STATS.quant_rejected += 1
                    return "quant-mismatch"
                self._entries.move_to_end(seq_hash)
                if source not in e.sources:
                    e.sources.add(source)
                    self._emit(source, "stored", e)
                POOL_STATS.dedup_hits += 1
                return "dup"
            e = PoolEntry(seq_hash=seq_hash, parent=parent,
                          tokens_hash=tokens_hash, mode=mode,
                          arrays=arrays, sum_=sum_,
                          nbytes=sum(a.numel() * a.element_size()
                                     for a in arrays),
                          sources={source})
            self._entries[seq_hash] = e
            POOL_STATS.publishes += 1
            POOL_STATS.bytes += e.nbytes
            self._emit(source, "stored", e)
            while len(self._entries) > self.capacity_pages:
                _, old = self._entries.popitem(last=False)
                POOL_STATS.evicted += 1
                POOL_STATS.bytes -= old.nbytes
                for src in old.sources:
                    self._emit(src, "removed", old)
            POOL_STATS.entries = len(self._entries)
            return "new"

    # -- fetch ----------------------------------------------------------------

    def fetch(self, seq_hash: int, mode: str = "") -> Optional[Tuple]:
        """Verified host copies of one page, (k, v) or (k, v, ks, vs), or
        None on a miss or an integrity mismatch (the rotten entry is
        quarantined and the page recomputed). Raises PoolQuantMismatch for
        an entry of another kv_quant mode."""
        with self._mu:
            e = self._entries.get(seq_hash)
            if e is None:
                POOL_STATS.fetch_misses += 1
                return None
            if e.mode != mode:
                POOL_STATS.quant_rejected += 1
                raise PoolQuantMismatch(seq_hash, e.mode, mode)
            self._entries.move_to_end(seq_hash)
            # copies: the caller's verify and inject must not race an LRU
            # eviction of the entry
            arrays = tuple(a.clone() for a in e.arrays)
            sum_ = e.sum_
        if tensor_checksum(*arrays) != sum_:
            INTEGRITY.mismatches += 1
            INTEGRITY.quarantined += 1
            POOL_STATS.quarantined += 1
            with self._mu:
                old = self._entries.pop(seq_hash, None)
                if old is not None:
                    POOL_STATS.entries = len(self._entries)
                    POOL_STATS.bytes -= old.nbytes
                    for src in old.sources:
                        self._emit(src, "removed", old)
            log.warning("shared-pool kv page %x failed integrity check; "
                        "quarantined (will recompute)", seq_hash)
            return None
        INTEGRITY.pages_verified += 1
        POOL_STATS.fetch_hits += 1
        return arrays

    # -- source lifecycle -----------------------------------------------------

    def evict_source(self, source: str) -> int:
        """A source died: forget it everywhere. Entries it alone published
        are dropped; entries with other sources survive. Returns the number
        of entries dropped."""
        dropped = 0
        with self._mu:
            self._events.pop(source, None)
            for h in [h for h, e in self._entries.items()
                      if source in e.sources]:
                e = self._entries[h]
                e.sources.discard(source)
                if not e.sources:
                    del self._entries[h]
                    POOL_STATS.bytes -= e.nbytes
                    dropped += 1
            POOL_STATS.entries = len(self._entries)
        if dropped:
            POOL_STATS.source_evictions += 1
            log.info("shared pool evicted %d page(s) solely sourced from "
                     "dead worker %s", dropped, source)
        return dropped

    def snapshot(self) -> dict:
        with self._mu:
            return {"entries": len(self._entries),
                    "bytes": sum(e.nbytes for e in self._entries.values()),
                    "sources": sorted({s for e in self._entries.values()
                                       for s in e.sources})}


class PoolPublishStream:
    """Background publisher: publish copies overlap decode.

    The engine enqueues the extraction of freshly sealed pages on its
    stream (values captured before any overwrite) and hands the page-major
    block here with its "ready" event; this thread copies it to the host,
    and `publish` checksums and stores each page, off the step loop. A
    failed publish costs only a recompute elsewhere; it is logged and
    counted in `failed`."""

    def __init__(self, pool: SharedKvPool, source: str, mode: str = "",
                 device=None, lock=None):
        self._pool = pool
        self._source = source
        self._mode = mode
        dev = torch.device(device) if device is not None else None
        self._stream = (torch.cuda.Stream(dev)
                        if dev is not None and dev.type == "cuda" else None)
        self._lock = lock if lock is not None else contextlib.nullcontext()
        self.failed = 0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="kv-pool-publish", daemon=True)
        self._thread.start()

    def submit(self, device_pages: dict, metas) -> None:
        """device_pages: {"k", "v"[, "k_scale", "v_scale"], "ready"}, the
        page-major block; metas: (seq_hash, parent_hash, tokens_hash) of
        each page."""
        self._q.put((device_pages, list(metas)))

    def drain(self) -> None:
        """Block until every submitted publish has landed (a barrier)."""
        self._q.join()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=30)

    def _host(self, pages: dict) -> list:
        """The block's leaves on the host (a copy; waits for it)."""
        leaves = [pages[k] for k in LEAVES if k in pages]
        if self._stream is None:
            return [t.clone() for t in leaves]
        with self._lock, torch.cuda.stream(self._stream):
            ready = pages.get("ready")
            if ready is not None:
                self._stream.wait_event(ready)
            host = [t.to("cpu", non_blocking=True) for t in leaves]
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return host

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            pages, metas = item
            try:
                host = self._host(pages)
                for i, (sh, parent, th) in enumerate(metas):
                    # publish() takes the capture checksum over the bytes
                    # just pulled off the device; every fetch verifies it
                    self._pool.publish(self._source, sh, parent, th,
                                       tuple(leaf[i] for leaf in host),
                                       mode=self._mode)
            except Exception:  # noqa: BLE001 — a failed publish only costs
                # a future recompute; never kill the drain, never hide it
                self.failed += len(metas)
                log.exception("kv pool publish of %d page(s) failed",
                              len(metas))
            finally:
                with self._lock:
                    pages = item = None   # the device block, freed here
                self._q.task_done()


class AdmissionPrefetcher:
    """Prefetch into the admission window: while a request waits for
    admission, warm its matched pool pages into the target engine's HBM so
    that the later prefix walk hits device memory. Best-effort and free of
    side effects: fetches are verified at the claim, warmed pages are
    evictable reusable pages, and a cancel racing the prefetch leaks
    nothing.

    `tokens_fn(request)` maps the frontend request to prompt token ids (None
    = not prefetchable); `target_fn(tokens)` picks the worker the request is
    expected to reach and returns a handle with `submit(fn)`
    (NativeEngineWorker)."""

    def __init__(self, pool: SharedKvPool, tokens_fn, target_fn,
                 page_size: int):
        self.pool = pool
        self.tokens_fn = tokens_fn
        self.target_fn = target_fn
        self.page_size = page_size

    def matched_pages(self, tokens) -> int:
        return matched_pool_pages(self.pool, tokens, self.page_size)

    async def prefetch(self, request, admitted=None) -> int:
        """Warm the request's matched pool pages into the target worker's
        HBM; returns the pages warmed (0 on any failure). When `admitted`
        (an asyncio.Event set once admission completes) is already set when
        the warm finishes, the window was too short: counted as
        `prefetch_late` (the pages still help the next arrival)."""
        try:
            tokens = self.tokens_fn(request)
            if not tokens or self.matched_pages(tokens) == 0:
                return 0
            worker = self.target_fn(tokens)
            if worker is None:
                return 0
            warmed = await worker.submit(
                lambda eng: eng.prefetch_pool_pages(tokens))
        except Exception:  # noqa: BLE001 — prefetch never fails a request
            log.debug("admission prefetch failed", exc_info=True)
            return 0
        if warmed:
            if admitted is not None and admitted.is_set():
                POOL_STATS.prefetch_late += 1
            else:
                POOL_STATS.prefetch_hits += 1
        return warmed
