"""Global KV-cache radix-tree index for KV-aware routing.

Copied from dynamo_tpu/kv_router/indexer.py: a prefix tree whose edges are
content-only page hashes (tokens_hash), each node recording which workers
hold that page. `find_matches` walks a query's page-hash prefix
accumulating per-worker overlap counts (with optional frequency tracking
of recent uses); `apply_event` applies worker Stored / Removed events
through a per-worker `block_hash -> node` map; `remove_worker` purges a
dead or draining worker's pages incrementally, and `revive_worker` accepts
a worker back. The tree is owned by the asyncio loop (single-threaded by
construction); `KvIndexer` is the event-fed wrapper.

`KvIndexer(native="auto")` (:249-266) uses the native C++ tree
(native/kv_indexer.cpp, built with g++ at first use) when frequency
tracking is off and the build succeeds, and the Python tree otherwise;
`native=True` insists on it, False never uses it. `KvIndexer.kind` says
which is in use ("native" or "python"): the router service prints it on its
READY line and answers it on its `state` endpoint, and the frontend's GET
/router/state shows it per model. `KvIndexerSharded` (:327-383) shards
workers across independent indexers by a hash of the worker id and merges
their matches (scores, summed frequencies), evictions and backlogs. The
shard hash is BLAKE2b (8 bytes, key 1337) where JAX takes xxh3-64 at seed
1337, so a worker may land in another shard than in JAX; merged results do
not depend on placement.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheRemoveData, KvCacheStoreData, RouterEvent, compute_page_hashes,
)
from dynamo_tpu_torch.runtime.cpstats import CP_STATS

log = logging.getLogger("dynamo_tpu_torch.indexer")

# incremental-eviction budgets: a dead 100k-node worker must not stall
# find_matches for the whole purge. remove_worker() processes one
# EVICT_CHUNK synchronously (small workers behave exactly as before);
# the rest drains EVICT_AMORTIZE nodes per subsequent apply_event /
# find_matches call, so eviction cost is amortized across the very
# traffic that needs the tree responsive.
EVICT_CHUNK = 512
EVICT_AMORTIZE = 64


@dataclasses.dataclass
class MatchResult:
    """Per-worker count of query prefix pages resident on that worker."""

    scores: Dict[str, int] = dataclasses.field(default_factory=dict)
    # frequency of recent use of the matched prefix (when tracking enabled)
    frequencies: List[int] = dataclasses.field(default_factory=list)


class _Node:
    __slots__ = ("tokens_hash", "parent", "children", "workers", "recent_uses")

    def __init__(self, tokens_hash: int, parent: Optional["_Node"]):
        self.tokens_hash = tokens_hash
        self.parent = parent
        self.children: Dict[int, _Node] = {}
        # worker_id -> block_hash this worker stored the page under
        self.workers: Dict[str, int] = {}
        self.recent_uses: Deque[float] = deque()


class RadixTree:
    def __init__(self, expiration_duration_s: Optional[float] = None):
        self.root = _Node(0, None)
        # worker_id -> {block_hash -> node}
        self.lookup: Dict[str, Dict[int, _Node]] = {}
        self.expiration_s = expiration_duration_s
        self.node_count = 0
        # incremental eviction state: worker -> pending (block_hash, node)
        # pairs still holding that worker's entries. While a worker is
        # here, find_matches filters it from scores — the tree answers as
        # if the purge already finished, the WORK is what's amortized.
        self._evicting: Dict[str, Deque[Tuple[int, "_Node"]]] = {}

    # -- matching ------------------------------------------------------------

    def find_matches(self, page_hashes: Sequence[int],
                     early_exit: bool = False,
                     now: Optional[float] = None) -> MatchResult:
        """Walk the query's page-hash prefix, accumulating per-worker overlap.

        A worker's score is the number of leading query pages it holds
        (reference indexer.rs:239-275 walks exactly this way: the walk stops
        at the first page no worker holds).
        """
        if self._evicting:
            self.process_evictions(EVICT_AMORTIZE)
        result = MatchResult()
        node = self.root
        for h in page_hashes:
            nxt = node.children.get(h)
            if nxt is None:
                break
            node = nxt
            for worker in node.workers:
                result.scores[worker] = result.scores.get(worker, 0) + 1
            if self.expiration_s is not None:
                t = now if now is not None else time.monotonic()
                self._expire(node, t)
                node.recent_uses.append(t)
                result.frequencies.append(len(node.recent_uses))
            if early_exit and len(node.workers) == 1:
                break
        if self._evicting:
            # a mid-eviction worker's leftover entries must not score:
            # the router would route onto the corpse the purge exists
            # to remove (this filter is what makes chunked eviction
            # OBSERVABLY identical to the old synchronous purge)
            for worker in self._evicting:
                result.scores.pop(worker, None)
        return result

    def _expire(self, node: _Node, now: float) -> None:
        cutoff = now - self.expiration_s
        while node.recent_uses and node.recent_uses[0] < cutoff:
            node.recent_uses.popleft()

    # -- event application ---------------------------------------------------

    def apply_event(self, event: RouterEvent) -> None:
        if self._evicting:
            self.process_evictions(EVICT_AMORTIZE)
        worker = event.worker_id
        data = event.event.data
        table = self.lookup.setdefault(worker, {})
        if isinstance(data, KvCacheStoreData):
            if data.parent_hash is None or data.parent_hash == 0:
                node = self.root
            else:
                node = table.get(data.parent_hash)
                if node is None:
                    # parent unknown (events raced a router restart): drop the
                    # event — root-attaching a mid-sequence page would forge a
                    # depth-1 prefix edge and cause false routing matches
                    return
            for blk in data.blocks:
                child = node.children.get(blk.tokens_hash)
                if child is None:
                    child = _Node(blk.tokens_hash, node)
                    node.children[blk.tokens_hash] = child
                    self.node_count += 1
                # re-store under a new block_hash: drop the stale mapping
                # (invariant: table entries are {bh: node.workers[w]==bh})
                old = child.workers.get(worker)
                if old is not None and old != blk.block_hash:
                    table.pop(old, None)
                child.workers[worker] = blk.block_hash
                table[blk.block_hash] = child
                node = child
        elif isinstance(data, KvCacheRemoveData):
            for bh in data.block_hashes:
                node = table.pop(bh, None)
                if node is None:
                    continue
                if node.workers.get(worker) == bh:
                    del node.workers[worker]
                self._maybe_prune(node)

    def _maybe_prune(self, node: _Node) -> None:
        while (node.parent is not None and not node.workers
               and not node.children):
            parent = node.parent
            if parent.children.get(node.tokens_hash) is node:
                del parent.children[node.tokens_hash]
                self.node_count -= 1
            node = parent

    def remove_worker(self, worker: str) -> None:
        """Queue the worker's entries for incremental eviction and
        process one bounded chunk now. Small workers finish here (the
        pre-storm behavior); a 100k-node worker leaves a backlog that
        drains EVICT_AMORTIZE nodes per apply_event/find_matches (or via
        process_evictions) — meanwhile find_matches already answers as
        if the purge completed."""
        table = self.lookup.pop(worker, None)
        if not table:
            return
        items = deque(table.items())
        dq = self._evicting.get(worker)
        if dq is None:
            self._evicting[worker] = items
        else:
            dq.extend(items)
        self.process_evictions(EVICT_CHUNK)

    def process_evictions(self, budget: int = EVICT_CHUNK) -> int:
        """Drain up to `budget` pending eviction entries; returns the
        number processed. The block-hash guard makes a pending entry a
        no-op when the node's entry no longer belongs to the evicted
        generation (the worker was revived and re-stored the page)."""
        done = 0
        while budget > 0 and self._evicting:
            worker, dq = next(iter(self._evicting.items()))
            while dq and budget > 0:
                bh, node = dq.popleft()
                if node.workers.get(worker) == bh:
                    del node.workers[worker]
                    self._maybe_prune(node)
                done += 1
                budget -= 1
            if not dq:
                del self._evicting[worker]
        return done

    def finish_eviction(self, worker: str) -> None:
        """Synchronously drain this worker's pending eviction (the
        revive path: a worker coming BACK must not stay hidden behind
        the find_matches eviction filter)."""
        dq = self._evicting.pop(worker, None)
        if not dq:
            return
        for bh, node in dq:
            if node.workers.get(worker) == bh:
                del node.workers[worker]
                self._maybe_prune(node)

    def eviction_backlog(self) -> int:
        return sum(len(dq) for dq in self._evicting.values())

    # -- introspection -------------------------------------------------------

    def num_nodes(self) -> int:
        # O(1): maintained at node create/prune (a periodic /metrics
        # refresh over a 100k-node tree cannot afford the full walk)
        return self.node_count

    def worker_block_count(self, worker: str) -> int:
        return len(self.lookup.get(worker, {}))


class KvIndexer:
    """Event-fed index: subscribe to `{ns}.{component}.kv_events` and answer
    overlap queries (reference indexer.rs:499-668)."""

    def __init__(self, block_size: int,
                 expiration_duration_s: Optional[float] = None,
                 native: object = "auto"):
        self.block_size = block_size
        # native C++ tree when available; the Python tree is the fallback
        # and the frequency-tracking path
        self.tree = None
        if native and expiration_duration_s is None:
            # lazy: native.radix imports MatchResult from this module
            from dynamo_tpu_torch.native import NATIVE_STATS, radix
            try:
                if radix.available():
                    self.tree = radix.NativeRadixTree()
            except Exception as e:  # noqa: BLE001 — counted in NATIVE_STATS
                NATIVE_STATS.build_failures += 1
                NATIVE_STATS.last_error = f"kv_indexer: start: {e!r}"
                if native is True:
                    raise
                log.exception("native kv indexer failed to start; using "
                              "the Python tree")
        if self.tree is None:
            if native is True:
                raise RuntimeError("native kv indexer requested but "
                                   "unavailable")
            self.tree = RadixTree(expiration_duration_s)
        self.kind = "python" if isinstance(self.tree, RadixTree) \
            else "native"
        self.events_applied = 0
        # tombstones: in-flight events from a removed worker must not
        # resurrect it (they'd leak ghost nodes forever, since a worker
        # absent from the endpoint snapshot can never be removed again)
        self._removed: set = set()

    def apply_event(self, event: RouterEvent) -> None:
        if event.worker_id in self._removed:
            return
        self.tree.apply_event(event)
        self.events_applied += 1
        if self.events_applied % 256 == 0:
            self._refresh_cp_stats()

    def revive_worker(self, worker: str) -> None:
        """A worker id re-appeared live (restart): accept its events
        again — and drain any eviction still pending against its old
        generation, so the find_matches eviction filter cannot hide the
        revived worker's fresh pages."""
        self._removed.discard(worker)
        finish = getattr(self.tree, "finish_eviction", None)
        if finish is not None:
            finish(worker)

    def find_matches(self, page_hashes: Sequence[int]) -> MatchResult:
        return self.tree.find_matches(page_hashes)

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> MatchResult:
        return self.find_matches(
            compute_page_hashes(tokens, self.block_size))

    def remove_worker(self, worker: str) -> None:
        self._removed.add(worker)
        self.tree.remove_worker(worker)
        self._refresh_cp_stats()

    def process_evictions(self, budget: int = EVICT_CHUNK) -> int:
        """Drain pending incremental evictions (no-op on the native tree,
        whose remove_worker is synchronous)."""
        proc = getattr(self.tree, "process_evictions", None)
        done = proc(budget) if proc is not None else 0
        if done:
            self._refresh_cp_stats()
        return done

    def eviction_backlog(self) -> int:
        backlog = getattr(self.tree, "eviction_backlog", None)
        return backlog() if backlog is not None else 0

    def num_nodes(self) -> int:
        return self.tree.num_nodes()

    def _refresh_cp_stats(self) -> None:
        CP_STATS.indexer_nodes = self.tree.num_nodes()
        CP_STATS.indexer_eviction_backlog = self.eviction_backlog()


def shard_hash(worker: str) -> int:
    """The shard key of a worker id: stable across processes and restarts
    (Python's hash() is salted per process)."""
    return int.from_bytes(hashlib.blake2b(
        worker.encode("utf-8"), digest_size=8,
        key=(1337).to_bytes(8, "little")).digest(), "little")


class KvIndexerSharded:
    """Shards workers across independent indexers (reference
    indexer.rs:677-900). Queries fan out to every shard and merge; events
    touch exactly one shard."""

    def __init__(self, block_size: int, num_shards: int = 4,
                 expiration_duration_s: Optional[float] = None,
                 native: object = "auto"):
        self.block_size = block_size
        self.shards = [KvIndexer(block_size, expiration_duration_s, native)
                       for _ in range(num_shards)]
        self.kind = self.shards[0].kind

    def _shard_for(self, worker: str) -> KvIndexer:
        return self.shards[shard_hash(worker) % len(self.shards)]

    def apply_event(self, event: RouterEvent) -> None:
        self._shard_for(event.worker_id).apply_event(event)

    def find_matches(self, page_hashes: Sequence[int]) -> MatchResult:
        merged = MatchResult()
        for shard in self.shards:
            res = shard.find_matches(page_hashes)
            merged.scores.update(res.scores)
            # per-depth use counts sum across shards (each shard tracks its
            # own matched path; total recent uses of depth i is the sum)
            for i, f in enumerate(res.frequencies):
                if i < len(merged.frequencies):
                    merged.frequencies[i] += f
                else:
                    merged.frequencies.append(f)
        return merged

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> MatchResult:
        return self.find_matches(compute_page_hashes(tokens, self.block_size))

    def remove_worker(self, worker: str) -> None:
        self._shard_for(worker).remove_worker(worker)

    def revive_worker(self, worker: str) -> None:
        self._shard_for(worker).revive_worker(worker)

    def process_evictions(self, budget: int = EVICT_CHUNK) -> int:
        return sum(shard.process_evictions(budget) for shard in self.shards)

    def eviction_backlog(self) -> int:
        return sum(s.eviction_backlog() for s in self.shards)

    def num_nodes(self) -> int:
        return sum(s.num_nodes() for s in self.shards)
