"""Host-side paged KV cache bookkeeping: page allocator + per-sequence state.

Copied from dynamo_tpu/engine/kv_cache.py, trimmed to the slice: the
multimodal salts are left out. `on_evict(pid, seq_hash)` (the host tier's
hook, engine/offload.py) fires when a reusable page is recycled, before
its hash is dropped. Free pages are
reclaimable by content hash (prefix cache); in-flight pages are ref-counted
and shared between sequences with identical prefixes. Only integer
bookkeeping happens here; the device tensors live in the engine.

The allocator records the KV events the router consumes, in the JAX
package's order and at its points (kv_cache.py:86, :121, :150):
("stored", page, seq_hash, parent_hash, tokens_hash) when a page is sealed
and ("removed", page, seq_hash, 0, 0) when a reusable page is recycled;
`drain_events` hands them over.

Page hashes chain hash(parent_seq_hash, page_token_ids) as in the JAX
package, but over BLAKE2b-64 from the standard library instead of xxh3:
the port depends on nothing beyond torch and numpy. `tokens_hash` is the
content-only page hash (BLAKE2b-64 under its own key) that keys the
router's radix tree; the port's router computes it from query tokens with
the same function (kv_router/protocols.compute_page_hashes). Neither
hash matches the JAX package's, so a port worker and a JAX router never
agree on hashes.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


def _hash64(parts: Sequence[bytes], key: bytes = b"dynamo-page-1337") -> int:
    h = hashlib.blake2b(digest_size=8, key=key)
    for p in parts:
        h.update(p)
    return int.from_bytes(h.digest(), "little")


def _token_bytes(tokens: Sequence[int]) -> bytes:
    return b"".join(int(t).to_bytes(4, "little", signed=True) for t in tokens)


def page_hash(parent: int, tokens: Sequence[int]) -> int:
    """Chained content hash of one full page of tokens."""
    return _hash64((parent.to_bytes(8, "little", signed=False),
                    _token_bytes(tokens)))


def tokens_hash(tokens: Sequence[int]) -> int:
    """Content-only (unchained) page hash: computable from query tokens
    alone, it keys the router's radix tree."""
    return _hash64((_token_bytes(tokens),), key=b"dynamo-tokens-1337")


@dataclasses.dataclass
class PageInfo:
    ref_count: int = 0
    seq_hash: Optional[int] = None   # set once the page is full + hashed


class PageAllocator:
    """Free-list page allocator with content-hash reuse (prefix caching).

    Freed pages keep their contents and sit in a reuse map keyed by chained
    sequence hash until evicted (LRU order)."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        # called as on_evict(page_id, seq_hash) when a reusable page is
        # recycled, while its contents are still intact (the host tier)
        self.on_evict = None
        self.pages: List[PageInfo] = [PageInfo() for _ in range(num_pages)]
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        # seq_hash -> page id, for pages whose ref_count dropped to 0
        self._reusable: Dict[int, int] = {}
        self._reusable_order: List[int] = []  # LRU eviction order (page ids)
        # live (ref_count>0) full pages by hash, for inflight sharing
        self._live: Dict[int, int] = {}
        # (kind, page, seq_hash, parent_seq_hash, tokens_hash); tokens_hash=0
        # for "removed" (removal is keyed by the chained hash)
        self.events: List[Tuple[str, int, int, int, int]] = []

    # -- stats ---------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._reusable)

    @property
    def usage(self) -> float:
        return 1.0 - self.num_free / self.num_pages

    def can_allocate(self, n: int) -> bool:
        return self.num_free >= n

    # -- allocation ----------------------------------------------------------
    def allocate(self) -> int:
        """Take one blank page (evicting from the reuse pool if needed)."""
        if self._free:
            pid = self._free.pop()
        else:
            pid = self._evict_one()
        info = self.pages[pid]
        info.ref_count = 1
        info.seq_hash = None
        return pid

    def _evict_one(self) -> int:
        while self._reusable_order:
            pid = self._reusable_order.pop(0)
            info = self.pages[pid]
            if info.ref_count == 0 and info.seq_hash is not None \
                    and self._reusable.get(info.seq_hash) == pid:
                if self.on_evict is not None:
                    self.on_evict(pid, info.seq_hash)
                del self._reusable[info.seq_hash]
                self.events.append(("removed", pid, info.seq_hash, 0, 0))
                info.seq_hash = None
                return pid
        raise MemoryError("KV cache exhausted: no free or reusable pages")

    def lookup(self, seq_hash: int) -> Optional[int]:
        """Find a page holding this hashed prefix page (live or reusable)."""
        pid = self._live.get(seq_hash)
        if pid is not None:
            return pid
        return self._reusable.get(seq_hash)

    def share(self, pid: int) -> int:
        """Add a reference to an existing page (prefix-cache hit)."""
        info = self.pages[pid]
        if info.ref_count == 0:
            # revive from the reuse pool
            if info.seq_hash is not None \
                    and self._reusable.get(info.seq_hash) == pid:
                del self._reusable[info.seq_hash]
                self._live[info.seq_hash] = pid
        info.ref_count += 1
        return pid

    def seal(self, pid: int, parent_hash: int, tokens: Sequence[int]) -> int:
        """Mark a page full and content-hashed; returns the chained hash."""
        sh = page_hash(parent_hash, tokens)
        info = self.pages[pid]
        info.seq_hash = sh
        self._live[sh] = pid
        self.events.append(("stored", pid, sh, parent_hash,
                            tokens_hash(tokens)))
        return sh

    def free(self, pid: int) -> None:
        info = self.pages[pid]
        info.ref_count -= 1
        if info.ref_count > 0:
            return
        if info.seq_hash is not None:
            if self._live.get(info.seq_hash) == pid:
                del self._live[info.seq_hash]
            if info.seq_hash in self._reusable:
                # duplicate content (two requests computed the same page):
                # only one copy is worth keeping — recycle this one as blank
                info.seq_hash = None
                self._free.append(pid)
            else:
                self._reusable[info.seq_hash] = pid
                self._reusable_order.append(pid)
        else:
            self._free.append(pid)

    def drain_events(self) -> List[Tuple[str, int, int, int, int]]:
        ev, self.events = self.events, []
        return ev


@dataclasses.dataclass
class SequenceState:
    """Per-request device-cache bookkeeping owned by the scheduler."""

    request_id: str
    prompt: List[int]
    pages: List[int] = dataclasses.field(default_factory=list)
    page_hashes: List[int] = dataclasses.field(default_factory=list)
    num_cached: int = 0       # tokens whose KV is already valid in the cache
    num_computed: int = 0     # tokens whose KV was computed by US this request
    output: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1            # decode slot id, -1 while prefilling
    # bumped on every preempt-and-readmit (the sampler's host caches key
    # slots by (request_id, epoch))
    epoch: int = 0
    prefill_only: bool = False  # park after prefill instead of decoding
    # multi-tenant QoS (runtime/qos.py): class name + resolved priority,
    # queue-bypass count (bounded by the aging limit) and the preemptor's
    # class while this sequence waits as a preemption victim
    qos: str = ""
    qos_prio: int = 0
    qos_bypassed: int = 0
    preempted_by: Optional[str] = None

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def all_tokens(self) -> List[int]:
        """prompt + generated tokens; the KV-resident token sequence (a
        preempted request re-prefills its generated tokens too)."""
        return self.prompt + self.output

    def flat_index(self, pos: int, page_size: int) -> int:
        return self.pages[pos // page_size] * page_size + pos % page_size
