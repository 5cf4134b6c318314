"""KV event wire protocol for the KV-aware router.

Copied from dynamo_tpu/kv_router/protocols.py: a worker's page allocator
emits `RouterEvent{worker_id, KvCacheEvent}` onto the event-plane subject
`{ns}.{component}.kv_events`; Stored events carry the parent chained hash
plus per-page (chained block_hash, content-only tokens_hash) pairs, Removed
events carry chained block hashes. Two hash kinds:

- tokens_hash: the port's content-only BLAKE2b page hash
  (engine/kv_cache.tokens_hash), computable by a router from query tokens
  alone; it keys the radix tree. `compute_page_hashes` is the router side.
- block_hash: the chained sequence hash the worker's allocator assigned
  (engine/kv_cache.page_hash), unique per prefix; it keys the per-worker
  lookup that applies Removed events.

A shared pool's Stored / Removed events ride the same plane under the
source id `pool:{worker_id}` (protocols.py:33-52): the radix tree indexes
pool-resident prefixes next to worker-resident ones, the router splits
the two at schedule time (a pool score is a fetchable prefix, not a
resident one), and the id embeds the publishing worker, so the watch
eviction that purges a dead worker purges its pool entries too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from dynamo_tpu_torch.engine.kv_cache import tokens_hash

__all__ = [
    "tokens_hash", "compute_page_hashes", "KvCacheStoredBlockData",
    "KvCacheStoreData", "KvCacheRemoveData", "KvCacheEvent", "RouterEvent",
    "POOL_SOURCE_PREFIX", "pool_source_id", "is_pool_source",
    "pool_source_worker",
]

POOL_SOURCE_PREFIX = "pool:"


def pool_source_id(worker_id: str) -> str:
    return f"{POOL_SOURCE_PREFIX}{worker_id}"


def is_pool_source(worker_id: str) -> bool:
    return worker_id.startswith(POOL_SOURCE_PREFIX)


def pool_source_worker(worker_id: str) -> str:
    """The source worker behind a pool: id (a plain id is its own)."""
    return worker_id[len(POOL_SOURCE_PREFIX):] \
        if is_pool_source(worker_id) else worker_id


def compute_page_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """tokens_hash of each *full* page of the sequence (router query side)."""
    n_full = len(tokens) // page_size
    return [tokens_hash(tokens[i * page_size:(i + 1) * page_size])
            for i in range(n_full)]


@dataclasses.dataclass
class KvCacheStoredBlockData:
    block_hash: int    # chained sequence hash (worker-assigned)
    tokens_hash: int   # content-only hash (router-computable)


@dataclasses.dataclass
class KvCacheStoreData:
    parent_hash: Optional[int]  # chained hash of the preceding block, None=root
    blocks: List[KvCacheStoredBlockData] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class KvCacheRemoveData:
    block_hashes: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class KvCacheEvent:
    event_id: int
    data: "KvCacheStoreData | KvCacheRemoveData"


@dataclasses.dataclass
class RouterEvent:
    worker_id: str
    event: KvCacheEvent
    # publish-time unix timestamp (time.time()); when present the router
    # derives its event-plane lag (now - ts at apply time)
    ts: Optional[float] = None

    def pack(self) -> dict:
        d = self.event.data
        if isinstance(d, KvCacheStoreData):
            data = {"kind": "stored", "parent_hash": d.parent_hash,
                    "blocks": [[b.block_hash, b.tokens_hash]
                               for b in d.blocks]}
        else:
            data = {"kind": "removed", "block_hashes": list(d.block_hashes)}
        out = {"worker_id": self.worker_id,
               "event_id": self.event.event_id, "data": data}
        if self.ts is not None:
            out["ts"] = self.ts
        return out

    @classmethod
    def unpack(cls, msg: dict) -> "RouterEvent":
        d = msg["data"]
        if d["kind"] == "stored":
            data = KvCacheStoreData(
                parent_hash=d.get("parent_hash"),
                blocks=[KvCacheStoredBlockData(b[0], b[1])
                        for b in d["blocks"]])
        else:
            data = KvCacheRemoveData(block_hashes=list(d["block_hashes"]))
        return cls(worker_id=msg["worker_id"],
                   event=KvCacheEvent(event_id=msg["event_id"], data=data),
                   ts=msg.get("ts"))
