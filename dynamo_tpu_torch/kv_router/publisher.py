"""Worker-side KV event + load-metrics publishing, and the router's scrape.

Copied from dynamo_tpu/kv_router/publisher.py: the engine worker pushes page
Stored / Removed events onto the event-plane subject
`{ns}.{component}.kv_events` (`KvEventPublisher`, from the allocator's
events: engine/kv_cache.PageAllocator.drain_events) and exposes its latest
metrics through the endpoint's stats handler (`KvMetricsPublisher`), which
the router-side `KvMetricsAggregator` scrapes.
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Dict, Optional

from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheEvent, KvCacheRemoveData, KvCacheStoreData, KvCacheStoredBlockData,
    RouterEvent,
)
from dynamo_tpu_torch.kv_router.scoring import ProcessedEndpoints, WorkerMetrics

log = logging.getLogger("dynamo_tpu_torch.kv_router")

KV_EVENTS_SUBJECT = "kv_events"
# one event a routing decision (KvRouter with publish_hit_events=True)
KV_HIT_RATE_SUBJECT = "kv-hit-rate"


class KvEventPublisher:
    """Converts allocator events into RouterEvents on the event plane."""

    def __init__(self, component, worker_id: str):
        self.component = component
        self.worker_id = worker_id
        self._event_id = 0

    async def publish_allocator_events(self, events) -> int:
        """Publish a batch of (kind, page, seq_hash, parent, tokens_hash)
        tuples drained from PageAllocator; returns the number of RouterEvents
        published. Consecutive stored events that chain (parent == previous
        seq_hash) coalesce into one multi-block Stored event, and runs of
        removals into one Removed event, so an N-page prefill costs O(1)
        event-plane messages (the reference batches the same way —
        KvCacheStoreData carries a block list)."""
        batches: list = []
        for kind, _pid, seq_hash, parent, tok_hash in events:
            if kind == "stored":
                prev = batches[-1] if batches else None
                if (prev is not None and isinstance(prev, KvCacheStoreData)
                        and prev.blocks and prev.blocks[-1].block_hash == parent):
                    prev.blocks.append(KvCacheStoredBlockData(seq_hash, tok_hash))
                else:
                    batches.append(KvCacheStoreData(
                        parent_hash=parent or None,
                        blocks=[KvCacheStoredBlockData(seq_hash, tok_hash)]))
            else:
                prev = batches[-1] if batches else None
                if isinstance(prev, KvCacheRemoveData):
                    prev.block_hashes.append(seq_hash)
                else:
                    batches.append(KvCacheRemoveData(block_hashes=[seq_hash]))
        for data in batches:
            ev = RouterEvent(self.worker_id,
                             KvCacheEvent(self._event_id, data),
                             ts=time.time())
            self._event_id += 1
            await self.component.publish(KV_EVENTS_SUBJECT, ev.pack())
        return len(batches)


class KvMetricsPublisher:
    """Holds the worker's latest load snapshot; plugs into the endpoint's
    stats handler so the aggregator's scrape sees it."""

    def __init__(self):
        self.metrics = WorkerMetrics()

    def update(self, m) -> None:
        if dataclasses.is_dataclass(m) and not isinstance(m, WorkerMetrics):
            m = WorkerMetrics.from_dict(dataclasses.asdict(m))
        self.metrics = m

    def stats_handler(self) -> dict:
        return dataclasses.asdict(self.metrics)


class KvMetricsAggregator:
    """Router-side scrape loop: polls live workers' stats handlers into a
    ProcessedEndpoints snapshot (reference metrics_aggregator.rs:26-145)."""

    def __init__(self, client, interval_s: float = 0.5):
        self.client = client            # runtime Client on the worker endpoint
        self.interval_s = interval_s
        self.endpoints = ProcessedEndpoints()
        self._task: Optional[asyncio.Task] = None
        self._listeners = []
        # pristine last successful scrape per worker — carry-forward copies
        # come from here, NOT from the bump-mutated working snapshot, so
        # optimistic bumps never compound across scrape windows
        self._last_scraped: Dict[str, WorkerMetrics] = {}
        # where each worker's entry in the current snapshot came from:
        # "scraped" this cycle, "carried" forward from its last scrape, or
        # "defaulted" (never published: unit totals)
        self.snapshot_source: Dict[str, str] = {}

    def on_update(self, cb) -> None:
        """cb(ProcessedEndpoints, removed_worker_ids) per scrape."""
        self._listeners.append(cb)

    async def scrape_once(self) -> ProcessedEndpoints:
        stats = await self.client.scrape_stats()
        workers: Dict[str, WorkerMetrics] = {}
        sources: Dict[str, str] = {}
        for worker_id, payload in stats.items():
            try:
                m = WorkerMetrics.from_dict(payload)
            except (TypeError, KeyError):
                continue
            workers[worker_id] = m
            self._last_scraped[worker_id] = dataclasses.replace(m)
            sources[worker_id] = "scraped"
        # a live instance that failed this scrape resumes from its last
        # *pristine* snapshot (not the bump-mutated working copy); one that
        # never published stats is still routable, with unit totals so the
        # scheduler's optimistic bump has teeth (zero totals would make it
        # look permanently idle and attract the whole request stream between
        # scrapes). Either way a live instance must never count as removed —
        # removal purges its radix-index entries. DRAINING instances are
        # deliberately NOT carried forward (instance_ids excludes them):
        # they fall into `removed`, which fences their index entries and
        # drops them from scheduling until they come back ready.
        for worker_id in set(self.client.instance_ids()) - set(workers):
            last = self._last_scraped.get(worker_id)
            workers[worker_id] = (dataclasses.replace(last)
                                  if last is not None else WorkerMetrics(
                                      request_total_slots=1, kv_total_blocks=1))
            sources[worker_id] = "carried" if last is not None else "defaulted"
        removed = set(self.endpoints.workers) - set(workers)
        for worker_id in removed:
            self._last_scraped.pop(worker_id, None)
        self.endpoints = ProcessedEndpoints(workers)
        self.snapshot_source = sources
        for cb in self._listeners:
            cb(self.endpoints, removed)
        return self.endpoints

    async def start(self) -> None:
        async def loop():
            # dynalint: backoff-ok=fixed-interval scrape; a failed cycle is logged and the next tick retries at the same cadence
            while True:
                try:
                    await self.scrape_once()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — the loop must go on
                    log.exception("metrics scrape failed")
                await asyncio.sleep(self.interval_s)
        self._task = asyncio.create_task(loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            self._task = None
