"""KvRouter: event subscription + radix index + scheduler in one.

Copied from dynamo_tpu/kv_router/router.py: subscribes to the component's
`kv_events` subject and feeds the indexer (the event pump, with per-tick
batches, lag and backlog accounting and the stale-snapshot degraded mode),
keeps a metrics-driven worker snapshot (publisher.KvMetricsAggregator), and
answers `schedule(tokens) -> worker_id`. An instance that leaves discovery
(deregistration or lease expiry) is purged from the index and the snapshot
when its watch event arrives; a DRAINING instance is fenced out of prefix
scoring and, through the client's draining ids, out of the candidates.

The selector defaults to `TransferAwareSelector`, the JAX serving default
(router.py:61-67): prefix overlap and load, plus the transfer cost of the
pages a candidate lacks at the process-global TransferCostModel
(observability/fleet.py) and the fail-slow health penalty. The cost term
is live even when no link has been measured (the cold prior prices every
missing page), so it can pick another worker than `DefaultWorkerSelector`
would on the same inputs; the degraded mode freezes it (`freeze_cost`).
The shared pool's sources (router.py:111-160, :261-297): `pool:{worker}`
scores leave the resident score map at schedule time and fold into one
fetchable depth (`_split_pool_scores`, the decision's `pool_blocks`),
which the selector prices as a fetch, never as a live worker's resident
overlap; a dead worker's pool entries, its health evidence and its
endpoint entry go with its watch delete; a `pool-host:` instance event
feeds `pool_membership` (runtime/placement.py), and with no live pool host
the depth is 0. `schedule(..., qos=)` resolves the request's class through
runtime/qos.DEFAULT_POLICY and passes its latency weight. With
publish_hit_events=True (the standalone router service,
kv_router/main.py) every decision's `kv-hit-rate` event is published on
the router's component.

`decisions` keeps the last DECISION_LOG decisions (request id, the winner,
its matched and required pages, the pool depth, the QoS class, every
worker's score, and every candidate's selector terms, with whether its
load snapshot was scraped, carried forward or defaulted) for inspection;
with the default selector a candidate's terms are its matched pages and
the JAX selector's components (overlap share, kv_usage, active share,
transfer bytes and seconds, pool blocks, health, logit; rounded as JAX
rounds them).
"""
from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Optional, Sequence

from dynamo_tpu_torch.kv_router.indexer import KvIndexer, MatchResult
from dynamo_tpu_torch.kv_router.protocols import (
    RouterEvent, compute_page_hashes, is_pool_source, pool_source_id,
    pool_source_worker,
)
from dynamo_tpu_torch.kv_router.publisher import (
    KV_EVENTS_SUBJECT, KV_HIT_RATE_SUBJECT, KvMetricsAggregator,
)
from dynamo_tpu_torch.kv_router.scheduler import (
    KvScheduler, TransferAwareSelector, WorkerSelector,
)
from dynamo_tpu_torch.observability.serving import SERVING
from dynamo_tpu_torch.runtime.backoff import Backoff
from dynamo_tpu_torch.runtime.component import (
    STATUS_DRAINING, instance_status,
)
from dynamo_tpu_torch.runtime.cpstats import CP_STATS
from dynamo_tpu_torch.runtime.health import HEALTH
from dynamo_tpu_torch.runtime.placement import is_pool_host_instance
from dynamo_tpu_torch.runtime.qos import DEFAULT_POLICY

log = logging.getLogger("dynamo_tpu_torch.kv_router")

DECISION_LOG = 1024


class KvRouter:
    """The stale-snapshot degraded mode: prefix scores are advisory, so
    when the event plane lags (publish ts -> apply time) past DEGRADED_LAG_S
    or the event backlog passes DEGRADED_BACKLOG, the router keeps
    scheduling on its last-good prefix scores and load metrics and reports
    the staleness (self.degraded, llm_cp_router_degraded) instead of
    blocking requests behind event application. Exit uses half-threshold
    hysteresis plus a DEGRADED_MIN_S dwell."""

    DEGRADED_LAG_S = 2.0
    DEGRADED_BACKLOG = 10_000
    DEGRADED_MIN_S = 1.0
    EVENT_BATCH = 2048

    def __init__(self, component, worker_client, block_size: int,
                 selector: Optional[WorkerSelector] = None,
                 scrape_interval_s: float = 0.5, pool_membership=None,
                 publish_hit_events: bool = False):
        self.component = component
        self.client = worker_client
        self.block_size = block_size
        self.indexer = KvIndexer(block_size)
        self.scheduler = KvScheduler(
            block_size, selector if selector is not None
            else TransferAwareSelector())
        self.publish_hit_events = publish_hit_events
        self.aggregator = KvMetricsAggregator(worker_client, scrape_interval_s)
        self.pool_membership = pool_membership
        self.degraded = False
        self.degraded_entries = 0
        self._degraded_since = 0.0
        self.event_lag_s = 0.0
        self.events_applied = 0
        self.decisions: collections.deque = collections.deque(
            maxlen=DECISION_LOG)
        self._event_task: Optional[asyncio.Task] = None

    async def start(self) -> "KvRouter":
        stream = await self.component.subscribe(KV_EVENTS_SUBJECT)
        self._event_task = asyncio.create_task(self._event_pump(stream))
        self.aggregator.on_update(self._on_metrics)
        self.client.add_listener(self._on_instance)
        await self.aggregator.start()
        return self

    def _on_metrics(self, endpoints, removed) -> None:
        # fence re-check: a scrape that raced a death can still carry the
        # dead worker; the client's watch state is authoritative
        for worker_id in [w for w in endpoints.workers
                          if w not in self.client.instances]:
            del endpoints.workers[worker_id]
        self.scheduler.update_endpoints(endpoints)
        for worker_id in removed:
            self.indexer.remove_worker(worker_id)
        for worker_id in endpoints.workers:
            self.indexer.revive_worker(worker_id)
            # a restarted worker's pool publishes must not stay tombstoned
            # behind its old generation's eviction
            self.indexer.revive_worker(pool_source_id(worker_id))

    def _on_instance(self, kind, worker_id, info) -> None:
        """Watch-event-time eviction: the moment discovery drops an
        instance its cached-prefix scores, its pool-source entries and its
        endpoint entry go, not at the next metrics scrape. A pool host's
        instance event feeds the pool membership instead."""
        if is_pool_host_instance(worker_id):
            if self.pool_membership is not None:
                self.pool_membership.on_instance(kind, worker_id, info)
            return
        if kind == "delete":
            self.indexer.remove_worker(worker_id)
            self.indexer.remove_worker(pool_source_id(worker_id))
            self.scheduler.remove_worker(worker_id)
            # a dead worker's latency evidence must not bias a reused
            # instance name
            HEALTH.forget(worker_id)
        elif kind == "put" and instance_status(info) == STATUS_DRAINING:
            # drain fence: keep the worker out of prefix scoring so cached
            # overlap cannot pull new streams onto it
            self.indexer.remove_worker(worker_id)

    async def _event_pump(self, stream) -> None:
        """Event-plane consumer with backpressure accounting: events apply
        in per-tick batches bounded by EVENT_BATCH, with a yield between
        batches so schedule() calls interleave. The pump survives stream
        death with bounded backoff and a resubscribe."""
        backoff = Backoff(base_s=0.05, max_s=2.0, stable_reset_s=10.0)
        idle_s = 0.25
        while True:
            try:
                batch = await stream.next_batch(self.EVENT_BATCH,
                                                timeout=idle_s)
                now = time.time()
                for _subj, msg in batch:
                    try:
                        ev = RouterEvent.unpack(msg)
                        self.indexer.apply_event(ev)
                        self.events_applied += 1
                        if ev.ts is not None:
                            self.event_lag_s = max(0.0, now - ev.ts)
                    except Exception:  # noqa: BLE001 — skip a bad event
                        log.exception("bad kv event: %r", msg)
                backlog = stream.depth()
                if not batch and backlog == 0:
                    self.event_lag_s = 0.0   # caught up and idle
                self._update_degraded(backlog)
                backoff.reset()
                if batch:
                    await asyncio.sleep(0)   # let schedule() interleave
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the pump must outlive it
                log.warning("kv event stream failed; resubscribing",
                            exc_info=True)
                try:
                    await stream.aclose()
                except Exception:  # noqa: BLE001 — best-effort close
                    pass
                await backoff.sleep()
                try:
                    stream = await self.component.subscribe(
                        KV_EVENTS_SUBJECT)
                except Exception:  # noqa: BLE001 — retried next round
                    log.warning("kv event resubscribe failed",
                                exc_info=True)

    def _update_degraded(self, backlog: int) -> None:
        lag = self.event_lag_s
        if not self.degraded:
            if lag > self.DEGRADED_LAG_S or backlog > self.DEGRADED_BACKLOG:
                self.degraded = True
                self.degraded_entries += 1
                self._degraded_since = time.monotonic()
                log.warning(
                    "kv_router entering stale-snapshot degraded mode "
                    "(event lag %.2fs, backlog %d): scheduling continues "
                    "on last-good prefix scores + load", lag, backlog)
        elif lag < self.DEGRADED_LAG_S / 2 \
                and backlog < self.DEGRADED_BACKLOG / 2 \
                and time.monotonic() - self._degraded_since \
                >= self.DEGRADED_MIN_S:
            self.degraded = False
            log.info("kv_router exited degraded mode (event lag %.2fs, "
                     "backlog %d)", lag, backlog)
        CP_STATS.event_lag_seconds = lag
        CP_STATS.event_backlog = backlog
        CP_STATS.router_degraded = int(self.degraded)
        CP_STATS.router_degraded_entries = self.degraded_entries
        # while the snapshot is stale the transfer cost freezes at its
        # last-good per-worker values instead of recomputing from it
        freeze = getattr(self.scheduler.selector, "freeze_cost", None)
        if freeze is not None:
            freeze(self.degraded)

    async def stop(self) -> None:
        if self._event_task:
            self._event_task.cancel()
            self._event_task = None
        await self.aggregator.stop()

    # -- scheduling ----------------------------------------------------------

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> MatchResult:
        return self.indexer.find_matches(
            compute_page_hashes(tokens, self.block_size))

    def _split_pool_scores(self, overlap: MatchResult) -> int:
        """Strip the `pool:{worker}` entries out of the match scores and
        fold them into ONE fetchable-prefix depth, the deepest live-sourced
        pool match: a candidate must fetch those pages, so they never rank
        a worker as if it held them. A source missing from the live
        instance set is never counted (a Stored event racing the watch
        eviction can re-add a dead worker's edge), and with a pool
        membership wired and no live pool host the depth is 0."""
        pool_matched = 0
        dead_pool = (self.pool_membership is not None
                     and not self.pool_membership.live_hosts())
        instances = getattr(self.client, "instances", None)
        for wid in [w for w in overlap.scores if is_pool_source(w)]:
            score = overlap.scores.pop(wid)
            if dead_pool:
                continue   # no live pool host can serve any fetch
            src = pool_source_worker(wid)
            if instances is not None and src not in instances:
                continue   # a dead source: never count a fetch from it
            pool_matched = max(pool_matched, score)
        return pool_matched

    @property
    def last_score_components(self) -> dict:
        """Per-worker score components of the last decision (transfer-
        aware selectors only; {} otherwise)."""
        return getattr(self.scheduler.selector, "last_components", {})

    async def schedule(self, tokens: Sequence[int], exclude=(),
                       request_id: str = "", qos: str = "") -> str:
        """Pick the best worker for this token sequence; returns its id.
        `exclude` drops instances from scoring unless that would leave no
        candidates; DRAINING instances join the exclusion the same way.
        `qos`: the request's QoS class; its latency weight scales the
        transfer-aware selector's cost term."""
        t0 = time.monotonic()
        drains = self.client.draining_ids()
        if drains:
            exclude = set(exclude) | set(drains)
        overlap = self.find_matches_for_tokens(tokens)
        pool_matched = self._split_pool_scores(overlap)
        qos_cls = DEFAULT_POLICY.resolve(qos or None)
        sel = self.scheduler.schedule(
            len(tokens), overlap, exclude=exclude, pool_matched=pool_matched,
            qos=qos_cls.name, qos_weight=qos_cls.latency_weight)
        SERVING.schedule.observe(value=time.monotonic() - t0)
        sources = self.aggregator.snapshot_source
        self.decisions.append({
            "request_id": request_id, "worker_id": sel.worker_id,
            "overlap_blocks": sel.overlap_blocks,
            "required_blocks": sel.required_blocks,
            "pool_blocks": pool_matched, "qos": qos_cls.name,
            "scores": dict(overlap.scores),
            "candidates": [
                {**c, "snapshot": sources.get(c["worker_id"], "unknown")}
                for c in sel.candidates]})
        hits = self.scheduler.drain_hit_events()
        if self.publish_hit_events:
            for ev in hits:
                await self.component.publish(KV_HIT_RATE_SUBJECT, {
                    "worker_id": ev.worker_id, "isl_blocks": ev.isl_blocks,
                    "overlap_blocks": ev.overlap_blocks})
        return sel.worker_id
