"""KV-aware worker selection.

Copied from dynamo_tpu/kv_router/scheduler.py: given the query's per-worker
overlap scores (from the radix index) and each worker's load metrics,
`DefaultWorkerSelector` ranks workers by

    logit = OVERLAP_WEIGHT * overlap_score - kv_usage - normalized_active

where `overlap_score = matched_blocks * block_size / isl` (the share of the
prompt already resident), `kv_usage = kv_active_blocks / kv_total_blocks`
and `normalized_active = request_active_slots / request_total_slots`, with
OVERLAP_WEIGHT 2. Ties break with the selector's `rng`; the chosen worker's
active slots and blocks are bumped optimistically until the next metrics
scrape.

**Transfer-aware scoring** (`TransferAwareSelector`, the serving default
of both packages' KvRouter): the logit grows a transfer term and a health
term,

    logit -= (TRANSFER_WEIGHT * qos_weight
              * min(MAX_PENALTY, cost_s / HORIZON_S)
              + HEALTH_WEIGHT * (1 - health))
    cost_s = estimate(link, bytes).seconds + queue_s(link)

with `bytes = (required - matched - fetchable) * page bytes + fetchable *
page bytes` (the worker's reported `kv_page_bytes`, falling back to
`DEFAULT_BLOCK_BYTES`), `estimate` the per-link measured-bandwidth EWMA of
observability/fleet.TransferCostModel and `queue_s` the drain time of the
bytes already in flight toward that worker. The term is not zero when no
link has been measured: a cold link prices at the fleet-median prior
(1e9 B/s while nothing is measured), so every page a candidate lacks costs
`page_bytes / 1e9 / HORIZON_S` of logit, capped at `MAX_PENALTY`: a
per-page overlap preference on top of the default formula, which can pick
another worker than `DefaultWorkerSelector` on the same inputs.
`fetchable` is the shared pool's depth beyond the candidate's resident
prefix (`SchedulingRequest.pool_matched`): it joins the overlap term and
its fetch is priced at the same cost model. `qos_weight` is the request's
class latency weight (runtime/qos.py). `health` is the fail-slow score
(runtime/health.HEALTH.score, 1.0 without evidence). Under the router's
stale-snapshot degraded mode the cost term freezes at its last live
per-worker values (`freeze_cost`). Each decision's components land in
`last_components` / `last_pick` and in the returned selection's
`candidates`, rounded as the JAX selector rounds them, and feed the
llm_router_* gauges (kv_router/stats.py).

`KvScheduler.schedule` returns the whole `WorkerSelection` (the JAX one
returns the worker id) so that the router's decision log can keep every
candidate's terms; it queues one `KVHitRateEvent` a decision, which
`drain_hit_events` hands to the router (published on `kv-hit-rate` when the
router is built with publish_hit_events=True, as the standalone router
service does).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Protocol

from dynamo_tpu_torch.kv_router.indexer import MatchResult
from dynamo_tpu_torch.kv_router.scoring import (
    ProcessedEndpoints, WorkerMetrics,
)
from dynamo_tpu_torch.kv_router.stats import ROUTER_STATS


class AllWorkersBusy(Exception):
    pass


@dataclasses.dataclass
class SchedulingRequest:
    isl_tokens: int                # input sequence length in tokens
    overlap: MatchResult           # per-worker matched block counts
    # leading query blocks fetchable from the shared KV pool (the router
    # derives it from the `pool:{w}` index scores, live sources only);
    # transfer-aware selectors price the fetch instead of counting misses
    pool_matched: int = 0
    # the request's QoS class and its latency weight (runtime/qos.py):
    # transfer-aware selectors scale the transfer / backlog cost by it
    qos: str = ""
    qos_weight: float = 1.0


@dataclasses.dataclass
class WorkerSelection:
    worker_id: str
    required_blocks: int
    overlap_blocks: int
    # every candidate's terms as the selector computed them (worker_id,
    # matched_blocks and the selector's components), for the router's
    # decision log
    candidates: List[dict] = dataclasses.field(default_factory=list)


class WorkerSelector(Protocol):
    def select_worker(self, endpoints: ProcessedEndpoints,
                      request: SchedulingRequest,
                      block_size: int) -> WorkerSelection: ...


class DefaultWorkerSelector:
    OVERLAP_WEIGHT = 2.0

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()

    def select_worker(self, endpoints: ProcessedEndpoints,
                      request: SchedulingRequest,
                      block_size: int) -> WorkerSelection:
        if not endpoints.workers:
            raise AllWorkersBusy("no live workers")
        isl = max(request.isl_tokens, 1)
        best_logit = float("-inf")
        best: List[str] = []
        terms: List[dict] = []
        for worker_id, m in endpoints.workers.items():
            matched = request.overlap.scores.get(worker_id, 0)
            overlap_score = matched * block_size / isl
            kv_usage = (m.kv_active_blocks / m.kv_total_blocks
                        if m.kv_total_blocks else 0.0)
            norm_active = (m.request_active_slots / m.request_total_slots
                           if m.request_total_slots else 0.0)
            logit = (self.OVERLAP_WEIGHT * overlap_score
                     - kv_usage - norm_active)
            terms.append({"worker_id": worker_id, "matched_blocks": matched,
                          "overlap": overlap_score, "kv_usage": kv_usage,
                          "active": norm_active, "logit": logit})
            if logit > best_logit:
                best_logit, best = logit, [worker_id]
            elif logit == best_logit:
                best.append(worker_id)
        worker_id = self.rng.choice(best)
        required = -(-isl // block_size)
        return WorkerSelection(
            worker_id=worker_id, required_blocks=required,
            overlap_blocks=request.overlap.scores.get(worker_id, 0),
            candidates=terms)


class TransferAwareSelector(DefaultWorkerSelector):
    """DefaultWorkerSelector + a measured KV-transfer cost and a health
    penalty (module docstring). The cost is normalized by `HORIZON_S` (how
    many seconds of transfer outweigh one whole unit of load score) and
    capped at `MAX_PENALTY`. `DEFAULT_BLOCK_BYTES` prices a page of a
    worker that reports no `kv_page_bytes`."""

    TRANSFER_WEIGHT = 1.0
    HORIZON_S = 0.25
    MAX_PENALTY = 4.0
    HEALTH_WEIGHT = 1.0
    DEFAULT_BLOCK_BYTES = 64 * 1024

    def __init__(self, cost_model=None,
                 rng: Optional[random.Random] = None,
                 health_of=None):
        super().__init__(rng)
        if cost_model is None:
            from dynamo_tpu_torch.observability.fleet import TRANSFER_MODEL
            cost_model = TRANSFER_MODEL
        self.cost_model = cost_model
        # health_of(worker) -> [0, 1]; the logit pays HEALTH_WEIGHT *
        # (1 - health), so a gray-failed worker sheds load before any
        # breaker trips and a healthy fleet ranks as without the term
        if health_of is None:
            from dynamo_tpu_torch.runtime.health import HEALTH
            health_of = HEALTH.score
        self.health_of = health_of
        # while frozen, per-worker cost terms pin to their last live
        # values (KvRouter flips this with its degraded flag)
        self.frozen = False
        self._frozen_cost: Dict[str, float] = {}
        self.last_components: Dict[str, dict] = {}
        self.last_pick: Optional[dict] = None

    def freeze_cost(self, frozen: bool) -> None:
        """Enter/exit the degraded cost freeze. Entering keeps the last
        live per-worker costs; exiting clears them so the next decision
        recomputes from fresh signals."""
        if self.frozen and not frozen:
            self._frozen_cost.clear()
        self.frozen = frozen

    def _bytes_to_move(self, m: WorkerMetrics, required: int,
                       matched: int) -> int:
        block_bytes = m.kv_page_bytes or self.DEFAULT_BLOCK_BYTES
        return max(0, required - matched) * block_bytes

    def _cost_s(self, worker_id: str, nbytes: int) -> tuple:
        """(cost_s, cold): live, or pinned under the degraded freeze. A
        frozen worker never seen live prices at the median of the pinned
        costs (unknown is not free)."""
        if self.frozen:
            known = self._frozen_cost
            if worker_id in known:
                return known[worker_id], False
            if known:
                vals = sorted(known.values())
                return vals[len(vals) // 2], True
            # frozen before any live decision: one live estimate beats
            # scoring everyone at zero
        est = self.cost_model.estimate(worker_id, nbytes)
        cost = est.seconds + self.cost_model.queue_s(worker_id)
        if not self.frozen:
            self._frozen_cost[worker_id] = cost
        return cost, est.cold

    def select_worker(self, endpoints: ProcessedEndpoints,
                      request: SchedulingRequest,
                      block_size: int) -> WorkerSelection:
        if not endpoints.workers:
            raise AllWorkersBusy("no live workers")
        isl = max(request.isl_tokens, 1)
        required = -(-isl // block_size)
        pool_m = max(0, min(request.pool_matched, required))
        best_logit = float("-inf")
        best: List[str] = []
        components: Dict[str, dict] = {}
        terms: List[dict] = []
        any_cold = False
        any_degraded = False
        if not self.frozen:
            # the pinned-cost table is the last live decision's view,
            # rebuilt each decision so dead workers cannot linger
            self._frozen_cost.clear()
        for worker_id, m in endpoints.workers.items():
            matched = request.overlap.scores.get(worker_id, 0)
            # pool blocks beyond this worker's resident prefix are
            # fetchable, not misses: they join the overlap term and leave
            # bytes_to_move, and their fetch is priced below
            fetchable = max(0, pool_m - matched)
            eff_matched = matched + fetchable
            overlap_score = eff_matched * block_size / isl
            kv_usage = (m.kv_active_blocks / m.kv_total_blocks
                        if m.kv_total_blocks else 0.0)
            norm_active = (m.request_active_slots / m.request_total_slots
                           if m.request_total_slots else 0.0)
            nbytes_move = self._bytes_to_move(m, required, eff_matched)
            nbytes_fetch = fetchable * (m.kv_page_bytes
                                        or self.DEFAULT_BLOCK_BYTES)
            cost_s, cold = self._cost_s(worker_id,
                                        nbytes_move + nbytes_fetch)
            any_cold |= cold
            norm_cost = min(self.MAX_PENALTY, cost_s / self.HORIZON_S)
            health = self.health_of(worker_id)
            any_degraded |= health < 1.0
            logit = (self.OVERLAP_WEIGHT * overlap_score
                     - kv_usage - norm_active
                     - self.TRANSFER_WEIGHT * request.qos_weight
                     * norm_cost
                     - self.HEALTH_WEIGHT * (1.0 - health))
            comp = {
                "qos": request.qos,
                "qos_weight": request.qos_weight,
                "overlap": round(overlap_score, 4),
                "kv_usage": round(kv_usage, 4),
                "active": round(norm_active, 4),
                "transfer_bytes": nbytes_move,
                "pool_blocks": fetchable,
                "pool_fetch_bytes": nbytes_fetch,
                "transfer_s": round(cost_s, 6),
                "transfer_norm": round(norm_cost, 4),
                "cold": cold,
                "frozen": self.frozen,
                "health": round(health, 4),
                "logit": round(logit, 4),
            }
            components[worker_id] = comp
            terms.append(dict(comp, worker_id=worker_id,
                              matched_blocks=matched))
            if logit > best_logit:
                best_logit, best = logit, [worker_id]
            elif logit == best_logit:
                best.append(worker_id)
        worker_id = self.rng.choice(best)
        self.last_components = components
        pick = dict(components[worker_id], worker_id=worker_id)
        self.last_pick = pick
        ROUTER_STATS.transfer_scored += 1
        if any_cold:
            ROUTER_STATS.cold_scored += 1
        if self.frozen:
            ROUTER_STATS.frozen_scored += 1
        if pool_m > 0:
            ROUTER_STATS.pool_scored += 1
        if any_degraded:
            ROUTER_STATS.health_scored += 1
        ROUTER_STATS.last_pick_health = pick["health"]
        ROUTER_STATS.last_pool_fetch_blocks = pick["pool_blocks"]
        ROUTER_STATS.last_transfer_est_s = pick["transfer_s"]
        ROUTER_STATS.last_transfer_bytes = pick["transfer_bytes"]
        ROUTER_STATS.est_err_abs_frac = round(
            self.cost_model.mean_abs_est_err(), 4)
        return WorkerSelection(
            worker_id=worker_id, required_blocks=required,
            overlap_blocks=request.overlap.scores.get(worker_id, 0),
            candidates=terms)


@dataclasses.dataclass
class KVHitRateEvent:
    """Queued per scheduling decision; the router publishes it on the
    event plane (`kv-hit-rate`) when asked to."""

    worker_id: str
    isl_blocks: int
    overlap_blocks: int


class KvScheduler:
    """Ranks workers for each request against the latest metrics snapshot.

    The snapshot is swapped in whole by the metrics aggregator's scrape
    loop; optimistic bumps are applied to it between scrapes."""

    def __init__(self, block_size: int,
                 selector: Optional[WorkerSelector] = None):
        self.block_size = block_size
        self.selector = selector or DefaultWorkerSelector()
        self.endpoints = ProcessedEndpoints()
        self.hit_events: List[KVHitRateEvent] = []

    def update_endpoints(self, endpoints: ProcessedEndpoints) -> None:
        self.endpoints = endpoints

    def remove_worker(self, worker_id: str) -> None:
        self.endpoints.workers.pop(worker_id, None)

    def schedule(self, isl_tokens: int, overlap: MatchResult,
                 exclude=(), pool_matched: int = 0, qos: str = "",
                 qos_weight: float = 1.0) -> WorkerSelection:
        """Pick a worker; `exclude` drops workers from consideration
        unless that would empty the candidate set (a probe somewhere beats
        failing the request outright). `pool_matched`: leading query
        blocks fetchable from the shared KV pool; `qos` / `qos_weight`:
        the request's class and latency weight (runtime/qos.py)."""
        endpoints = self.endpoints
        if exclude:
            kept = {w: m for w, m in endpoints.workers.items()
                    if w not in exclude}
            if kept:
                # the same WorkerMetrics objects: the optimistic bumps
                # below still land on the live snapshot
                endpoints = ProcessedEndpoints(workers=kept)
        sel = self.selector.select_worker(
            endpoints, SchedulingRequest(isl_tokens, overlap,
                                         pool_matched=pool_matched,
                                         qos=qos, qos_weight=qos_weight),
            self.block_size)
        m = self.endpoints.workers.get(sel.worker_id)
        if m is not None:
            # optimistic accounting until the next scrape
            m.request_active_slots += 1
            m.kv_active_blocks += sel.required_blocks - sel.overlap_blocks
        self.hit_events.append(KVHitRateEvent(
            worker_id=sel.worker_id, isl_blocks=sel.required_blocks,
            overlap_blocks=sel.overlap_blocks))
        ROUTER_STATS.scheduled += 1
        ROUTER_STATS.last_overlap_blocks = sel.overlap_blocks
        ROUTER_STATS.last_required_blocks = sel.required_blocks
        return sel

    def drain_hit_events(self) -> List[KVHitRateEvent]:
        ev, self.hit_events = self.hit_events, []
        return ev
