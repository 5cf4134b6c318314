"""KV-aware worker selection.

Copied from dynamo_tpu/kv_router/scheduler.py (`DefaultWorkerSelector`,
`KvScheduler`, :85-130 and :246-): given the query's per-worker overlap
scores (from the radix index) and each worker's load metrics, rank workers
by

    logit = overlap_weight * overlap_score - kv_usage - normalized_active

where `overlap_score = matched_blocks * block_size / isl` (the share of the
prompt already resident), `kv_usage = kv_active_blocks / kv_total_blocks`
and `normalized_active = request_active_slots / request_total_slots`, with
overlap_weight 2. Ties break with the selector's seeded `rng`; the chosen
worker's active slots and blocks are bumped optimistically until the next
metrics scrape. The per-decision `kv-hit-rate` events (published when the
JAX router is built with publish_hit_events=True, which no caller does)
are left out.

Left out: `TransferAwareSelector` (the JAX serving default, router.py:
61-67), which adds a measured KV-transfer cost from the disaggregated data
plane's cost model (observability/fleet.py). With no measured link it
ranks exactly like this selector, which is always the case in an
aggregated deployment; the QoS weight and pool-fetch terms of the
scheduling request go with it.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Protocol

from dynamo_tpu_torch.kv_router.indexer import MatchResult
from dynamo_tpu_torch.kv_router.scoring import ProcessedEndpoints
from dynamo_tpu_torch.kv_router.stats import ROUTER_STATS


class AllWorkersBusy(Exception):
    pass


@dataclasses.dataclass
class SchedulingRequest:
    isl_tokens: int                # input sequence length in tokens
    overlap: MatchResult           # per-worker matched block counts


@dataclasses.dataclass
class WorkerSelection:
    worker_id: str
    required_blocks: int
    overlap_blocks: int
    # every candidate's terms as the selector computed them (worker_id,
    # matched_blocks, overlap, kv_usage, active, logit), for the router's
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


class KvScheduler:
    """Ranks workers for each request against the latest metrics snapshot.

    The snapshot is swapped in whole by the metrics aggregator's scrape
    loop; optimistic bumps are applied to it between scrapes."""

    def __init__(self, block_size: int,
                 selector: Optional[WorkerSelector] = None):
        self.block_size = block_size
        self.selector = selector or DefaultWorkerSelector()
        self.endpoints = ProcessedEndpoints()

    def update_endpoints(self, endpoints: ProcessedEndpoints) -> None:
        self.endpoints = endpoints

    def remove_worker(self, worker_id: str) -> None:
        self.endpoints.workers.pop(worker_id, None)

    def schedule(self, isl_tokens: int, overlap: MatchResult,
                 exclude=()) -> WorkerSelection:
        """Pick a worker; `exclude` drops workers from consideration
        unless that would empty the candidate set (a probe somewhere beats
        failing the request outright)."""
        endpoints = self.endpoints
        if exclude:
            kept = {w: m for w, m in endpoints.workers.items()
                    if w not in exclude}
            if kept:
                # the same WorkerMetrics objects: the optimistic bumps
                # below still land on the live snapshot
                endpoints = ProcessedEndpoints(workers=kept)
        sel = self.selector.select_worker(
            endpoints, SchedulingRequest(isl_tokens, overlap),
            self.block_size)
        m = self.endpoints.workers.get(sel.worker_id)
        if m is not None:
            # optimistic accounting until the next scrape
            m.request_active_slots += 1
            m.kv_active_blocks += sel.required_blocks - sel.overlap_blocks
        ROUTER_STATS.scheduled += 1
        ROUTER_STATS.last_overlap_blocks = sel.overlap_blocks
        ROUTER_STATS.last_required_blocks = sel.required_blocks
        return sel
