"""Process-local router counters (/metrics: llm_router_*).

Copied from dynamo_tpu/kv_router/stats.py (ROUTER_STATS): plain numbers
bumped on the routing path and folded into gauges when the frontend or
the standalone exporter renders /metrics (frontend/service.py,
observability/exporter.py). The JAX fields come from the transfer-aware
selector (kv_router/scheduler.py TransferAwareSelector, the serving
default): every decision records whether the transfer-cost term was live,
cold (a candidate link had no bandwidth EWMA yet, so the fleet-median
prior priced it), frozen (degraded mode pinned the last-good costs),
pool-priced or health-penalized, plus the winner's estimated transfer
seconds and bytes and the fleet's estimator-error EWMA. The port adds:

- scheduled: routing decisions made by the KV router;
- last_overlap_blocks / last_required_blocks: the winner's matched pages
  and the request's pages in the last decision;
- fallbacks: requests whose routing raised and that were dispatched by
  the client's plain policy instead (llm/pipeline.RemoteEngineSink). A
  broken router shows here instead of passing unseen.
"""
from __future__ import annotations


class RouterScoringStats:
    FIELDS = (
        "transfer_scored",       # decisions scored with the transfer term
        "cold_scored",           # decisions where >=1 candidate was cold
        "frozen_scored",         # decisions under the degraded cost freeze
        "last_transfer_est_s",   # winner's estimated transfer seconds
        "last_transfer_bytes",   # winner's bytes-to-move estimate
        "est_err_abs_frac",      # fleet mean |estimator error| (EWMA-fed)
        "pool_scored",           # decisions with a fetchable pool prefix
        "last_pool_fetch_blocks",  # winner's pool-fetchable block count
        "health_scored",         # decisions with >=1 degraded candidate
        "last_pick_health",      # winner's health score (1.0 = healthy)
        "scheduled",
        "last_overlap_blocks",
        "last_required_blocks",
        "fallbacks",
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


ROUTER_STATS = RouterScoringStats()
