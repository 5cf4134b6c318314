"""Process-local router counters (/metrics: llm_router_*).

The counterpart of dynamo_tpu/kv_router/stats.py (ROUTER_STATS): plain
numbers bumped on the routing path and folded into gauges when the
frontend renders /metrics (frontend/service.py). The JAX fields describe
its transfer-aware selector (transfer-cost, pool and health terms), which
the port leaves out with the disaggregated data plane; the port's fields
describe what its prefix-and-load selector and the raw dispatch path do:

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
