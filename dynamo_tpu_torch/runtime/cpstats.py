"""Process-local control-plane health counters (/metrics: llm_cp_*).

Copied whole from dynamo_tpu/runtime/cpstats.py (the port has no
standalone exporter yet; the frontend's /metrics folds these).

Same pattern as runtime.component.DRAIN_STATS and runtime.integrity.STATS:
plain ints bumped on the hot paths, folded into Prometheus gauges at
/metrics render time by frontend/service.py and observability/exporter.py.
The sources:

- the Client watch pump (runtime/component.py): queue depth, events
  applied, events coalesced away by per-tick batching, resyncs after a
  watch-stream disconnect;
- the KV indexer (kv_router/indexer.py): live radix node count and the
  incremental-eviction backlog;
- the KvRouter event pump (kv_router/router.py): event-plane lag
  (publish ts → apply time), event backlog, and the stale-snapshot
  degraded-mode flag + transition count.

Values are process-local and last-writer-wins across multiple watchers /
indexers in one process — they answer "is THIS process's control plane
healthy", which is the per-instance question /metrics exists for.
"""
from __future__ import annotations


class ControlPlaneStats:
    FIELDS = (
        "watch_queue_depth",        # latest observed watch backlog
        "watch_events_applied",     # cumulative events applied
        "watch_events_coalesced",   # cumulative events folded by batching
        "watch_resyncs",            # watch-stream deaths -> snapshot resyncs
        "indexer_nodes",            # live radix-tree nodes
        "indexer_eviction_backlog", # nodes queued for incremental eviction
        "event_lag_seconds",        # newest applied event: now - publish ts
        "event_backlog",            # latest kv-event queue depth
        "router_degraded",          # 1 while in stale-snapshot degraded mode
        "router_degraded_entries",  # cumulative degraded-mode entries
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


CP_STATS = ControlPlaneStats()
