"""Aggregated per-worker load state consumed by the KV scheduler.

Copied from dynamo_tpu/kv_router/scoring.py: `ProcessedEndpoints`, the live
worker set with each worker's latest metrics (its load mean and spread,
which nothing in the port reads, are left out), and `WorkerMetrics`, the
reference's ForwardPassMetrics fields plus the counters the port's engine
reports (engine/scheduler.EngineMetrics, which the worker publishes). The
JAX record's KV-transfer, ledger, offload-tier and streaming fields are
left out with the slices that bring those counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class WorkerMetrics:
    # the reference's ForwardPassMetrics
    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    # the port engine's counters (engine/scheduler.EngineMetrics)
    gpu_prefix_cache_hits: int = 0
    gpu_prefix_cache_lookups: int = 0
    requests_admitted: int = 0
    window_slot_steps: int = 0
    window_wasted_steps: int = 0
    decode_windows: int = 0
    decode_host_syncs: int = 0
    decode_dispatches: int = 0
    decode_plan_uploads: int = 0
    pipeline_windows: int = 0
    pipeline_overlapped: int = 0
    pipeline_fallbacks: int = 0
    mixed_steps: int = 0
    decode_stall_steps: int = 0
    # speculative decoding (JAX ForwardPassMetrics :33-35, and the verify
    # count): acceptance = accepted / proposed
    spec_steps: int = 0
    spec_proposed_tokens: int = 0
    spec_accepted_tokens: int = 0
    kv_page_bytes: int = 0
    kv_quant_bits: int = 0
    weight_bytes: int = 0
    weight_quant_bits: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "WorkerMetrics":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class ProcessedEndpoints:
    workers: Dict[str, WorkerMetrics] = dataclasses.field(default_factory=dict)
