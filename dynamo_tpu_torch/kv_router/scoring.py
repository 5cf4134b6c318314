"""Aggregated per-worker load state consumed by the KV scheduler.

Copied from dynamo_tpu/kv_router/scoring.py: `ProcessedEndpoints`, the live
worker set with each worker's latest metrics and its load mean and spread
(the exporter's llm_load_avg / llm_load_std), and `WorkerMetrics`, the
reference's ForwardPassMetrics fields plus the counters the port's engine
reports (engine/scheduler.EngineMetrics, which the worker publishes as its
$STATS): windows, pipeline, spec, KV representation and transfer, the
step ledger, the KV tiers and streaming.
"""
from __future__ import annotations

import dataclasses
import statistics
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
    # KV transfer volume and the chunk-committed stream's counters (JAX
    # :47-58; runtime/integrity.XFER_STATS of the worker's process)
    kv_transfer_bytes: int = 0
    kv_transfer_fetches: int = 0
    kv_transfer_resumes: int = 0
    kv_transfer_salvaged_pages: int = 0
    kv_transfer_stale_chunks: int = 0
    kv_transfer_link_timeouts: int = 0
    # the per-step ledger's figures (observability/ledger.py, JAX :68-72):
    # committed steps, first-seen program keys, EWMA useful tok/s, MFU
    # (0 without DYN_PEAK_TFLOPS) and the padding-waste fraction; and the
    # KV tiers' occupancy (the fleet rollup's inputs)
    engine_steps: int = 0
    engine_recompiles: int = 0
    engine_tok_s: float = 0.0
    engine_mfu: float = 0.0
    engine_pad_frac: float = 0.0
    kv_host_pages_used: int = 0
    kv_host_pages_total: int = 0
    kv_disk_pages_used: int = 0
    kv_disk_pages_total: int = 0
    # streaming past the page budget (engine/streaming.py)
    kv_stream_steps: int = 0
    kv_stream_prefetch_hit: int = 0
    kv_stream_prefetch_late: int = 0
    kv_stream_pages_spilled: int = 0
    kv_stream_pages_quarantined: int = 0
    kv_stream_stall_steps: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "WorkerMetrics":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class ProcessedEndpoints:
    workers: Dict[str, WorkerMetrics] = dataclasses.field(default_factory=dict)

    @property
    def load_avg(self) -> float:
        if not self.workers:
            return 0.0
        return statistics.fmean(
            w.kv_active_blocks for w in self.workers.values())

    @property
    def load_std(self) -> float:
        if len(self.workers) < 2:
            return 0.0
        return statistics.pstdev(
            w.kv_active_blocks for w in self.workers.values())
