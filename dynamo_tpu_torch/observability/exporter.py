"""Standalone metrics exporter: scrapes worker load metrics into Prometheus.

Copied from dynamo_tpu/observability/exporter.py (the reference's
`components/metrics` binary): a separate process that watches a
component's live instances, scrapes each worker's $STATS (WorkerMetrics)
through the stats plane, folds them into ProcessedEndpoints, and serves
Prometheus gauges (`llm_kv_blocks_*`, `llm_requests_*`, the decode
pipeline, the KV representation and transfer, the engine ledger's
`llm_engine_*`, streaming, load avg/std) on GET /metrics. It subscribes to
the namespace's event plane for the router's `kv-hit-rate` events
(`llm_router_kv_hit_rate`) and the frontends' reliability snapshots
(`llm_reliability_*{source}`), and folds this process's control-plane,
router, shared-pool, pool-service and fail-slow counters at render. A
departed or draining worker's series go at its watch event.

The closed-loop autoscaler's `llm_autoscaler_*` (runtime/autoscaler.py
AUTOSCALER_STATS, JAX :206-212, :449-451) are folded the same way: when
this process hosts the controller they are its decision health, otherwise
they render 0. The coordinator may be an HA pair, "h1:p1,h2:p2"; the
process ends with its runtime (a lost lease: `EXIT exporter
lease_lost=True`).

Run: python -m dynamo_tpu_torch.observability.exporter \
        --coordinator 127.0.0.1:<control port> --namespace ns \
        --component worker [--endpoint generate] [--port 9091]
(prints `READY metrics=:<port>`).
"""
from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Optional

from dynamo_tpu_torch.kv_router.publisher import (
    KV_HIT_RATE_SUBJECT, KvMetricsAggregator,
)
from dynamo_tpu_torch.observability.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.transports.codec import unpackb

log = logging.getLogger("dynamo_tpu_torch.metrics_exporter")

PREFIX = "llm"


class MetricsExporter:
    """Aggregator + Prometheus endpoint for one component's worker fleet."""

    def __init__(self, runtime, namespace: str, component: str,
                 endpoint: str = "generate", port: int = 9091,
                 scrape_interval_s: float = 0.5):
        self.runtime = runtime
        self.namespace, self.component_name = namespace, component
        self.endpoint_name = endpoint
        self.port = port
        self._interval_s = scrape_interval_s
        self.registry = MetricsRegistry()
        labels = ("worker",)
        r = self.registry
        self.g_active_slots = r.gauge(
            f"{PREFIX}_requests_active_slots",
            "Decode slots currently generating", labels)
        self.g_total_slots = r.gauge(
            f"{PREFIX}_requests_total_slots", "Decode slot capacity", labels)
        self.g_kv_active = r.gauge(
            f"{PREFIX}_kv_blocks_active", "KV pages in use", labels)
        self.g_kv_total = r.gauge(
            f"{PREFIX}_kv_blocks_total", "KV page capacity", labels)
        self.g_waiting = r.gauge(
            f"{PREFIX}_requests_waiting", "Requests queued for prefill",
            labels)
        self.g_usage = r.gauge(
            f"{PREFIX}_kv_cache_usage_percent",
            "KV cache usage fraction [0,1]", labels)
        self.g_hit_rate = r.gauge(
            f"{PREFIX}_prefix_cache_hit_rate",
            "Worker-reported prefix cache hit rate", labels)
        self.g_window_steps = r.gauge(
            f"{PREFIX}_window_slot_steps",
            "Cumulative decode-window (step, slot) pairs run", labels)
        self.g_window_wasted = r.gauge(
            f"{PREFIX}_window_wasted_steps",
            "Of those, steps after the slot's request finished", labels)
        self.g_spec_proposed = r.gauge(
            f"{PREFIX}_spec_proposed_tokens",
            "Cumulative speculative draft tokens verified", labels)
        self.g_spec_accepted = r.gauge(
            f"{PREFIX}_spec_accepted_tokens",
            "Of those, drafts accepted (free decode tokens)", labels)
        # overlapped decode pipeline occupancy (engine pipelined loop):
        # overlapped/pipelined is the live host-overlap rate; fallbacks
        # count reconciliation discards; plan_uploads staying flat while
        # windows climbs is the zero-upload steady-state invariant
        self.g_pipe = {
            name: r.gauge(f"{PREFIX}_decode_{name}", help_, labels)
            for name, help_ in (
                ("windows", "Decode windows dispatched"),
                ("pipeline_windows",
                 "Of those, committed via the overlapped pipeline"),
                ("pipeline_overlapped",
                 "Commits that ran while a follow-up window executed"),
                ("pipeline_fallbacks",
                 "In-flight windows discarded on membership change"),
                ("host_syncs", "Blocking output fetches in decode"),
                ("plan_uploads", "Windows that staged fresh host arrays"),
                ("mixed_steps",
                 "Fused prefill+decode device steps run"),
                ("stall_steps",
                 "Steps where running streams emitted nothing (decode "
                 "stalled by a prefill-only step)"),
            )}
        # KV representation gauges (ops/kv_quant.py): page HBM footprint,
        # quant mode bit width (0 = unquantized, 8 = int8 pages), and
        # transfer volume in the wire representation — bytes_per_fetch is
        # the disagg handoff cost the kv_quant capacity bench halves
        self.g_kv_repr = {
            name: r.gauge(f"{PREFIX}_kv_{name}", help_, labels)
            for name, help_ in (
                ("page_bytes", "HBM bytes per KV page (k+v+scales)"),
                ("quant_mode",
                 "KV page quant bit width (0 = unquantized, 8 = int8)"),
                ("transfer_bytes",
                 "Cumulative KV transfer payload bytes (wire "
                 "representation: quantized on kv_quant engines)"),
                ("transfer_fetches", "Cumulative KV transfer fetches"),
                ("transfer_bytes_per_fetch",
                 "Mean KV transfer payload bytes per fetch"),
                # chunk-committed streaming (disagg/remote_transfer.py)
                ("transfer_resumes",
                 "KV transfers resumed from a committed frontier "
                 "(link failure or replacement sender)"),
                ("transfer_salvaged_pages",
                 "Committed-prefix pages re-used by decode-side salvage "
                 "instead of local re-prefill"),
                ("transfer_stale_chunks",
                 "Transfer chunks rejected by the alloc-epoch fence "
                 "(stale sender after realloc)"),
                ("transfer_link_timeouts",
                 "Per-IO socket timeouts treated as transfer link death"),
            )}
        # per-step ledger figures (observability/ledger.py via
        # EngineMetrics): committed steps, recompile events, EWMA tok/s,
        # MFU estimate, padding-waste fraction, offload tier occupancy
        self.g_engine = {
            name: r.gauge(f"{PREFIX}_engine_{name}", help_, labels)
            for name, help_ in (
                ("steps", "Device steps committed (ledger samples)"),
                ("recompiles",
                 "New (program, bucket) keys dispatched (XLA compiles)"),
                ("tok_s", "EWMA instantaneous useful tokens/s"),
                ("mfu", "Model FLOPs utilization estimate (0 = no peak "
                        "configured)"),
                ("pad_frac",
                 "Cumulative bucket-ladder padding-waste fraction"),
                ("host_pages_used", "Host-DRAM KV tier pages in use"),
                ("host_pages_total", "Host-DRAM KV tier page capacity"),
                ("disk_pages_used", "Disk KV tier pages in use"),
                ("disk_pages_total", "Disk KV tier page capacity"),
            )}
        # tiered-KV streaming decode (engine/streaming.py via
        # EngineMetrics): contexts beyond the HBM page budget — prefetch
        # hit/late is the double-buffer health signal (hit >> late on a
        # well-provisioned tier), quarantines count verify-on-fetch rot
        self.g_kv_stream = {
            name: r.gauge(f"{PREFIX}_kv_stream_{name}", help_, labels)
            for name, help_ in (
                ("steps", "Streamed decode/prefill steps run"),
                ("prefetch_hit",
                 "Window-pool segment consumes served by a completed "
                 "double-buffer prefetch"),
                ("prefetch_late",
                 "Window-pool segment consumes that staged synchronously "
                 "(prefetch missed the compute window)"),
                ("pages_spilled",
                 "Resident KV pages spilled to the offload hierarchy by "
                 "the attention-mass EWMA policy"),
                ("pages_quarantined",
                 "Cold pages that failed the verify-on-fetch checksum "
                 "gate (each recomputed from its token span)"),
                ("stall_steps",
                 "Streamed steps that consumed at least one late "
                 "segment"),
            )}
        self.g_load_avg = r.gauge(
            f"{PREFIX}_load_avg", "Mean active KV blocks across workers")
        self.g_load_std = r.gauge(
            f"{PREFIX}_load_std", "Stddev of active KV blocks across workers")
        self.g_workers = r.gauge(
            f"{PREFIX}_workers", "Live worker instances")
        self.g_router_hit = r.gauge(
            f"{PREFIX}_router_kv_hit_rate",
            "ISL-weighted router overlap rate (kv-hit-rate events)")
        # reliability layer counters (frontend/reliability.py), published
        # as snapshots on "{ns}.{component}.reliability" by each frontend;
        # gauges mirror the source's counters, labeled by publisher
        from dynamo_tpu_torch.frontend.reliability import ReliabilityMetrics
        self.g_reliability = {
            name: r.gauge(f"{PREFIX}_reliability_{name}",
                          f"reliability layer: cumulative {name} "
                          "at the publishing frontend", ("source",))
            for name in ReliabilityMetrics.FIELDS}
        # control-plane health of THIS exporter process (its own Client
        # watch + aggregator — the same watch fan-out every frontend
        # runs, so its lag/resync counters are a representative canary);
        # refreshed from runtime/cpstats.py CP_STATS at render time
        from dynamo_tpu_torch.runtime.cpstats import ControlPlaneStats
        self.g_cp = {
            name: r.gauge(f"{PREFIX}_cp_{name}",
                          f"control plane: {name.replace('_', ' ')}")
            for name in ControlPlaneStats.FIELDS}
        # transfer-aware router scoring counters (kv_router/stats.py),
        # same render-time refresh — when the exporter process hosts a
        # router these are its scoring health, otherwise they render 0
        from dynamo_tpu_torch.kv_router.stats import RouterScoringStats
        self.g_router = {
            name: r.gauge(f"{PREFIX}_router_{name}",
                          f"router scoring: {name.replace('_', ' ')}")
            for name in RouterScoringStats.FIELDS}
        # closed-loop autoscaler counters (runtime/autoscaler.py), same
        # render-time refresh
        from dynamo_tpu_torch.runtime.autoscaler import AutoscalerStats
        self.g_autoscaler = {
            name: r.gauge(f"{PREFIX}_autoscaler_{name}",
                          f"fleet autoscaler: {name.replace('_', ' ')}")
            for name in AutoscalerStats.FIELDS}
        # cluster-wide shared KV pool counters (engine/kv_pool.py), same
        # render-time refresh — when this process hosts the pool (or a
        # publishing/fetching engine) these are its reuse health
        from dynamo_tpu_torch.engine.kv_pool import KvPoolStats
        self.g_kv_pool = {
            name: r.gauge(f"{PREFIX}_kv_pool_{name}",
                          f"shared kv pool: {name.replace('_', ' ')}")
            for name in KvPoolStats.FIELDS}
        # cross-host pool service (engine/pool_service.py): remote
        # fetch/failover/quorum health + placement-ring membership and
        # rebalance progress, same render-time refresh
        from dynamo_tpu_torch.engine.pool_service import (
            PoolRingStats, RemotePoolStats,
        )
        self.g_kv_pool_remote = {
            name: r.gauge(f"{PREFIX}_kv_pool_remote_{name}",
                          f"cross-host kv pool: {name.replace('_', ' ')}")
            for name in RemotePoolStats.FIELDS}
        self.g_pool_ring = {
            name: r.gauge(f"{PREFIX}_pool_ring_{name}",
                          f"pool placement ring: {name.replace('_', ' ')}")
            for name in PoolRingStats.FIELDS}
        # fail-slow plane (runtime/health.py): gray-failure detection
        # counters (HEALTH_STATS) + hedged-dispatch outcomes
        # (HEDGE_STATS), same render-time refresh — live when this
        # process hosts a reliability layer or scorer, 0 otherwise
        from dynamo_tpu_torch.runtime.health import HealthStats, HedgeStats
        self.g_health = {
            name: r.gauge(f"{PREFIX}_health_{name}",
                          f"fail-slow detection: {name.replace('_', ' ')}")
            for name in HealthStats.FIELDS}
        self.g_hedge = {
            name: r.gauge(f"{PREFIX}_hedge_{name}",
                          f"hedged dispatch: {name.replace('_', ' ')}")
            for name in HedgeStats.FIELDS}
        self.g_hedge_by_class = r.gauge(
            f"{PREFIX}_hedge_fired_by_class",
            "hedged dispatch: hedges fired per QoS class", ("qos",))
        self._client = None
        self._aggregator: Optional[KvMetricsAggregator] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._sub_task: Optional[asyncio.Task] = None
        # cumulative KVHitRateEvent totals (reference lib.rs:433-512)
        self._hit_isl = 0
        self._hit_overlap = 0

    async def start(self) -> "MetricsExporter":
        ep = self.runtime.namespace(self.namespace).component(
            self.component_name).endpoint(self.endpoint_name)
        self._client = ep.client()
        await self._client.start()
        # watch-event series eviction: delete/draining events drop the
        # instance's label series immediately (the scrape-driven
        # `removed` pass below stays as the backstop)
        self._client.add_listener(self._on_instance)
        self._aggregator = KvMetricsAggregator(
            self._client, interval_s=self._interval_s)
        self._aggregator.on_update(self._on_update)
        await self._aggregator.start()
        # the router publishes kv-hit-rate on ITS component subject
        # ({ns}.{router_component}.kv-hit-rate); subscribe with a namespace
        # wildcard and filter, so the exporter needn't know the router name
        raw = await self.runtime.messaging.subscribe(f"{self.namespace}.>")
        self._sub_task = asyncio.create_task(self._consume_hit_rate(raw))
        self._server = await asyncio.start_server(
            self._serve_http, "0.0.0.0", self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._aggregator:
            await self._aggregator.stop()
        if self._sub_task:
            self._sub_task.cancel()
        if self._client is not None:
            await self._client.stop()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # -- aggregation ----------------------------------------------------------

    def _worker_gauges(self):
        """Every per-instance gauge family (the ('worker',) label set)."""
        return (self.g_active_slots, self.g_total_slots,
                self.g_kv_active, self.g_kv_total, self.g_waiting,
                self.g_usage, self.g_hit_rate, self.g_window_steps,
                self.g_window_wasted, self.g_spec_proposed,
                self.g_spec_accepted, *self.g_pipe.values(),
                *self.g_kv_repr.values(), *self.g_engine.values(),
                *self.g_kv_stream.values())

    def _evict_worker_series(self, worker_id: str) -> None:
        for g in self._worker_gauges():
            g.remove(worker_id)

    def _on_instance(self, kind: str, worker_id: str, info) -> None:
        """Watch-event label-series eviction (the kv_router's
        `on_instance` pattern): a departed or draining worker's
        per-instance series drop the moment its delete/draining event
        is APPLIED — not a scrape interval later. Without this, a
        scrape loop that stalls (or a fleet that churns faster than it
        scrapes) leaks one series set per dead instance and the
        exporter's /metrics grows without bound (rolling-restart churn
        test in tests/test_metrics_exporter.py)."""
        from dynamo_tpu_torch.runtime.component import STATUS_DRAINING
        if kind == "delete" or (
                info is not None and info.get("status") == STATUS_DRAINING):
            self._evict_worker_series(worker_id)

    def _on_update(self, endpoints, removed) -> None:
        for worker_id in removed:
            self._evict_worker_series(worker_id)
        for worker_id, m in endpoints.workers.items():
            self.g_active_slots.set(worker_id, value=m.request_active_slots)
            self.g_total_slots.set(worker_id, value=m.request_total_slots)
            self.g_kv_active.set(worker_id, value=m.kv_active_blocks)
            self.g_kv_total.set(worker_id, value=m.kv_total_blocks)
            self.g_waiting.set(worker_id, value=m.num_requests_waiting)
            self.g_usage.set(worker_id, value=m.gpu_cache_usage_perc)
            self.g_hit_rate.set(worker_id,
                                value=m.gpu_prefix_cache_hit_rate)
            self.g_window_steps.set(worker_id, value=m.window_slot_steps)
            self.g_window_wasted.set(worker_id,
                                     value=m.window_wasted_steps)
            self.g_spec_proposed.set(worker_id,
                                     value=m.spec_proposed_tokens)
            self.g_spec_accepted.set(worker_id,
                                     value=m.spec_accepted_tokens)
            self.g_pipe["windows"].set(worker_id, value=m.decode_windows)
            self.g_pipe["pipeline_windows"].set(
                worker_id, value=m.pipeline_windows)
            self.g_pipe["pipeline_overlapped"].set(
                worker_id, value=m.pipeline_overlapped)
            self.g_pipe["pipeline_fallbacks"].set(
                worker_id, value=m.pipeline_fallbacks)
            self.g_pipe["host_syncs"].set(
                worker_id, value=m.decode_host_syncs)
            self.g_pipe["plan_uploads"].set(
                worker_id, value=m.decode_plan_uploads)
            self.g_pipe["mixed_steps"].set(
                worker_id, value=m.mixed_steps)
            self.g_pipe["stall_steps"].set(
                worker_id, value=m.decode_stall_steps)
            self.g_kv_repr["page_bytes"].set(
                worker_id, value=m.kv_page_bytes)
            self.g_kv_repr["quant_mode"].set(
                worker_id, value=m.kv_quant_bits)
            self.g_kv_repr["transfer_bytes"].set(
                worker_id, value=m.kv_transfer_bytes)
            self.g_kv_repr["transfer_fetches"].set(
                worker_id, value=m.kv_transfer_fetches)
            self.g_kv_repr["transfer_bytes_per_fetch"].set(
                worker_id,
                value=(m.kv_transfer_bytes / m.kv_transfer_fetches
                       if m.kv_transfer_fetches else 0.0))
            self.g_kv_repr["transfer_resumes"].set(
                worker_id, value=m.kv_transfer_resumes)
            self.g_kv_repr["transfer_salvaged_pages"].set(
                worker_id, value=m.kv_transfer_salvaged_pages)
            self.g_kv_repr["transfer_stale_chunks"].set(
                worker_id, value=m.kv_transfer_stale_chunks)
            self.g_kv_repr["transfer_link_timeouts"].set(
                worker_id, value=m.kv_transfer_link_timeouts)
            self.g_engine["steps"].set(worker_id, value=m.engine_steps)
            self.g_engine["recompiles"].set(
                worker_id, value=m.engine_recompiles)
            self.g_engine["tok_s"].set(worker_id, value=m.engine_tok_s)
            self.g_engine["mfu"].set(worker_id, value=m.engine_mfu)
            self.g_engine["pad_frac"].set(
                worker_id, value=m.engine_pad_frac)
            self.g_engine["host_pages_used"].set(
                worker_id, value=m.kv_host_pages_used)
            self.g_engine["host_pages_total"].set(
                worker_id, value=m.kv_host_pages_total)
            self.g_engine["disk_pages_used"].set(
                worker_id, value=m.kv_disk_pages_used)
            self.g_engine["disk_pages_total"].set(
                worker_id, value=m.kv_disk_pages_total)
            self.g_kv_stream["steps"].set(
                worker_id, value=m.kv_stream_steps)
            self.g_kv_stream["prefetch_hit"].set(
                worker_id, value=m.kv_stream_prefetch_hit)
            self.g_kv_stream["prefetch_late"].set(
                worker_id, value=m.kv_stream_prefetch_late)
            self.g_kv_stream["pages_spilled"].set(
                worker_id, value=m.kv_stream_pages_spilled)
            self.g_kv_stream["pages_quarantined"].set(
                worker_id, value=m.kv_stream_pages_quarantined)
            self.g_kv_stream["stall_steps"].set(
                worker_id, value=m.kv_stream_stall_steps)
        self.g_load_avg.set(value=endpoints.load_avg)
        self.g_load_std.set(value=endpoints.load_std)
        self.g_workers.set(value=len(endpoints.workers))

    async def _consume_hit_rate(self, sub) -> None:
        from dynamo_tpu_torch.frontend.reliability import RELIABILITY_SUBJECT
        try:
            async for subject, payload in sub:
                if subject.endswith("." + RELIABILITY_SUBJECT):
                    # "{ns}.{source}.reliability": counter snapshot from a
                    # frontend's reliability layer
                    snap = unpackb(payload)
                    source = subject.split(".")[-2] if subject.count(".") \
                        >= 2 else "unknown"
                    for name, gauge in self.g_reliability.items():
                        if name in snap:
                            gauge.set(source, value=float(snap[name]))
                    continue
                if not subject.endswith("." + KV_HIT_RATE_SUBJECT):
                    continue
                payload = unpackb(payload)
                isl = int(payload.get("isl_blocks", 0))
                overlap = int(payload.get("overlap_blocks", 0))
                self._hit_isl += isl
                self._hit_overlap += overlap
                if self._hit_isl:
                    self.g_router_hit.set(
                        value=self._hit_overlap / self._hit_isl)
        except asyncio.CancelledError:
            pass
        finally:
            aclose = getattr(sub, "aclose", None)
            if aclose is not None:
                await aclose()

    def _refresh_cp_gauges(self) -> None:
        from dynamo_tpu_torch.runtime.cpstats import CP_STATS
        for name, value in CP_STATS.snapshot().items():
            self.g_cp[name].set(value=float(value))
        from dynamo_tpu_torch.kv_router.stats import ROUTER_STATS
        for name, value in ROUTER_STATS.snapshot().items():
            self.g_router[name].set(value=float(value))
        from dynamo_tpu_torch.runtime.autoscaler import AUTOSCALER_STATS
        for name, value in AUTOSCALER_STATS.snapshot().items():
            self.g_autoscaler[name].set(value=float(value))
        from dynamo_tpu_torch.engine.kv_pool import POOL_STATS
        for name, value in POOL_STATS.snapshot().items():
            self.g_kv_pool[name].set(value=float(value))
        from dynamo_tpu_torch.engine.pool_service import (
            REMOTE_STATS as POOL_REMOTE, RING_STATS as POOL_RING,
        )
        for name, value in POOL_REMOTE.snapshot().items():
            self.g_kv_pool_remote[name].set(value=float(value))
        for name, value in POOL_RING.snapshot().items():
            self.g_pool_ring[name].set(value=float(value))
        from dynamo_tpu_torch.runtime.health import (
            HEALTH_STATS, HEDGE_STATS, HealthStats, HedgeStats,
        )
        for name in HealthStats.FIELDS:
            self.g_health[name].set(value=float(getattr(HEALTH_STATS, name)))
        for name in HedgeStats.FIELDS:
            self.g_hedge[name].set(value=float(getattr(HEDGE_STATS, name)))
        for cls, n in HEDGE_STATS.fired_by_class.items():
            self.g_hedge_by_class.set(cls, value=float(n))

    # -- http -----------------------------------------------------------------

    async def _serve_http(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            # bounded reads: an idle probe connection must not pin the
            # handler open (3.12 Server.wait_closed waits for ALL
            # connections, so it would hang stop())
            line = await asyncio.wait_for(reader.readline(), 5.0)
            while (await asyncio.wait_for(reader.readline(), 5.0)) \
                    not in (b"\r\n", b"\n", b""):
                pass  # drain headers
            if b"/metrics" in line:
                self._refresh_cp_gauges()
                # serving-path histograms (TTFT/ITL/queue/schedule/
                # transfer) observed in-process fold in at render, the
                # same way the frontend's /metrics appends them
                from dynamo_tpu_torch.observability.serving import SERVING
                body = (self.registry.render() + SERVING.render()).encode()
                writer.write(
                    b"HTTP/1.1 200 OK\r\ncontent-type: text/plain; "
                    b"version=0.0.4\r\ncontent-length: %d\r\n\r\n%s"
                    % (len(body), body))
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"content-length: 0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        finally:
            writer.close()


async def _amain(args) -> None:
    from dynamo_tpu_torch.runtime.distributed import connect_coordinator
    runtime = await connect_coordinator(args.coordinator, "metrics-exporter")
    exporter = MetricsExporter(
        runtime, args.namespace, args.component, endpoint=args.endpoint,
        port=args.port, scrape_interval_s=args.interval)
    await exporter.start()
    log.info("metrics exporter on :%d scraping %s/%s/%s", exporter.port,
             args.namespace, args.component, args.endpoint)
    print(f"READY metrics=:{exporter.port}", flush=True)
    # the process ends with its runtime (a lost lease shuts it down)
    await runtime.shutdown_event.wait()
    await exporter.stop()
    print(f"EXIT exporter lease_lost={runtime.lease_lost}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dynamo-tpu metrics exporter")
    ap.add_argument("--coordinator", default="127.0.0.1:6230",
                    help="control plane host:port, or an HA pair "
                         "h1:p1,h2:p2")
    ap.add_argument("--namespace", required=True)
    ap.add_argument("--component", required=True)
    ap.add_argument("--endpoint", default="generate")
    ap.add_argument("--port", type=int, default=9091,
                    help="HTTP port of /metrics (0: any free port)")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="seconds between $STATS scrapes")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
