"""The port's standalone metrics exporter
(dynamo_tpu_torch/observability/exporter.py MetricsExporter) against the
JAX package's, on the CPU: the two cases of tests/test_metrics_exporter.py.

Each case runs the same script on each package's own stack (its in-process
memory plane, runtime, workers answering $STATS with the same dicts, a
router hit-rate event and a frontend reliability snapshot on the event
plane) and scrapes GET /metrics at the same points. The per-worker gauge
families, the fleet gauges (llm_workers, llm_load_*, the router hit rate)
and the reliability gauges must render the same lines; the JAX test's own
assertions then hold on the port's body. The process-global control-plane
and router counters are each package's own and are compared only where the
script sets them. Tolerance: exact equality of the rendered values.
"""
import asyncio

import pytest

from dynamo_tpu.observability.fleet import (
    parse_prometheus_text as jparse,
)


def _pkg(name):
    if name == "jax":
        from dynamo_tpu.frontend.reliability import ReliabilityMetrics
        from dynamo_tpu.kv_router.publisher import KV_HIT_RATE_SUBJECT
        from dynamo_tpu.observability.exporter import MetricsExporter
        from dynamo_tpu.runtime.cpstats import CP_STATS
        from dynamo_tpu.runtime.distributed import DistributedRuntime
        from dynamo_tpu.runtime.transports.memory import MemoryPlane
    else:
        from dynamo_tpu_torch.frontend.reliability import ReliabilityMetrics
        from dynamo_tpu_torch.kv_router.publisher import KV_HIT_RATE_SUBJECT
        from dynamo_tpu_torch.observability.exporter import MetricsExporter
        from dynamo_tpu_torch.runtime.cpstats import CP_STATS
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
        from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
    return dict(ReliabilityMetrics=ReliabilityMetrics,
                KV_HIT_RATE_SUBJECT=KV_HIT_RATE_SUBJECT,
                MetricsExporter=MetricsExporter, CP_STATS=CP_STATS,
                DistributedRuntime=DistributedRuntime,
                MemoryPlane=MemoryPlane)


async def fake_engine(request, context):
    yield {"ok": True}


async def _get_metrics(port: int) -> str:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /metrics HTTP/1.1\r\nhost: x\r\n\r\n")
    await writer.drain()
    head = b""
    while b"\r\n\r\n" not in head:
        head += await reader.read(65536)
    hdr, body = head.split(b"\r\n\r\n", 1)
    n = int([ln.split(b":")[1] for ln in hdr.split(b"\r\n")
             if ln.lower().startswith(b"content-length")][0])
    while len(body) < n:
        body += await reader.read(65536)
    writer.close()
    return hdr.decode() + "\r\n\r\n" + body.decode()


async def _two_worker_graph(name: str) -> list:
    m = _pkg(name)
    DRT = m["DistributedRuntime"]
    plane = m["MemoryPlane"]()
    rts = []
    pipe_stats = {"decode_windows": 4, "pipeline_windows": 3,
                  "pipeline_overlapped": 2, "pipeline_fallbacks": 1,
                  "decode_host_syncs": 4, "decode_plan_uploads": 1,
                  "engine_steps": 12, "engine_recompiles": 3,
                  "engine_tok_s": 250.5, "engine_pad_frac": 0.25}
    for i, (active, total) in enumerate(((3, 16), (5, 16))):
        rt = await DRT.create_local(plane, f"w{i}")
        ep = rt.namespace("ns").component("worker").endpoint("generate")
        extra = pipe_stats if i == 0 else {}
        await ep.serve(
            fake_engine,
            stats_handler=lambda a=active, t=total, e=extra: {
                "request_active_slots": 1, "request_total_slots": 4,
                "kv_active_blocks": a, "kv_total_blocks": t,
                "num_requests_waiting": 0,
                "gpu_cache_usage_perc": a / t,
                "gpu_prefix_cache_hit_rate": 0.5, **e})
        rts.append(rt)
    ert = await DRT.create_local(plane, "exporter")
    exporter = m["MetricsExporter"](ert, "ns", "worker", port=0,
                                    scrape_interval_s=0.05)
    await exporter.start()
    bodies = []
    try:
        await rts[0].namespace("ns").component("router").publish(
            m["KV_HIT_RATE_SUBJECT"],
            {"worker_id": "w0", "isl_blocks": 8, "overlap_blocks": 6})
        await asyncio.sleep(0.3)
        bodies.append(await _get_metrics(exporter.port))
        pipe_stats.update(decode_windows=11, pipeline_windows=10,
                          pipeline_overlapped=9, decode_host_syncs=10)
        rm = m["ReliabilityMetrics"]()
        rm.migrations.inc(value=3)
        rm.retries.inc(value=2)
        rm.breaker_opens.inc()
        rm.shed_requests.inc(value=5)
        rm.stall_fires.inc()
        await rm.publish(rts[0].namespace("ns").component("front0"))
        await asyncio.sleep(0.2)
        await rts[1].shutdown()
        await asyncio.sleep(0.3)
        bodies.append(await _get_metrics(exporter.port))
        cp = m["CP_STATS"]
        cp.indexer_nodes = 12345
        cp.router_degraded = 1
        cp.event_lag_seconds = 2.5
        bodies.append(await _get_metrics(exporter.port))
        cp.reset()
    finally:
        await exporter.stop()
        for rt in rts:
            await rt.shutdown()
        await ert.shutdown()
    return bodies


COMPARED = ("llm_requests_", "llm_kv_blocks_", "llm_kv_cache_usage",
            "llm_prefix_cache", "llm_window_", "llm_spec_", "llm_decode_",
            "llm_kv_page", "llm_kv_quant", "llm_kv_transfer", "llm_engine_",
            "llm_kv_stream_", "llm_load_", "llm_workers",
            "llm_router_kv_hit_rate", "llm_reliability_")


# the serving-path histograms each process observes in its own registry
SERVING_FAMILIES = ("llm_ttft_seconds", "llm_itl_seconds",
                    "llm_queue_wait_seconds", "llm_schedule_seconds",
                    "llm_kv_transfer_seconds")


def _compared(body: str) -> dict:
    fams = jparse(body.split("\r\n\r\n", 1)[1])
    return {k: v for k, v in fams.items()
            if k.startswith(COMPARED) and k not in SERVING_FAMILIES}


def test_exporter_two_worker_graph():
    want = asyncio.run(_two_worker_graph("jax"))
    body, body2, body3 = got = asyncio.run(_two_worker_graph("torch"))
    for w, g in zip(want, got):
        assert _compared(g) == _compared(w)
    assert "200 OK" in body
    assert 'llm_kv_blocks_active{worker="w0"} 3' in body
    assert 'llm_kv_blocks_active{worker="w1"} 5' in body
    assert 'llm_kv_blocks_total{worker="w0"} 16' in body
    assert "llm_workers 2" in body
    assert "llm_load_avg 4" in body
    assert "llm_router_kv_hit_rate 0.75" in body
    assert 'llm_decode_windows{worker="w0"} 4' in body
    assert 'llm_decode_pipeline_overlapped{worker="w0"} 2' in body
    assert 'llm_decode_pipeline_fallbacks{worker="w0"} 1' in body
    assert 'llm_decode_plan_uploads{worker="w0"} 1' in body
    # the ledger's figures a worker's $STATS carries
    assert 'llm_engine_steps{worker="w0"} 12' in body
    assert 'llm_engine_recompiles{worker="w0"} 3' in body
    assert 'llm_engine_tok_s{worker="w0"} 250.5' in body
    assert 'llm_kv_blocks_active{worker="w1"}' not in body2
    assert "llm_workers 1" in body2
    assert 'llm_decode_windows{worker="w0"} 11' in body2
    assert 'llm_decode_pipeline_overlapped{worker="w0"} 9' in body2
    assert 'llm_decode_host_syncs{worker="w0"} 10' in body2
    for line in ('migrations{source="front0"} 3',
                 'retries{source="front0"} 2',
                 'breaker_opens{source="front0"} 1',
                 'breaker_closes{source="front0"} 0',
                 'shed_requests{source="front0"} 5',
                 'stall_fires{source="front0"} 1',
                 'deadline_exceeded{source="front0"} 0'):
        assert "llm_reliability_" + line in body2
    assert "llm_cp_watch_queue_depth" in body2
    assert "llm_cp_router_degraded" in body2
    assert "llm_cp_indexer_nodes 12345" in body3
    assert "llm_cp_router_degraded 1" in body3
    assert "llm_cp_event_lag_seconds 2.5" in body3
    # the router scoring fields, JAX's and the port's own
    for name in ("transfer_scored", "cold_scored", "pool_scored",
                 "health_scored", "est_err_abs_frac", "scheduled",
                 "fallbacks"):
        assert f"llm_router_{name} " in body3


def _series_count(exporter) -> int:
    return sum(len(g._values) for g in exporter._worker_gauges())


async def _churn(name: str) -> list:
    m = _pkg(name)
    DRT = m["DistributedRuntime"]
    plane = m["MemoryPlane"]()
    ert = await DRT.create_local(plane, "exporter")
    exporter = m["MetricsExporter"](ert, "ns", "worker", port=0,
                                    scrape_interval_s=30.0)
    await exporter.start()
    counts = []
    try:
        for gen in range(3):
            rts = []
            for i in range(2):
                rt = await DRT.create_local(plane, f"gen{gen}-w{i}")
                ep = rt.namespace("ns").component("worker").endpoint(
                    "generate")
                await ep.serve(
                    fake_engine,
                    stats_handler=lambda: {
                        "request_active_slots": 1, "request_total_slots": 4,
                        "kv_active_blocks": 2, "kv_total_blocks": 16,
                        "num_requests_waiting": 0,
                        "gpu_cache_usage_perc": 0.1,
                        "gpu_prefix_cache_hit_rate": 0.5})
                rts.append(rt)
            await asyncio.sleep(0.05)
            await exporter._aggregator.scrape_once()
            counts.append(_series_count(exporter))
            for rt in rts:
                await rt.shutdown()
            await asyncio.sleep(0.05)
            counts.append(_series_count(exporter))
        return counts
    finally:
        await exporter.stop()
        await ert.shutdown()


def test_exporter_series_lifecycle_under_rolling_restart_churn():
    """Departed workers' per-instance series go at watch-event time, so a
    rolling restart cannot grow the series set; the same counts as the
    JAX exporter's, whose per-worker families the port renders all of."""
    want = asyncio.run(_churn("jax"))
    counts = asyncio.run(_churn("torch"))
    assert counts == want
    alive, dead = counts[0::2], counts[1::2]
    assert all(c == alive[0] > 0 for c in alive), counts
    assert all(c == 0 for c in dead), counts


@pytest.mark.parametrize("argv", [[], ["--namespace", "ns"]])
def test_exporter_and_router_cli_require_namespace_and_component(argv):
    from dynamo_tpu_torch.kv_router import main as router_main
    from dynamo_tpu_torch.observability import exporter
    for entry in (exporter.main, router_main.main):
        with pytest.raises(SystemExit):
            entry(argv)
