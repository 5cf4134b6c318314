"""Serving-path latency histograms: time to first token, inter-token
latency and the router's decision time.

Copied from dynamo_tpu/observability/serving.py, trimmed to the histograms
the port's serving path observes (TTFT and ITL in llm/pipeline._drive_n,
the schedule decision in kv_router/router.KvRouter.schedule, a disagg page
transfer in disagg/transfer.py and disagg/remote_transfer.py, the
admission wait in frontend/service.py) and `ttft_quantile`, the hedge
trigger's live TTFT percentile (frontend/reliability.py). One
process-global registry,
`SERVING`; the HTTP frontend appends `SERVING.render()` to its own
registry's output on GET /metrics.

Observation cost is one bucket scan under a lock per token frame, in the
asyncio layer around the engine: no device sync, nothing on the engine step
path.
"""
from __future__ import annotations

from typing import Optional

from dynamo_tpu_torch.observability.metrics import MetricsRegistry

# buckets sized to the quantity measured (the JAX package's ladders)
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, float("inf"))
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
               0.5, 1.0, float("inf"))
QUEUE_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                 5.0, 30.0, float("inf"))
SCHEDULE_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                    0.01, 0.05, 0.1, float("inf"))
TRANSFER_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                    float("inf"))


class ServingMetrics:
    """The serving-path histograms on one registry.

    - llm_ttft_seconds{model, qos}: request start -> first token-carrying
      frame of each choice stream, by the request's QoS class
      (runtime/qos.py; unclassed requests label as the policy default).
    - llm_itl_seconds{model, qos}: the gap between successive
      token-carrying frames of one choice stream (the commit boundary).
    - llm_queue_wait_seconds{qos}: admission-gate wait at the frontend.
    - llm_schedule_seconds: one KvRouter.schedule decision.
    - llm_kv_transfer_seconds: one disagg page transfer, send side
      (local or remote backend), staging -> last ack.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.ttft = r.histogram(
            "llm_ttft_seconds", "time to first token frame",
            ("model", "qos"), buckets=TTFT_BUCKETS)
        self.itl = r.histogram(
            "llm_itl_seconds",
            "inter-token latency at the frame boundary",
            ("model", "qos"), buckets=ITL_BUCKETS)
        self.queue_wait = r.histogram(
            "llm_queue_wait_seconds",
            "admission-gate wait before the request runs", ("qos",),
            buckets=QUEUE_BUCKETS)
        self.schedule = r.histogram(
            "llm_schedule_seconds", "worker-selection decision time",
            buckets=SCHEDULE_BUCKETS)
        self.kv_transfer = r.histogram(
            "llm_kv_transfer_seconds",
            "disagg KV page transfer, send side (stage -> last ack)",
            buckets=TRANSFER_BUCKETS)

    def render(self) -> str:
        return self.registry.render()

    def reset(self) -> None:
        """Fresh registry + histograms (test isolation). Call sites read
        SERVING.<name> at observation time, so re-pointing the attributes
        is enough."""
        self.__init__()


SERVING = ServingMetrics()


def ttft_quantile(q: float, qos: str = "") -> float:
    """Live TTFT quantile: the QoS class's view when that class has
    observations, the fleet-wide view otherwise; NaN only when the
    histogram is empty. The hedge trigger's adaptive delay."""
    v = float("nan")
    if qos:
        v = SERVING.ttft.quantile_label(q, "qos", qos)
    if not (v == v):
        v = SERVING.ttft.quantile_all(q)
    return v
