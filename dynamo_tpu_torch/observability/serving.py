"""Serving-path latency histograms: time to first token and inter-token
latency.

Copied from dynamo_tpu/observability/serving.py, trimmed to the two
histograms the port's serving path observes (llm/pipeline._drive_n): the
queue-wait, schedule and transfer histograms wait for the admission,
router and disagg slices that observe them. One process-global registry,
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


class ServingMetrics:
    """The serving-path histograms on one registry.

    - llm_ttft_seconds{model, qos}: request start -> first token-carrying
      frame of each choice stream, by the request's QoS class
      (runtime/qos.py; unclassed requests label as the policy default).
    - llm_itl_seconds{model, qos}: the gap between successive
      token-carrying frames of one choice stream (the commit boundary).
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

    def render(self) -> str:
        return self.registry.render()

    def reset(self) -> None:
        """Fresh registry + histograms (test isolation). Call sites read
        SERVING.<name> at observation time, so re-pointing the attributes
        is enough."""
        self.__init__()


SERVING = ServingMetrics()
