"""Service-graph SDK: declare a deployment's services in Python, launch them.

Copied from dynamo_tpu/sdk/__init__.py: a service is a plain class
(`@service`), endpoints are async-generator methods (`@endpoint`),
`depends()` edges resolve to runtime clients at start-up, `@async_on_start`
hooks build engines, and the supervisor (`python -m
dynamo_tpu_torch.sdk.serve`) starts one process per service against the
control-plane server. `sdk/build.py` writes a docker-buildable bundle and
renders the graph's K8s manifests, and `sdk/reconcile.py` keeps them
applied.
"""
from dynamo_tpu_torch.sdk.config import ServiceConfig
from dynamo_tpu_torch.sdk.service import (
    Depends, async_on_start, depends, endpoint, service,
)

__all__ = ["service", "endpoint", "depends", "Depends", "async_on_start",
           "ServiceConfig"]
