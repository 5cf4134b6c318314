"""Client-side view of a dependent service.

Copied from dynamo_tpu/sdk/client.py: a `depends()` edge resolves to lazy
per-endpoint runtime clients of the target service."""
from __future__ import annotations

from typing import Any, AsyncIterator, Dict


class ServiceClient:
    """Lazy per-endpoint runtime Clients for one dependent service."""

    def __init__(self, runtime, spec):
        self._rt = runtime
        self.spec = spec
        self._clients: Dict[str, Any] = {}

    async def _client(self, endpoint: str):
        cl = self._clients.get(endpoint)
        if cl is None:
            comp = self._rt.namespace(self.spec.namespace).component(
                self.spec.component)
            cl = comp.endpoint(endpoint).client()
            await cl.start()
            await cl.wait_for_instances()
            self._clients[endpoint] = cl
        return cl

    async def generate(self, request: Any, endpoint: str = "generate",
                       context=None) -> AsyncIterator:
        cl = await self._client(endpoint)
        return await cl.generate(request, context)

    async def stop(self) -> None:
        for cl in self._clients.values():
            await cl.stop()
        self._clients.clear()
