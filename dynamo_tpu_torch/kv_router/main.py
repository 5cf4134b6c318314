"""Standalone KV-aware router service.

Copied from dynamo_tpu/kv_router/main.py (the reference's
`components/router` binary): a dedicated process that keeps the radix index
and the load snapshot of a worker fleet (a KvRouter with the default
transfer-aware selector) and answers `route` queries over the request
plane, so that a frontend or processor without an embedded router can call
it as a service. The reply carries the chosen worker id and the overlap
evidence; the caller then dispatches to that worker directly. Every
decision's `kv-hit-rate` event is published on the worker component
(`{ns}.{component}.kv-hit-rate`, as in JAX), which the standalone exporter
folds into `llm_router_kv_hit_rate`.

Run: python -m dynamo_tpu_torch.kv_router.main \\
        --coordinator 127.0.0.1:<control port> --namespace ns \\
        --component worker [--router-component router] [--block-size 64]
(prints `READY router indexer=<native|python>`). A request is
`{"token_ids": [...]}`; the reply is `{"worker_id", "overlap_blocks",
"best_overlap_blocks"}` or `{"error"}`. A second endpoint, `state`, answers
any request with `{"indexer", "events_applied", "instances"}`: which radix
tree the index runs on, the events it applied and the live instances. The
coordinator may be an HA pair, "h1:p1,h2:p2"; the process ends with its
runtime (a lost lease: `EXIT router lease_lost=True`).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import logging

from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.utils.logconfig import configure_logging
from dynamo_tpu_torch.utils.settings import load_settings

log = logging.getLogger("dynamo_tpu_torch.router_main")


class RouterService:
    """Serves `route` queries backed by a KvRouter over a worker fleet."""

    def __init__(self, runtime, namespace: str, worker_component: str,
                 block_size: int, router_component: str = "router",
                 endpoint: str = "generate"):
        self.runtime = runtime
        self.namespace = namespace
        self.block_size = block_size
        self._worker_comp = runtime.namespace(namespace).component(
            worker_component)
        self._router_comp = runtime.namespace(namespace).component(
            router_component)
        self._client = None
        self.router: KvRouter = None
        self._endpoint_name = endpoint
        self._served = None
        self._served_state = None

    async def start(self) -> "RouterService":
        self._client = self._worker_comp.endpoint(
            self._endpoint_name).client()
        await self._client.start()
        # the router subscribes to the worker component's kv_events and
        # publishes its kv-hit-rate events there
        self.router = KvRouter(self._worker_comp, self._client,
                               self.block_size, publish_hit_events=True)
        await self.router.start()
        self._served = await self._router_comp.endpoint("route").serve(
            self._route)
        self._served_state = await self._router_comp.endpoint(
            "state").serve(self._state)
        return self

    async def stop(self) -> None:
        for served in (self._served, self._served_state):
            if served is not None:
                await served.shutdown()
        if self.router is not None:
            await self.router.stop()
        if self._client is not None:
            await self._client.stop()

    async def _state(self, request, context):
        yield {"indexer": self.router.indexer.kind,
               "events_applied": self.router.events_applied,
               "instances": sorted(self._client.instances)}

    async def _route(self, request, context):
        tokens = list(request.get("token_ids", ()))
        if not tokens:
            yield {"error": "token_ids required"}
            return
        overlap = self.router.find_matches_for_tokens(tokens)
        try:
            # KvRouter.schedule also publishes the decision's kv-hit-rate
            # event (publish_hit_events=True)
            worker_id = await self.router.schedule(tokens)
        except Exception as e:  # noqa: BLE001 — no live workers etc.
            yield {"error": f"{type(e).__name__}: {e}"}
            return
        best = max(overlap.scores.values(), default=0)
        yield {"worker_id": worker_id,
               "overlap_blocks": int(overlap.scores.get(worker_id, 0)),
               "best_overlap_blocks": int(best)}


async def _amain(args) -> None:
    from dynamo_tpu_torch.runtime.distributed import connect_coordinator
    runtime = await connect_coordinator(args.coordinator, "kv-router")
    svc = RouterService(runtime, args.namespace, args.component,
                        block_size=args.block_size,
                        router_component=args.router_component,
                        endpoint=args.endpoint)
    await svc.start()
    log.info("router serving %s/%s/route over %s/%s", args.namespace,
             args.router_component, args.namespace, args.component)
    print(f"READY router indexer={svc.router.indexer.kind}", flush=True)
    # the process ends with its runtime (a lost lease shuts it down)
    await runtime.shutdown_event.wait()
    await svc.stop()
    print(f"EXIT router lease_lost={runtime.lease_lost}", flush=True)


def main(argv=None) -> None:
    # layered defaults <- DYN_CONFIG file <- DYN_* env <- CLI flags
    # (utils/settings.py; e.g. DYN_ROUTER__BLOCK_SIZE=128)
    s = load_settings({"router": {
        "coordinator": "127.0.0.1:6230", "block_size": 64}}).router
    ap = argparse.ArgumentParser(description="dynamo-tpu standalone router")
    ap.add_argument("--coordinator", default=s.coordinator,
                    help="control plane host:port, or an HA pair "
                         "h1:p1,h2:p2")
    ap.add_argument("--namespace", required=True)
    ap.add_argument("--component", required=True,
                    help="worker component to route over")
    ap.add_argument("--router-component", default="router")
    ap.add_argument("--endpoint", default="generate")
    ap.add_argument("--block-size", type=int, default=s.block_size)
    args = ap.parse_args(argv)
    configure_logging()
    log.info("settings %s", json.dumps({
        "coordinator": args.coordinator, "block_size": args.block_size}))
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
