"""Standalone OpenAI HTTP frontend: watches the model registry and serves.

Copied from dynamo_tpu/frontend/serve.py: connect to the control plane,
watch the registered models (frontend/discovery.ModelWatcher), route each
request of a KV-routed model to the worker that holds the longest cached
prefix of it (kv_router/router.KvRouter), and serve the OpenAI routes.
`--no-kv-routing` dispatches round-robin instead. Every request goes
through the reliability layer (frontend/reliability.py: migration,
retries, the circuit breaker, deadlines).

Environment knobs, read as the JAX frontend reads them (serve.py:23-50),
also by `run.py in=http`:
  DYN_MAX_INFLIGHT        concurrently admitted requests (0 / unset: no
                          shedding); past it requests queue, then 429
  DYN_ADMISSION_QUEUE     the wait line behind the cap (default 64)
  DYN_RETRY_AFTER_S       the retry-after of a shed request (default 1)
  DYN_REQUEST_DEADLINE_S  an end-to-end deadline armed on every request
  DYN_QOS=1               class-aware weighted-fair admission over the
                          default class table (runtime/qos.py); the
                          x-qos-class header names a request's class

Usage:
  python -m dynamo_tpu_torch.frontend.serve --port 0 \\
      --control-host 127.0.0.1 --control-port <port>
(prints `ENROLLED epoch=<n>`, then `READY http=:<port>`). An HA pair is
given in the comma form, `--control-host h1:p1,h2:p2`. The process ends
with its runtime: when its lease is lost (the primary it enrolled with
died), it prints `EXIT frontend lease_lost=True` and exits.
"""
from __future__ import annotations

import argparse
import asyncio
import os

from dynamo_tpu_torch.frontend.discovery import ModelWatcher
from dynamo_tpu_torch.frontend.reliability import AdmissionControl
from dynamo_tpu_torch.frontend.service import HttpService
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.qos import DEFAULT_POLICY
from dynamo_tpu_torch.utils.logconfig import configure_logging


def service_options(env=None) -> dict:
    """HttpService keyword arguments from the DYN_* knobs (see above)."""
    env = os.environ if env is None else env
    qos_policy = None
    if env.get("DYN_QOS", "") not in ("", "0"):
        qos_policy = DEFAULT_POLICY
    admission = None
    max_inflight = int(env.get("DYN_MAX_INFLIGHT", "0"))
    if max_inflight > 0:
        admission = AdmissionControl(
            max_inflight,
            max_queued=int(env.get("DYN_ADMISSION_QUEUE", "64")),
            retry_after_s=int(env.get("DYN_RETRY_AFTER_S", "1")),
            policy=qos_policy)
    deadline = env.get("DYN_REQUEST_DEADLINE_S")
    return {"admission": admission,
            "default_deadline_s": float(deadline) if deadline else None,
            "qos_policy": qos_policy}


async def run_frontend(runtime, host: str = "0.0.0.0", port: int = 8080,
                       kv_routing: bool = True) -> HttpService:
    service = await HttpService(host, port, **service_options()).start()

    async def make_router(component, client, card):
        return await KvRouter(component, client,
                              block_size=card.kv_page_size).start()

    service.watcher = await ModelWatcher(
        runtime, service.models,
        make_router=make_router if kv_routing else None,
        reliability_metrics=service.reliability).start()
    return service


async def amain(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (printed on the READY line)")
    p.add_argument("--control-host", default="127.0.0.1")
    p.add_argument("--control-port", type=int, default=5550)
    p.add_argument("--worker-id", default=None)
    p.add_argument("--no-kv-routing", action="store_true")
    args = p.parse_args(argv)
    configure_logging()

    runtime = await DistributedRuntime.connect(
        args.control_host, args.control_port, args.worker_id)
    service = await run_frontend(runtime, args.host, args.port,
                                 kv_routing=not args.no_kv_routing)
    # the fencing epoch of the control-plane member it enrolled with
    print(f"ENROLLED epoch={runtime.epoch}", flush=True)
    print(f"READY http=:{service.port}", flush=True)
    try:
        # the process ends with its runtime (a lost lease shuts it down)
        await runtime.shutdown_event.wait()
    finally:
        await service.watcher.stop()
        await service.stop()
        await runtime.shutdown()
    print(f"EXIT frontend lease_lost={runtime.lease_lost}", flush=True)


def main() -> None:
    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
