"""Per-process service entry.

Copied from dynamo_tpu/sdk/run_service.py. Started by the supervisor
(sdk/serve.py), one process per service worker: connect the runtime,
instantiate the service class, resolve its depends() edges to
ServiceClients, run its @async_on_start hooks, serve its endpoints, print
`READY service=<name> worker=<id>`, and block. SIGTERM or SIGINT runs the
service's own `drain()` when it has one (a worker finishes its in-flight
requests and deregisters), then shuts the runtime down, and the process
exits 0. The JAX entry's jax.distributed bootstrap has no counterpart: a
port service is one process on one card.

Usage:
  python -m dynamo_tpu_torch.sdk.run_service module.path:Class \\
      --control-host 127.0.0.1 --control-port <port>
"""
from __future__ import annotations

import argparse
import asyncio
import importlib
import logging
import signal
import sys

from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.sdk.client import ServiceClient
from dynamo_tpu_torch.utils.logconfig import configure_logging

log = logging.getLogger("dynamo_tpu_torch.sdk")


def resolve(spec_str: str):
    mod_name, _, cls_name = spec_str.partition(":")
    mod = importlib.import_module(mod_name)
    cls = getattr(mod, cls_name)
    if not hasattr(cls, "__service_spec__"):
        raise SystemExit(f"{spec_str} is not a @service class")
    return cls


async def serve_service(cls, runtime):
    """Instantiate and start one service; returns the instance."""
    spec = cls.__service_spec__
    inst = cls()
    # the cluster handle (kv, messaging, lease) before the hooks run
    inst.runtime = runtime
    for attr, dep_cls in spec.dependencies.items():
        setattr(inst, attr,
                ServiceClient(runtime, dep_cls.__service_spec__))
    for hook in spec.start_hooks:
        await getattr(inst, hook)()
    comp = runtime.namespace(spec.namespace).component(spec.component)
    stats = getattr(inst, "stats_handler", None)
    for ep_name, attr in spec.endpoints.items():
        await comp.endpoint(ep_name).serve(
            getattr(inst, attr), stats_handler=stats)
    print(f"READY service={spec.name} worker={runtime.worker_id}",
          flush=True)
    return inst


def install_drain(runtime, inst) -> None:
    """SIGTERM / SIGINT -> the service's drain() (if any), then the
    runtime's shutdown."""
    loop = asyncio.get_running_loop()
    state = {"task": None}

    async def drain():
        hook = getattr(inst, "drain", None)
        try:
            if hook is not None:
                await hook()
        except Exception:  # noqa: BLE001 (shut down regardless)
            log.exception("drain failed; shutting down anyway")
        await runtime.shutdown()

    def on_signal():
        if state["task"] is None:
            state["task"] = asyncio.ensure_future(drain())

    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, on_signal)


async def amain(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("service", help="module.path:ClassName")
    p.add_argument("--control-host", default="127.0.0.1")
    p.add_argument("--control-port", type=int, default=5550)
    args = p.parse_args(argv)
    configure_logging()
    cls = resolve(args.service)
    runtime = await DistributedRuntime.connect(
        args.control_host, args.control_port)
    inst = await serve_service(cls, runtime)
    install_drain(runtime, inst)
    await runtime.shutdown_event.wait()


if __name__ == "__main__":
    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        sys.exit(0)
