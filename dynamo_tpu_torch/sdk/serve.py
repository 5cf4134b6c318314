"""Graph supervisor: launch a service graph, one process per worker.

Copied from dynamo_tpu/sdk/serve.py: resolve the depends() graph, start
the control-plane server when asked (`--start-control-plane`, the port's
`runtime/transports/server.py`; `--control-port 0` lets it pick a port),
start `python -m dynamo_tpu_torch.sdk.run_service` for each worker with
the config JSON and its card assignment in its environment (dependencies
first, each waited for until it prints READY), print `READY graph=...
services=... control-port=<port>`, and supervise until a child dies or the
supervisor gets SIGTERM / SIGINT. Teardown signals the children in reverse
start order, one at a time (SIGTERM to a service, which drains; SIGINT to
the control plane), each given up to two minutes to exit, and prints `EXIT service=<tag> code=<rc>` for each; the
supervisor exits 0 when it was stopped by a signal and every child exited
0, and 1 when a child died on its own.

`--control-data-dir DIR` starts that control plane durable (its
`--data-dir`: unleased KV and the work queues, the disaggregated prefill
queue among them, are journaled there; transports/journal.py).

Usage:
  python -m dynamo_tpu_torch.sdk.serve my.graph:Frontend -f config.json \\
      --start-control-plane --control-port 0 [--control-data-dir DIR]
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys

from dynamo_tpu_torch.sdk.allocator import CardAllocator
from dynamo_tpu_torch.sdk.config import ServiceConfig, load_config_file
from dynamo_tpu_torch.sdk.run_service import resolve
from dynamo_tpu_torch.sdk.service import collect_graph

log = logging.getLogger("dynamo_tpu_torch.sdk.serve")

# strong refs to the per-child stdout pumps (the loop holds tasks weakly)
_drain_tasks: set = set()
# how long a service has to drain and exit after SIGTERM
STOP_TIMEOUT_S = 120.0


async def wait_ready(proc: asyncio.subprocess.Process, tag: str,
                     timeout: float = 900.0) -> str:
    """Relay the child's output until its READY line (returned); then keep
    relaying in the background so it never blocks on a full pipe. The
    timeout covers building an engine at full width."""
    async def pump():
        while True:
            line = await proc.stdout.readline()
            if not line:
                raise RuntimeError(f"{tag} exited before READY")
            sys.stdout.write(f"[{tag}] {line.decode()}")
            sys.stdout.flush()
            if line.startswith(b"READY"):
                return line.decode().strip()
    ready = await asyncio.wait_for(pump(), timeout)

    async def relay():
        while True:
            line = await proc.stdout.readline()
            if not line:
                return
            sys.stdout.write(f"[{tag}] {line.decode()}")
            sys.stdout.flush()
    task = asyncio.create_task(relay())
    _drain_tasks.add(task)
    task.add_done_callback(_drain_tasks.discard)
    return ready


async def amain(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("graph", help="module.path:RootServiceClass")
    p.add_argument("-f", "--config", default=None,
                   help="JSON (or YAML, with pyyaml) config keyed by "
                        "service name")
    p.add_argument("--control-host", default="127.0.0.1")
    p.add_argument("--control-port", type=int, default=5550)
    p.add_argument("--start-control-plane", action="store_true")
    p.add_argument("--control-data-dir", default=None,
                   help="journal the started control plane's state here")
    p.add_argument("--gpus", type=int, default=0,
                   help="cards for resources={'gpu': n} services; a "
                        "service that asks for none shares card 0")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    root = resolve(args.graph)
    specs = collect_graph(root)
    cfg = load_config_file(args.config) if args.config else {}
    alloc = CardAllocator(args.gpus)
    procs: list = []
    stopping = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stopping.set)

    async def spawn(cmd, tag, extra_env=None) -> str:
        env = {**os.environ, **(extra_env or {})}
        proc = await asyncio.create_subprocess_exec(
            sys.executable, *cmd, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT, env=env)
        procs.append((tag, proc))
        return await wait_ready(proc, tag)

    codes = {}
    died = False
    try:
        port = args.control_port
        if args.start_control_plane:
            ready = await spawn(
                ["-m", "dynamo_tpu_torch.runtime.transports.server",
                 "--host", args.control_host, "--port", str(port),
                 *(("--data-dir", args.control_data_dir)
                   if args.control_data_dir else ())],
                "control-plane")
            port = int(ready.rsplit(":", 1)[1])
        for spec in specs:
            mod, cls = spec.cls.__module__, spec.cls.__qualname__
            for i in range(spec.workers):
                extra = {**ServiceConfig.to_env(cfg),
                         **alloc.env_for(spec.resources)}
                await spawn(
                    ["-m", "dynamo_tpu_torch.sdk.run_service",
                     f"{mod}:{cls}", "--control-host", args.control_host,
                     "--control-port", str(port)],
                    f"{spec.name}/{i}", extra)
        print(f"READY graph={args.graph} services="
              f"{','.join(s.name for s in specs)} control-port={port}",
              flush=True)
        waits = {asyncio.create_task(proc.wait()): tag
                 for tag, proc in procs}
        stop = asyncio.create_task(stopping.wait())
        done, _ = await asyncio.wait({*waits, stop},
                                     return_when=asyncio.FIRST_COMPLETED)
        stop.cancel()
        for d in done:
            if d in waits:
                log.error("service %s exited with %s", waits[d], d.result())
                codes[waits[d]] = d.result()
                died = True
    finally:
        # reverse start order: the frontend stops taking requests, the
        # workers drain (SIGTERM), the control plane goes last (SIGINT: it
        # exits 0 on it)
        for tag, proc in reversed(procs):
            if proc.returncode is None:
                proc.send_signal(signal.SIGINT if tag == "control-plane"
                                 else signal.SIGTERM)
                try:
                    await asyncio.wait_for(proc.wait(), STOP_TIMEOUT_S)
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()
            codes.setdefault(tag, proc.returncode)
            print(f"EXIT service={tag} code={codes[tag]}", flush=True)
    return 0 if not died and all(c == 0 for c in codes.values()) else 1


def main() -> None:
    sys.exit(asyncio.run(amain()))


if __name__ == "__main__":
    main()
