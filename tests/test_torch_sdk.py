"""The port's service-graph SDK (dynamo_tpu_torch/sdk/) and its disaggregated
example graph (dynamo_tpu_torch/examples/disagg/): tests/test_sdk.py and
tests/test_example_disagg.py held to the port.

- graph collection, dependencies, endpoints and start hooks, the same as
  the JAX SDK collects for the same declarations;
- the card allocator (CUDA_VISIBLE_DEVICES; a service that asks for no
  card shares card 0) and the config view each service process gets;
- the example graph resolves to PrefillWorker -> DecodeWorker -> Frontend,
  as the JAX example's does;
- the one-command CPU deployment (`python -m dynamo_tpu_torch.sdk.serve
  ...graph:Frontend -f config.cpu.json --start-control-plane`): each
  service's config section reaches its process (their $STATS show the
  configured slots and pages), one streamed chat runs through the
  frontend, its prefill went remote, and SIGTERM drains every service.
"""
import asyncio
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys

import pytest

from dynamo_tpu.sdk import (
    async_on_start as j_on_start, depends as j_depends,
    endpoint as j_endpoint, service as j_service,
)
from dynamo_tpu.sdk.service import collect_graph as j_collect
from dynamo_tpu_torch.sdk import (
    ServiceConfig, async_on_start, depends, endpoint, service,
)
from dynamo_tpu_torch.sdk.allocator import CardAllocator
from dynamo_tpu_torch.sdk.config import ENV_VAR, load_config_file
from dynamo_tpu_torch.sdk.run_service import resolve
from dynamo_tpu_torch.sdk.service import collect_graph

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "dynamo_tpu_torch" / "examples" / "disagg"


def _graph(svc, dep, on_start, ep):
    """Worker <- Processor, declared with one SDK's decorators."""
    @svc(name="EchoWorker", namespace="sdktest", component="worker")
    class EchoWorker:
        @on_start
        async def boot(self):
            self.started = True

        @ep()
        async def generate(self, request, context):
            yield {"word": request["text"].upper()}

    @svc(name="Processor", namespace="sdktest", component="processor")
    class Processor:
        worker = dep(EchoWorker)

        @ep()
        async def generate(self, request, context):
            yield {"count": 0}

    return EchoWorker, Processor


def _summary(specs):
    return [(s.name, s.namespace, s.component, s.endpoints,
             {a: t.__name__ for a, t in s.dependencies.items()},
             s.start_hooks) for s in specs]


def test_graph_collection_matches_jax_sdk():
    _, proc = _graph(service, depends, async_on_start, endpoint)
    _, jproc = _graph(j_service, j_depends, j_on_start, j_endpoint)
    specs = collect_graph(proc)
    assert _summary(specs) == _summary(j_collect(jproc))
    assert [s.name for s in specs] == ["EchoWorker", "Processor"]
    assert specs[0].start_hooks == ["boot"]
    assert specs[1].endpoints == {"generate": "generate"}


def test_card_allocator():
    alloc = CardAllocator(4)
    assert alloc.env_for({}) == {}     # shares card 0
    assert alloc.env_for({"gpu": 3}) == {"CUDA_VISIBLE_DEVICES": "0,1,2"}
    with pytest.raises(RuntimeError, match="not enough"):
        alloc.env_for({"gpu": 2})


def test_service_config_view(tmp_path, monkeypatch):
    data = {"DecodeWorker": {"num_pages": 7}, "Frontend": {"port": 1}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(data))
    assert load_config_file(str(path)) == data
    env = ServiceConfig.to_env(data)
    monkeypatch.setenv(ENV_VAR, env[ENV_VAR])
    monkeypatch.setattr(ServiceConfig, "_instance", None)
    cfg = ServiceConfig.global_instance()
    assert cfg.for_service("DecodeWorker") == {"num_pages": 7}
    assert cfg.get("Frontend", "port") == 1
    assert cfg.for_service("PrefillWorker") == {}


def test_example_graph_resolves_like_the_jax_example():
    root = resolve("dynamo_tpu_torch.examples.disagg.graph:Frontend")
    specs = collect_graph(root)
    jspecs = j_collect(resolve_jax("examples.disagg.graph:Frontend"))
    assert [(s.name, s.namespace, s.component) for s in specs] == \
        [(s.name, s.namespace, s.component) for s in jspecs]
    assert [s.name for s in specs] == ["PrefillWorker", "DecodeWorker",
                                       "Frontend"]
    assert specs[0].endpoints == {"stats": "stats"}
    # the JSON configs carry the JAX example's YAML values, plus the CPU
    # device in the CPU config
    import yaml
    for name in ("config", "config.cpu"):
        ours = json.loads((EXAMPLE / f"{name}.json").read_text())
        theirs = yaml.safe_load(
            (REPO / "examples" / "disagg" / f"{name}.yaml").read_text())
        for svc in ours.values():
            svc.pop("device", None)
        assert ours == theirs, name


def resolve_jax(spec):
    from dynamo_tpu.sdk.run_service import resolve as jresolve
    return jresolve(spec)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_one_command_cpu_deployment_streams_a_chat(tmp_path):
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    cfg = json.loads((EXAMPLE / "config.cpu.json").read_text())
    http = _free_port()
    cfg["Frontend"]["port"] = http
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    env = {**os.environ, "PYTHONPATH": str(REPO), "DYN_LEASE_TTL_S": "30"}
    sup = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.sdk.serve",
         "dynamo_tpu_torch.examples.disagg.graph:Frontend", "-f", str(path),
         "--start-control-plane", "--control-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO, env=env,
        text=True)
    lines = []
    try:
        while True:
            line = sup.stdout.readline()
            assert line, "supervisor exited early:\n" + "".join(lines)
            lines.append(line)
            if line.startswith("READY graph="):
                break
        port = int(line.rsplit("control-port=", 1)[1])

        async def chat():
            body = json.dumps({
                "model": "tiny", "stream": True, "max_tokens": 6,
                "messages": [{"role": "user", "content":
                              "a prompt long enough to go through the "
                              "remote prefill path"}]}).encode()
            reader, writer = await asyncio.open_connection("127.0.0.1", http)
            writer.write(
                b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                b"Content-Type: application/json\r\nConnection: close\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), 120)
            writer.close()
            return raw.decode()

        async def scrape(component, ep):
            rt = await DistributedRuntime.connect("127.0.0.1", port)
            client = await rt.namespace("dynamo-demo").component(
                component).endpoint(ep).client().start()
            await client.wait_for_instances()
            (st,) = (await client.scrape_stats(timeout=10.0)).values()
            await client.stop()
            await rt.shutdown()
            return st

        raw = asyncio.run(chat())
        assert "text/event-stream" in raw and "data: [DONE]" in raw, raw
        frames = [json.loads(x[len("data: "):]) for x in raw.splitlines()
                  if x.startswith("data: {")]
        reasons = [c["finish_reason"] for f in frames
                   for c in f["choices"] if c.get("finish_reason")]
        assert reasons in (["length"], ["stop"])
        dec = asyncio.run(scrape("backend", "generate"))
        pre = asyncio.run(scrape("prefill", "stats"))
        assert dec["request_total_slots"] == cfg["DecodeWorker"]["max_slots"]
        assert dec["kv_total_blocks"] == cfg["DecodeWorker"]["num_pages"]
        assert pre["request_total_slots"] == \
            cfg["PrefillWorker"]["max_slots"]
        assert dec["disagg"]["remote_prefills"] == 1
        assert pre["prefill"]["completed"] == 1
        sup.send_signal(signal.SIGTERM)
        rest = sup.communicate(timeout=120)[0]
        assert sup.returncode == 0, rest
        assert "EXIT decode remote_prefills=1" in rest
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait(30)
