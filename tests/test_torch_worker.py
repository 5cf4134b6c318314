"""The port's LLM worker as a control-plane endpoint (dynamo_tpu_torch/llm/
worker.py) against the JAX package's, on the CPU, `tiny` in float32 with the
JAX weights carried over by `params_from_jax`.

(a) A port worker behind `serve_llm_worker` on an in-process memory plane,
    reached through `RemotePipeline` (a runtime Client and a KvRouter):
    the greedy and the seeded-sampled token streams equal the port's
    `LocalPipeline` over an engine of its own and the JAX worker's, served
    the same way by the JAX package (its raw RemoteEngineSink).
(b) The port engine's KV events (drain_kv_events) equal the JAX engine's
    for the same requests, page ids and kinds as they are and every hash
    replaced by the index of its first appearance (the packages hash
    differently); the requests share prefixes and overflow the page pool,
    so both Stored and Removed events occur.
(c) A client stop mid-stream aborts the engine request on the worker.
(d) `run.py in=endpoint` as a process on a port control-plane server
    (out=echo): READY, the instance and the KV-routed model registered,
    a request answered, then SIGTERM drains (the instance deregisters) and
    the process exits 0 — `install_graceful_drain`.
(e) The worker's $STATS reply: the engine's metrics and the kernel
    launch counts.

(a) runs on each of the port's decode paths (tests/torch_decode_paths.py):
"ragged" (the kernel's plain version, JAX on the gather window), "gather"
(`decode_kernel="off"` in both) and a tiny Gemma-2 (its knobs resolve the
port to the gather window), each JAX worker on the same config and weights.
"""
import asyncio
import os
import signal
import subprocess
import sys

import jax
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from tests import torch_decode_paths as paths

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
EOS = {2}
T = 120.0


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def _tengine(jax_params, **kw):
    return TNativeEngine(TCFG, TEngineConfig(**dict(ENGINE_KW, **kw)),
                         eos_token_ids=EOS, device="cpu",
                         params=params_from_jax(jax_params, TCFG, "cpu"))


def _jengine(**kw):
    return JNativeEngine(JCFG, JEngineConfig(**dict(ENGINE_KW, **kw)),
                         eos_token_ids=EOS, seed=0)


CONTENT = "route the port's worker over the control plane"
SAMPLING = {"greedy": {}, "sampled": {"temperature": 0.9, "seed": 7,
                                      "ext": {"top_k": 40}}}


def _modules(pkg: str) -> dict:
    if pkg == "jax":
        from dynamo_tpu.llm import model_card, pipeline, worker
        from dynamo_tpu.protocols import openai
        from dynamo_tpu.runtime import distributed, engine
        from dynamo_tpu.runtime.transports import memory
    else:
        from dynamo_tpu_torch.llm import model_card, pipeline, worker
        from dynamo_tpu_torch.protocols import openai
        from dynamo_tpu_torch.runtime import distributed, engine
        from dynamo_tpu_torch.runtime.transports import memory
    return {"card": model_card, "pipeline": pipeline, "worker": worker,
            "openai": openai, "distributed": distributed, "engine": engine,
            "memory": memory}


async def _token_streams(pkg: str, engine, kind: str, remote: bool):
    """The token ids and finish reason of one chat request through pkg's
    serving path: RemotePipeline's sink over a served worker (remote) or
    the engine worker in-process."""
    m = _modules(pkg)
    card = m["card"].ModelDeploymentCard(name="tiny", arch="tiny",
                                         context_length=512)
    req = m["openai"].ChatCompletionRequest.model_validate(
        {"model": "tiny", "max_tokens": 12,
         "messages": [{"role": "user", "content": CONTENT}],
         **SAMPLING[kind]}) if pkg == "jax" else \
        m["openai"].ChatCompletionRequest.from_json(
            {"model": "tiny", "max_tokens": 12,
             "messages": [{"role": "user", "content": CONTENT}],
             **SAMPLING[kind]})
    worker = await m["worker"].NativeEngineWorker(engine).start()
    rts = []
    try:
        if remote:
            DRT = m["distributed"].DistributedRuntime
            plane = m["memory"].MemoryPlane()
            wrt = await DRT.create_local(plane, "w0")
            crt = await DRT.create_local(plane, "fe")
            rts += [wrt, crt]
            await m["worker"].serve_llm_worker(wrt, "ns", "llm", worker)
            comp = crt.namespace("ns").component("llm")
            client = comp.endpoint("generate").client()
            await client.start()
            await client.wait_for_instances()
            router = None
            if pkg == "jax":
                pipe = m["pipeline"].RemotePipeline(card, client,
                                                    reliability=False)
            else:
                from dynamo_tpu_torch.kv_router.router import KvRouter
                router = await KvRouter(comp, client, card.kv_page_size
                                        ).start()
                pipe = m["pipeline"].RemotePipeline(card, client,
                                                    router=router)
            sink = pipe.sink.generate
        else:
            pipe = m["pipeline"].LocalPipeline(card, worker)
            sink = worker.generate
        pre, _ = pipe.preprocessor.preprocess_chat(req, "rid-0")
        ids, finish = [], None
        async for frame in sink(pre, m["engine"].Context("rid-0")):
            if isinstance(frame, dict):
                ids += frame.get("token_ids", [])
                finish = frame.get("finish_reason") or finish
            else:
                ids += frame.token_ids
                finish = frame.finish_reason or finish
        text = None
        if pkg == "torch":
            from dynamo_tpu_torch.protocols.delta import (
                aggregate_chat_chunks,
            )
            chunks = [c async for c in pipe.generate_chat(
                req, m["engine"].Context("rid-1"))]
            agg = aggregate_chat_chunks(chunks)
            text = (agg.choices[0].message.content,
                    agg.choices[0].finish_reason,
                    agg.usage.completion_tokens)
        if remote and pkg == "torch":
            await router.stop()
        return ids, str(getattr(finish, "value", finish)), text
    finally:
        for rt in rts:
            await rt.shutdown()
        await worker.stop()


@pytest.mark.parametrize("path", paths.PATHS)
@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_remote_streams_equal_local_and_jax(kind, path):
    jcfg, tcfg, tree, tparams = paths.env(path)

    def tengine():
        eng = TNativeEngine(tcfg, TEngineConfig(**ENGINE_KW),
                            eos_token_ids=EOS, device="cpu", params=tparams)
        paths.check_path(eng, path)
        return eng

    async def main():
        remote = await _token_streams("torch", tengine(), kind, True)
        local = await _token_streams("torch", tengine(), kind, False)
        jax_remote = await _token_streams(
            "jax", JNativeEngine(jcfg, JEngineConfig(**ENGINE_KW),
                                 eos_token_ids=EOS, seed=0,
                                 params=paths.jax_params(tree)),
            kind, True)
        return remote, local, jax_remote
    remote, local, jax_remote = asyncio.run(asyncio.wait_for(main(), T))
    assert remote[:2] == local[:2] == jax_remote[:2]
    assert remote[2] == local[2]          # the chat text, finish, usage
    assert len(remote[0]) == 12 and remote[1] == "length"


# -- (b) KV events --------------------------------------------------------------

def _canonical(events):
    """Events with every hash replaced by the index of its first
    appearance (0 stays 0: the root parent and Removed's tokens_hash)."""
    ids = {0: 0}
    out = []
    for kind, pid, h, parent, tok in events:
        out.append((kind, pid) + tuple(
            ids.setdefault(x, len(ids)) for x in (h, parent, tok)))
    return out


def _events(eng, request_cls, params_cls, reqs, batches):
    """Add the requests in batches, step each batch to completion,
    draining the KV events after every step."""
    out = []
    for batch in batches:
        for rid, prompt, kw in (reqs[i] for i in batch):
            eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
        while eng.has_work():
            eng.step()
            out += eng.drain_kv_events()
    return out


def test_kv_events_equal_jax_engine(jax_params):
    import numpy as np
    rng = np.random.default_rng(3)
    head = [int(t) for t in rng.integers(3, 250, 40)]
    reqs = []
    for i in range(6):
        tail = [int(t) for t in rng.integers(3, 250, int(rng.integers(
            5, 40)))]
        prompt = (head[:8 * (i % 3) + 16] if i % 2 else
                  [int(t) for t in rng.integers(3, 250, 30)]) + tail
        kw = {"max_tokens": 10, "ignore_eos": True}
        if i % 3 == 2:
            kw.update(temperature=0.8, seed=11 + i, top_k=20)
        reqs.append((f"r{i}", prompt, kw))
    batches = [[0, 1], [2], [3, 4], [5, 1]]
    kw = dict(num_pages=24, max_slots=2)
    jev = _events(_jengine(**kw), JRequest, JSamplingParams, reqs, batches)
    tev = _events(_tengine(jax_params, **kw), TRequest, TSamplingParams,
                  [(f"{r}-t", p, k) for r, p, k in reqs], batches)
    assert _canonical(tev) == _canonical(jev)
    kinds = {e[0] for e in jev}
    assert kinds == {"stored", "removed"}
    # a shared head: some Stored event chains onto a page stored earlier
    # by another request
    assert len(jev) > 20


# -- (c) client stop --------------------------------------------------------------

def test_client_stop_aborts_engine_request(jax_params):
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker, serve_llm_worker
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    async def main():
        engine = _tengine(jax_params)
        worker = await NativeEngineWorker(engine).start()
        plane = MemoryPlane()
        wrt = await DistributedRuntime.create_local(plane, "w0")
        crt = await DistributedRuntime.create_local(plane, "fe")
        try:
            await serve_llm_worker(wrt, "ns", "llm", worker)
            client = crt.namespace("ns").component("llm").endpoint(
                "generate").client()
            await client.start()
            await client.wait_for_instances()
            ctx = Context("long-1")
            pre = PreprocessedRequest(
                "long-1", list(range(3, 40)),
                stop=StopConditions(max_tokens=400, ignore_eos=True))
            frames = []
            async for f in await client.generate(pre, ctx):
                frames.append(f)
                if len(frames) == 3:
                    ctx.stop_generating()
            assert len(frames) < 100
            for _ in range(200):
                if not engine.has_work() and not engine.scheduler.params:
                    break
                await asyncio.sleep(0.01)
            assert not engine.has_work() and not engine.scheduler.params
        finally:
            await wrt.shutdown()
            await crt.shutdown()
            await worker.stop()

    asyncio.run(asyncio.wait_for(main(), T))


# -- (d) the entry point and install_graceful_drain ------------------------------

def _readline(proc, prefix: str, timeout: float = 60.0) -> str:
    import queue
    import threading
    q: queue.Queue = queue.Queue()

    def pump():
        for line in iter(proc.stdout.readline, ""):
            q.put(line)
            if line.startswith(prefix):
                return
    threading.Thread(target=pump, daemon=True).start()
    seen = []
    while True:
        try:
            line = q.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"no {prefix!r} line: {''.join(seen)}")
        seen.append(line)
        if line.startswith(prefix):
            return line.strip()


def test_run_endpoint_serves_and_drains_on_sigterm():
    import json

    from dynamo_tpu_torch.frontend.discovery import model_key
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    env = {**os.environ, "PYTHONPATH": REPO, "DYN_LEASE_TTL_S": "30"}
    procs = []
    try:
        server = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.transports.server",
             "--host", "127.0.0.1", "--port", "0"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(server)
        port = int(_readline(server, "READY").rsplit(":", 1)[1])
        worker = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.run",
             "in=endpoint:ns.llm.generate", "out=echo", "tiny",
             "--control-host", "127.0.0.1", "--control-port", str(port)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(worker)
        ready = _readline(worker, "READY endpoint=")
        assert "model=tiny" in ready and "device=none" in ready

        async def main():
            rt = await DistributedRuntime.connect("127.0.0.1", port, "t")
            try:
                entry = json.loads(await rt.kv.get(model_key("chat", "tiny")))
                assert entry["kv_routed"] is True and entry["name"] == "tiny"
                client = rt.namespace("ns").component("llm").endpoint(
                    "generate").client()
                await client.start()
                await client.wait_for_instances()
                frames = [f async for f in await client.generate(
                    PreprocessedRequest("e1", [5, 6, 7], stop=StopConditions(
                        max_tokens=3)))]
                assert [t for f in frames for t in f["token_ids"]] == [5, 6, 7]
                assert frames[-1]["finish_reason"] == "length"
                worker.send_signal(signal.SIGTERM)
                for _ in range(500):
                    if not client.instances:
                        break
                    await asyncio.sleep(0.02)
                assert not client.instances
            finally:
                await rt.shutdown()

        asyncio.run(asyncio.wait_for(main(), 60))
        assert worker.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)


# -- (e) $STATS ---------------------------------------------------------------

def test_stats_reply_carries_engine_metrics(jax_params):
    from dynamo_tpu_torch.kv_router.scoring import WorkerMetrics
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker, serve_llm_worker
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    async def main():
        engine = _tengine(jax_params)
        worker = await NativeEngineWorker(engine).start()
        plane = MemoryPlane()
        wrt = await DistributedRuntime.create_local(plane, "w0")
        crt = await DistributedRuntime.create_local(plane, "fe")
        try:
            await serve_llm_worker(wrt, "ns", "llm", worker)
            client = crt.namespace("ns").component("llm").endpoint(
                "generate").client()
            await client.start()
            await client.wait_for_instances()
            prompt = list(range(3, 30))
            for rid in ("a", "b"):
                [f async for f in await client.generate(PreprocessedRequest(
                    rid, prompt, stop=StopConditions(max_tokens=4)))]
            stats = (await client.scrape_stats())["w0"]
            m = engine.metrics()
            assert stats["requests_admitted"] == m.requests_admitted == 2
            # the second prompt hit the first one's 3 full pages
            assert stats["gpu_prefix_cache_hits"] == 3
            assert stats["gpu_prefix_cache_lookups"] == 1 + 3
            assert stats["decode_windows"] == m.decode_windows > 0
            assert set(stats["kernel_launches"]) == {
                "ragged_decode_attention", "w8a16_gemm", "w8a16_dequant",
                "w8a16_moe_gemm", "w8a16_large_m"}
            assert stats["decode_window_steps"] > 0
            # every field the router reads comes through
            assert WorkerMetrics.from_dict(stats).kv_total_blocks == \
                ENGINE_KW["num_pages"]
        finally:
            await wrt.shutdown()
            await crt.shutdown()
            await worker.stop()

    asyncio.run(asyncio.wait_for(main(), T))
