"""The port's OpenAI HTTP frontend (dynamo_tpu_torch/frontend) against the
JAX package's, each on a localhost port, driven by the same client
(tests/http_client.py).

(a) Both services serve LocalPipelines over NativeEngines on `tiny` in
    float32 with the same weights (JAX pytree -> numpy -> params_from_jax).
    The same chat and completion requests, streamed and unary, greedy and
    seeded-sampled, with n = 2 and a stop string: unary bodies and every
    SSE frame are equal as parsed JSON apart from `id` and `created`, and
    both streams end with [DONE].
(b) tests/test_frontend.py's TestHttpService cases against both services
    with the same fake engines: statuses and error bodies (404 for an
    unknown model or route, 405, 422 for an invalid body, 500 when the
    engine fails), a client disconnect stopping generation, /v1/models,
    /metrics, /health, and tool-call parsing unary and streamed. Statuses
    and body shapes equal the JAX service's; the tool-call bodies are equal
    (apart from ids, which are random on both sides).
(c) GET /metrics: llm_ttft_seconds_count and llm_itl_seconds_count equal
    the JAX service's for the same requests.
(d) `python -m dynamo_tpu_torch.run in=http:0 out=native tiny --device
    cpu` prints READY and answers one streamed request.
(e) The distributed path: a worker served on an in-process memory plane
    (`serve_llm_worker`, the model registered KV-routed) behind each
    package's `run_frontend` (frontend/serve.py: ModelWatcher ->
    RemotePipeline -> KvRouter). The port's watcher discovers the
    registered model and drops it when it is unregistered; a routed chat
    over HTTP, unary and streamed, greedy and seeded-sampled, gives the
    same bodies and frames as the JAX frontend over the JAX worker on the
    same weights, apart from id and created.
(f) Admission and deadlines through each package's run_frontend in front
    of an echo worker: with DYN_MAX_INFLIGHT=1 DYN_ADMISSION_QUEUE=0
    DYN_RETRY_AFTER_S=3 and one stream held, two more requests answer 429
    with the JAX service's retry-after and body and count as shed, then a
    request answers 200; a request past its 1 s deadline ends with the JAX
    service's body and frames.
"""
import asyncio
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.models.llama import params_from_jax

from tests.http_client import request, sse_events

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "127.0.0.1"
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)


def _modules(pkg: str) -> dict:
    """The service, pipeline, worker, card, protocol types and serving
    histograms of one package."""
    if pkg == "jax":
        from dynamo_tpu.frontend import service
        from dynamo_tpu.llm import model_card, pipeline, worker
        from dynamo_tpu.observability import serving
        from dynamo_tpu.protocols import openai
    else:
        from dynamo_tpu_torch.frontend import service
        from dynamo_tpu_torch.llm import model_card, pipeline, worker
        from dynamo_tpu_torch.observability import serving
        from dynamo_tpu_torch.protocols import openai
    return {"service": service, "card": model_card, "pipeline": pipeline,
            "worker": worker, "serving": serving, "openai": openai}


def _strip(obj):
    """A parsed body or frame without its per-response `id` / `created`
    and the random ids of tool calls."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _shape(obj):
    """The structure of a parsed body: keys and value types."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


async def _post(port, path, body):
    status, raw = await request(HOST, port, "POST", path, body)
    return status, json.loads(raw) if raw else None


async def _stream(port, path, body):
    frames = [d async for _, d in sse_events(HOST, port, path, body)]
    assert frames and frames[-1] == "[DONE]", frames[-3:]
    return [json.loads(d) for d in frames[:-1]]


# -- (a) + (c): the same engines behind both services ---------------------------

@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


CONTENT = "serve the port over http, keep the frames identical"
CASES = [
    ("/v1/chat/completions", {"max_tokens": 12}),
    ("/v1/chat/completions", {"max_tokens": 10, "temperature": 0.9,
                              "seed": 5, "ext": {"top_k": 30}}),
    ("/v1/chat/completions", {"max_tokens": 8, "n": 2, "temperature": 0.7,
                              "seed": 11}),
    # "?" is the greedy stream's seventh character on these weights
    ("/v1/chat/completions", {"max_tokens": 16, "stop": "?"}),
    ("/v1/chat/completions", {"max_tokens": 6,
                              "stream_options": {"include_usage": True}}),
    ("/v1/completions", {"prompt": "paged attention on a card",
                         "max_tokens": 9}),
    ("/v1/completions", {"prompt": "seeded", "max_tokens": 7,
                         "temperature": 1.1, "seed": 3, "n": 2}),
]


def _body(path, kw, stream):
    body = {"model": "tiny", "stream": stream, **kw}
    if path.endswith("chat/completions"):
        body["messages"] = [{"role": "user", "content": CONTENT}]
    return body


async def _serve(pkg, jax_params, fn):
    """Run fn(port, serving) against pkg's HttpService on a localhost port
    in front of LocalPipeline -> NativeEngineWorker -> NativeEngine (tiny,
    f32, the bridged weights); the serving histograms start empty."""
    mods = _modules(pkg)
    if pkg == "jax":
        engine = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    else:
        engine = TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cpu",
                               params=params_from_jax(jax_params, TCFG))
    card = mods["card"].ModelDeploymentCard(name="tiny", arch="tiny",
                                            context_length=512,
                                            model_type="both")
    worker = await mods["worker"].NativeEngineWorker(engine).start()
    svc = await mods["service"].HttpService(HOST, 0).start()
    svc.models.add("tiny", mods["pipeline"].LocalPipeline(card, worker),
                   "both")
    mods["serving"].SERVING.reset()
    try:
        return await fn(svc.port)
    finally:
        await svc.stop()
        await worker.stop()


def _both(jax_params, fn):
    return tuple(asyncio.run(_serve(pkg, jax_params, fn))
                 for pkg in ("jax", "torch"))


def test_bodies_and_frames_identical(jax_params):
    async def drive(port):
        out = []
        for path, kw in CASES:
            status, body = await _post(port, path, _body(path, kw, False))
            assert status == 200, body
            out.append(_strip(body))
            out.append(_strip(await _stream(port, path,
                                            _body(path, kw, True))))
        return out

    want, got = _both(jax_params, drive)
    assert len(got) == len(want) == 2 * len(CASES)
    for (path, kw), i in zip(CASES, range(0, len(want), 2)):
        assert got[i] == want[i], (path, kw)
        assert got[i + 1] == want[i + 1], (path, kw)
    # the cases produced text, both choices of the n = 2 cases, a stop
    # string finish and the usage-only tail
    assert all(c.get("message", c).get("content", c.get("text"))
               for c in want[0]["choices"])
    assert [c["index"] for c in want[4]["choices"]] == [0, 1]
    assert want[1][-1]["choices"][0]["finish_reason"] == "length"
    assert want[6]["choices"][0]["finish_reason"] == "stop"
    assert want[9][-1]["choices"] == [] and want[9][-1]["usage"]


def _hist_counts(text: str, name: str) -> dict:
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        rf"^{name}_count{{([^}}]*)}} (\d+)$", text, re.M)}


def test_serving_histograms_match(jax_params):
    async def drive(port):
        for path, kw in CASES[:3] + CASES[5:6]:
            for stream in (False, True):
                body = _body(path, kw, stream)
                if stream:
                    await _stream(port, path, body)
                else:
                    assert (await _post(port, path, body))[0] == 200
        status, raw = await request(HOST, port, "GET", "/metrics")
        assert status == 200
        text = raw.decode()
        return (_hist_counts(text, "llm_ttft_seconds"),
                _hist_counts(text, "llm_itl_seconds"))

    want, got = _both(jax_params, drive)
    assert got == want
    ttft, itl = got
    label = 'model="tiny",qos="standard"'
    # one TTFT per choice served: 4 cases x 2 requests, one with n = 2
    assert ttft == {label: 10}
    assert itl[label] > 0


# -- (b): the fake-engine cases ---------------------------------------------------

def _fakes(openai):
    """tests/test_frontend.py's fake engines over one package's protocol
    types."""
    Chunk, Choice = openai.ChatCompletionChunk, openai.ChatStreamChoice

    def chunk(request, rid, created, idx, delta, fin=None):
        return Chunk(id=rid, created=created, model=request.model,
                     choices=[Choice(index=idx, delta=delta,
                                     finish_reason=fin)])

    class CounterEngine:
        def __init__(self, n=3, delay=0.0):
            self.n, self.delay, self.contexts = n, delay, []

        async def generate_chat(self, request, context):
            self.contexts.append(context)
            rid, created = openai.new_response_id("chatcmpl"), openai.now()
            for i in range(self.n):
                if context.is_stopped:
                    return
                if self.delay:
                    await asyncio.sleep(self.delay)
                yield chunk(request, rid, created, 0,
                            {"role": "assistant", "content": f"c{i} "})
            yield chunk(request, rid, created, 0, {}, "stop")

        async def generate_completion(self, request, context):
            raise NotImplementedError
            yield

    class AlwaysFailEngine:
        async def generate_chat(self, request, context):
            raise RuntimeError("boom")
            yield

        generate_completion = generate_chat

    class TextEngine(CounterEngine):
        """Streams fixed pieces for choice 0 (or per-choice pieces)."""

        def __init__(self, pieces):
            super().__init__()
            self.pieces = pieces

        async def generate_chat(self, request, context):
            rid, created = openai.new_response_id("chatcmpl"), openai.now()
            by_choice = (self.pieces if isinstance(self.pieces, dict)
                         else {0: self.pieces})
            for idx, pieces in by_choice.items():
                for p in pieces:
                    yield chunk(request, rid, created, idx,
                                {"role": "assistant", "content": p})
            for idx in by_choice:
                yield chunk(request, rid, created, idx, {}, "stop")

    return CounterEngine, AlwaysFailEngine, TextEngine


CHAT = {"model": "m", "messages": [{"role": "user", "content": "hi"}]}
TOOLS = [{"type": "function", "function": {"name": "f"}}]
TOOL_TEXT = '{"name": "f", "arguments": {"x": 1}}'


def _fake_service(pkg, fn):
    async def main():
        mods = _modules(pkg)
        fakes = _fakes(mods["openai"])
        svc = await mods["service"].HttpService(HOST, 0).start()
        try:
            return await fn(svc, *fakes)
        finally:
            await svc.stop()
    return asyncio.run(asyncio.wait_for(main(), 60))


def _fake_both(fn):
    return _fake_service("jax", fn), _fake_service("torch", fn)


def test_statuses_and_error_bodies():
    async def drive(svc, Counter, Fail, Text):
        svc.models.add("m", Fail())
        url = "/v1/chat/completions"
        out = []
        for method, path, body in (
                ("POST", url, {**CHAT, "model": "nope"}),      # 404 model
                ("POST", url, {"model": "m"}),                 # 422 missing
                ("POST", url, {**CHAT, "max_tokens": "many"}),  # 422 type
                ("POST", url, {**CHAT, "messages": "hi"}),     # 422 type
                ("POST", "/v1/completions", {"model": "m"}),   # 422 prompt
                ("GET", url, None),                            # 405
                ("GET", "/nope", None),                        # 404 route
                ("POST", url, CHAT)):                          # 500 engine
            status, raw = await request(HOST, svc.port, method, path, body)
            out.append((status, _shape(json.loads(raw))))
        assert svc._requests.get("m", "chat", "unary", "error") == 1
        return out

    want, got = _fake_both(drive)
    assert got == want
    assert [s for s, _ in got] == [404, 422, 422, 422, 422, 405, 404, 500]
    assert got[0][1] == {"error": {"message": "str", "code": "int"}}


def test_unary_stream_and_counters():
    async def drive(svc, Counter, Fail, Text):
        svc.models.add("m", Counter(3))
        status, body = await _post(svc.port, "/v1/chat/completions", CHAT)
        frames = await _stream(svc.port, "/v1/chat/completions",
                               {**CHAT, "stream": True})
        counts = (svc._requests.get("m", "chat", "unary", "success"),
                  svc._requests.get("m", "chat", "stream", "success"),
                  svc._inflight.get("m"), svc._duration.count("m"))
        return status, _strip(body), [_strip(f) for f in frames], counts

    want, got = _fake_both(drive)
    assert got == want
    assert got[1]["choices"][0]["message"]["content"] == "c0 c1 c2 "
    assert got[3] == (1, 1, 0, 2)


def test_client_disconnect_stops_generation():
    async def drive(svc, Counter, Fail, Text):
        eng = Counter(1000, delay=0.01)
        svc.models.add("m", eng)
        got = [d async for _, d in sse_events(
            HOST, svc.port, "/v1/chat/completions",
            {**CHAT, "stream": True}, max_events=3)]
        for _ in range(100):
            if eng.contexts and eng.contexts[0].is_stopped \
                    and svc._inflight.get("m") == 0:
                break
            await asyncio.sleep(0.05)
        return (len(got), eng.contexts[0].is_stopped,
                svc._inflight.get("m"),
                svc._requests.get("m", "chat", "stream", "disconnect"))

    want, got = _fake_both(drive)
    assert got == want == (3, True, 0, 1)


def test_models_metrics_and_health_routes():
    """/v1/models and /metrics as the JAX service answers them. /health and
    /live answer {"status": "ok", "models": [...]}, the JAX handler's body:
    the JAX service itself answers them 500, because its fail-slow gauge
    dict is assigned over the `_health` handler (ROADMAP.md §C)."""
    async def drive(svc, Counter, Fail, Text):
        svc.models.add("m1", Counter(), "chat")
        svc.models.add("m2", Counter(), "completion")
        _, models = await request(HOST, svc.port, "GET", "/v1/models")
        health = [await request(HOST, svc.port, "GET", path)
                  for path in ("/health", "/live")]
        await request(HOST, svc.port, "POST", "/v1/chat/completions",
                      {**CHAT, "model": "m1"})
        status, raw = await request(HOST, svc.port, "GET", "/metrics")
        text = raw.decode()
        keep = [line for line in text.splitlines() if line.startswith(
            ("llm_http_service_requests_total",
             "# TYPE llm_http_service", "llm_http_service_inflight"))]
        return (json.loads(models), status, keep), [
            (st, json.loads(body)) for st, body in health]

    (want, _), (got, health) = _fake_both(drive)
    assert got == want
    assert [m["id"] for m in got[0]["data"]] == ["m1", "m2"]
    assert ('llm_http_service_requests_total{model="m1",endpoint="chat",'
            'request_type="unary",status="success"} 1') in got[2]
    assert health == [(200, {"status": "ok", "models": ["m1", "m2"]})] * 2


def _no_call_ids(obj):
    """Tool-call ids are random on both sides."""
    if isinstance(obj, dict):
        return {k: _no_call_ids(v) for k, v in obj.items()
                if not (k == "id" and str(v).startswith("call_"))}
    if isinstance(obj, list):
        return [_no_call_ids(v) for v in obj]
    return obj


@pytest.mark.parametrize("pieces", [
    [TOOL_TEXT[:8], TOOL_TEXT[8:]],                      # a bare JSON call
    ["just some ", "prose here"],                        # prose
    ["Let me check. ", "<tool", '_call>{"name": "f", "arguments": '
     '{"x": 1}}</tool_call>'],                           # a mid-text tag
    {1: ["Sure, ", "here is prose"],                     # n = 2, mixed
     0: ['{"name": "f", ', '"arguments": {"x": 1}}']},
])
def test_tool_calls_unary_and_streamed(pieces):
    async def drive(svc, Counter, Fail, Text):
        svc.models.add("m", Text(pieces))
        body = {**CHAT, "tools": TOOLS}
        status, unary = await _post(svc.port, "/v1/chat/completions", body)
        frames = await _stream(svc.port, "/v1/chat/completions",
                               {**body, "stream": True})
        plain = await _post(svc.port, "/v1/chat/completions", CHAT)
        return (status, _no_call_ids(_strip(unary)),
                [_no_call_ids(_strip(f)) for f in frames],
                _strip(plain[1]))

    want, got = _fake_both(drive)
    assert got == want
    fins = {c["index"]: c["finish_reason"] for c in got[1]["choices"]}
    if pieces[0] == TOOL_TEXT[:8] or isinstance(pieces, dict) \
            or "<tool" in pieces:
        assert fins[0] == "tool_calls"
        assert any(ch["delta"].get("tool_calls") for f in got[2]
                   for ch in f["choices"])
    else:
        assert fins == {0: "stop"}


def test_request_wire_forms():
    """from_json keeps unknown keys (the JAX models' extra="allow"),
    converts nested objects, and refuses n < 1 and wrong types; to_json
    drops None fields when asked."""
    from dynamo_tpu_torch.protocols.openai import (
        ChatCompletionRequest, ChatMessage, CompletionRequest, Ext,
        ValidationError,
    )
    req = ChatCompletionRequest.from_json(
        {**CHAT, "ext": {"top_k": 3}, "logit_bias": {"5": 1}, "n": 2.0,
         "tools": TOOLS, "tool_choice": "auto"})
    assert isinstance(req.messages[0], ChatMessage) and req.n == 2
    assert isinstance(req.ext, Ext) and req.ext.top_k == 3
    assert req.model_extra == {"logit_bias": {"5": 1}}
    assert req.to_json(exclude_none=True)["tool_choice"] == "auto"
    assert "seed" not in req.to_json(exclude_none=True)
    assert CompletionRequest.from_json(
        {"model": "m", "prompt": [[1, 2], [3]]}).prompt == [[1, 2], [3]]
    for bad in ({**CHAT, "n": 0}, {**CHAT, "stream": "yes"},
                {**CHAT, "temperature": True}, {**CHAT, "messages": [{}]},
                {"messages": CHAT["messages"]}, [CHAT]):
        with pytest.raises(ValidationError):
            ChatCompletionRequest.from_json(bad)


# -- (d): the entry point -------------------------------------------------------

def test_run_in_http_serves_a_request():
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http:0",
         "out=native", "tiny", "--device", "cpu", "--num-pages", "64"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env={**os.environ, "PYTHONPATH": REPO})
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("READY"):
                break
        m = re.match(r"READY http=:(\d+) model=tiny", line)
        assert m, line
        port = int(m.group(1))

        async def one():
            return await _stream(port, "/v1/chat/completions", {
                "model": "tiny", "stream": True, "max_tokens": 5,
                "messages": [{"role": "user", "content": "hello"}]})

        frames = asyncio.run(asyncio.wait_for(one(), 120))
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in frames if c["choices"])
        assert frames[-1]["choices"][0]["finish_reason"] in ("length",
                                                              "stop")
        assert len(text.encode("utf-8", "replace")) >= 1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


# -- (e): the routed path ----------------------------------------------------

def _routed_modules(pkg: str) -> dict:
    if pkg == "jax":
        from dynamo_tpu.frontend import discovery, serve
        from dynamo_tpu.runtime import distributed
        from dynamo_tpu.runtime.transports import memory
    else:
        from dynamo_tpu_torch.frontend import discovery, serve
        from dynamo_tpu_torch.runtime import distributed
        from dynamo_tpu_torch.runtime.transports import memory
    return {**_modules(pkg), "discovery": discovery, "serve": serve,
            "distributed": distributed, "memory": memory}


async def _serve_routed(pkg, jax_params, fn):
    """Run fn(port) against pkg's run_frontend on a memory plane, in front
    of one NativeEngineWorker served as ns.llm.generate (tiny, f32, the
    bridged weights), the model registered KV-routed."""
    m = _routed_modules(pkg)
    if pkg == "jax":
        engine = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    else:
        engine = TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cpu",
                               params=params_from_jax(jax_params, TCFG))
    card = m["card"].ModelDeploymentCard(
        name="tiny", arch="tiny", context_length=512, model_type="both",
        kv_page_size=ENGINE_KW["page_size"])  # the router's block size
    DRT = m["distributed"].DistributedRuntime
    plane = m["memory"].MemoryPlane()
    wrt = await DRT.create_local(plane, "w0")
    frt = await DRT.create_local(plane, "fe")
    worker = await m["worker"].NativeEngineWorker(engine).start()
    await m["worker"].serve_llm_worker(wrt, "ns", "llm", worker)
    await m["discovery"].register_model(wrt.kv, "tiny", "ns", "llm", card,
                                        model_type="both", kv_routed=True)
    svc = await m["serve"].run_frontend(frt, HOST, 0)
    watcher = getattr(svc, "watcher", None) or svc._watcher
    try:
        return await fn(svc.port, wrt, m, watcher)
    finally:
        await watcher.stop()
        await svc.stop()
        await frt.shutdown()
        await wrt.shutdown()
        await worker.stop()


ROUTED_CASES = [{"max_tokens": 10},
                {"max_tokens": 9, "temperature": 0.9, "seed": 5,
                 "ext": {"top_k": 30}}]


def test_routed_chat_equals_jax_frontend(jax_params):
    async def drive(port, wrt, m, watcher):
        out = []
        for kw in ROUTED_CASES:
            body = _body("/v1/chat/completions", kw, False)
            status, got = await _post(port, "/v1/chat/completions", body)
            assert status == 200, got
            out.append(_strip(got))
            out.append(_strip(await _stream(
                port, "/v1/chat/completions",
                _body("/v1/chat/completions", kw, True))))
        return out

    want, got = (asyncio.run(asyncio.wait_for(
        _serve_routed(pkg, jax_params, drive), 120))
        for pkg in ("jax", "torch"))
    want, got = list(want), list(got)
    assert got == want
    assert want[0]["choices"][0]["message"]["content"]
    assert want[0]["usage"]["completion_tokens"] == 10


def test_model_watcher_discovers_and_drops_models(jax_params):
    async def drive(port, wrt, m, watcher):
        status, raw = await request(HOST, port, "GET", "/v1/models")
        assert status == 200
        assert [x["id"] for x in json.loads(raw)["data"]] == ["tiny"]
        state = json.loads((await request(HOST, port, "GET",
                                          "/router/state"))[1])
        assert state["models"]["tiny"]["kv_routed"] is True
        assert list(state["models"]["tiny"]["instances"]) == ["w0"]
        # the router scores the served prefix after one request
        body = _body("/v1/chat/completions", {"max_tokens": 4}, False)
        body["messages"][0]["content"] = CONTENT * 3
        status, _ = await _post(port, "/v1/chat/completions", body)
        assert status == 200
        for _ in range(200):
            status, match = await _post(port, "/router/match", body)
            if match["scores"]:
                break
            await asyncio.sleep(0.01)
        # every full page of the prompt (its template adds 25 bytes)
        assert status == 200 and match["scores"] == {
            "w0": (len(CONTENT * 3) + 25) // ENGINE_KW["page_size"]}
        assert match["isl"] == len(CONTENT * 3) + 25
        decision = json.loads((await request(
            HOST, port, "GET", "/router/state"))[1])["models"]["tiny"][
                "decisions"][-1]
        assert decision["worker_id"] == "w0"
        metrics = (await request(HOST, port, "GET", "/metrics"))[1].decode()
        assert re.search(r"^llm_router_fallbacks 0(\.0)?$", metrics, re.M)
        assert "llm_cp_watch_events_applied" in metrics
        await m["discovery"].unregister_model(wrt.kv, "tiny", "both")
        for _ in range(200):
            status, raw = await request(HOST, port, "GET", "/v1/models")
            if not json.loads(raw)["data"]:
                break
            await asyncio.sleep(0.01)
        assert json.loads(raw)["data"] == []
        assert not watcher.pipelines
        return True

    assert asyncio.run(asyncio.wait_for(
        _serve_routed("torch", jax_params, drive), 120))


# -- (f) admission and deadlines, through each package's run_frontend ---------

def _wedging_echo(worker_mod, hang_after):
    """The package's EchoTokenEngine, silent after `hang_after` tokens with
    its transport up (a worker that stopped producing)."""
    class Wedging(worker_mod.EchoTokenEngine):
        async def generate(self, request, context):
            n = 0
            async for frame in super().generate(request, context):
                yield frame
                n += len(frame["token_ids"] if isinstance(frame, dict)
                         else frame.token_ids)
                if n >= hang_after:
                    await asyncio.Event().wait()
    return Wedging()


async def _serve_echo(pkg, engine, env, monkeypatch, fn, policy=None):
    """fn(port, svc) against pkg's run_frontend (the DYN_* knobs from
    `env`) on a memory plane, in front of `engine` served as
    ns.echo.generate with an `echo` model registered. `policy`: a
    ReliabilityPolicy for the frontend's watcher in place of
    run_frontend's default."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    m = _routed_modules(pkg)
    card = m["card"].ModelDeploymentCard(
        name="echo", arch="tiny", context_length=512, model_type="both",
        kv_page_size=ENGINE_KW["page_size"])
    DRT = m["distributed"].DistributedRuntime
    plane = m["memory"].MemoryPlane()
    wrt = await DRT.create_local(plane, "w0")
    frt = await DRT.create_local(plane, "fe")
    await m["worker"].serve_llm_worker(wrt, "ns", "echo", engine)
    await m["discovery"].register_model(wrt.kv, "echo", "ns", "echo", card,
                                        model_type="both")
    if policy is None:
        svc = await m["serve"].run_frontend(frt, HOST, 0)
        watcher = getattr(svc, "watcher", None) or svc._watcher
    else:
        svc = await m["service"].HttpService(HOST, 0).start()
        watcher = await m["discovery"].ModelWatcher(
            frt, svc.models, reliability_metrics=svc.reliability,
            reliability_policy=policy).start()
    try:
        for _ in range(200):
            _, raw = await request(HOST, svc.port, "GET", "/v1/models")
            if json.loads(raw)["data"]:
                break
            await asyncio.sleep(0.01)
        return await fn(svc.port, svc)
    finally:
        for k in env:
            monkeypatch.delenv(k)
        await watcher.stop()
        await svc.stop()
        await frt.shutdown()
        await wrt.shutdown()


ECHO = {"model": "echo", "messages": [{"role": "user", "content": "hold"}],
        "max_tokens": 200}


def test_admission_shed_matches_jax(monkeypatch):
    """DYN_MAX_INFLIGHT=1 DYN_ADMISSION_QUEUE=0 DYN_RETRY_AFTER_S=3: with
    one stream held open, a second request answers 429 with retry-after 3
    and the JAX service's body, counts as status="shed", and once the
    held stream ends a request answers 200 and nothing stays in flight."""
    env = {"DYN_MAX_INFLIGHT": "1", "DYN_ADMISSION_QUEUE": "0",
           "DYN_RETRY_AFTER_S": "3"}

    async def drive(port, svc):
        held = sse_events(HOST, port, "/v1/chat/completions",
                          {**ECHO, "stream": True})
        first = await held.__anext__()
        shed = [await request(HOST, port, "POST", "/v1/chat/completions",
                              {**ECHO, "max_tokens": 2}, return_headers=True)
                for _ in range(2)]
        await held.aclose()
        for _ in range(400):
            if svc._inflight.get("echo") == 0:
                break
            await asyncio.sleep(0.01)
        status, body = await _post(port, "/v1/chat/completions",
                                   {**ECHO, "max_tokens": 2})
        _, raw = await request(HOST, port, "GET", "/metrics")
        sheds = re.findall(r'^llm_http_service_requests_total\{[^}]*'
                           r'status="shed"\} (\S+)$', raw.decode(), re.M)
        rel = re.findall(r"^llm_reliability_shed_requests_total (\S+)$",
                         raw.decode(), re.M)
        return (json.loads(first[1])["choices"][0]["delta"]["role"],
                [(st, hdr.get("retry-after"), json.loads(b))
                 for st, b, hdr in shed],
                status, body["usage"]["completion_tokens"],
                [float(x) for x in sheds], [float(x) for x in rel],
                svc._inflight.get("echo"))

    def one(pkg):
        worker = _routed_modules(pkg)["worker"]
        return asyncio.run(asyncio.wait_for(_serve_echo(
            pkg, worker.EchoTokenEngine(delay_s=0.02), env, monkeypatch,
            drive), 120))

    want, got = one("jax"), one("torch")
    assert got == want
    assert got[1] == [(429, "3", {"error": {
        "message": "server overloaded, retry later", "code": 429}})] * 2
    assert got[2:] == (200, 2, [2.0], [2.0], 0)


def test_reliability_snapshot_published_matches_jax(monkeypatch):
    """The frontend's watcher publishes its reliability counters under
    `ns.frontend-<worker id>.reliability` (one publisher per namespace,
    every 2 s): after one shed request, a subscriber reads the same
    subject and snapshot as from the JAX frontend."""
    env = {"DYN_MAX_INFLIGHT": "1", "DYN_ADMISSION_QUEUE": "0"}

    async def drive(port, svc):
        watcher = getattr(svc, "watcher", None) or svc._watcher
        sub = await watcher.runtime.namespace("ns").component(
            "frontend-fe").subscribe("reliability")
        held = sse_events(HOST, port, "/v1/chat/completions",
                          {**ECHO, "stream": True})
        await held.__anext__()
        status, _ = await request(HOST, port, "POST",
                                  "/v1/chat/completions",
                                  {**ECHO, "max_tokens": 2})
        await held.aclose()
        try:
            while True:   # the first snapshot taken after the shed
                subject, snap = await sub.__anext__()
                if snap["shed_requests"] >= 1:
                    return (status, subject, snap,
                            sorted(watcher._rel_publishers))
        finally:
            await sub.aclose()

    def one(pkg):
        worker = _routed_modules(pkg)["worker"]
        return asyncio.run(asyncio.wait_for(_serve_echo(
            pkg, worker.EchoTokenEngine(delay_s=0.02), env, monkeypatch,
            drive), 120))

    got = one("torch")
    assert got == one("jax")
    assert got[:2] == (429, "ns.frontend-fe.reliability")
    assert got[2]["shed_requests"] == 1 and got[3] == ["ns"]


def test_request_deadline_matches_jax(monkeypatch):
    """DYN_REQUEST_DEADLINE_S=1 on the port: a worker that goes silent
    after 3 tokens ends the request at its deadline; the unary body and the
    SSE frames (finish_reason "error" after the 3 tokens' text) and the
    llm_reliability_deadline_exceeded_total count equal the JAX service's
    for the same 1 s deadline. The JAX pipeline drops the service's
    deadline when it makes the per-choice contexts (ROADMAP §C), so its
    deadline is armed by its reliability policy (`request_deadline_s`),
    where the JAX layer enforces it."""
    env = {"DYN_REQUEST_DEADLINE_S": "1.0"}

    async def drive(port, svc):
        status, body = await _post(port, "/v1/chat/completions", ECHO)
        frames = await _stream(port, "/v1/chat/completions",
                               {**ECHO, "stream": True})
        _, raw = await request(HOST, port, "GET", "/metrics")
        dl = re.findall(r"^llm_reliability_deadline_exceeded_total (\S+)$",
                        raw.decode(), re.M)
        return status, _strip(body), [_strip(f) for f in frames], dl

    def one(pkg):
        worker = _routed_modules(pkg)["worker"]
        if pkg == "jax":
            from dynamo_tpu.frontend.reliability import ReliabilityPolicy
            return asyncio.run(asyncio.wait_for(_serve_echo(
                pkg, _wedging_echo(worker, 3), {}, monkeypatch, drive,
                policy=ReliabilityPolicy(request_deadline_s=1.0)), 120))
        return asyncio.run(asyncio.wait_for(_serve_echo(
            pkg, _wedging_echo(worker, 3), env, monkeypatch, drive), 120))

    want, got = one("jax"), one("torch")
    assert got == want
    status, body, frames, dl = got
    assert status == 200
    assert body["choices"][0]["finish_reason"] == "error"
    assert body["usage"]["completion_tokens"] == 3
    assert frames[-1]["choices"][0]["finish_reason"] == "error"
    assert [float(x) for x in dl] == [2.0]
