"""OpenAI-compatible HTTP frontend service.

Copied from dynamo_tpu/frontend/service.py, trimmed to one process serving
in-process pipelines: `ModelManager`; the routes POST /v1/chat/completions,
POST /v1/completions, GET /v1/models, GET /metrics, GET /health and
GET /live; the request counter, in-flight gauge and duration histogram;
unary aggregation and the SSE stream with tool-call buffering; a client
disconnect stopping generation (`ctx.stop_generating()`); `_GuardedGen`.
GET /metrics renders the service's registry followed by the serving
histograms (observability/serving.py SERVING: TTFT and ITL).

Requests are validated by the port's dataclass protocols
(`Cls.from_json`, protocols/openai.py) in place of pydantic; a body that
does not fit answers 422 with the error shape {"error": {"message",
"code"}}, as the JAX service's does (its message text is pydantic's).

Left out, each with the later slice that brings its module: admission
control and 429 shedding, the reliability counters, the KV-pool
prefetcher, QoS classes from the x-qos-class header (every request runs in
the policy's default class), tracing spans, and the fault, integrity,
drain, KV-transfer, control-plane, router, pool, ledger, autoscaler and
fail-slow gauges. Reference equivalent: the axum HttpService (reference:
lib/llm/src/http/service/service_v2.rs:23-130, openai.rs:132-540).
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import AsyncIterator, Dict, Optional, Protocol

from dynamo_tpu_torch.frontend.http import (
    HttpError, HttpServer, Request, Response, StreamingResponse,
)
from dynamo_tpu_torch.llm.tool_calls import (
    TOOL_CALL_TAG, apply_tool_calls, could_be_tool_call_prefix,
    parse_tool_calls, tag_hold_len,
)
from dynamo_tpu_torch.observability.metrics import MetricsRegistry
from dynamo_tpu_torch.observability.serving import SERVING
from dynamo_tpu_torch.protocols import sse
from dynamo_tpu_torch.protocols.delta import (
    aggregate_chat_chunks, aggregate_completion_chunks,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatChoiceDelta, ChatCompletionChunk, ChatCompletionRequest,
    ChatStreamChoice, CompletionRequest, ModelInfo, ModelList,
    ValidationError,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.qos import DEFAULT_POLICY, QOS_KEY

log = logging.getLogger("dynamo_tpu_torch.frontend")


class OpenAIEngine(Protocol):
    """What the frontend needs from a model pipeline: chunk streams."""

    async def generate_chat(self, request: ChatCompletionRequest,
                            context: Context) -> AsyncIterator: ...

    async def generate_completion(self, request: CompletionRequest,
                                  context: Context) -> AsyncIterator: ...


class ModelManager:
    def __init__(self):
        self.chat: Dict[str, OpenAIEngine] = {}
        self.completion: Dict[str, OpenAIEngine] = {}

    def add(self, name: str, engine: OpenAIEngine,
            model_type: str = "chat") -> None:
        if model_type in ("chat", "both"):
            self.chat[name] = engine
        if model_type in ("completion", "both"):
            self.completion[name] = engine

    def remove(self, name: str, model_type: str = "both") -> None:
        if model_type in ("chat", "both"):
            self.chat.pop(name, None)
        if model_type in ("completion", "both"):
            self.completion.pop(name, None)

    def list_models(self) -> ModelList:
        names = sorted(set(self.chat) | set(self.completion))
        return ModelList(data=[ModelInfo(id=n) for n in names])


class HttpService:
    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 registry: Optional[MetricsRegistry] = None):
        self.server = HttpServer(host, port)
        self.models = ModelManager()
        self.registry = registry or MetricsRegistry()
        m = self.registry
        self._requests = m.counter(
            "llm_http_service_requests_total",
            "HTTP requests by model/endpoint/type/status",
            ("model", "endpoint", "request_type", "status"))
        self._inflight = m.gauge(
            "llm_http_service_inflight_requests",
            "requests currently being served", ("model",))
        self._duration = m.histogram(
            "llm_http_service_request_duration_seconds",
            "request duration", ("model",))
        s = self.server
        s.route("POST", "/v1/chat/completions", self._chat)
        s.route("POST", "/v1/completions", self._completions)
        s.route("GET", "/v1/models", self._models)
        s.route("GET", "/metrics", self._metrics)
        s.route("GET", "/health", self._health)
        s.route("GET", "/live", self._health)

    @property
    def port(self) -> int:
        return self.server.port

    async def start(self) -> "HttpService":
        await self.server.start()
        log.info("http frontend on :%d", self.server.port)
        return self

    async def stop(self) -> None:
        await self.server.stop()

    # -- handlers ------------------------------------------------------------

    async def _health(self, req: Request) -> Response:
        return Response.json({"status": "ok",
                              "models": [m.id for m in
                                         self.models.list_models().data]})

    async def _models(self, req: Request) -> Response:
        return Response.json(self.models.list_models().to_json())

    async def _metrics(self, req: Request) -> Response:
        # the serving-path latency histograms (TTFT / ITL) live on the
        # process-global SERVING registry, observed in the pipelines
        return Response.text(self.registry.render() + SERVING.render(),
                             content_type="text/plain; version=0.0.4")

    async def _chat(self, req: Request):
        try:
            request = ChatCompletionRequest.from_json(req.json())
        except ValidationError as e:
            raise HttpError(422, str(e.errors[:3]))
        engine = self.models.chat.get(request.model)
        if engine is None:
            raise HttpError(404, f"model '{request.model}' not found")
        return await self._run(req, request, "chat", request.model,
                               lambda ctx: engine.generate_chat(request, ctx))

    async def _completions(self, req: Request):
        try:
            request = CompletionRequest.from_json(req.json())
        except ValidationError as e:
            raise HttpError(422, str(e.errors[:3]))
        engine = self.models.completion.get(request.model)
        if engine is None:
            raise HttpError(404, f"model '{request.model}' not found")
        return await self._run(req, request, "completion", request.model,
                               lambda ctx: engine.generate_completion(
                                   request, ctx))

    # -- core ----------------------------------------------------------------

    async def _run(self, http_req: Request, oai_req, endpoint: str,
                   model: str, start_stream):
        request_type = "stream" if oai_req.stream else "unary"
        t0 = time.perf_counter()
        # the class rides Context.baggage; without the admission slice
        # every request runs in the policy default
        ctx = Context(baggage={QOS_KEY: DEFAULT_POLICY.default})
        self._inflight.inc(model)

        finished = False

        def finish(status: str):
            # idempotent: also reachable from the stream-guard aclose path
            # when the SSE generator is closed before its first iteration
            nonlocal finished
            if finished:
                return
            finished = True
            self._inflight.dec(model)
            self._requests.inc(model, endpoint, request_type, status)
            self._duration.observe(model, value=time.perf_counter() - t0)

        try:
            chunk_gen = await _ensure_aiter(start_stream(ctx))
        except Exception:
            finish("error")
            raise

        if not oai_req.stream:
            chunks = []
            try:
                async for chunk in chunk_gen:
                    chunks.append(chunk)
            except Exception:
                finish("error")
                raise
            finish("success")
            agg = (aggregate_chat_chunks if endpoint == "chat"
                   else aggregate_completion_chunks)(chunks)
            if endpoint == "chat" and getattr(oai_req, "tools", None):
                # a tools-carrying request may answer WITH a tool call:
                # parse each choice's text into OpenAI tool_calls
                # (reference: preprocessor/tools/response.rs)
                for choice in agg.choices:
                    choice.finish_reason = apply_tool_calls(
                        choice.message, choice.finish_reason)
            return Response.json(agg.to_json(exclude_none=True))

        # a tools-carrying streaming request buffers only while the
        # accumulated text could still BE a tool invocation (clients must
        # receive genuine calls as delta.tool_calls + finish_reason
        # "tool_calls", identical to unary). The moment the head cannot be
        # a tool-call dialect, buffered chunks flush and the stream passes
        # through normally.
        buffer_tools = (endpoint == "chat"
                        and bool(getattr(oai_req, "tools", None)))

        async def sse_gen():
            status = "success"
            # per-choice candidacy: each choice buffers independently while
            # ITS head could still be a tool call; a prose-answering choice
            # in an n>1 fan-out streams live the moment its own head
            # disqualifies. Chunks are split into single-choice chunks so
            # releases never reorder any one choice's deltas.
            cand_held = {}   # choice index -> [single-choice chunks]
            flushed = set()  # choice indexes streaming live
            heads = {}       # choice index -> accumulated content head
            usage_tail = []  # choice-less chunks (stream_options usage)
            # post-flush tag watch, PER CHOICE: prose streams live, but a
            # mid-text <tool_call> tag (the one dialect the unary parser
            # matches anywhere) must still resolve to delta.tool_calls
            # exactly as unary does: a choice's chunks are held while ITS
            # accumulated tail is a (possible) tag start
            pend = {}    # choice index -> held chunks
            tails = {}   # choice index -> held-back tail text
            tagged = set()  # choice indexes committed to a mid-text tag

            def scan(one):
                """Stream-mode gate. In tools mode `one` is always a
                single-choice chunk; returns the chunks safe to emit."""
                if not buffer_tools:
                    return [one]
                ch = one.choices[0]
                idx = ch.index
                c = ch.delta.content if ch.delta else None
                if idx not in tagged and c:
                    s = tails.get(idx, "") + c
                    if TOOL_CALL_TAG in s:
                        tagged.add(idx)
                        tails[idx] = s
                    else:
                        k = tag_hold_len(s)
                        tails[idx] = s[len(s) - k:] if k else ""
                if idx in tagged or tails.get(idx):
                    pend.setdefault(idx, []).append(one)
                    return []
                out = pend.pop(idx, [])
                out.append(one)
                return out

            def frame(chunk) -> bytes:
                return sse.encode_json_data(
                    chunk.to_json(exclude_none=True)).encode()

            try:
                async for chunk in chunk_gen:
                    if http_req.disconnected.is_set():
                        ctx.stop_generating()
                        status = "disconnect"
                        break
                    if buffer_tools:
                        if not chunk.choices:
                            usage_tail.append(chunk)
                            continue
                        outs = []
                        for ch in chunk.choices:
                            one = (chunk if len(chunk.choices) == 1
                                   else dataclasses.replace(chunk,
                                                            choices=[ch]))
                            idx = ch.index
                            if idx in flushed:
                                outs.extend(scan(one))
                                continue
                            cand_held.setdefault(idx, []).append(one)
                            if ch.delta and ch.delta.content:
                                heads[idx] = (heads.get(idx, "")
                                              + ch.delta.content)
                            if not could_be_tool_call_prefix(
                                    heads.get(idx, "")):
                                # this choice is prose: release it through
                                # the tag watch and stream it live
                                flushed.add(idx)
                                for h in cand_held.pop(idx):
                                    outs.extend(scan(h))
                        for out_chunk in outs:
                            yield frame(out_chunk)
                        continue
                    for out_chunk in scan(chunk):
                        yield frame(out_chunk)
                else:
                    # whatever is still held resolves like unary, per
                    # choice; usage-only chunks follow
                    for idx in sorted(set(cand_held) | set(pend)):
                        for out_chunk in _resolve_held_chunks(
                                cand_held.get(idx) or pend.get(idx) or []):
                            yield frame(out_chunk)
                    for u in usage_tail:
                        yield frame(u)
                    yield sse.DONE_FRAME.encode()
            except asyncio.CancelledError:
                ctx.stop_generating()
                status = "disconnect"
                raise
            except Exception as e:
                log.exception("stream error for %s", model)
                yield sse.encode_event(sse.SseEvent(
                    event="error", data=str(e))).encode()
                status = "error"
            finally:
                ctx.stop_generating()
                finish(status)

        def on_close():
            # closing a never-started generator skips its finally block; make
            # sure the inflight gauge and request counters still settle
            ctx.stop_generating()
            finish("disconnect")

        return StreamingResponse(_GuardedGen(sse_gen(), on_close))


class _GuardedGen:
    """Async-gen wrapper whose aclose() runs cleanup even when the wrapped
    generator was never iterated (plain aclose() would skip its body)."""

    def __init__(self, gen, on_close):
        self.gen = gen
        self.on_close = on_close

    def __aiter__(self):
        return self

    def __anext__(self):
        return self.gen.__anext__()

    async def aclose(self):
        try:
            await self.gen.aclose()
        finally:
            self.on_close()


async def _ensure_aiter(maybe_coro):
    if asyncio.iscoroutine(maybe_coro):
        return await maybe_coro
    return maybe_coro


def _resolve_held_chunks(held):
    """Buffered tools-mode stream: if the aggregate parses as tool calls,
    replace the content deltas with one tool_calls delta + a finish chunk;
    otherwise replay the original chunks unchanged."""
    if not held:
        return
    agg = aggregate_chat_chunks(held)
    calls_by_index = {}
    for choice in agg.choices:
        content = (choice.message.content
                   if isinstance(choice.message.content, str) else None)
        calls = parse_tool_calls(content or "")
        if calls:
            for i, c in enumerate(calls):
                c["index"] = i
            calls_by_index[choice.index] = calls
    if not calls_by_index:
        yield from held
        return
    proto = held[0]
    # one delta chunk per choice (tool_calls or the full text for prose
    # choices in a mixed n>1 fan-out), then one finish chunk for all
    for choice in agg.choices:
        calls = calls_by_index.get(choice.index)
        delta = (ChatChoiceDelta(role="assistant", tool_calls=calls)
                 if calls else
                 ChatChoiceDelta(role="assistant",
                                 content=choice.message.content or ""))
        yield ChatCompletionChunk(
            id=proto.id, created=proto.created, model=proto.model,
            choices=[ChatStreamChoice(index=choice.index, delta=delta)])
    yield ChatCompletionChunk(
        id=proto.id, created=proto.created, model=proto.model,
        choices=[ChatStreamChoice(
            index=choice.index, delta=ChatChoiceDelta(),
            finish_reason=("tool_calls" if choice.index in calls_by_index
                           else choice.finish_reason))
            for choice in agg.choices])
    # trailing usage-only chunks (stream_options.include_usage) must
    # survive the rewrite
    for c in held:
        if c.usage is not None and not c.choices:
            yield c
