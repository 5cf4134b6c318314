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

With a model watcher attached (`service.watcher`, frontend/serve.py), GET
/metrics also shows the control-plane gauges `llm_cp_*`
(runtime/cpstats.py) and the router gauges `llm_router_*`
(kv_router/stats.py), folded at render as the JAX service folds them
(service.py:169-177, :326-328), and two JSON routes show the KV routers:
GET /router/state (per model: its instances and their status, the
router's applied events and its recent decisions) and POST /router/match
(`{"model", "messages"}` or `{"model", "prompt"}`: each worker's matched
pages for that request's tokens, as the router would score it). A request
may name its id with an `x-request-id` header; the router's decisions are
keyed by it.

GET /metrics also shows the KV data-plane integrity gauges
`llm_kv_integrity_*`, the KV-transfer gauges `llm_kv_transfer_*`
(runtime/integrity.py STATS / XFER_STATS, :124-128 and :134-150 of the
JAX service) and the shared KV pool's `llm_kv_pool_*` (engine/kv_pool.py
POOL_STATS, :178-185 and :329-331), refreshed at render. A `prefetcher`
(engine/kv_pool.AdmissionPrefetcher, JAX :74-81, :412-424, :447-448)
warms each request's matched pool pages into its worker's HBM. They count this process's transfers:
a frontend in front of worker processes shows 0, and the workers report
theirs in $STATS (disagg/worker.py).

Admission (JAX :73-103, :425-446): with an `admission`
(frontend/reliability.AdmissionControl, legacy or class-aware) a request
past its caps answers 429 with a `retry-after` header and the error shape
{"error": {"message", "code"}}, and counts as status="shed". A request's
QoS class comes from its `x-qos-class` header (unknown or absent names
resolve to the policy default) and rides Context.baggage (:394-401);
`default_deadline_s` arms an end-to-end deadline on every request's
Context, which the reliability layer enforces and the wire carries to the
worker. Each request roots a trace (runtime/tracing.py; recorded only once
TRACER.configure(enabled=True) switches it on) whose context rides the
baggage too.

GET /metrics also shows the reliability counters (`llm_reliability_*`,
`llm_qos_shed_total`, on this service's registry: the discovery watcher
shares them), the fault-injection gauges `llm_fault_site_hits` /
`llm_fault_injections` (runtime/faults.py), the drain gauges `llm_drain_*`
(runtime/component.DRAIN_STATS) and the fail-slow gauges `llm_health_*` /
`llm_hedge_*` (runtime/health.py), folded at render (:115-133, :236-251).
GET /health and /live answer 200 with the served models; the JAX service's
health-gauge dict is assigned over its `_health` handler, so it answers
500 there (ROADMAP §C), and the port keeps the gauges under another name.

The cross-host pool's `llm_kv_pool_remote_*` / `llm_pool_ring_*`
(engine/pool_service.py REMOTE_STATS / RING_STATS, JAX :186-199) and the
streamed decode's `llm_kv_stream_*` (engine/streaming.py STREAM_STATS, JAX
:252-260) are folded at render the same way.

The engine ledger's `llm_engine_*` (observability/ledger.py LEDGER_STATS,
JAX :200-208, :339-341) is folded the same way, and `llm_router_*` carries
the transfer-aware selector's fields (kv_router/stats.py, JAX :169-177).

The closed-loop autoscaler's `llm_autoscaler_*` (runtime/autoscaler.py
AUTOSCALER_STATS, JAX :209-217, :345-347) are folded the same way.
GET /router/state names each KV-routed model's radix tree (`indexer`:
"native" or "python").

Left out, with the later slice that brings its module: the per-stream
transfer gauges.
Reference equivalent: the axum HttpService (reference:
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
from dynamo_tpu_torch.engine.kv_pool import POOL_STATS, KvPoolStats
from dynamo_tpu_torch.engine.pool_service import (
    REMOTE_STATS, RING_STATS, PoolRingStats, RemotePoolStats,
)
from dynamo_tpu_torch.engine.streaming import STREAM_STATS, StreamStats
from dynamo_tpu_torch.frontend.reliability import (
    AdmissionShed, ReliabilityMetrics,
)
from dynamo_tpu_torch.kv_router.stats import (
    ROUTER_STATS, RouterScoringStats,
)
from dynamo_tpu_torch.observability.ledger import LEDGER_STATS, LedgerStats
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
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.autoscaler import (
    AUTOSCALER_STATS, AutoscalerStats,
)
from dynamo_tpu_torch.runtime.component import DRAIN_STATS
from dynamo_tpu_torch.runtime.cpstats import CP_STATS, ControlPlaneStats
from dynamo_tpu_torch.runtime.health import (
    HEALTH_STATS, HEDGE_STATS, HealthStats, HedgeStats,
)
from dynamo_tpu_torch.runtime.integrity import (
    STATS as INTEGRITY, XFER_STATS, IntegrityStats, KvTransferStats,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.qos import DEFAULT_POLICY, QOS_KEY
from dynamo_tpu_torch.runtime.tracing import TRACE_KEY, TRACER

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
                 registry: Optional[MetricsRegistry] = None,
                 admission=None, default_deadline_s: Optional[float] = None,
                 prefetcher=None, qos_policy=None):
        """admission: an AdmissionControl (frontend/reliability.py); past
        its caps a request answers 429 with retry-after.
        default_deadline_s: the end-to-end deadline armed on every
        request's Context.
        prefetcher: an AdmissionPrefetcher (engine/kv_pool.py); each
        request's matched shared-pool pages are warmed into its target
        worker's HBM while it waits for admission, best-effort.
        qos_policy: the QosPolicy that resolves the x-qos-class header
        (None: DEFAULT_POLICY)."""
        self.qos_policy = qos_policy or DEFAULT_POLICY
        self.server = HttpServer(host, port)
        self.models = ModelManager()
        self.registry = registry or MetricsRegistry()
        # the reliability counters render on this service's /metrics; the
        # discovery watcher's pipelines share them
        self.reliability = ReliabilityMetrics(self.registry)
        self.admission = admission
        if self.admission is not None and self.admission.metrics is None:
            self.admission.metrics = self.reliability
        self.default_deadline_s = default_deadline_s
        self.prefetcher = prefetcher
        # prefetch tasks run on past their request: held until done
        self._prefetches: set = set()
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
        # the model watcher of a frontend over the control plane (None for
        # in-process pipelines); its gauges are folded at render
        self.watcher = None
        self._cp = {}
        self._router = {}
        # KV data-plane integrity and transfer volume (wire bytes: int8
        # pages plus scales on an int8 cache), refreshed at render
        self._integrity = {
            f.name: m.gauge(f"llm_kv_integrity_{f.name}",
                            f"kv data-plane integrity: {f.name}")
            for f in dataclasses.fields(IntegrityStats)}
        self._kv_xfer = {
            f.name: m.gauge(f"llm_kv_transfer_{f.name}",
                            f"kv transfer: cumulative {f.name} "
                            "(wire representation)")
            for f in dataclasses.fields(KvTransferStats)}
        # the shared KV pool (engine/kv_pool.py POOL_STATS): residency,
        # dedup, fetch and admission-prefetch outcomes, folded at render
        self._kv_pool = {
            name: m.gauge(f"llm_kv_pool_{name}",
                          f"shared kv pool: {name.replace('_', ' ')}")
            for name in KvPoolStats.FIELDS}
        # the cross-host pool service (engine/pool_service.py) and the
        # streamed decode (engine/streaming.py), folded at render
        self._kv_pool_remote = {
            name: m.gauge(f"llm_kv_pool_remote_{name}",
                          f"cross-host kv pool: {name.replace('_', ' ')}")
            for name in RemotePoolStats.FIELDS}
        self._pool_ring = {
            name: m.gauge(f"llm_pool_ring_{name}",
                          f"pool placement ring: {name.replace('_', ' ')}")
            for name in PoolRingStats.FIELDS}
        self._kv_stream = {
            name: m.gauge(f"llm_kv_stream_{name}",
                          f"tiered-kv streaming: {name.replace('_', ' ')}")
            for name in StreamStats.FIELDS}
        # the per-step engine ledger (observability/ledger.py
        # LEDGER_STATS, JAX :200-208): step counts by kind, recompiles,
        # padding waste, KV tier and batch occupancy, queue depth, EWMA
        # tok/s and the MFU estimate
        self._engine = {
            name: m.gauge(f"llm_engine_{name}",
                          f"engine step ledger: {name.replace('_', ' ')}")
            for name in LedgerStats.FIELDS}
        # the closed-loop autoscaler (AUTOSCALER_STATS): decisions by kind,
        # cooldown / hysteresis suppressions, do-no-harm refusals,
        # degraded-freeze ticks, last-decision age and the budget tuner
        self._autoscaler = {
            name: m.gauge(f"llm_autoscaler_{name}",
                          f"fleet autoscaler: {name.replace('_', ' ')}")
            for name in AutoscalerStats.FIELDS}
        # failpoint hits and injections, drains, and the fail-slow plane's
        # detection and hedging counters, folded at render
        self._fault_hits = m.gauge(
            "llm_fault_site_hits", "failpoint site evaluations", ("site",))
        self._fault_injected = m.gauge(
            "llm_fault_injections", "faults actually injected", ("site",))
        self._drain = {
            name: m.gauge(f"llm_drain_{name}", f"graceful drain: {name}")
            for name in DRAIN_STATS.snapshot()}
        self._health_gauges = {
            name: m.gauge(f"llm_health_{name}",
                          f"fail-slow detection: {name.replace('_', ' ')}")
            for name in HealthStats.FIELDS}
        self._hedge = {
            name: m.gauge(f"llm_hedge_{name}",
                          f"hedged dispatch: {name.replace('_', ' ')}")
            for name in HedgeStats.FIELDS}
        self._hedge_by_class = m.gauge(
            "llm_hedge_fired_by_class",
            "hedged dispatch: hedges fired per QoS class", ("qos",))
        s = self.server
        s.route("POST", "/v1/chat/completions", self._chat)
        s.route("POST", "/v1/completions", self._completions)
        s.route("GET", "/v1/models", self._models)
        s.route("GET", "/metrics", self._metrics)
        s.route("GET", "/health", self._health)
        s.route("GET", "/live", self._health)
        s.route("GET", "/router/state", self._router_state)
        s.route("POST", "/router/match", self._router_match)

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
        if self.watcher is not None:
            self._refresh_router_gauges()
        for gauges, stats in ((self._integrity, INTEGRITY),
                              (self._kv_xfer, XFER_STATS),
                              (self._kv_pool, POOL_STATS),
                              (self._kv_pool_remote, REMOTE_STATS),
                              (self._pool_ring, RING_STATS),
                              (self._kv_stream, STREAM_STATS),
                              (self._engine, LEDGER_STATS),
                              (self._autoscaler, AUTOSCALER_STATS),
                              (self._drain, DRAIN_STATS),
                              (self._health_gauges, HEALTH_STATS)):
            for name, value in stats.snapshot().items():
                gauges[name].set(value=float(value))
        snap = faults.REGISTRY.snapshot()
        for site, n in snap["hits"].items():
            self._fault_hits.set(site, value=float(n))
        for site, n in snap["injected"].items():
            self._fault_injected.set(site, value=float(n))
        for name in HedgeStats.FIELDS:
            self._hedge[name].set(value=float(getattr(HEDGE_STATS, name)))
        for cls, n in HEDGE_STATS.fired_by_class.items():
            self._hedge_by_class.set(cls, value=float(n))
        # the serving-path latency histograms (TTFT / ITL / schedule) live
        # on the process-global SERVING registry, observed where they occur
        return Response.text(self.registry.render() + SERVING.render(),
                             content_type="text/plain; version=0.0.4")

    def _refresh_router_gauges(self) -> None:
        """Fold the process-global control-plane and router counters into
        this registry's gauges (made at the first render with a watcher)."""
        m = self.registry
        if not self._cp:
            self._cp = {
                name: m.gauge(f"llm_cp_{name}",
                              f"control plane: {name.replace('_', ' ')}")
                for name in ControlPlaneStats.FIELDS}
            self._router = {
                name: m.gauge(f"llm_router_{name}",
                              f"router: {name.replace('_', ' ')}")
                for name in RouterScoringStats.FIELDS}
        for name, value in CP_STATS.snapshot().items():
            self._cp[name].set(value=float(value))
        for name, value in ROUTER_STATS.snapshot().items():
            self._router[name].set(value=float(value))

    def _pipeline(self, name: str):
        if self.watcher is not None:
            for p in self.watcher.pipelines.values():
                if p.card.name == name:
                    return p
        raise HttpError(404, f"model '{name}' not found")

    async def _router_state(self, req: Request) -> Response:
        if self.watcher is None:
            raise HttpError(404, "no model watcher")
        models = {}
        for p in self.watcher.pipelines.values():
            router = p.router
            models[p.card.name] = {
                "kv_routed": router is not None,
                "indexer": router.indexer.kind if router else None,
                "instances": {w: info.get("status", "ready")
                              for w, info in p.client.instances.items()},
                "events_applied": router.events_applied if router else 0,
                "decisions": list(router.decisions) if router else []}
        return Response.json({"models": models,
                              "router": ROUTER_STATS.snapshot()})

    async def _router_match(self, req: Request) -> Response:
        body = req.json()
        p = self._pipeline(body.get("model", ""))
        if p.router is None:
            raise HttpError(404, f"model '{p.card.name}' is not KV-routed")
        try:
            if "messages" in body:
                pre, _ = p.preprocessor.preprocess_chat(
                    ChatCompletionRequest.from_json(body))
            else:
                pre, _ = p.preprocessor.preprocess_completion(
                    CompletionRequest.from_json(body))
        except ValidationError as e:
            raise HttpError(422, str(e.errors[:3]))
        match = p.router.find_matches_for_tokens(pre.token_ids)
        return Response.json({
            "scores": match.scores, "isl": len(pre.token_ids),
            "required_blocks": -(-len(pre.token_ids) // p.router.block_size)})

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
        # the x-qos-class header names the tenant class; unknown or absent
        # names resolve to the policy default. The resolved name rides
        # Context.baggage across every wire hop, as the trace does.
        qos_cls = self.qos_policy.resolve(
            http_req.headers.get("x-qos-class", "")).name
        # one trace per HTTP request, rooted before the admission wait; the
        # root span ends in finish() below, where every exit funnels
        trace = TRACER.start_trace()
        # dynalint: span-ok=root-span-ends-in-the-idempotent-finish-callback
        root = TRACER.begin_span("http.request", trace, model=model,
                                 endpoint=endpoint,
                                 request_type=request_type)
        admitted = False
        done = None
        if self.prefetcher is not None:
            # the admission window is free time to move matched pool pages
            # into the target worker's HBM; a warm that lands after it
            # closes counts late
            done = asyncio.Event()
            task = asyncio.create_task(self.prefetcher.prefetch(oai_req,
                                                                done))
            self._prefetches.add(task)
            task.add_done_callback(self._prefetches.discard)
        if self.admission is not None:
            try:
                t_adm = time.monotonic()
                await self.admission.acquire(qos=qos_cls)
                admitted = True
                wait = time.monotonic() - t_adm
                SERVING.queue_wait.observe(qos_cls, value=wait)
                TRACER.record_span("admission.wait",
                                   root.context() if root else None, wait)
            except AdmissionShed as e:
                if done is not None:
                    done.set()
                    task.cancel()
                self._requests.inc(model, endpoint, request_type, "shed")
                TRACER.end_span(root, status="shed", error=True)
                # class-aware Retry-After: scaled by the shedder's class
                # queue depth; a constant in legacy mode
                raise HttpError(
                    429, "server overloaded, retry later",
                    headers={"retry-after": str(e.retry_after_s)})
        if done is not None:
            done.set()
        ctx = Context(http_req.headers.get("x-request-id") or None,
                      baggage={QOS_KEY: qos_cls})
        if root is not None:
            ctx.trace = root.context()
            ctx.baggage[TRACE_KEY] = ctx.trace.to_wire()
        if self.default_deadline_s is not None:
            ctx.set_deadline(self.default_deadline_s)
        self._inflight.inc(model)

        finished = False

        def finish(status: str):
            # idempotent: also reachable from the stream-guard aclose path
            # when the SSE generator is closed before its first iteration
            nonlocal finished
            if finished:
                return
            finished = True
            if admitted:
                self.admission.release(qos=qos_cls)
            self._inflight.dec(model)
            self._requests.inc(model, endpoint, request_type, status)
            self._duration.observe(model, value=time.perf_counter() - t0)
            TRACER.end_span(root, status=status, error=status == "error")

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
