"""LLM worker: serves a token-level engine to a pipeline or an endpoint.

Copied from dynamo_tpu/llm/worker.py: `NativeEngineWorker` (async request
fan-in, the engine step loop in an executor thread, per-request frame
fan-out, and from its step loop the allocator's KV events and the engine's
metrics for the router, :225-280), `submit` (:147-154: `fn(engine)` run
on the step loop between device steps, the one way the disaggregation
layer touches the engine), `EchoTokenEngine` (the deterministic
no-hardware engine; a migrated stream resumes mid-prompt, :96), `serve_llm_worker` (:362-396) and
`install_graceful_drain` (:398-446). Requests arrive as PreprocessedRequest
objects in-process or as their dict forms over the wire; frames are
EngineOutput objects (runtime/component.py sends their dict forms).

The publishers run on the event loop, after the executor step returns:
the events come from the host allocator, so draining them adds no device
sync to a decode window. The worker drains the events after every step
whether or not a publisher is wired, so a worker serving a local pipeline
does not accumulate them. A request's multimodal parts (JAX :44-64)
become the engine request's raw pixels, which the engine encodes at
admission, or, for the embeds a disaggregated decode worker ships, its
spans with their salts. With a shared KV pool attached to the engine
(JAX :128-132, :264-280) the drain runs after every step even without a
router (it also tees sealed pages into the pool), and the pool's Stored /
Removed events for this worker's pages go out under the source id
`pool:{worker_id}` (`pool_publisher`, wired with the event publisher).

Tracing: every frame with tokens records a `decode.emit` instant (`n`
tokens) under the request's trace (JAX :313-316). The profiler hook (JAX
:31-32, :157-190) is the JAX feature on torch's profiler: with
`DYN_TORCH_PROFILE_DIR` set, the first worker started in a process runs
`torch.profiler` (CPU activity, and CUDA when the card is there) until it
stops, then writes a chrome trace `worker-<pid>-<n>.pt.trace.json` into
that directory. The profiler is process-global, so only that first worker
starts it and only it stops it.
"""
from __future__ import annotations

import asyncio
import itertools
import logging
import os
from typing import Dict, Optional

import numpy as np

from dynamo_tpu_torch.engine.scheduler import EngineRequest, SamplingParams
from dynamo_tpu_torch.kv_router.protocols import pool_source_id
from dynamo_tpu_torch.kv_router.publisher import (
    KvEventPublisher, KvMetricsPublisher,
)
from dynamo_tpu_torch.protocols.common import (
    EngineOutput, FinishReason, PreprocessedRequest, preprocessed_from_wire,
)
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.qos import qos_of
from dynamo_tpu_torch.runtime.tracing import TRACER

log = logging.getLogger("dynamo_tpu_torch.worker")

PROFILE_DIR_ENV = "DYN_TORCH_PROFILE_DIR"
# the process-wide torch profiler session's owner (NativeEngineWorker.start)
_PROFILE_OWNER = None
_PROFILE_SEQ = itertools.count()


def to_engine_request(pre: PreprocessedRequest,
                       qos: str = "") -> EngineRequest:
    s, st, out = pre.sampling, pre.stop, pre.output
    # resume from a prefix: the committed tokens ride in token_ids and are
    # charged against the original budgets
    resume = pre.resume_committed or 0
    mm_pixels = mm_spans = None
    if pre.mm_parts:
        mm_pixels, mm_spans = [], []
        for p in pre.mm_parts:
            arr = (np.frombuffer(p.data, dtype=np.dtype(p.dtype))
                   .reshape(p.shape).astype(np.float32))
            if p.kind == "embeds" and p.salt is not None:
                # pre-encoded patch embeds + the pixels' salt (disagg
                # mm_transfer="embeds"): no vision tower runs here
                mm_spans.append((p.offset, arr, int(p.salt)))
            else:
                mm_pixels.append((p.offset, arr))
        mm_pixels = mm_pixels or None
        mm_spans = mm_spans or None
    return EngineRequest(
        request_id=pre.request_id,
        prompt=list(pre.token_ids),
        mm_pixels=mm_pixels,
        mm_spans=mm_spans,
        qos=qos,
        params=SamplingParams(
            max_tokens=max(1, (st.max_tokens or 16) - resume),
            temperature=s.temperature if s.temperature is not None else 0.0,
            top_k=s.top_k or 0,
            top_p=s.top_p if s.top_p is not None else 1.0,
            seed=s.seed or 0,
            ignore_eos=st.ignore_eos,
            stop_token_ids=tuple(st.stop_token_ids_hidden or ()),
            min_tokens=max(0, (st.min_tokens or 0) - resume),
            repetition_penalty=s.repetition_penalty or 1.0,
            logprobs=out.logprobs,
        ))


class EchoTokenEngine(AsyncEngine):
    """Echoes the prompt tokens back, one frame per token, rate-limited."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    async def generate(self, request, context: Context):
        if isinstance(request, dict):
            request = preprocessed_from_wire(request)
        # resume from a prefix (a migrated stream): token_ids is the prompt
        # plus the committed tokens, which for an echo are the prompt's own
        # head, so the echo continues mid-prompt and the budget is charged
        # for what was already emitted (JAX llm/worker.py:96)
        resume = request.resume_committed or 0
        prompt = (request.token_ids[:len(request.token_ids) - resume]
                  if resume else request.token_ids)
        n = request.stop.max_tokens or len(prompt)
        emitted = resume
        for tok in prompt[resume:]:
            if emitted >= n or context.is_stopped:
                break
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
            emitted += 1
            yield EngineOutput(token_ids=[tok])
        reason = (FinishReason.LENGTH if emitted >= n
                  else FinishReason.CANCELLED if context.is_stopped
                  else FinishReason.STOP)
        yield EngineOutput(token_ids=[], finish_reason=reason)


class NativeEngineWorker(AsyncEngine):
    """Serves a NativeEngine: async request fan-in, device step loop,
    per-request frame fan-out, KV event + metrics publication."""

    # discovery role on the instance key (None: an aggregated worker, a
    # wildcard); the disagg workers set "decode" / "prefill"
    serving_role: Optional[str] = None

    def __init__(self, engine):
        self.engine = engine
        self.metrics_publisher = KvMetricsPublisher()
        # wired by serve_llm_worker once the worker has a runtime identity
        self.event_publisher: Optional[KvEventPublisher] = None
        # the shared pool's events for this worker's pages, under the
        # `pool:{worker_id}` source (wired with event_publisher)
        self.pool_publisher: Optional[KvEventPublisher] = None
        self._queues: Dict[str, asyncio.Queue] = {}
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        # engine state is touched ONLY by the step loop (adds/aborts are
        # staged here) so nothing mutates the scheduler while a device step
        # runs in the executor thread
        self._pending_adds: list = []
        self._pending_aborts: list = []
        self._pending_ops: list = []
        self._profiler = None
        self.profile_path: Optional[str] = None

    async def start(self) -> "NativeEngineWorker":
        global _PROFILE_OWNER
        trace_dir = os.environ.get(PROFILE_DIR_ENV)
        if trace_dir and _PROFILE_OWNER is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(trace_dir, exist_ok=True)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            _PROFILE_OWNER = self
            self.profile_path = os.path.join(
                trace_dir, f"worker-{os.getpid()}-{next(_PROFILE_SEQ)}"
                ".pt.trace.json")
            log.info("torch profiler tracing to %s", self.profile_path)
        self._loop_task = asyncio.create_task(self._step_loop())
        return self

    async def stop(self) -> None:
        if self._loop_task:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None
        self.engine.close()
        global _PROFILE_OWNER
        if self._profiler is not None and _PROFILE_OWNER is self:
            prof, self._profiler = self._profiler, None
            _PROFILE_OWNER = None
            prof.stop()
            prof.export_chrome_trace(self.profile_path)
            log.info("torch profiler trace written to %s", self.profile_path)

    def submit(self, fn) -> asyncio.Future:
        """Stage `fn(engine)` to run between device steps; returns a future
        of its result. The only safe way to touch engine state from outside
        the step loop."""
        fut = asyncio.get_running_loop().create_future()
        self._pending_ops.append((fn, fut))
        self._wake.set()
        return fut

    # -- engine loop ----------------------------------------------------------

    def _apply_pending(self) -> None:
        """Apply staged ops/adds/aborts; runs only between device steps."""
        ops, self._pending_ops = self._pending_ops, []
        for fn, fut in ops:
            try:
                result = fn(self.engine)
            except Exception as e:  # surfaced to the submitter
                if not fut.done():
                    fut.set_exception(e)
            else:
                if not fut.done():
                    fut.set_result(result)
        adds, self._pending_adds = self._pending_adds, []
        for req in adds:
            try:
                self.engine.add_request(req)
            except (ValueError, MemoryError) as e:
                q = self._queues.get(req.request_id)
                if q is not None:
                    # ValueError = deterministic request rejection;
                    # MemoryError = THIS worker is out of capacity
                    q.put_nowait(EngineOutput(
                        finish_reason=FinishReason.ERROR, text=str(e),
                        retryable=isinstance(e, MemoryError)))
        aborts, self._pending_aborts = self._pending_aborts, []
        for rid in aborts:
            self.engine.abort(rid)

    async def _step_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            self._apply_pending()
            if not self.engine.has_work():
                self._wake.clear()
                if not self._pending_adds and not self._pending_ops:
                    self.metrics_publisher.update(self.engine.metrics())
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                    except asyncio.TimeoutError:
                        pass
                continue
            try:
                outputs = await loop.run_in_executor(None, self.engine.step)
            except Exception:
                log.exception("engine step failed; failing active requests")
                for q in self._queues.values():
                    q.put_nowait(EngineOutput(
                        finish_reason=FinishReason.ERROR, retryable=True))
                self._queues.clear()
                self._pending_adds.clear()
                continue
            for ev in outputs:
                q = self._queues.get(ev.request_id)
                if q is None:
                    continue
                q.put_nowait(EngineOutput(
                    token_ids=[ev.token] if ev.token is not None else [],
                    log_probs=([ev.logprob] if ev.logprob is not None
                               else None),
                    top_logprobs=([[[float(t), lp] for t, lp in
                                    ev.top_logprobs]]
                                  if ev.top_logprobs is not None else None),
                    finish_reason=(FinishReason(ev.finish_reason)
                                   if ev.finish_reason else None)))
            self.metrics_publisher.update(self.engine.metrics())
            events = self.engine.drain_kv_events()
            if self.event_publisher is not None and events:
                await self.event_publisher.publish_allocator_events(events)
            pool = getattr(self.engine, "kv_pool", None)
            if pool is not None and self.pool_publisher is not None:
                pev = pool.drain_events(self.engine.kv_pool_source)
                if pev:
                    await self.pool_publisher.publish_allocator_events(pev)

    # -- AsyncEngine ----------------------------------------------------------

    async def _stream(self, request_id: str, context: Context,
                      q: asyncio.Queue):
        """Drain a request's frame queue, honoring client-side stop."""
        stop = asyncio.create_task(context.wait_stopped())
        get = None
        trace = context.trace
        try:
            while True:
                get = asyncio.create_task(q.get())
                done, _ = await asyncio.wait(
                    {get, stop}, return_when=asyncio.FIRST_COMPLETED)
                if stop in done and get not in done:
                    get.cancel()
                    get = None
                    self._pending_aborts.append(request_id)
                    self._wake.set()
                    yield EngineOutput(finish_reason=FinishReason.CANCELLED)
                    return
                frame: EngineOutput = get.result()
                get = None
                if frame.token_ids:
                    # a per-emit instant (the explain tool's decode gaps);
                    # one branch while tracing is off
                    TRACER.event("decode.emit", trace,
                                 n=len(frame.token_ids))
                yield frame
                if frame.finish_reason is not None:
                    return
        finally:
            stop.cancel()
            if get is not None:  # client closed the stream mid-get
                get.cancel()
                self._pending_aborts.append(request_id)
                self._wake.set()

    async def generate(self, request, context: Context):
        if isinstance(request, dict):
            request = preprocessed_from_wire(request)
        if request.request_id in self._queues:
            # a second dispatch of a live id would clobber the first
            # stream's frame queue
            yield EngineOutput(
                finish_reason=FinishReason.ERROR, retryable=False,
                text=f"request {request.request_id} already in flight on "
                     "this worker")
            return
        q: asyncio.Queue = asyncio.Queue()
        self._queues[request.request_id] = q
        try:
            self._pending_adds.append(
                to_engine_request(request, qos=qos_of(context.baggage)))
            self._wake.set()
            async for frame in self._stream(request.request_id, context, q):
                yield frame
        finally:
            self._queues.pop(request.request_id, None)

    # -- stats ----------------------------------------------------------------

    def stats_handler(self) -> dict:
        """The endpoint's $STATS reply: the engine's latest metrics (the
        router's load inputs) and the kernel launch counts of this process
        (each wrapper's count, which the window graphs' replays add to,
        and the launches of the eager warm-ups before captures), the decode
        path the engine resolved and its window graphs' captures (with
        their wall-clock times) and replays (by path: a speculative
        engine's verify replays under "verify"), a draft model's proposal
        graphs, and the host wall time of the decode loop's phases (with a
        speculative engine's "verify" and "propose")."""
        from dynamo_tpu_torch.engine.window_graph import KERNELS
        graphs = self.engine.graphs
        out = {}
        draft = getattr(self.engine, "_draft", None)
        if draft is not None:
            # the draft model's proposal graphs: their replays and the
            # kernel launches the replays alone added
            dg = draft.graphs
            out["draft"] = {"model": draft.cfg.name, "path": draft.path,
                            "layers": draft.cfg.num_layers, "k": draft.k,
                            "captured": dg.captured, "replays": dg.replays,
                            "replay_launches": dict(dg.replay_launches),
                            "warmup_launches": dict(dg.warmup_launches),
                            "catchup_buckets": dict(draft.catchup_buckets)}
        return {**self.metrics_publisher.stats_handler(), **out,
                "decode_window_steps": self.engine.decode_window_steps,
                "decode_path": self.engine.decode_path,
                "decode_path_reason": self.engine.decode_path_reason,
                "kernel_launches": {
                    name: getattr(mod, attr)
                    for name, (mod, attr, _) in KERNELS.items()},
                "graph_warmup_launches": dict(graphs.warmup_launches),
                "phases": self.engine.phases.split(),
                "graphs": {"captured": graphs.captured,
                           "capture_times": list(graphs.capture_times),
                           "replays": graphs.replays,
                           "replay_paths": dict(graphs.replay_paths)}}


async def serve_llm_worker(runtime, namespace: str, component: str,
                           engine: AsyncEngine, endpoint: str = "generate"):
    """Register + serve an LLM engine endpoint with stats wired up.

    Also wires the KV event publisher of an engine worker (built before
    the runtime existed): without it a KV-routed frontend receives no
    overlap data from the worker. The worker id is
    the runtime's: that is the instance id routers see in the event stream
    and the instance table. The model card rides the model registry
    (frontend/discovery.register_model); the JAX package also copies it
    into the instance key, which nothing in the port reads."""
    comp = runtime.namespace(namespace).component(component)
    ep = comp.endpoint(endpoint)
    if getattr(engine, "event_publisher", "absent") is None:
        engine.event_publisher = KvEventPublisher(comp, runtime.worker_id)
        engine.pool_publisher = KvEventPublisher(
            comp, pool_source_id(runtime.worker_id))
    stats = getattr(engine, "stats_handler", None)
    # the serving role on the instance key (llm/worker.py:383-393): the
    # disagg workers describe themselves, aggregated ones carry none
    role = getattr(engine, "serving_role", None)
    return await ep.serve(engine, stats_handler=stats,
                          metadata={"role": role} if role else None)


def install_graceful_drain(runtime, served) -> None:
    """SIGTERM / SIGINT -> graceful drain for a serving worker process:
    mark the instance DRAINING (routers fence it out of new assignments
    while the request subject stays up), let in-flight response streams
    finish (bounded by DYN_DRAIN_TIMEOUT_S, default 30 s), cut whatever is
    left, deregister, then shut the runtime down so the process exits
    cleanly. A second signal skips the wait for in-flight streams."""
    import os
    import signal as _signal

    timeout_s = float(os.environ.get("DYN_DRAIN_TIMEOUT_S", "30"))
    loop = asyncio.get_running_loop()
    # the loop holds only weak task refs: keep the drain task here
    state = {"task": None, "force": False}

    async def drain():
        log.warning("SIGTERM: draining — fencing instance, then up to "
                    "%.0fs for %d in-flight stream(s)", timeout_s,
                    len(served.inflight))
        try:
            await served.drain(timeout_s=timeout_s, poll_s=0.2,
                               force=lambda: state["force"])
        except Exception:  # noqa: BLE001 — exit cleanly regardless
            log.exception("drain failed; shutting down anyway")
        await runtime.shutdown()

    def on_signal():
        if state["task"] is None:
            state["task"] = asyncio.ensure_future(drain())
        else:
            state["force"] = True  # escalate: stop waiting on streams

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        loop.add_signal_handler(sig, on_signal)
