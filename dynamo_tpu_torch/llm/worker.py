"""LLM worker: serves a token-level engine to a pipeline.

Copied from dynamo_tpu/llm/worker.py for the slice: `NativeEngineWorker`
(async request fan-in, the engine step loop in an executor thread,
per-request frame fan-out) and `EchoTokenEngine` (the deterministic
no-hardware engine). KV-event and metrics publishers, tracing and the
profiler hook come with the runtime slice. Requests are
PreprocessedRequest objects and frames EngineOutput objects (in-process;
the JAX package passes their dict forms over its wire).
"""
from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from dynamo_tpu_torch.engine.scheduler import EngineRequest, SamplingParams
from dynamo_tpu_torch.protocols.common import (
    EngineOutput, FinishReason, PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.qos import qos_of

log = logging.getLogger("dynamo_tpu_torch.worker")


def to_engine_request(pre: PreprocessedRequest,
                       qos: str = "") -> EngineRequest:
    s, st, out = pre.sampling, pre.stop, pre.output
    return EngineRequest(
        request_id=pre.request_id,
        prompt=list(pre.token_ids),
        qos=qos,
        params=SamplingParams(
            max_tokens=max(1, st.max_tokens or 16),
            temperature=s.temperature if s.temperature is not None else 0.0,
            top_k=s.top_k or 0,
            top_p=s.top_p if s.top_p is not None else 1.0,
            seed=s.seed or 0,
            ignore_eos=st.ignore_eos,
            stop_token_ids=tuple(st.stop_token_ids_hidden or ()),
            min_tokens=max(0, st.min_tokens or 0),
            repetition_penalty=s.repetition_penalty or 1.0,
            logprobs=out.logprobs,
        ))


class EchoTokenEngine(AsyncEngine):
    """Echoes the prompt tokens back, one frame per token, rate-limited."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    async def generate(self, request: PreprocessedRequest,
                       context: Context):
        prompt = request.token_ids
        n = request.stop.max_tokens or len(prompt)
        emitted = 0
        for tok in prompt:
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
    per-request frame fan-out."""

    def __init__(self, engine):
        self.engine = engine
        self._queues: Dict[str, asyncio.Queue] = {}
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        # engine state is touched ONLY by the step loop (adds/aborts are
        # staged here) so nothing mutates the scheduler while a device step
        # runs in the executor thread
        self._pending_adds: list = []
        self._pending_aborts: list = []

    async def start(self) -> "NativeEngineWorker":
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

    # -- engine loop ----------------------------------------------------------

    def _apply_pending(self) -> None:
        """Apply staged adds/aborts; runs only between device steps."""
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
                if not self._pending_adds:
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

    # -- AsyncEngine ----------------------------------------------------------

    async def _stream(self, request_id: str, context: Context,
                      q: asyncio.Queue):
        """Drain a request's frame queue, honoring client-side stop."""
        stop = asyncio.create_task(context.wait_stopped())
        get = None
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
                yield frame
                if frame.finish_reason is not None:
                    return
        finally:
            stop.cancel()
            if get is not None:  # client closed the stream mid-get
                get.cancel()
                self._pending_aborts.append(request_id)
                self._wake.set()

    async def generate(self, request: PreprocessedRequest,
                       context: Context):
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
