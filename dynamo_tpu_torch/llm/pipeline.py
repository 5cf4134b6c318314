"""Model pipelines: OpenAI request -> preprocess -> engine -> postprocess.

Copied from dynamo_tpu/llm/pipeline.py for the slice: `Pipeline` (render +
tokenize, stream token frames from an engine, incremental detokenisation
with the stop-string jail, OpenAI delta chunks, the TTFT / ITL histograms
observed at the frame boundary) and `LocalPipeline` (the engine
in-process). The pipeline-graph segment and the remote sink come with the
endpoint slice; here the sink is the engine itself.
"""
from __future__ import annotations

import asyncio
import copy
import logging
import time
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.llm.backend import BackendPostprocessor
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.observability.serving import SERVING
from dynamo_tpu_torch.protocols.common import (
    EngineOutput, FinishReason, PreprocessedRequest,
)
from dynamo_tpu_torch.protocols.delta import (
    ChatDeltaGenerator, CompletionDeltaGenerator,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest, CompletionRequest, Usage,
)
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.qos import qos_label

log = logging.getLogger("dynamo_tpu_torch.pipeline")


class _LogprobShaper:
    """Per-choice logprob entries gated behind the stop-string jail: an
    entry is released only once the cumulative EMITTED text covers it, so
    the response never carries logprobs for suppressed or held text."""

    def __init__(self, kind: str, token_str, offset: int = 0):
        self.kind = kind
        self._token_str = token_str
        self._pending = []       # (piece, logprob, top) not yet emitted
        self._emitted_budget = 0  # chars of emitted text not yet attributed
        self._offset = offset

    def push(self, frame: EngineOutput, pieces, emitted_text: str):
        """Feed one engine frame + its emitted text; returns the response
        logprobs object covering entries that became emittable, or None."""
        if frame.log_probs is not None:
            tops = frame.top_logprobs or [[]] * len(frame.token_ids)
            self._pending += list(zip(pieces, frame.log_probs, tops))
        self._emitted_budget += len(emitted_text)
        released = []
        while self._pending and len(self._pending[0][0]) <= \
                self._emitted_budget:
            piece, lp, top = self._pending.pop(0)
            self._emitted_budget -= len(piece)
            released.append((piece, lp, top))
        if not released:
            return None
        if self.kind == "chat":
            content = []
            for piece, lp, top in released:
                alts = []
                for t, v in top:
                    s = self._token_str(int(t))
                    alts.append({"token": s, "logprob": v,
                                 "bytes": list(s.encode())})
                content.append({"token": piece, "logprob": lp,
                                "bytes": list(piece.encode()),
                                "top_logprobs": alts})
            return {"content": content}
        obj = {"text_offset": [], "token_logprobs": [], "tokens": [],
               "top_logprobs": []}
        for piece, lp, top in released:
            obj["text_offset"].append(self._offset)
            self._offset += len(piece)
            obj["token_logprobs"].append(lp)
            obj["tokens"].append(piece)
            obj["top_logprobs"].append(
                {self._token_str(int(t)): v for t, v in top})
        return obj


class Pipeline:
    """Shared OpenAI-facing plumbing; subclasses supply `_token_stream`."""

    def __init__(self, card: ModelDeploymentCard):
        self.card = card
        self.preprocessor = OpenAIPreprocessor(card)

    def _token_stream(self, pre: PreprocessedRequest,
                      context: Context) -> AsyncIterator[EngineOutput]:
        raise NotImplementedError

    # -- OpenAIEngine interface ----------------------------------------------

    async def generate_chat(self, request: ChatCompletionRequest,
                            context: Context):
        pre, _ = self.preprocessor.preprocess_chat(request, context.id)
        gen = ChatDeltaGenerator(request.model)
        # non-streaming responses always carry usage; streaming only on
        # stream_options.include_usage
        want_usage = not request.stream or bool(
            request.stream_options
            and request.stream_options.get("include_usage"))
        async for chunk in self._drive_n(pre, context, gen, "chat",
                                         want_usage):
            yield chunk

    async def generate_completion(self, request: CompletionRequest,
                                  context: Context):
        pre, _ = self.preprocessor.preprocess_completion(request, context.id)
        gen = CompletionDeltaGenerator(request.model)
        want_usage = not request.stream or bool(
            request.stream_options
            and request.stream_options.get("include_usage"))
        echo_text = None
        if pre.output.echo:
            echo_text = self.preprocessor.tokenizer.decode(pre.token_ids)
        async for chunk in self._drive_n(pre, context, gen, "completion",
                                         want_usage, echo_text):
            yield chunk

    def _token_str(self, tid: int) -> str:
        return self.preprocessor.tokenizer.decode([tid])

    async def _drive_n(self, pre: PreprocessedRequest, context: Context,
                       gen, kind: str, want_usage: bool,
                       echo_text: Optional[str] = None):
        """Drive n parallel engine streams (OpenAI `n` choices) into one
        chunk stream. Choice i runs as its own engine request (distinct id
        and seed); per-choice stop strings stop only that choice."""
        n = max(1, pre.sampling.n)
        tokenizer = self.preprocessor.tokenizer
        pres = [pre]
        for i in range(1, n):
            clone = copy.deepcopy(pre)
            clone.request_id = f"{pre.request_id}#{i}"
            clone.sampling.seed = ((pre.sampling.seed or 0)
                                   + i * 0x1F123BB5) & 0x7FFFFFFF
            pres.append(clone)
        ctxs = [Context(p.request_id, context.baggage) for p in pres]

        async def cascade_stop():
            await context.wait_stopped()
            for c in ctxs:
                c.stop_generating()

        watcher = asyncio.create_task(cascade_stop())
        q: asyncio.Queue = asyncio.Queue()

        async def pump(i: int):
            try:
                async for frame in self._token_stream(pres[i], ctxs[i]):
                    await q.put((i, frame, None))
            except Exception as e:  # surface as an error frame
                await q.put((i, None, e))
            finally:
                await q.put((i, None, None))

        pumps = [asyncio.create_task(pump(i)) for i in range(n)]
        # serving-path latency histograms (observability/serving.py): TTFT
        # = request start -> first token-carrying frame, ITL = gap between
        # successive token frames, both per choice stream at the frame
        # (commit) boundary; unclassed requests label as the policy default
        model_label = pre.model or self.card.name
        qos = qos_label(context.baggage)
        t_start = time.monotonic()
        last_emit: dict = {}
        posts = [BackendPostprocessor(tokenizer, pre.stop.stop or ())
                 for _ in range(n)]
        shapers = [_LogprobShaper(kind, self._token_str,
                                  len(echo_text or "")) for _ in range(n)]
        finishes: dict = {}
        n_out = 0
        try:
            if echo_text:
                for i in range(n):
                    yield gen.text_chunk(echo_text, index=i)
            active = n
            while active:
                i, frame, err = await q.get()
                if err is not None:
                    log.error("stream %d failed: %s", i, err)
                if frame is None and err is None:
                    active -= 1
                    if i not in finishes:
                        # stream ended with no finish frame: abnormal
                        # termination or client stop — never a clean "stop"
                        finishes[i] = (FinishReason.CANCELLED.value
                                       if context.is_stopped or
                                       ctxs[i].is_stopped
                                       else FinishReason.ERROR.value)
                        yield gen.finish_chunk(finishes[i], index=i)
                    continue
                if err is not None or i in finishes:
                    continue
                n_out += len(frame.token_ids)
                if frame.token_ids:
                    now = time.monotonic()
                    prev = last_emit.get(i)
                    if prev is None:
                        SERVING.ttft.observe(model_label, qos,
                                             value=now - t_start)
                    else:
                        SERVING.itl.observe(model_label, qos,
                                            value=now - prev)
                    last_emit[i] = now
                res = posts[i].process(frame)
                lp_obj = shapers[i].push(frame, posts[i].last_pieces,
                                         res.text)
                if res.text or lp_obj:
                    yield gen.text_chunk(res.text, index=i, logprobs=lp_obj)
                if res.finish_reason is not None:
                    finishes[i] = res.finish_reason.value
                    if res.finish_reason == FinishReason.STOP \
                            and frame.finish_reason is None:
                        # stop string matched frontend-side: stop the engine
                        ctxs[i].stop_generating()
                    yield gen.finish_chunk(finishes[i], index=i)
        finally:
            watcher.cancel()
            for t in pumps:
                t.cancel()
        if want_usage:
            usage = Usage(prompt_tokens=len(pre.token_ids),
                          completion_tokens=n_out,
                          total_tokens=len(pre.token_ids) + n_out)
            yield gen.usage_chunk(usage)


class LocalPipeline(Pipeline):
    """Engine lives in-process (`run in=batch:FILE out=native`)."""

    def __init__(self, card: ModelDeploymentCard, engine: AsyncEngine):
        super().__init__(card)
        self.engine = engine

    def _token_stream(self, pre: PreprocessedRequest,
                      context: Context) -> AsyncIterator[EngineOutput]:
        return self.engine.generate(pre, context)
