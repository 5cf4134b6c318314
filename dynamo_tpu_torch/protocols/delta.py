"""OpenAI delta generation + SSE aggregation.

Copied from dynamo_tpu/protocols/delta.py (the import of the port's
dataclass types aside, unchanged). Reference equivalents: the delta
generators turning backend frames into chat/completion stream chunks and
the aggregators folding an SSE stream back into a unary response for
non-streaming clients (reference:
lib/llm/src/protocols/openai/chat_completions/{delta,aggregator}.rs and
completions/{delta,aggregator}.rs).
"""
from __future__ import annotations

from typing import Iterable, Optional

from dynamo_tpu_torch.protocols.openai import (
    ChatChoice, ChatChoiceDelta, ChatCompletionChunk, ChatCompletionResponse,
    ChatMessage, ChatStreamChoice, CompletionChoice, CompletionResponse,
    Usage, new_response_id, now,
)


class ChatDeltaGenerator:
    """Builds chat.completion.chunk frames from text deltas."""

    def __init__(self, model: str, response_id: Optional[str] = None):
        self.model = model
        self.id = response_id or new_response_id("chatcmpl")
        self.created = now()
        self._sent_role = False

    def _chunk(self, choice: ChatStreamChoice,
               usage: Optional[Usage] = None) -> ChatCompletionChunk:
        return ChatCompletionChunk(id=self.id, created=self.created,
                                   model=self.model, choices=[choice],
                                   usage=usage)

    def role_chunk(self, index: int = 0) -> ChatCompletionChunk:
        self._sent_role = True
        return self._chunk(ChatStreamChoice(
            index=index, delta=ChatChoiceDelta(role="assistant", content="")))

    def text_chunk(self, text: str, index: int = 0,
                   logprobs: Optional[dict] = None) -> ChatCompletionChunk:
        delta = ChatChoiceDelta(content=text)
        if not self._sent_role:
            delta.role = "assistant"
            self._sent_role = True
        return self._chunk(ChatStreamChoice(index=index, delta=delta,
                                            logprobs=logprobs))

    def finish_chunk(self, finish_reason: str, index: int = 0,
                     usage: Optional[Usage] = None) -> ChatCompletionChunk:
        return self._chunk(ChatStreamChoice(
            index=index, delta=ChatChoiceDelta(), finish_reason=finish_reason),
            usage)

    def usage_chunk(self, usage: Usage) -> ChatCompletionChunk:
        """Trailing usage-only chunk (OpenAI stream_options.include_usage
        sends usage with an empty choices array after all finishes)."""
        return ChatCompletionChunk(id=self.id, created=self.created,
                                   model=self.model, choices=[], usage=usage)


class CompletionDeltaGenerator:
    def __init__(self, model: str, response_id: Optional[str] = None):
        self.model = model
        self.id = response_id or new_response_id("cmpl")
        self.created = now()

    def text_chunk(self, text: str, index: int = 0,
                   logprobs: Optional[dict] = None) -> CompletionResponse:
        return CompletionResponse(
            id=self.id, created=self.created, model=self.model,
            choices=[CompletionChoice(index=index, text=text,
                                      logprobs=logprobs)])

    def finish_chunk(self, finish_reason: str, index: int = 0,
                     usage: Optional[Usage] = None) -> CompletionResponse:
        return CompletionResponse(
            id=self.id, created=self.created, model=self.model,
            choices=[CompletionChoice(index=index, text="",
                                      finish_reason=finish_reason)],
            usage=usage)

    def usage_chunk(self, usage: Usage) -> CompletionResponse:
        return CompletionResponse(id=self.id, created=self.created,
                                  model=self.model, choices=[], usage=usage)


def aggregate_chat_chunks(
        chunks: Iterable[ChatCompletionChunk]) -> ChatCompletionResponse:
    """Fold a chunk stream into a unary chat.completion response.

    Chunks are grouped by choice index so n>1 fan-out aggregates into n
    choices (reference: chat_completions/aggregator.rs does the same
    index-keyed fold)."""
    pieces: dict = {}
    finishes: dict = {}
    logprobs: dict = {}
    rid, created, model, usage = None, None, None, None
    for c in chunks:
        rid, created, model = c.id, c.created, c.model
        usage = c.usage or usage
        for choice in c.choices:
            i = choice.index
            if choice.delta.content:
                pieces.setdefault(i, []).append(choice.delta.content)
            if choice.finish_reason:
                finishes[i] = choice.finish_reason
            if choice.logprobs and choice.logprobs.get("content"):
                logprobs.setdefault(i, []).extend(
                    choice.logprobs["content"])
    idxs = sorted(set(pieces) | set(finishes)) or [0]
    return ChatCompletionResponse(
        id=rid or new_response_id("chatcmpl"), created=created or now(),
        model=model or "", usage=usage,
        choices=[ChatChoice(
            index=i,
            message=ChatMessage(role="assistant",
                                content="".join(pieces.get(i, []))),
            finish_reason=finishes.get(i),
            logprobs=({"content": logprobs[i]} if i in logprobs else None))
            for i in idxs])


def aggregate_completion_chunks(
        chunks: Iterable[CompletionResponse]) -> CompletionResponse:
    pieces: dict = {}
    finishes: dict = {}
    logprobs: dict = {}
    rid, created, model, usage = None, None, None, None
    for c in chunks:
        rid, created, model = c.id, c.created, c.model
        usage = c.usage or usage
        for choice in c.choices:
            i = choice.index
            if choice.text:
                pieces.setdefault(i, []).append(choice.text)
            if choice.finish_reason:
                finishes[i] = choice.finish_reason
            if choice.logprobs:
                agg = logprobs.setdefault(i, {
                    "text_offset": [], "token_logprobs": [], "tokens": [],
                    "top_logprobs": []})
                for k in agg:
                    agg[k].extend(choice.logprobs.get(k) or [])
    idxs = sorted(set(pieces) | set(finishes)) or [0]
    return CompletionResponse(
        id=rid or new_response_id("cmpl"), created=created or now(),
        model=model or "", usage=usage,
        choices=[CompletionChoice(
            index=i, text="".join(pieces.get(i, [])),
            finish_reason=finishes.get(i), logprobs=logprobs.get(i))
            for i in idxs])
