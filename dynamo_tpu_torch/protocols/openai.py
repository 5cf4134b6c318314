"""OpenAI-compatible protocol types (chat completions + completions) with
the engine-extension field `ext`.

Copied from dynamo_tpu/protocols/openai.py, as dataclasses instead of
pydantic models (see protocols/common.py). Nested fields given as dicts
(`messages`, `ext`) are converted on construction, as pydantic would.
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Dict, List, Optional, Union


@dataclasses.dataclass
class Ext:
    """Non-OpenAI extension knobs (reference nvext equivalent)."""

    ignore_eos: Optional[bool] = None
    top_k: Optional[int] = None
    repetition_penalty: Optional[float] = None
    greed_sampling: Optional[bool] = None
    use_raw_prompt: Optional[bool] = None
    annotations: Optional[List[str]] = None


@dataclasses.dataclass
class ChatMessage:
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None


def _ext(ext) -> Optional[Ext]:
    return Ext(**ext) if isinstance(ext, dict) else ext


@dataclasses.dataclass
class ChatCompletionRequest:
    model: str
    messages: List[ChatMessage]
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    n: int = 1
    stream: bool = False
    stream_options: Optional[Dict[str, Any]] = None
    stop: Optional[Union[str, List[str]]] = None
    seed: Optional[int] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    ext: Optional[Ext] = None

    def __post_init__(self):
        self.messages = [ChatMessage(**m) if isinstance(m, dict) else m
                         for m in self.messages]
        self.ext = _ext(self.ext)


@dataclasses.dataclass
class CompletionRequest:
    model: str
    prompt: Union[str, List[int]]
    max_tokens: Optional[int] = 16
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    n: int = 1
    stream: bool = False
    stream_options: Optional[Dict[str, Any]] = None
    stop: Optional[Union[str, List[str]]] = None
    seed: Optional[int] = None
    echo: bool = False
    logprobs: Optional[int] = None
    ext: Optional[Ext] = None

    def __post_init__(self):
        self.ext = _ext(self.ext)


@dataclasses.dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


@dataclasses.dataclass
class ChatChoiceDelta:
    role: Optional[str] = None
    content: Optional[str] = None


@dataclasses.dataclass
class ChatStreamChoice:
    index: int = 0
    delta: ChatChoiceDelta = dataclasses.field(
        default_factory=ChatChoiceDelta)
    finish_reason: Optional[str] = None
    # {"content": [{token, logprob, bytes, top_logprobs: [...]}, ...]}
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatChoice:
    index: int = 0
    message: ChatMessage = dataclasses.field(
        default_factory=lambda: ChatMessage(role="assistant", content=""))
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatCompletionResponse:
    id: str
    created: int
    model: str
    choices: List[ChatChoice]
    usage: Optional[Usage] = None
    object: str = "chat.completion"


@dataclasses.dataclass
class ChatCompletionChunk:
    id: str
    created: int
    model: str
    choices: List[ChatStreamChoice]
    usage: Optional[Usage] = None
    object: str = "chat.completion.chunk"


@dataclasses.dataclass
class CompletionChoice:
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class CompletionResponse:
    id: str
    created: int
    model: str
    choices: List[CompletionChoice]
    usage: Optional[Usage] = None
    object: str = "text_completion"


def new_response_id(prefix: str = "cmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now() -> int:
    return int(time.time())
