"""Engine-agnostic internal request/response protocol.

Copied from dynamo_tpu/protocols/common.py. The JAX package declares these
as pydantic models because they double as a wire schema; the port's first
slice runs frontend, worker and engine in one process and depends on
nothing beyond torch and numpy, so they are dataclasses here. Multimodal
parts and mid-stream migration fields come with the slices that use them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class FinishReason(str, enum.Enum):
    STOP = "stop"            # eos or stop sequence
    LENGTH = "length"        # max_tokens reached
    CANCELLED = "cancelled"  # client disconnect / stop_generating
    ERROR = "error"


@dataclasses.dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    stop: Optional[List[str]] = None              # visible stop strings
    stop_token_ids_hidden: Optional[List[int]] = None  # never emitted
    min_tokens: Optional[int] = None
    ignore_eos: bool = False


@dataclasses.dataclass
class SamplingOptions:
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    n: int = 1


@dataclasses.dataclass
class OutputOptions:
    logprobs: Optional[int] = None
    echo: bool = False


@dataclasses.dataclass
class PreprocessedRequest:
    """What the frontend/processor sends to a worker (token-level request):
    token ids, sampling and stop options, eos ids, the card checksum."""

    request_id: str
    token_ids: List[int]
    sampling: SamplingOptions = dataclasses.field(
        default_factory=SamplingOptions)
    stop: StopConditions = dataclasses.field(default_factory=StopConditions)
    output: OutputOptions = dataclasses.field(default_factory=OutputOptions)
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)
    model: str = ""
    mdc_sum: str = ""
    annotations: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineOutput:
    """One streamed frame from a worker back to the frontend."""

    token_ids: List[int] = dataclasses.field(default_factory=list)
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    # parallel to token_ids when the request asked for logprobs
    log_probs: Optional[List[float]] = None
    # per token: the top-k alternatives as [token_id, logprob] pairs
    top_logprobs: Optional[List[List[List[float]]]] = None
    finish_reason: Optional[FinishReason] = None
    # ERROR frames only — False: deterministic per-REQUEST rejection;
    # True/None: instance-scoped failure, retryable on another worker
    retryable: Optional[bool] = None
