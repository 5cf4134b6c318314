"""Engine-agnostic internal request/response protocol.

Copied from dynamo_tpu/protocols/common.py. The JAX package declares these
as pydantic models because they double as a wire schema; the port's first
slice runs frontend, worker and engine in one process and depends on
nothing beyond torch and numpy, so they are dataclasses here. An
`ImagePart`'s `data` is bytes, which the port's codec packs as msgpack bin,
as msgpack packs the JAX model's dump.
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
    PREFILL_DONE = "prefill_done"  # disagg: prefill-only run finished


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
class ImagePart:
    """One image's payload, positioned in the token stream.

    `offset` points at the first of the image's placeholder ids in
    token_ids. kind="pixels": `data` is the raw float32 pixel buffer
    [H, W, 3] in [0, 1], which the receiving engine's vision tower
    encodes. kind="embeds": `data` is the projected patch-embed buffer
    [n_patches, D_text] float32 and `salt` the pixel-content hash the page
    hashes need (a disaggregated decode worker's mm_transfer="embeds"
    mode, so the prefill side never runs its tower)."""

    offset: int
    shape: List[int]          # [H, W, 3] pixels | [n_patches, D] embeds
    dtype: str = "float32"
    data: bytes = dataclasses.field(kw_only=True)
    kind: str = "pixels"      # "pixels" | "embeds"
    salt: Optional[int] = None  # pixel-content hash (embeds kind)


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
    # multimodal: images to mix into the prefill at placeholder positions
    mm_parts: Optional[List[ImagePart]] = None
    # resume from a prefix: token_ids holds the prompt plus the last
    # `resume_committed` tokens already emitted to the client, which are
    # charged against the original stop budgets (the disagg early-decode
    # fallback re-prefills this way)
    resume_committed: int = 0


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


# -- wire forms ----------------------------------------------------------------
# The JAX package sends these models over its data plane as
# `model_dump(exclude_none=True)` and rebuilds them with `model_validate`;
# the port's dataclasses take the same dict forms.

def to_wire(obj):
    """The dict form of a protocol dataclass, None fields left out at every
    depth (pydantic's exclude_none), lists item by item, enums as their
    values; anything else passes through."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = to_wire(getattr(obj, f.name))
            if v is not None:
                out[f.name] = v
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, list):
        return [to_wire(v) for v in obj]
    return obj


def _known(cls, d: dict) -> dict:
    """The keys of `d` that name fields of `cls` (unknown keys are ignored,
    as pydantic ignores extra fields)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def image_parts_from_wire(parts) -> Optional[List[ImagePart]]:
    """ImageParts from their dict forms."""
    if parts is None:
        return None
    return [ImagePart(**_known(ImagePart, p)) for p in parts]


def preprocessed_from_wire(d: dict) -> PreprocessedRequest:
    d = _known(PreprocessedRequest, d)
    for name, cls in (("sampling", SamplingOptions), ("stop", StopConditions),
                      ("output", OutputOptions)):
        if name in d:
            d[name] = cls(**_known(cls, d[name]))
    if "mm_parts" in d:
        d["mm_parts"] = image_parts_from_wire(d["mm_parts"])
    return PreprocessedRequest(**d)


def output_from_wire(d: dict) -> EngineOutput:
    d = _known(EngineOutput, d)
    if d.get("finish_reason") is not None:
        d["finish_reason"] = FinishReason(d["finish_reason"])
    return EngineOutput(**d)
