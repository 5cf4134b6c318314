"""OpenAI-compatible protocol types (chat completions, completions, models)
with the engine-extension field `ext`, and their wire forms.

Copied from dynamo_tpu/protocols/openai.py, as dataclasses instead of
pydantic models (see protocols/common.py). What pydantic gave the JAX
service is written out here:

- construction converts nested dicts (`messages`, `ext`, `delta`,
  `message`, `choices`, `usage`) into their dataclasses, as pydantic would;
- `Cls.from_json(obj)` validates a decoded JSON body and stands in for
  `model_validate`: a missing required field, a value of the wrong type or
  `n < 1` raises `ValidationError`; unknown keys are accepted and kept in
  `model_extra` (the JAX models use extra="allow");
- `obj.to_json(exclude_none=True)` stands in for `model_dump`: a plain dict
  of the dataclass tree, dropping None fields when asked.

Type rules of `from_json` (pydantic's lax mode where it matters for JSON):
`str` takes strings only; `int` takes integers and integral floats, not
booleans; `float` takes integers and floats; `bool` takes booleans; lists
take JSON arrays, dicts JSON objects; a Union takes the first member that
validates; a nested dataclass takes an object.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import typing
import uuid
from typing import Any, Dict, List, Optional, Union


class ValidationError(ValueError):
    """A request body that does not fit its schema. `errors` lists
    {"loc": [...], "msg": ...} entries, like pydantic's `errors()`."""

    def __init__(self, errors: List[dict]):
        super().__init__("; ".join(
            f"{'.'.join(str(p) for p in e['loc'])}: {e['msg']}"
            for e in errors))
        self.errors = errors


@functools.lru_cache(maxsize=None)
def _hints(cls) -> Dict[str, Any]:
    return typing.get_type_hints(cls)


_MISSING = object()


def _validate(tp, value, loc: list, errors: list):
    """`value` checked (and nested objects converted) against type `tp`;
    appends to `errors` and returns _MISSING on a mismatch."""
    origin = typing.get_origin(tp)
    if tp is Any:
        return value
    if origin is Union:
        args = typing.get_args(tp)
        if value is None and type(None) in args:
            return None
        for arg in args:
            if arg is type(None):
                continue
            sub: list = []
            got = _validate(arg, value, loc, sub)
            if not sub:
                return got
        errors.append({"loc": loc, "msg": f"value does not match {tp}"})
        return _MISSING
    if origin in (list, List):
        if not isinstance(value, list):
            errors.append({"loc": loc, "msg": "input should be a list"})
            return _MISSING
        (arg,) = typing.get_args(tp) or (Any,)
        out = [_validate(arg, v, loc + [i], errors)
               for i, v in enumerate(value)]
        return _MISSING if any(v is _MISSING for v in out) else out
    if origin in (dict, Dict):
        if not isinstance(value, dict):
            errors.append({"loc": loc, "msg": "input should be an object"})
            return _MISSING
        return dict(value)
    if dataclasses.is_dataclass(tp):
        return tp._from_json(value, loc, errors)
    if tp is bool:
        if isinstance(value, bool):
            return value
    elif tp is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
    elif tp is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
    elif tp is str:
        if isinstance(value, str):
            return value
    errors.append({"loc": loc,
                   "msg": f"input should be {getattr(tp, '__name__', tp)}"})
    return _MISSING


def _dump(value, exclude_none: bool):
    if dataclasses.is_dataclass(value):
        return value.to_json(exclude_none)
    if isinstance(value, list):
        return [_dump(v, exclude_none) for v in value]
    if isinstance(value, dict):
        return {k: _dump(v, exclude_none) for k, v in value.items()}
    return value


class _Wire:
    """Base of the wire dataclasses: dict -> dataclass conversion of nested
    fields on construction, `from_json` and `to_json`."""

    def __post_init__(self):
        for name, tp in _hints(type(self)).items():
            value = getattr(self, name)
            if isinstance(value, dict) or (
                    isinstance(value, list) and value
                    and isinstance(value[0], dict)):
                setattr(self, name, _coerce(tp, value))

    @classmethod
    def _from_json(cls, obj, loc: list, errors: list):
        if not isinstance(obj, dict):
            errors.append({"loc": loc, "msg": "input should be an object"})
            return _MISSING
        kwargs, n_err = {}, len(errors)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for name, f in fields.items():
            if name not in obj:
                if (f.default is dataclasses.MISSING
                        and f.default_factory is dataclasses.MISSING):
                    errors.append({"loc": loc + [name],
                                   "msg": "field required"})
                continue
            kwargs[name] = _validate(_hints(cls)[name], obj[name],
                                     loc + [name], errors)
        if len(errors) > n_err:
            return _MISSING
        out = cls(**kwargs)
        out.model_extra = {k: v for k, v in obj.items() if k not in fields}
        return out

    @classmethod
    def from_json(cls, obj):
        """Validate a decoded JSON body; raises ValidationError."""
        errors: list = []
        out = cls._from_json(obj, [], errors)
        if errors:
            raise ValidationError(errors)
        return out

    def to_json(self, exclude_none: bool = False) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if exclude_none and value is None:
                continue
            out[f.name] = _dump(value, exclude_none)
        return out


def _coerce(tp, value):
    """Construction-time conversion of dicts into the dataclass `tp` names
    (directly, in an Optional, or as list items); other values as given."""
    if typing.get_origin(tp) is Union:
        classes = [a for a in typing.get_args(tp)
                   if dataclasses.is_dataclass(a)]
        if not classes:
            return value
        tp = classes[0]
    if typing.get_origin(tp) in (list, List):
        (arg,) = typing.get_args(tp) or (Any,)
        return [_coerce(arg, v) for v in value]
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return tp(**value)
    return value


@dataclasses.dataclass
class Ext(_Wire):
    """Non-OpenAI extension knobs (reference nvext equivalent)."""

    ignore_eos: Optional[bool] = None
    top_k: Optional[int] = None
    repetition_penalty: Optional[float] = None
    greed_sampling: Optional[bool] = None
    use_raw_prompt: Optional[bool] = None
    annotations: Optional[List[str]] = None


@dataclasses.dataclass
class ChatMessage(_Wire):
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    tool_call_id: Optional[str] = None


def _check_n(n: int) -> None:
    if n < 1:
        raise ValidationError([{"loc": ["n"],
                                "msg": "n must be at least 1"}])


@dataclasses.dataclass
class ChatCompletionRequest(_Wire):
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
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    seed: Optional[int] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    user: Optional[str] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Union[str, Dict[str, Any]]] = None
    ext: Optional[Ext] = None

    def __post_init__(self):
        super().__post_init__()
        _check_n(self.n)


@dataclasses.dataclass
class CompletionRequest(_Wire):
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
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
    user: Optional[str] = None
    ext: Optional[Ext] = None

    def __post_init__(self):
        super().__post_init__()
        _check_n(self.n)


@dataclasses.dataclass
class Usage(_Wire):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


@dataclasses.dataclass
class ChatChoiceDelta(_Wire):
    role: Optional[str] = None
    content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None


@dataclasses.dataclass
class ChatStreamChoice(_Wire):
    index: int = 0
    delta: ChatChoiceDelta = dataclasses.field(
        default_factory=ChatChoiceDelta)
    finish_reason: Optional[str] = None
    # {"content": [{token, logprob, bytes, top_logprobs: [...]}, ...]}
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatChoice(_Wire):
    index: int = 0
    message: ChatMessage = dataclasses.field(
        default_factory=lambda: ChatMessage(role="assistant", content=""))
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChatCompletionResponse(_Wire):
    id: str
    created: int
    model: str
    choices: List[ChatChoice]
    usage: Optional[Usage] = None
    object: str = "chat.completion"


@dataclasses.dataclass
class ChatCompletionChunk(_Wire):
    id: str
    created: int
    model: str
    choices: List[ChatStreamChoice]
    usage: Optional[Usage] = None
    object: str = "chat.completion.chunk"


@dataclasses.dataclass
class CompletionChoice(_Wire):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class CompletionResponse(_Wire):
    id: str
    created: int
    model: str
    choices: List[CompletionChoice]
    usage: Optional[Usage] = None
    object: str = "text_completion"


@dataclasses.dataclass
class ModelInfo(_Wire):
    id: str
    object: str = "model"
    created: int = 0
    owned_by: str = "dynamo-tpu"


@dataclasses.dataclass
class ModelList(_Wire):
    object: str = "list"
    data: List[ModelInfo] = dataclasses.field(default_factory=list)


def new_response_id(prefix: str = "cmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now() -> int:
    return int(time.time())
