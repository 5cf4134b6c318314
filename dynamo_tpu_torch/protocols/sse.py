"""Server-Sent Events encoding + the Annotated frame envelope.

Copied from dynamo_tpu/protocols/sse.py: the envelope the preprocessor
returns its request-introspection annotations in (`token_ids`,
`formatted_prompt`) and the encoder the HTTP frontend streams with
(`encode_event`, `encode_json_data`, `DONE_FRAME`). The stream decoder is
left out: nothing in the port reads SSE. Reference equivalents: the
`Annotated{data,id,event,comment}` envelope (reference:
lib/runtime/src/protocols/annotated.rs:32-80) and the SSE codec
(lib/llm/src/protocols/codec.rs).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional


@dataclasses.dataclass
class Annotated:
    data: Optional[Any] = None
    id: Optional[str] = None
    event: Optional[str] = None
    comment: Optional[List[str]] = None

    def is_error(self) -> bool:
        return self.event == "error"

    @classmethod
    def from_error(cls, message: str) -> "Annotated":
        return cls(event="error", comment=[message])

    @classmethod
    def annotation(cls, name: str, value: Any) -> "Annotated":
        return cls(event=name, data=value)

    def to_wire(self) -> dict:
        out = {}
        for f in ("data", "id", "event", "comment"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        return out

    @classmethod
    def from_wire(cls, d: dict) -> "Annotated":
        return cls(data=d.get("data"), id=d.get("id"), event=d.get("event"),
                   comment=d.get("comment"))


@dataclasses.dataclass
class SseEvent:
    data: Optional[str] = None
    event: Optional[str] = None
    id: Optional[str] = None
    comments: List[str] = dataclasses.field(default_factory=list)


def encode_event(ev: SseEvent) -> str:
    """Encode one SSE event block (terminated by a blank line)."""
    lines = []
    for c in ev.comments:
        lines.append(f": {c}")
    if ev.event:
        lines.append(f"event: {ev.event}")
    if ev.id:
        lines.append(f"id: {ev.id}")
    if ev.data is not None:
        for part in ev.data.split("\n"):
            lines.append(f"data: {part}")
    return "\n".join(lines) + "\n\n"


def encode_json_data(obj: Any) -> str:
    return encode_event(SseEvent(data=json.dumps(obj, separators=(",", ":"))))


DONE_FRAME = "data: [DONE]\n\n"
