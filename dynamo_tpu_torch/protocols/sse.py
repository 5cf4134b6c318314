"""The Annotated frame envelope.

Copied from dynamo_tpu/protocols/sse.py, trimmed to the envelope the
preprocessor returns its request-introspection annotations in (`token_ids`,
`formatted_prompt`); the SSE codec itself comes with the HTTP frontend.
Reference equivalent: the `Annotated{data,id,event,comment}` envelope
(reference: lib/runtime/src/protocols/annotated.rs:32-80).
"""
from __future__ import annotations

import dataclasses
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
