"""Wire types of disaggregated prefill.

Copied from dynamo_tpu/disagg/protocols.py as dataclasses (see
protocols/common.py). `to_json()` gives the dict the JAX models'
`model_dump()` gives (None fields included), and `from_json(d)` rebuilds
a dataclass from it, unknown keys ignored, nested ImageParts included.
The trace context is left out with the slice that carries it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from dynamo_tpu_torch.protocols.common import (
    ImagePart, SamplingOptions, StopConditions, _known, image_parts_from_wire,
)


class _Json:
    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json()).encode()

    @classmethod
    def from_json(cls, d: dict):
        return cls(**_known(cls, d))

    @classmethod
    def from_bytes(cls, raw: bytes):
        return cls.from_json(json.loads(raw))


@dataclasses.dataclass
class RemotePrefillRequest(_Json):
    """Enqueued by the decode worker; consumed by a prefill worker."""

    engine_id: str            # decode worker id (transfer + notify target)
    request_id: str
    token_ids: List[int]
    page_ids: List[int]       # decode-side pages of the whole prompt
    sampling: SamplingOptions = dataclasses.field(
        default_factory=SamplingOptions)
    stop: StopConditions = dataclasses.field(default_factory=StopConditions)
    # leading tokens already valid decode-side (prefix hit): their pages
    # are not transferred
    num_cached_tokens: int = 0
    page_size: int = 0        # decode engine page size (must match prefill)
    # admission epoch of the decode-side allocation: every chunk carries it
    # and the decode side fences a mismatch (a stale sender)
    alloc_epoch: int = 0
    notify_subject: str = ""  # where the PrefillCompletion goes
    # the client deadline as a unix time: an item dequeued after it is
    # dropped instead of prefilled
    deadline_unix: Optional[float] = None
    # multimodal: pixels the prefill worker's tower encodes, or (a decode
    # worker's mm_transfer="embeds") its tower's output with the salts
    mm_parts: Optional[List[ImagePart]] = None
    enqueued_unix: Optional[float] = None   # enqueue instant (time.time())
    qos: str = ""             # multi-tenant QoS class ("" = default)

    def to_json(self) -> dict:
        # the JAX model's field order, so the two dumps are equal dicts
        d = dataclasses.asdict(self)
        order = ("engine_id", "request_id", "token_ids", "sampling", "stop",
                 "page_ids", "num_cached_tokens", "page_size", "alloc_epoch",
                 "notify_subject", "deadline_unix", "mm_parts",
                 "enqueued_unix", "qos")
        return {k: d[k] for k in order}

    @classmethod
    def from_json(cls, d: dict) -> "RemotePrefillRequest":
        d = _known(cls, d)
        d["sampling"] = SamplingOptions(
            **_known(SamplingOptions, d.get("sampling") or {}))
        d["stop"] = StopConditions(
            **_known(StopConditions, d.get("stop") or {}))
        d["mm_parts"] = image_parts_from_wire(d.get("mm_parts"))
        return cls(**d)


@dataclasses.dataclass
class PrefillCompletion(_Json):
    """Published on `completion_subject(engine_id)` after the KV pages were
    injected, or (early decode) as soon as the prefill sampled its first
    token, with `transfer_pending=True` while the transfer still streams;
    the decode side then gates decode on its own committed frontier, and a
    final (or an error) completion follows."""

    request_id: str
    first_token: Optional[int] = None   # sampled by the prefill engine
    error: Optional[str] = None
    transfer_pending: bool = False
    total_pages: int = 0      # pages shipped (prefix-hit pages excluded)


@dataclasses.dataclass
class PrefillCancel(_Json):
    """Broadcast by a decode worker that gave up on a remote prefill: every
    prefill worker drops the item if queued or aborts it mid-run."""

    request_id: str


def completion_subject(engine_id: str) -> str:
    return f"disagg.prefill_done.{engine_id}"


def cancel_subject(queue_name: str) -> str:
    """Cancellation channel paired with a prefill work queue."""
    return f"{queue_name}.cancel"
