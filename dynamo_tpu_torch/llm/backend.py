"""Backend postprocessor: incremental detokenization + stop-string jail.

Copied from dynamo_tpu/llm/backend.py (unchanged but for imports).
Reference equivalent: the Backend operator wrapping the engine (reference:
lib/llm/src/backend.rs:56-120): converts engine token frames into text deltas
with a DecodeStream, and implements the hidden-stop "jail" — when the decoded
tail could be the beginning of a stop string, text is held back until the
match resolves; a completed stop string finishes the request and is never
emitted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from dynamo_tpu_torch.llm.tokenizer import BaseTokenizer, DecodeStream
from dynamo_tpu_torch.protocols.common import EngineOutput, FinishReason


@dataclasses.dataclass
class PostprocessResult:
    text: str = ""
    finish_reason: Optional[FinishReason] = None


class StopJail:
    """Holds back text that may be a prefix of a stop string."""

    def __init__(self, stop_strings: Sequence[str]):
        self.stops = [s for s in (stop_strings or []) if s]
        self._held = ""

    def push(self, text: str) -> Tuple[str, bool]:
        """Returns (emittable_text, stopped)."""
        if not self.stops:
            return text, False
        buf = self._held + text
        # full stop match anywhere in the buffer?
        cut = None
        for s in self.stops:
            idx = buf.find(s)
            if idx != -1 and (cut is None or idx < cut):
                cut = idx
        if cut is not None:
            self._held = ""
            return buf[:cut], True
        # longest suffix of buf that is a prefix of any stop string
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._held = buf[-hold:]
            return buf[:-hold], False
        self._held = ""
        return buf, False

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held


class BackendPostprocessor:
    """Per-request token->text pipeline stage."""

    def __init__(self, tokenizer: BaseTokenizer,
                 stop_strings: Sequence[str] = ()):
        self._decode = DecodeStream(tokenizer)
        self._jail = StopJail(stop_strings)
        # per-token text pieces of the last process_tokens call (pre-jail):
        # the logprobs response attributes text to tokens from these
        self.last_pieces: List[str] = []

    def process_tokens(self, token_ids: Sequence[int]) -> PostprocessResult:
        self.last_pieces = [self._decode.step(t) for t in token_ids]
        text = "".join(self.last_pieces)
        emit, stopped = self._jail.push(text)
        if stopped:
            return PostprocessResult(emit, FinishReason.STOP)
        return PostprocessResult(emit)

    def process(self, frame: EngineOutput) -> PostprocessResult:
        res = self.process_tokens(frame.token_ids)
        if res.finish_reason is None and frame.finish_reason is not None:
            res.finish_reason = frame.finish_reason
            # on natural finish, drop any held partial-stop text? No: emit it,
            # it was real output that merely resembled a stop prefix.
            res.text += self._jail.flush()
        return res
