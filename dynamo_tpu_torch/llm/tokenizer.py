"""Tokenizer wrappers + incremental detokenization.

Copied from dynamo_tpu/llm/tokenizer.py for the slice: the deterministic
byte-level tokenizer (registry models have no tokenizer files) and the
DecodeStream incremental decoder. The HF `tokenizers` wrapper comes with
checkpoint loading.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Sequence


class BaseTokenizer(abc.ABC):
    eos_token_ids: List[int] = []
    bos_token_id: Optional[int] = None

    @abc.abstractmethod
    def encode(self, text: str) -> List[int]: ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int]) -> str: ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...


class ByteTokenizer(BaseTokenizer):
    """Deterministic byte-level tokenizer: id = byte + 3.

    ids 0..2 are reserved: 0 pad, 1 bos, 2 eos.
    """

    def __init__(self):
        self.eos_token_ids = [2]
        self.bos_token_id = 1

    def encode(self, text: str) -> List[int]:
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # specials (<3) and ids beyond the byte range (a model vocab can
        # exceed 259) are skipped rather than crashing the detokenizer
        return bytes(i - 3 for i in ids
                     if 3 <= i < 259).decode("utf-8", "replace")

    @property
    def vocab_size(self) -> int:
        return 259


class DecodeStream:
    """Incremental detokenizer: feed token ids, get printable text deltas.

    Tokens that only become printable with successors (UTF-8
    continuations) are held by decoding a sliding window and emitting only
    the stable suffix."""

    REPLACEMENT = "�"

    def __init__(self, tokenizer: BaseTokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._prefix_offset = 0  # start of the decode window (token index)
        self._read_offset = 0    # ids before this are already emitted

    def step(self, token_id: int) -> str:
        self._ids.append(token_id)
        prefix = self._tok.decode(
            self._ids[self._prefix_offset:self._read_offset])
        full = self._tok.decode(self._ids[self._prefix_offset:])
        if full.endswith(self.REPLACEMENT):
            return ""  # mid-glyph: wait for more tokens
        delta = full[len(prefix):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta
