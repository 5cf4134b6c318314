"""ctypes wrapper for the native SentencePiece-BPE encoder (spm_bpe.cpp).

Copied from dynamo_tpu/native/spm.py. An exact twin of
llm/gguf._spm_encode (the same merge order, byte fallback and unk
semantics; tests/test_torch_native_spm.py fuzzes the two against each
other and against the JAX package's). GGUFTokenizer uses it when the
toolchain can build it and the Python encoder otherwise; a build failure
is counted in native.NATIVE_STATS.build_failures and logged.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

from dynamo_tpu_torch.native import load


def available() -> bool:
    return load("spm_bpe") is not None


class NativeSpmEncoder:
    """One immutable vocab -> many encode() calls (thread-compatible: the
    native handle is read-only after construction)."""

    def __init__(self, tokens: Sequence[str], scores: Sequence[float],
                 byte_ids: Dict[int, int], unk: int):
        self._lib = load("spm_bpe")
        if self._lib is None:
            raise RuntimeError("native spm_bpe unavailable")
        lib = self._lib
        lib.spm_new.restype = ctypes.c_void_p
        lib.spm_new.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32]
        lib.spm_free.argtypes = [ctypes.c_void_p]
        lib.spm_encode.restype = ctypes.c_int64
        lib.spm_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]

        blobs = [t.encode("utf-8") for t in tokens]
        offsets = [0]
        for b in blobs:
            offsets.append(offsets[-1] + len(b))
        blob = b"".join(blobs)
        n = len(blobs)
        off_arr = (ctypes.c_int64 * (n + 1))(*offsets)
        score_arr = (ctypes.c_float * n)(*[float(s) for s in scores])
        bid_arr = (ctypes.c_int32 * 256)(*[-1] * 256)
        for b, tid in byte_ids.items():
            if 0 <= b < 256:
                bid_arr[b] = tid
        self._ptr = ctypes.c_void_p(lib.spm_new(
            blob, off_arr, n, score_arr, bid_arr, unk))

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.spm_free(ptr)

    def encode(self, prepared: str) -> List[int]:
        """`prepared` must already carry the space marker / prefix
        transform (GGUFTokenizer applies it before dispatching)."""
        raw = prepared.encode("utf-8")
        # a codepoint can byte-fall-back to <=4 ids; +1 for the unk case
        cap = 4 * len(prepared) + 1
        out = (ctypes.c_int32 * cap)()
        got = self._lib.spm_encode(self._ptr, raw, len(raw), out, cap)
        if got > cap:  # can't happen with the bound above; belt+braces
            out = (ctypes.c_int32 * got)()
            got = self._lib.spm_encode(self._ptr, raw, len(raw), out, got)
        return list(out[:got])


def make_encoder(tokens, scores, byte_ids, unk) -> Optional[NativeSpmEncoder]:
    try:
        return NativeSpmEncoder(tokens, scores, byte_ids, unk)
    except (RuntimeError, OSError):
        return None
