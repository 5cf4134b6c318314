"""ctypes surface of the native C API (native/capi.cpp).

Copied from dynamo_tpu/native/capi_py.py. The C API exists for C++ engine
workers that publish KV events into the control plane without Python; this
wrapper drives the same shared library from Python (tests, chip_smoke), so
the ABI is proven without a C++ harness. The library is built by
`native.load("capi")` with g++ into build/dynamo_tpu_torch/, as the
indexer's is.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

from dynamo_tpu_torch import native


class CApi:
    """Typed handle over the capi library. Raises RuntimeError if the
    native toolchain is unavailable (this binding has no Python fallback:
    its point is the native path)."""

    def __init__(self):
        lib = native.load("capi")
        if lib is None:
            raise RuntimeError("native capi unavailable (g++?): "
                               + native.NATIVE_STATS.last_error)
        lib.dyn_tokens_hash.restype = ctypes.c_uint64
        lib.dyn_tokens_hash.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t]
        lib.dyn_llm_init.restype = ctypes.c_int
        lib.dyn_llm_init.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int]
        lib.dyn_kv_event_publish_stored.restype = ctypes.c_int
        lib.dyn_kv_event_publish_stored.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)]
        lib.dyn_kv_event_publish_removed.restype = ctypes.c_int
        lib.dyn_kv_event_publish_removed.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t]
        lib.dyn_llm_shutdown.restype = ctypes.c_int
        lib.dyn_llm_shutdown.argtypes = []
        self._lib = lib

    def tokens_hash(self, tokens: Sequence[int]) -> int:
        arr = (ctypes.c_uint32 * len(tokens))(*tokens)
        return self._lib.dyn_tokens_hash(arr, len(tokens))

    def init(self, namespace: str, component: str, worker_id: str,
             kv_block_size: int, host: str, port: int) -> None:
        rc = self._lib.dyn_llm_init(
            namespace.encode(), component.encode(), worker_id.encode(),
            kv_block_size, host.encode(), port)
        if rc != 0:
            raise ConnectionError(
                f"dyn_llm_init failed (control plane at {host}:{port}?)")

    def publish_stored(self, event_id: int, parent_hash: Optional[int],
                       blocks: Sequence[tuple]) -> None:
        """blocks: [(block_hash, tokens), ...] with full pages only."""
        all_tokens = [t for _, toks in blocks for t in toks]
        tok_arr = (ctypes.c_uint32 * len(all_tokens))(*all_tokens)
        n_arr = (ctypes.c_size_t * len(blocks))(
            *[len(toks) for _, toks in blocks])
        id_arr = (ctypes.c_uint64 * len(blocks))(*[bh for bh, _ in blocks])
        parent = (ctypes.c_uint64(parent_hash)
                  if parent_hash is not None else None)
        rc = self._lib.dyn_kv_event_publish_stored(
            event_id, tok_arr, n_arr, id_arr, len(blocks),
            ctypes.byref(parent) if parent is not None else None)
        if rc != 0:
            raise IOError("dyn_kv_event_publish_stored failed")

    def publish_removed(self, event_id: int,
                        block_hashes: Sequence[int]) -> None:
        arr = (ctypes.c_uint64 * len(block_hashes))(*block_hashes)
        rc = self._lib.dyn_kv_event_publish_removed(
            event_id, arr, len(block_hashes))
        if rc != 0:
            raise IOError("dyn_kv_event_publish_removed failed")

    def shutdown(self) -> None:
        self._lib.dyn_llm_shutdown()
