"""ctypes wrapper for the native radix-tree KV index (kv_indexer.cpp).

Copied from dynamo_tpu/native/radix.py.

Drop-in for kv_router.indexer.RadixTree when recent-use frequency tracking
is off (the native tree tracks structure + workers only). Worker ids are
strings at the Python layer; the C layer uses u64 handles, so the wrapper
interns strings to dense ids.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

from dynamo_tpu_torch.kv_router.indexer import MatchResult
from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheRemoveData, KvCacheStoreData, RouterEvent,
)
from dynamo_tpu_torch.native import load

_MAX_WORKERS = 4096


def available() -> bool:
    return load("kv_indexer") is not None


class NativeRadixTree:
    """Same surface as kv_router.indexer.RadixTree (sans frequencies)."""

    def __init__(self):
        self._lib = load("kv_indexer")
        if self._lib is None:
            raise RuntimeError("native kv_indexer unavailable")
        lib = self._lib
        lib.dtr_new.restype = ctypes.c_void_p
        lib.dtr_free.argtypes = [ctypes.c_void_p]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.dtr_apply_stored.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_size_t, u64p, u64p]
        lib.dtr_apply_removed.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t, u64p]
        lib.dtr_remove_worker.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dtr_find_matches.restype = ctypes.c_size_t
        lib.dtr_find_matches.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, u64p, ctypes.c_size_t,
            u64p, u32p]
        lib.dtr_num_nodes.restype = ctypes.c_size_t
        lib.dtr_num_nodes.argtypes = [ctypes.c_void_p]
        lib.dtr_worker_block_count.restype = ctypes.c_size_t
        lib.dtr_worker_block_count.argtypes = [ctypes.c_void_p,
                                               ctypes.c_uint64]
        self._ptr = ctypes.c_void_p(lib.dtr_new())
        self._worker_ids: Dict[str, int] = {}
        self._worker_names: List[str] = []

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.dtr_free(ptr)
            self._ptr = None

    def _intern(self, worker: str) -> int:
        wid = self._worker_ids.get(worker)
        if wid is None:
            wid = len(self._worker_names) + 1  # 0 reserved
            self._worker_ids[worker] = wid
            self._worker_names.append(worker)
        return wid

    @staticmethod
    def _arr(values: Sequence[int]):
        return (ctypes.c_uint64 * len(values))(
            *[v & 0xFFFFFFFFFFFFFFFF for v in values])

    # -- RadixTree surface ----------------------------------------------------

    def apply_event(self, event: RouterEvent) -> None:
        wid = self._intern(event.worker_id)
        data = event.event.data
        if isinstance(data, KvCacheStoreData):
            blocks = data.blocks
            self._lib.dtr_apply_stored(
                self._ptr, wid, (data.parent_hash or 0) & 0xFFFFFFFFFFFFFFFF,
                len(blocks),
                self._arr([b.block_hash for b in blocks]),
                self._arr([b.tokens_hash for b in blocks]))
        elif isinstance(data, KvCacheRemoveData):
            self._lib.dtr_apply_removed(
                self._ptr, wid, len(data.block_hashes),
                self._arr(data.block_hashes))

    def find_matches(self, page_hashes: Sequence[int],
                     early_exit: bool = False,
                     now: Optional[float] = None) -> MatchResult:
        del early_exit, now  # structure-only walk
        out_w = (ctypes.c_uint64 * _MAX_WORKERS)()
        out_s = (ctypes.c_uint32 * _MAX_WORKERS)()
        n = self._lib.dtr_find_matches(
            self._ptr, len(page_hashes), self._arr(page_hashes),
            _MAX_WORKERS, out_w, out_s)
        scores = {self._worker_names[out_w[i] - 1]: int(out_s[i])
                  for i in range(n)}
        return MatchResult(scores=scores)

    def remove_worker(self, worker: str) -> None:
        wid = self._worker_ids.get(worker)
        if wid is not None:
            self._lib.dtr_remove_worker(self._ptr, wid)

    def clear_all_blocks(self, worker: str) -> None:
        self.remove_worker(worker)

    def num_nodes(self) -> int:
        return int(self._lib.dtr_num_nodes(self._ptr))

    def worker_block_count(self, worker: str) -> int:
        wid = self._worker_ids.get(worker)
        if wid is None:
            return 0
        return int(self._lib.dtr_worker_block_count(self._ptr, wid))
