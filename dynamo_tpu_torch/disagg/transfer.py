"""KV page transfer between prefill and decode engines.

Copied from dynamo_tpu/disagg/transfer.py. A backend writes the pages a
prefill engine extracted (`NativeEngine.extract_pages`) into a decode
engine's cache at the decode side's page ids, and refuses when the request
is no longer pending there or its allocation epoch changed.

- LocalTransferBackend: both engines in this process (on one card, or both
  on the CPU): the pages go device to device, one `index_copy_` per cache
  leaf on the decode engine's stream after the prefill engine's "ready"
  event. The JAX backend's chaos-mode staging hop (the fault-injection
  failpoints) waits for the fault-injection slice.
- RemoteTransferBackend (disagg/remote_transfer.py): the engines in
  separate processes; pages move through host memory over a TCP data plane
  to the decode worker's KvTransferServer.
"""
from __future__ import annotations

import abc
import hashlib
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from dynamo_tpu_torch.observability.fleet import TRANSFER_MODEL
from dynamo_tpu_torch.observability.serving import SERVING
from dynamo_tpu_torch.runtime.integrity import XFER_STATS

log = logging.getLogger("dynamo_tpu_torch.disagg.transfer")

def _page_sums(k_np, v_np, ks_np, vs_np, count: int,
               pool: Optional[ThreadPoolExecutor] = None) -> List[int]:
    """Capture-time checksums, one per page, over the host arrays as
    stored ([L, Hkv, n, ps, hd] values; on an int8 cache also the [L, Hkv,
    n, ps] f32 scales, so verifying needs no dequantization). bfloat16
    pages arrive as their 16-bit integer view. Each is
    `integrity.page_checksum(k[:, :, i], v[:, :, i], ...)`, fed here as
    slices of one flat view of each (C-contiguous) array, one (layer,
    head) block of a page at a time, so that no numpy object is made per
    block; with a `pool` the pages hash in its threads, hashlib releasing
    the GIL over each block of 2 KiB or more."""
    leaves = []
    for a in (k_np, v_np, ks_np, vs_np):
        if a is None:
            continue
        a = np.ascontiguousarray(a)
        lead, n = a.shape[0] * a.shape[1], a.shape[2]
        blk = a[0, 0, 0].nbytes     # one (layer, head) block of one page
        leaves.append((memoryview(a.reshape(-1).view(np.uint8)), lead, n,
                       blk))

    def one(i):
        h = hashlib.blake2b(digest_size=8)
        for mv, lead, n, blk in leaves:
            for j in range(lead):
                off = (j * n + i) * blk
                h.update(mv[off:off + blk])
        return int.from_bytes(h.digest(), "little")

    return list((pool.map if pool is not None else map)(one, range(count)))


def hash_pool() -> ThreadPoolExecutor:
    """A thread pool for `_page_sums` (its threads start at first use)."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                              thread_name_prefix="kv-checksum")


def check_pending(eng, engine_id: str, request_id: str,
                  alloc_epoch: int, stale_error=KeyError) -> None:
    """On the engine thread, before an inject: the request must still hold
    its remote allocation, and (epoch != 0) the same one the sender was
    given. A stale sender's bytes must never land in pages that were
    released and reallocated."""
    seq = eng.scheduler.remote.get(request_id)
    if seq is None:
        raise KeyError(f"request {request_id!r} no longer pending on "
                       f"{engine_id!r}")
    if alloc_epoch and seq.epoch != alloc_epoch:
        XFER_STATS.stale_chunks += 1
        raise stale_error(
            f"request {request_id!r} alloc epoch {seq.epoch} != sender "
            f"epoch {alloc_epoch} on {engine_id!r} (stale sender fenced)")


class TransferBackend(abc.ABC):
    """Writes KV pages into a decode engine identified by engine_id."""

    @abc.abstractmethod
    async def send_pages(self, engine_id: str, request_id: str, dst_page_ids,
                         k_pages, v_pages, k_scale=None, v_scale=None,
                         alloc_epoch: int = 0, budget_s=None,
                         ready=None) -> None:
        """Inject pages (k/v [L, Hkv, Nb, ps, hd] tensors as extracted; an
        int8 cache's senders also pass the [L, Hkv, Nb, ps] scales) into
        the target engine's cache at dst_page_ids. `ready` is the
        extraction's event on the prefill engine's stream (None on the
        CPU). A nonzero `alloc_epoch` fences the write against a changed
        allocation; `budget_s` bounds the whole transfer's wall time.
        Raises when the request is no longer pending on the target."""


class LocalTransferBackend(TransferBackend):
    """In-process registry of decode workers (engine_id -> worker)."""

    def __init__(self):
        self._receivers: Dict[str, object] = {}

    def register(self, engine_id: str, worker) -> None:
        """worker: a NativeEngineWorker wrapping the decode engine."""
        self._receivers[engine_id] = worker

    def unregister(self, engine_id: str) -> None:
        self._receivers.pop(engine_id, None)

    async def send_pages(self, engine_id: str, request_id: str, dst_page_ids,
                         k_pages, v_pages, k_scale=None, v_scale=None,
                         alloc_epoch: int = 0, budget_s=None,
                         ready=None) -> None:
        worker = self._receivers.get(engine_id)
        if worker is None:
            raise KeyError(f"unknown decode engine {engine_id!r}")
        ids = list(dst_page_ids)
        leaves = [t for t in (k_pages, v_pages, k_scale, v_scale)
                  if t is not None]
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        t0 = time.monotonic()

        def inject(eng):
            check_pending(eng, engine_id, request_id, alloc_epoch)
            eng.inject_pages(ids, k_pages, v_pages, k_scale, v_scale,
                             ready=ready)
            XFER_STATS.fetches += 1
            XFER_STATS.bytes_fetched += nbytes

        try:
            await worker.submit(inject)
        finally:
            dt = time.monotonic() - t0
            SERVING.kv_transfer.observe(value=dt)
        XFER_STATS.bytes_sent += nbytes
        XFER_STATS.pages_sent += len(ids)
        # a per-link bandwidth sample for the transfer cost model, the
        # remote backend's feed, so router scoring sees local moves too
        # (JAX :129-130)
        TRANSFER_MODEL.observe(engine_id, nbytes, dt)
