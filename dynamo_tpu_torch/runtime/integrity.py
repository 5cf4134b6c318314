"""KV data-plane integrity: per-page checksums, verify-on-fetch, counters.

Copied from dynamo_tpu/runtime/integrity.py. The contract: a corrupted
transfer may cost latency but never changes an emitted token. A checksum
is computed at capture, when the page bytes leave the authoritative copy
(staged on the prefill host), travels with the page, and is verified by
the consumer before the bytes can reach the device cache; a mismatch asks
the sender to stage the chunk again, and a transfer that keeps failing is
abandoned for a local prefill.

`page_checksum` is BLAKE2b-64 from `hashlib` where the JAX package uses
xxh3-64 (the port depends on torch and numpy only), so the frames carry it
under their own key (`SUMS_KEY`). `hashlib` releases the GIL while it
hashes a buffer of more than 2 KiB, so the transfer hashes a chunk's
pages in a thread pool (disagg/transfer.py). `tensor_checksum` feeds it
the bytes of CPU tensors: the KV tiers' slab pages. The per-stream counters of
the sharded transfer wait for the tp slice.

Counters live on the process-global ``STATS`` and ``XFER_STATS`` and render
on /metrics (frontend/service.py) as ``llm_kv_integrity_*`` and
``llm_kv_transfer_*``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict

import numpy as np

# the frame key of the port's checksums; a JAX sender's xxh3-64 sums ride
# under "sums", which the port cannot verify
SUMS_KEY = "sums_b2"
CHECKSUM_ALGORITHM = "blake2b-64"


def _blocks(a: np.ndarray):
    """`a`'s bytes in C order as contiguous buffers, without copying: the
    whole array when it is contiguous, else its innermost contiguous
    blocks."""
    if a.flags.c_contiguous:
        yield a.reshape(-1).view(np.uint8).data
        return
    for sub in a:
        yield from _blocks(sub)


def page_checksum(*arrays) -> int:
    """BLAKE2b-64 over the concatenated raw bytes (C order) of one page's
    arrays: k then v, then the scales on an int8 cache."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        for buf in _blocks(np.asarray(a)):
            h.update(buf)
    return int.from_bytes(h.digest(), "little")


def tensor_checksum(*tensors) -> int:
    """`page_checksum` over the raw bytes of CPU tensors (any dtype,
    bfloat16 included): the KV tiers' pages (engine/offload.py,
    engine/kv_pool.py)."""
    import torch
    return page_checksum(*(t.contiguous().reshape(-1).view(torch.uint8)
                           .numpy() for t in tensors))


class IntegrityError(ValueError):
    """A fetched page's bytes do not match its capture-time checksum."""

    def __init__(self, where: str, pages):
        self.where = where
        self.pages = list(pages)
        super().__init__(
            f"kv integrity mismatch at {where}: page(s) {self.pages}")


@dataclasses.dataclass
class IntegrityStats:
    """Process-global counters (/metrics: llm_kv_integrity_*)."""

    pages_hashed: int = 0      # checksums computed at capture
    pages_verified: int = 0    # fetch-time verifications that passed
    mismatches: int = 0        # fetch-time verifications that failed
    refetches: int = 0         # transfer retries triggered by a mismatch
    quarantined: int = 0       # pages abandoned after the retries
    reprefills: int = 0        # remote paths abandoned for local recompute

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


STATS = IntegrityStats()


@dataclasses.dataclass
class KvTransferStats:
    """Process-global KV-transfer counters (/metrics: llm_kv_transfer_*).
    Bytes count the wire representation: int8 pages plus their f32 scales
    on an int8 cache."""

    bytes_sent: int = 0       # payload bytes shipped by transfer senders
    pages_sent: int = 0       # pages those bytes carried
    fetches: int = 0          # transfer frames injected
    bytes_fetched: int = 0    # payload bytes arriving at inject
    # chunk-committed streaming: transfers resumed from a non-zero
    # committed frontier, pages a decode-side salvage kept, chunks the
    # epoch fence rejected, and per-IO socket timeouts taken as link death
    resumes: int = 0
    salvaged_pages: int = 0
    stale_chunks: int = 0
    link_timeouts: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


XFER_STATS = KvTransferStats()
