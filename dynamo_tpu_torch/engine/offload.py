"""Host-DRAM and disk KV page tiers (HBM -> host offload, host -> HBM onboard).

Copied from dynamo_tpu/engine/offload.py: `OffloadStats` (:36-44),
`DiskKvPool` (:47-165), `HostKvPool` (:167-401) and `CopyStream`
(:403-495). When a reusable HBM page is about to be recycled its KV moves
to a host slab; when a prefix walk misses HBM but hits the host tier, the
page is written back into a fresh HBM page before the next device step, a
host-to-device copy in place of a recompute (multi-turn chat whose history
was evicted). DRAM evictions spill to a disk tier and prefix hits promote
them back. Every page carries the checksum taken when it left the device;
it is verified before the page can be claimed, and a page that fails is
quarantined and recomputed, never served.

What differs from the JAX module:
- Slabs are torch tensors, page-major: [capacity, L, Hkv, ps, hd] values
  and, on an int8 cache, [capacity, L, Hkv, ps] f32 scales (the device
  representation, never dequantized). An engine on the card pins its host
  slabs (`pin=True`), so offload and onboard are both DMA straight into
  and out of a slot; a pinned allocation that fails raises.
- The disk slabs are files mapped by `torch.from_file(shared=True)` (the
  np.memmap role; bfloat16 needs no numpy dtype).
- Checksums are `runtime/integrity.tensor_checksum` (BLAKE2b-64 over the
  bytes); the counters are `integrity.STATS`. Hashing runs in a thread pool
  (hashlib releases the GIL): `CopyStream` hashes a block's pages side by
  side before putting them one by one, in order, with their sums, and
  `preverify` hashes the pages a prefix walk is about to pin ahead of it.
  A slot's verify is remembered for the one verify that follows, unless
  the slot is written between (a generation count per slot), so the pin
  finds it done; a page promoted from disk is verified once, on the disk
  read, and its DRAM copy is that verified buffer's. Every other get
  verifies again, as in JAX, and the outcome of every pin, and every
  counter, is the sequential verify's.
- `CopyStream` copies each block to pinned host memory on a stream of its
  own after the extraction's "ready" event, holding the engine's
  `capture_lock` for every CUDA call (window graphs are captured on the
  engine thread). A failed offload costs only a later recompute, as in JAX,
  but it is logged by name and counted (`OffloadStats.failed`).
- `TierTimes` records where the tiers' time goes (verify, copies, settle,
  spill, promote); the JAX module has no counterpart.
- The fault-injection failpoints (JAX :127-128, :153-154, :258-260,
  :350-352) wait for the port's `runtime/faults.py`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from dynamo_tpu_torch.runtime.integrity import (
    STATS as INTEGRITY, tensor_checksum,
)

log = logging.getLogger("dynamo_tpu_torch.offload")

LEAVES = ("k", "v", "k_scale", "v_scale")
# pages a CopyStream stages in host memory at a time (128 MiB of bf16
# llama3-8b pages)
STAGE_PAGES = 16


class Hasher:
    """A lazily started thread pool for page checksums (BLAKE2b over a
    buffer of more than 2 KiB releases the GIL). The copy thread and the
    prefix walk each own one, so that a walk's verifies never queue behind
    a block of capture checksums."""

    def __init__(self, name: str):
        self._name = name
        self._pool: Optional[ThreadPoolExecutor] = None

    def map(self, fn, items) -> list:
        """[fn(x) for x in items], side by side."""
        items = list(items)
        if len(items) < 2:
            return [fn(x) for x in items]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix=self._name)
        return list(self._pool.map(fn, items))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


@dataclasses.dataclass
class OffloadStats:
    offloaded: int = 0        # pages copied HBM -> host
    onboarded: int = 0        # pages copied host -> HBM
    evicted: int = 0          # pages dropped from the host pool (capacity)
    host_hits: int = 0        # prefix-walk hits served from the host tier
    put_dropped: int = 0      # offloads skipped because all slots were pinned
    disk_offloaded: int = 0   # DRAM evictions spilled to the disk tier
    disk_hits: int = 0        # gets served by promoting a disk page to DRAM
    disk_evicted: int = 0     # pages dropped from the disk tier (capacity)
    failed: int = 0           # pages whose offload copy raised (the port's)


@dataclasses.dataclass
class TierTimes:
    """Seconds and bytes of the tiers' work, for reports. The copies' and
    the inject's times are device time between CUDA events, taken on the
    card only; the others are host time."""

    verify_s: float = 0.0     # checksum verifies before a pin (wall time)
    verify_pages: int = 0     # pages hashed for them
    checksum_s: float = 0.0   # capture checksums of offloaded pages (wall)
    d2h_s: float = 0.0        # offload copies to host memory
    d2h_bytes: int = 0
    h2d_s: float = 0.0        # onboard copies out of slab slots
    h2d_bytes: int = 0
    inject_s: float = 0.0     # H2D done -> pages written into the cache
    onboard_batches: int = 0
    settle_s: float = 0.0     # prefix walks waiting for in-flight copies
    spill_s: float = 0.0      # DRAM -> disk writes
    spill_pages: int = 0
    promote_s: float = 0.0    # disk -> DRAM reads, verify included
    promote_pages: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


def _mapped(path: str, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """A zero-filled tensor backed by the file at `path` (created or
    truncated to size); writes land in the file."""
    n = math.prod(shape)
    with open(path, "wb") as f:
        f.truncate(n * torch.empty((), dtype=dtype).element_size())
    return torch.from_file(path, shared=True, size=n, dtype=dtype).view(shape)


class _SlotMemo:
    """Slots whose bytes were just verified against their checksum, for the
    one verify that follows (`consume`): a generation count per slot, bumped
    on every write, so a slot written since does not count."""

    def __init__(self, capacity: int):
        self.gen = [0] * capacity
        self.ok: Dict[int, int] = {}    # slot -> generation verified

    def written(self, slot: int) -> None:
        self.gen[slot] += 1
        self.ok.pop(slot, None)

    def mark(self, slot: int, gen: Optional[int] = None) -> None:
        if gen is None or gen == self.gen[slot]:
            self.ok[slot] = self.gen[slot]

    def holds(self, slot: int) -> bool:
        return self.ok.get(slot) == self.gen[slot]

    def consume(self, slot: int) -> bool:
        return self.ok.pop(slot, None) == self.gen[slot]


def _prehash(tier, slots: List[int], lock, hasher: Hasher) -> int:
    """Verify `slots` of a tier ahead of their use, in `hasher`'s threads,
    outside `lock` (held only to read and to record): a slot whose bytes
    match its checksum and that was not written meanwhile is remembered as
    verified. Returns the pages hashed."""
    with lock:
        todo = [(slot, tier._memo.gen[slot], tier._sum_at[slot],
                 tier._slot_arrays(slot)) for slot in slots
                if tier._sum_at[slot] is not None
                and not tier._memo.holds(slot)]
    sums = hasher.map(lambda t: tensor_checksum(*t[3]), todo)
    with lock:
        for (slot, gen, want, _), got in zip(todo, sums):
            if got == want:
                tier._memo.mark(slot, gen)
    return len(todo)


class DiskKvPool:
    """Disk KV page tier below host DRAM: mapped k / v (and scale) slabs in
    fixed slots, LRU keyed by chained hash. The OS page cache gives writes
    write-behind and hot reads DRAM speed."""

    def __init__(self, capacity: int, page_shape: Tuple[int, ...],
                 dtype: torch.dtype, directory: str,
                 scale_shape: Optional[Tuple[int, ...]] = None):
        os.makedirs(directory, exist_ok=True)
        self.capacity = capacity
        shape = (capacity,) + tuple(page_shape)
        self.k_slab = _mapped(os.path.join(directory, "kv_disk_k.bin"),
                              shape, dtype)
        self.v_slab = _mapped(os.path.join(directory, "kv_disk_v.bin"),
                              shape, dtype)
        # an int8 cache spills its stored representation: int8 values above,
        # f32 per-row scales here; the traveling checksum covers both
        self.ks_slab = self.vs_slab = None
        if scale_shape is not None:
            sshape = (capacity,) + tuple(scale_shape)
            self.ks_slab = _mapped(os.path.join(directory, "kv_disk_ks.bin"),
                                   sshape, torch.float32)
            self.vs_slab = _mapped(os.path.join(directory, "kv_disk_vs.bin"),
                                   sshape, torch.float32)
        self._by_hash: Dict[int, int] = {}
        self._hash_at: List[Optional[int]] = [None] * capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._lru: Dict[int, None] = {}
        # capture-time checksum per slot: travels WITH the page across tiers
        self._sum_at: List[Optional[int]] = [None] * capacity
        self._memo = _SlotMemo(capacity)

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._by_hash

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def _slabs(self) -> tuple:
        if self.ks_slab is None:
            return self.k_slab, self.v_slab
        return self.k_slab, self.v_slab, self.ks_slab, self.vs_slab

    def _slot_arrays(self, slot: int) -> Tuple:
        return tuple(slab[slot] for slab in self._slabs())

    def put(self, seq_hash: int, k_page, v_page, sum_: Optional[int] = None,
            k_scale=None, v_scale=None) -> bool:
        """Store (LRU-evicting); True when an existing entry was evicted to
        make room. `sum_` is the page's capture-time checksum (computed here
        for a caller without one)."""
        if seq_hash in self._by_hash:
            slot = self._by_hash[seq_hash]
            self._lru.pop(slot, None)
            self._lru[slot] = None
            return False
        pages = tuple(torch.as_tensor(p) for p in (k_page, v_page, k_scale,
                                                   v_scale) if p is not None)
        if sum_ is None:
            sum_ = tensor_checksum(*pages)
            INTEGRITY.pages_hashed += 1
        evicted = False
        if self._free:
            slot = self._free.pop()
        else:
            slot = next(iter(self._lru))
            del self._lru[slot]
            del self._by_hash[self._hash_at[slot]]
            evicted = True
        for slab, page in zip(self._slabs(), pages):
            slab[slot].copy_(page)
        self._memo.written(slot)
        self._sum_at[slot] = sum_
        self._by_hash[seq_hash] = slot
        self._hash_at[slot] = seq_hash
        self._lru[slot] = None
        return evicted

    def take(self, seq_hash: int) -> Optional[Tuple]:
        """Read AND remove (promotion): verified copies plus the traveling
        checksum, (k, v, sum_) or (k, v, k_scale, v_scale, sum_), or None
        on a miss or an integrity mismatch (the entry, already removed, is
        quarantined and the page will be recomputed)."""
        slot = self._by_hash.pop(seq_hash, None)
        if slot is None:
            return None
        self._hash_at[slot] = None
        self._lru.pop(slot, None)
        self._free.append(slot)
        pages = tuple(slab[slot].clone() for slab in self._slabs())
        sum_ = self._sum_at[slot]
        self._sum_at[slot] = None
        verified = self._memo.consume(slot)
        self._memo.written(slot)
        if sum_ is not None and not verified \
                and tensor_checksum(*pages) != sum_:
            INTEGRITY.mismatches += 1
            INTEGRITY.quarantined += 1
            log.warning("disk kv page %x failed integrity check; "
                        "quarantined (will recompute)", seq_hash)
            return None
        INTEGRITY.pages_verified += 1
        return pages + (sum_,)


class HostKvPool:
    """Fixed-capacity host slab of KV pages keyed by chained sequence hash.

    LRU eviction; duplicate puts refresh recency. A page is the device
    layout of one page, [L, Hkv, ps, hd] k and v (plus [L, Hkv, ps] scales on
    an int8 cache). With a disk tier (disk_pages > 0) DRAM evictions spill
    down and prefix hits promote back up."""

    def __init__(self, capacity: int, page_shape: Tuple[int, ...],
                 dtype: torch.dtype, disk_pages: int = 0,
                 disk_dir: Optional[str] = None,
                 scale_shape: Optional[Tuple[int, ...]] = None,
                 pin: bool = False):
        self.capacity = capacity
        shape = (capacity,) + tuple(page_shape)
        self.k_slab = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self.v_slab = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        # an int8 cache: the slabs above hold int8 values and these the f32
        # per-row scales; the capture checksum covers values AND scales
        self.ks_slab = self.vs_slab = None
        if scale_shape is not None:
            sshape = (capacity,) + tuple(scale_shape)
            self.ks_slab = torch.zeros(sshape, dtype=torch.float32,
                                       pin_memory=pin)
            self.vs_slab = torch.zeros(sshape, dtype=torch.float32,
                                       pin_memory=pin)
        self.pinned_bytes = (sum(s.numel() * s.element_size()
                                 for s in self._slabs()) if pin else 0)
        self._by_hash: Dict[int, int] = {}     # seq_hash -> slot
        self._hash_at: List[Optional[int]] = [None] * capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        # insertion-ordered dict as an O(1) LRU (oldest = first key)
        self._lru: Dict[int, None] = {}
        # capture-time checksum per slot: verified at pin / get, carried
        # down to the disk tier on spill
        self._sum_at: List[Optional[int]] = [None] * capacity
        self._memo = _SlotMemo(capacity)
        # pin counts by hash: a pinned entry is claimed by a pending onboard
        # (an HBM page was sealed expecting it) and survives LRU until then
        self._pins: Dict[int, int] = {}
        self.stats = OffloadStats()
        self.times = TierTimes()
        self._hasher = Hasher("kv-tier-verify")
        self.disk: Optional[DiskKvPool] = None
        if disk_pages > 0:
            import tempfile
            self.disk = DiskKvPool(
                disk_pages, page_shape, dtype,
                disk_dir or tempfile.mkdtemp(prefix="dynamo_kv_disk_"),
                scale_shape=scale_shape)
        # puts arrive from the CopyStream thread while the engine thread
        # matches prefixes and onboards: one lock guards the maps and slab
        # writes (slab views handed out are stable only while pinned)
        self._mu = threading.RLock()

    def _slabs(self) -> tuple:
        if self.ks_slab is None:
            return self.k_slab, self.v_slab
        return self.k_slab, self.v_slab, self.ks_slab, self.vs_slab

    def _slot_arrays(self, slot: int) -> Tuple:
        """The slot's stored arrays in checksum order (views)."""
        return tuple(slab[slot] for slab in self._slabs())

    def __contains__(self, seq_hash: int) -> bool:
        with self._mu:
            return (seq_hash in self._by_hash
                    or (self.disk is not None and seq_hash in self.disk))

    def preverify(self, hashes) -> None:
        """Verify the entries of `hashes` (DRAM or disk) in threads, ahead of
        the pins a prefix walk is about to make one by one; each pin then
        finds its verify done, with the same outcome."""
        t0 = time.perf_counter()
        with self._mu:
            slots = [self._by_hash[h] for h in hashes if h in self._by_hash
                     and h not in self._pins]
            disk = ([self.disk._by_hash[h] for h in hashes
                     if h in self.disk._by_hash]
                    if self.disk is not None else [])
        n = _prehash(self, slots, self._mu, self._hasher)
        if disk:
            n += _prehash(self.disk, disk, self._mu, self._hasher)
        self.times.verify_s += time.perf_counter() - t0
        self.times.verify_pages += n

    def close(self) -> None:
        """Stop the verify threads (the slabs stay readable)."""
        self._hasher.close()

    def forget_verified(self) -> None:
        """Drop the verifies `preverify` left unused (a walk that stopped
        early): a later pin or get hashes again."""
        with self._mu:
            self._memo.ok.clear()
            if self.disk is not None:
                self.disk._memo.ok.clear()

    def pin(self, seq_hash: int) -> bool:
        """Pin an entry against LRU eviction, promoting it from the disk tier
        if needed; False if it is in neither tier. Containment and pin are
        one atomic step, or a concurrent put could evict the slot between.

        The pin is also the integrity gate: the entry's bytes are verified
        against the capture-time checksum before the prefix walk can claim
        the page; a mismatch quarantines the entry and returns False (the
        page is recomputed)."""
        with self._mu:
            if seq_hash not in self._by_hash and not self._promote(seq_hash):
                return False
            slot = self._by_hash[seq_hash]
            if seq_hash not in self._pins and not self._verify(slot):
                self._quarantine(seq_hash, slot)
                return False
            self._pins[seq_hash] = self._pins.get(seq_hash, 0) + 1
            return True

    def _verify(self, slot: int) -> bool:
        """Lock held: check the slot's bytes against its capture checksum
        (done already when `preverify` or a promotion remembered it)."""
        sum_ = self._sum_at[slot]
        if sum_ is None:
            return True
        if not self._memo.consume(slot):
            t0 = time.perf_counter()
            ok = tensor_checksum(*self._slot_arrays(slot)) == sum_
            self.times.verify_s += time.perf_counter() - t0
            self.times.verify_pages += 1
            if not ok:
                INTEGRITY.mismatches += 1
                return False
        INTEGRITY.pages_verified += 1
        return True

    def _quarantine(self, seq_hash: int, slot: int) -> None:
        """Lock held: drop a corrupt entry so the walk misses and the page
        is recomputed, never served."""
        del self._by_hash[seq_hash]
        self._hash_at[slot] = None
        self._sum_at[slot] = None
        self._lru.pop(slot, None)
        self._free.append(slot)
        INTEGRITY.quarantined += 1
        log.warning("host kv page %x failed integrity check; quarantined "
                    "(will recompute)", seq_hash)

    def unpin(self, seq_hash: int) -> None:
        with self._mu:
            n = self._pins.get(seq_hash, 0) - 1
            if n <= 0:
                self._pins.pop(seq_hash, None)
            else:
                self._pins[seq_hash] = n

    def _promote(self, seq_hash: int) -> bool:
        """Lock held: move a disk-tier page up into the DRAM slab (the disk
        take verifies it; a quarantined entry is a miss)."""
        if self.disk is None:
            return False
        t0 = time.perf_counter()
        got = self.disk.take(seq_hash)
        if got is None:
            return False
        pages, sum_ = got[:-1], got[-1]
        ok = self._insert(seq_hash, pages, sum_, verified=True)
        self.times.promote_s += time.perf_counter() - t0
        self.times.promote_pages += 1
        if not ok:
            # DRAM fully pinned: return the page to disk, don't lose it
            self.disk.put(seq_hash, pages[0], pages[1], sum_, *pages[2:])
            return False
        self.stats.disk_hits += 1
        return True

    def _insert(self, seq_hash: int, pages, sum_: Optional[int],
                verified: bool = False) -> bool:
        """Lock held: place host pages in the DRAM slab, spilling the LRU
        victim down to the disk tier when one exists. `sum_` is the
        capture-time checksum traveling with the page; `verified`: the
        pages are a buffer just verified against it."""
        if seq_hash in self._by_hash:
            self._touch(self._by_hash[seq_hash])
            return True
        if self._free:
            slot = self._free.pop()
        else:
            slot = None
            for cand in self._lru:              # oldest unpinned entry
                if self._hash_at[cand] not in self._pins:
                    slot = cand
                    break
            if slot is None:                  # everything pinned: skip
                self.stats.put_dropped += 1
                return False
            del self._lru[slot]
            old = self._hash_at[slot]
            if old is not None:
                del self._by_hash[old]
                if self.disk is not None:
                    # spill down instead of dropping; the slot's checksum
                    # travels with the page, so corruption here cannot be
                    # laundered by the spill
                    t0 = time.perf_counter()
                    arrays = self._slot_arrays(slot)
                    if self.disk.put(old, arrays[0], arrays[1],
                                     self._sum_at[slot], *arrays[2:]):
                        self.stats.disk_evicted += 1
                    self.stats.disk_offloaded += 1
                    self.times.spill_s += time.perf_counter() - t0
                    self.times.spill_pages += 1
            self.stats.evicted += 1
        for dst, src in zip(self._slot_arrays(slot), pages):
            dst.copy_(src)
        self._memo.written(slot)
        if verified:
            self._memo.mark(slot)
        self._sum_at[slot] = sum_
        self._by_hash[seq_hash] = slot
        self._hash_at[slot] = seq_hash
        self._lru[slot] = None
        return True

    def put(self, seq_hash: int, k_page, v_page, k_scale=None, v_scale=None,
            sum_: Optional[int] = None) -> None:
        """Store one page from host arrays (numpy or CPU tensors). `sum_` is
        its capture checksum when the caller hashed it already (the
        CopyStream hashes a block's pages side by side); else it is taken
        here, over the bytes just pulled off the authoritative device copy,
        and every later verify checks against it."""
        pages = tuple(torch.as_tensor(p) for p in (k_page, v_page, k_scale,
                                                   v_scale) if p is not None)
        with self._mu:
            if seq_hash in self._by_hash:   # duplicate: refresh LRU only
                self._touch(self._by_hash[seq_hash])
                return
        if sum_ is None:
            sum_ = tensor_checksum(*pages)
        with self._mu:
            if seq_hash in self._by_hash:
                self._touch(self._by_hash[seq_hash])
                return
            INTEGRITY.pages_hashed += 1
            if self._insert(seq_hash, pages, sum_):
                self.stats.offloaded += 1

    def get(self, seq_hash: int) -> Optional[Tuple]:
        """Slab views (k, v) or (k, v, k_scale, v_scale), or None. A pinned
        entry was verified at pin() and its slot is stable, so it returns
        directly; an unpinned get re-verifies and quarantines on mismatch."""
        with self._mu:
            slot = self._by_hash.get(seq_hash)
            if slot is None:
                if not self._promote(seq_hash):
                    return None
                slot = self._by_hash[seq_hash]
            if seq_hash not in self._pins and not self._verify(slot):
                self._quarantine(seq_hash, slot)
                return None
            self._touch(slot)
            return self._slot_arrays(slot)

    def _touch(self, slot: int) -> None:
        self._lru.pop(slot, None)
        self._lru[slot] = None

    @property
    def used(self) -> int:
        with self._mu:
            return self.capacity - len(self._free)


class CopyStream:
    """Background HBM -> host drain: offload copies overlap decode.

    The engine enqueues each page extraction on its own stream in step
    order (values captured before any overwrite) and hands the block here,
    page-major ([N, L, Hkv, ps, hd] values, [N, L, Hkv, ps] scales) with
    its "ready" event. This thread copies the block to host memory (on the
    card: pinned, on a stream of its own after the ready event, every CUDA
    call holding `lock`, the engine's `WindowGraphs.capture_lock`), hashes
    its pages side by side and puts them into the host pool one by one, in
    order: the JAX order of device_get, then a put per page."""

    def __init__(self, host_pool: HostKvPool, device=None, lock=None):
        self._pool = host_pool
        dev = torch.device(device) if device is not None else None
        self._stream = (torch.cuda.Stream(dev)
                        if dev is not None and dev.type == "cuda" else None)
        self._lock = lock if lock is not None else contextlib.nullcontext()
        self._hasher = Hasher("kv-tier-capture")
        self._q: "queue.Queue" = queue.Queue()
        # chained hash -> in-flight copies carrying it: admission waits only
        # for the copies its prefix walk may hit
        self._inflight: Dict[int, int] = {}
        self._cv = threading.Condition()
        self._thread = threading.Thread(
            target=self._run, name="kv-copy-stream", daemon=True)
        self._thread.start()

    def submit(self, device_pages: dict, seq_hashes: List[int]) -> None:
        """device_pages: {"k", "v"[, "k_scale", "v_scale"], "ready"}, the
        page-major block; seq_hashes: the chained hash of each page."""
        hashes = list(seq_hashes)
        with self._cv:
            for h in hashes:
                self._inflight[h] = self._inflight.get(h, 0) + 1
        self._q.put((device_pages, hashes))

    def settle(self, seq_hashes) -> None:
        """Block until no copy carrying any of `seq_hashes` is in flight."""
        need = set(seq_hashes)
        if not need:
            return
        t0 = time.perf_counter()
        with self._cv:
            self._cv.wait_for(
                lambda: not any(h in self._inflight for h in need))
        self._pool.times.settle_s += time.perf_counter() - t0

    def drain(self) -> None:
        """Block until every submitted copy has landed (a barrier)."""
        self._q.join()

    def close(self) -> None:
        """Drain pending copies and stop the thread."""
        self._q.put(None)
        self._thread.join(timeout=30)
        self._hasher.close()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            pages, hashes = item
            try:
                self._land(pages, hashes)
            except Exception:  # noqa: BLE001 — a failed offload only costs
                # a future recompute; never kill the drain, never hide it
                self._pool.stats.failed += len(hashes)
                log.exception("kv offload of %d page(s) failed; they will "
                              "be recomputed", len(hashes))
            finally:
                with self._lock:
                    pages = item = None   # the device block, freed here
                with self._cv:
                    for h in hashes:
                        n = self._inflight.get(h, 0) - 1
                        if n <= 0:
                            self._inflight.pop(h, None)
                        else:
                            self._inflight[h] = n
                    self._cv.notify_all()
                self._q.task_done()

    def _land(self, pages: dict, hashes: List[int]) -> None:
        leaves = [pages[k] for k in LEAVES if k in pages]
        # STAGE_PAGES at a time, so the pinned staging stays bounded
        for start in range(0, len(hashes), STAGE_PAGES):
            end = min(start + STAGE_PAGES, len(hashes))
            host = self._to_host([x[start:end] for x in leaves],
                                 pages.get("ready"))
            t0 = time.perf_counter()
            sums = self._hasher.map(
                lambda i: tensor_checksum(*(x[i] for x in host)),
                range(end - start))
            self._pool.times.checksum_s += time.perf_counter() - t0
            for i, h in enumerate(hashes[start:end]):
                self._pool.put(h, *(x[i] for x in host), sum_=sums[i])

    def _to_host(self, leaves: list, ready) -> list:
        """The block's leaves in host memory (a CPU block as it is)."""
        t = self._pool.times
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        if self._stream is None:
            t.d2h_bytes += nbytes
            return leaves
        with self._lock, torch.cuda.stream(self._stream):
            if ready is not None:
                self._stream.wait_event(ready)
            host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in leaves]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            for d, x in zip(host, leaves):
                d.copy_(x, non_blocking=True)
            end.record(self._stream)
        end.synchronize()
        t.d2h_s += start.elapsed_time(end) / 1e3
        t.d2h_bytes += nbytes
        return host
