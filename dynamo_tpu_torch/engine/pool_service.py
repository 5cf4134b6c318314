"""Cross-host KV pool service: replicated placement, watch-driven
rebalance, and mid-fetch failover that never drops a stream.

Port of dynamo_tpu/engine/pool_service.py. The shared pool
(engine/kv_pool.py `SharedKvPool`) is one process's; this module serves it
from several pool hosts:

- `KvPoolHost`: one pool host, a RAM tier of sealed KV pages over an NVMe
  tier (engine/offload.py `DiskKvPool`) that RAM-capacity evictions spill
  into with their capture checksum; a RAM miss promotes from disk, verified
  first. Every fetch re-verifies the page (a rotten replica is quarantined
  HERE and never served), and every write is fenced by the ring's ownership
  epoch (runtime/placement.py): a publish or rebalance copy that carries a
  stale epoch is refused by name and counted. `kill` / `partition` make it
  unreachable (PoolHostUnavailable on every call); `register` advertises
  `kv_pool/{host}` in the discovery store under the host's lease.
- `ClusterKvPool`: the worker-side facade, with `SharedKvPool`'s interface
  (`__contains__` / `publish` / `note_source` / `fetch` / `drain_events` /
  `evict_source`), so `NativeEngine.attach_kv_pool`, the scheduler's pool
  claim, `prefetch_pool_pages`, `PoolPublishStream` and
  `AdmissionPrefetcher` take it unchanged. A publish writes to the R ring
  owners and succeeds on one landed copy (quorum 1; the gap is counted and
  repaired later). A fetch walks the owners in ring order and fails over
  at page granularity: the prefix walk keeps its committed pages, the next
  replica serves the page, and only an exhausted walk falls back to the
  recompute of the tail.
- Rebalance: membership changes only queue work; `run_rebalance` copies at
  most `budget` pages a call (a leave re-replicates from the survivors, a
  join hands owed entries over), every copy read through the verifying
  fetch and fenced by the epoch captured at scan time.

The failpoints `pool.remote_fetch` (one decision per replica attempt) and
`pool.rebalance` (one per rebalance copy) are JAX's (runtime/faults.py).

What differs from the JAX module: pages are CPU torch tensors and
checksums `runtime/integrity.tensor_checksum`; a host's NVMe tier defaults
to a fresh temporary directory. Each served page feeds the router's cost
model on the `pool:{host}` link (`TRANSFER_MODEL.observe`, JAX :754-777).
Left out: the `pool.fetch.remote` / `pool.rebalance` trace spans, with the
tracer's scope spans (ROADMAP A14).
"""
from __future__ import annotations

import logging
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import torch

from dynamo_tpu_torch.engine.kv_pool import (
    POOL_STATS, PoolEntry, PoolQuantMismatch,
)
from dynamo_tpu_torch.observability.fleet import TRANSFER_MODEL
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.integrity import (
    STATS as INTEGRITY, tensor_checksum,
)
from dynamo_tpu_torch.runtime.placement import HashRing, PoolMembership

log = logging.getLogger("dynamo_tpu_torch.pool_service")

KV_POOL_PREFIX = "kv_pool/"


def _nbytes(arrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays)


def pool_host_key(host: str) -> str:
    """Discovery key one pool host advertises (`kv_pool/{host}`) —
    the transfer plane's per-host endpoint idiom."""
    return f"{KV_POOL_PREFIX}{host}"


class PoolHostUnavailable(ConnectionError):
    """The addressed pool host cannot serve (killed, partitioned, or a
    `pool.remote_fetch` drop stood in for either). Retryable AT THE
    CLUSTER LAYER by failing over to the next replica in ring order;
    only when every replica is exhausted does the caller fall back to
    recompute (the salvage path — latency, never tokens)."""


class RemotePoolStats:
    """Cross-host pool counters (/metrics: llm_kv_pool_remote_*).

    Same pattern as KvPoolStats: plain numbers bumped on the cluster
    paths, folded into gauges at render time by frontend/service.py."""

    FIELDS = (
        "fetch_pages",          # pages served by a remote pool host
        "fetch_failovers",      # mid-fetch replica failovers (page granularity)
        "fetch_exhausted",      # fetches that exhausted every replica (recompute)
        "publishes",            # quorum publishes attempted
        "publish_quorum_degraded",  # publishes that landed on < R owners
        "repair_pages",         # pages re-replicated by repair/rebalance
        "stale_epoch_rejected", # writes fenced by the ring ownership epoch
        "stale_epoch_landed",   # fenced writes that LANDED anyway (must stay 0)
        "disk_spills",          # RAM-tier evictions spilled to the NVMe tier
        "disk_hits",            # fetches promoted from the NVMe tier
        "disk_quarantined",     # NVMe-tier entries quarantined on rot
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


REMOTE_STATS = RemotePoolStats()


class PoolRingStats:
    """Placement-ring counters (/metrics: llm_pool_ring_*)."""

    FIELDS = (
        "hosts",                # live pool hosts (ring membership)
        "epoch",                # current ownership epoch
        "rebalances",           # rebalance passes run
        "rebalanced_pages",     # pages copied by rebalance passes
        "under_replicated",     # entries below min(R, hosts) after last pass
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


RING_STATS = PoolRingStats()


class KvPoolHost:
    """One served pool host: RAM tier + NVMe spill, epoch-fenced writes.

    The data-plane contract is the chunk-committed protocol's, applied
    at page granularity: every page is stored with its capture-time
    checksum, re-VERIFIED on every fetch (quarantine on mismatch — a
    rotten replica is removed HERE and never served; the cluster walk
    simply moves to the next replica), and every write is fenced by the
    ring ownership epoch so a stale publisher or rebalancer cannot land
    bytes this membership never placed here.

    Thread-safe; `alive`/`partitioned` are the chaos controls — a killed
    or partitioned host raises PoolHostUnavailable on every call, which
    is exactly what a dead TCP peer looks like to the client facade.
    """

    def __init__(self, host_id: str, capacity_pages: int = 4096,
                 disk_capacity_pages: int = 0,
                 disk_dir: Optional[str] = None,
                 epoch_fn=None):
        self.host_id = host_id
        self.capacity_pages = max(1, capacity_pages)
        self.disk_capacity_pages = disk_capacity_pages
        self.disk_dir = disk_dir
        self.epoch_fn = epoch_fn      # () -> current ring ownership epoch
        self.alive = True
        self.partitioned = False
        self._entries: "OrderedDict[int, PoolEntry]" = OrderedDict()
        self._disk = None             # lazy: shapes known at first spill
        self._disk_meta: Dict[int, Tuple[int, int, str]] = {}
        self._mu = threading.RLock()
        self.on_removed = None        # cb(entry) — cluster event plumbing
        # entries dropped while _mu was held; drained by _flush_dropped
        # AFTER the lock is released — the on_removed callback scans
        # OTHER hosts (ClusterKvPool._host_dropped_entry -> contains),
        # so invoking it under our lock is an ABBA deadlock with a
        # concurrent eviction on a sibling host
        self._dropped_pending: List[PoolEntry] = []

    # -- chaos controls -------------------------------------------------------

    def kill(self) -> None:
        self.alive = False

    def partition(self, flag: bool = True) -> None:
        self.partitioned = flag

    def _check_reachable(self) -> None:
        if not self.alive or self.partitioned:
            raise PoolHostUnavailable(
                f"pool host {self.host_id} is "
                f"{'partitioned' if self.alive else 'dead'}")

    # -- introspection --------------------------------------------------------

    def contains(self, seq_hash: int) -> bool:
        with self._mu:
            return seq_hash in self._entries or seq_hash in self._disk_meta

    def hashes(self) -> List[int]:
        with self._mu:
            return list(self._entries) + list(self._disk_meta)

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries) + len(self._disk_meta)

    # -- write path -----------------------------------------------------------

    def publish_page(self, source: str, seq_hash: int, parent: int,
                     tokens_hash: int, arrays, mode: str = "",
                     sum_: Optional[int] = None,
                     ring_epoch: Optional[int] = None) -> str:
        """Store one sealed page. Returns "new" / "dup" /
        "quant-mismatch" (first representation wins, never cast) /
        "stale-epoch" (the write carried an ownership epoch older than
        the current ring membership's — fenced by name, the `alloc_epoch`
        zombie-sender discipline; the counter pair
        stale_epoch_rejected / stale_epoch_landed is the
        structural proof that no fenced write ever lands). `sum_` is the
        capture-time checksum that travels with the entry and is
        verified on every later fetch."""
        self._check_reachable()
        if ring_epoch is not None and self.epoch_fn is not None \
                and ring_epoch != self.epoch_fn():
            REMOTE_STATS.stale_epoch_rejected += 1
            log.info("pool host %s fenced stale-epoch write for %x "
                     "(write epoch %d != ring epoch %d)", self.host_id,
                     seq_hash, ring_epoch, self.epoch_fn())
            return "stale-epoch"
        arrays = tuple(torch.as_tensor(a) for a in arrays)
        if sum_ is None:
            sum_ = tensor_checksum(*arrays)
            INTEGRITY.pages_hashed += 1
        with self._mu:
            result = self._publish_locked(source, seq_hash, parent,
                                          tokens_hash, arrays, mode, sum_)
        self._flush_dropped()
        return result

    def _publish_locked(self, source: str, seq_hash: int, parent: int,
                        tokens_hash: int, arrays, mode: str,
                        sum_: int) -> str:
        """Lock held. Capacity evictions only QUEUE their on_removed
        report (_dropped); the caller flushes after releasing _mu."""
        e = self._entries.get(seq_hash)
        if e is not None:
            if e.mode != mode:
                return "quant-mismatch"
            self._entries.move_to_end(seq_hash)
            e.sources.add(source)
            return "dup"
        if seq_hash in self._disk_meta:
            if self._disk_meta[seq_hash][2] != mode:
                return "quant-mismatch"
            return "dup"
        e = PoolEntry(seq_hash=seq_hash, parent=parent,
                      tokens_hash=tokens_hash, mode=mode,
                      arrays=arrays, sum_=sum_,
                      nbytes=_nbytes(arrays), sources={source})
        self._entries[seq_hash] = e
        while len(self._entries) > self.capacity_pages:
            _, old = self._entries.popitem(last=False)
            self._spill(old)
        return "new"

    def _spill(self, e: PoolEntry) -> None:
        """Lock held. RAM-capacity eviction: spill down to the NVMe tier
        with the traveling checksum (never recomputed from a possibly-
        corrupt copy — the offload-tier discipline), or drop when no
        disk tier is configured."""
        if self.disk_capacity_pages <= 0:
            self._dropped(e)
            return
        if self._disk is None:
            from dynamo_tpu_torch.engine.offload import DiskKvPool
            scale_shape = (e.arrays[2].shape
                           if len(e.arrays) == 4 else None)
            self._disk = DiskKvPool(
                self.disk_capacity_pages, e.arrays[0].shape,
                e.arrays[0].dtype,
                self.disk_dir or tempfile.mkdtemp(
                    prefix=f"kv_pool_{self.host_id}_"),
                scale_shape=scale_shape)
        scales = e.arrays[2:] if len(e.arrays) == 4 else (None, None)
        before = set(self._disk._by_hash)
        self._disk.put(e.seq_hash, e.arrays[0], e.arrays[1], e.sum_,
                       *scales)
        for gone in [h for h in before
                     if h not in self._disk._by_hash]:
            meta = self._disk_meta.pop(gone, None)
            if meta is not None:
                self._dropped(PoolEntry(
                    seq_hash=gone, parent=meta[0], tokens_hash=meta[1],
                    mode=meta[2], arrays=(), sum_=0, nbytes=0))
        self._disk_meta[e.seq_hash] = (e.parent, e.tokens_hash, e.mode)
        REMOTE_STATS.disk_spills += 1

    def _dropped(self, e: PoolEntry) -> None:
        """An entry permanently left this host (disk eviction, drop, or
        quarantine). Only QUEUES the report — the on_removed callback
        takes cluster and sibling-host locks (it scans every host to
        decide whether the entry is globally gone), so it must never
        run while this host's _mu is held. Every public path that can
        drop calls _flush_dropped after releasing the lock."""
        with self._mu:
            self._dropped_pending.append(e)

    def _flush_dropped(self) -> None:
        """Deliver queued on_removed reports. Call with _mu RELEASED —
        this is the lock-order boundary that prevents the ABBA deadlock
        between two hosts evicting concurrently."""
        while True:
            with self._mu:
                if not self._dropped_pending:
                    return
                pending, self._dropped_pending = self._dropped_pending, []
            if self.on_removed is not None:
                for e in pending:
                    self.on_removed(self.host_id, e)

    # -- read path ------------------------------------------------------------

    def fetch_page(self, seq_hash: int, mode: str = "") -> Optional[Tuple]:
        """Verified host copies of one page, or None on a miss OR rot
        (the rotten entry is quarantined ON THIS REPLICA only — removed,
        never served; the cluster walk fails over to the next replica,
        which holds its own independently-verified copy). Raises
        PoolQuantMismatch by name (never cast), PoolHostUnavailable when
        this host cannot serve. The `pool.remote_fetch` failpoint fires
        here — ONE decision per fetch attempt (call-site-managed, so a
        chaos plan's hit index k is exactly the k-th replica attempt):
        drop stands in for a host death mid-fetch, delay for a stalled
        link, corrupt for bytes rotting on this replica's RAM tier
        (NVMe-tier rot rides the existing `offload.read_tier` site
        under DiskKvPool.take)."""
        self._check_reachable()
        out = faults.REGISTRY.decide("pool.remote_fetch") \
            if faults.REGISTRY.enabled else None
        if out is not None:
            if out.delay_s > 0:
                time.sleep(out.delay_s)
            if out.drop:
                raise PoolHostUnavailable(
                    f"pool host {self.host_id}: injected fetch fault")
        from_disk = False
        with self._mu:
            e = self._entries.get(seq_hash)
            if e is not None:
                if e.mode != mode:
                    raise PoolQuantMismatch(seq_hash, e.mode, mode)
                self._entries.move_to_end(seq_hash)
                arrays = tuple(a.clone() for a in e.arrays)
                sum_ = e.sum_
            else:
                arrays = self._fetch_from_disk(seq_hash, mode)
                from_disk = True
        if from_disk:
            # the disk promote may have queued drops (tier quarantine,
            # promote-triggered RAM spill) — deliver outside the lock
            self._flush_dropped()
            return arrays
        if out is not None and out.corrupt:
            # deterministic single-byte rot standing in for this
            # replica's tier rotting: the verify below catches it and
            # quarantines HERE; sibling replicas hold clean copies
            flat = arrays[0].reshape(-1).view(torch.uint8)
            flat[0] ^= 0xFF
        if tensor_checksum(*arrays) != sum_:
            INTEGRITY.mismatches += 1
            INTEGRITY.quarantined += 1
            with self._mu:
                old = self._entries.pop(seq_hash, None)
            if old is not None:
                self._dropped(old)
                self._flush_dropped()
            log.warning("pool host %s: page %x failed integrity check; "
                        "quarantined on this replica", self.host_id,
                        seq_hash)
            return None
        INTEGRITY.pages_verified += 1
        return arrays

    def _fetch_from_disk(self, seq_hash: int, mode: str) -> Optional[Tuple]:
        """Lock held. NVMe-tier promote: DiskKvPool.take verifies against
        the traveling checksum and quarantines on mismatch (returns
        None); a clean read promotes the page back into the RAM tier."""
        meta = self._disk_meta.get(seq_hash)
        if meta is None or self._disk is None:
            return None
        parent, tokens_hash, stored_mode = meta
        if stored_mode != mode:
            raise PoolQuantMismatch(seq_hash, stored_mode, mode)
        got = self._disk.take(seq_hash)
        del self._disk_meta[seq_hash]
        if got is None:     # quarantined by the tier's verify
            REMOTE_STATS.disk_quarantined += 1
            self._dropped(PoolEntry(
                seq_hash=seq_hash, parent=parent, tokens_hash=tokens_hash,
                mode=stored_mode, arrays=(), sum_=0, nbytes=0))
            return None
        arrays, sum_ = tuple(got[:-1]), got[-1]
        REMOTE_STATS.disk_hits += 1
        e = PoolEntry(seq_hash=seq_hash, parent=parent,
                      tokens_hash=tokens_hash, mode=stored_mode,
                      arrays=arrays, sum_=sum_,
                      nbytes=_nbytes(arrays), sources=set())
        self._entries[seq_hash] = e
        self._entries.move_to_end(seq_hash)
        while len(self._entries) > self.capacity_pages:
            _, old = self._entries.popitem(last=False)
            self._spill(old)
        return arrays

    def read_page(self, seq_hash: int):
        """Rebalance-side read: (entry-meta, arrays, sum_) WITHOUT
        serving-path accounting — still checksum-verified via the fetch
        path (a rebalance must never replicate rot). None on miss."""
        with self._mu:
            e = self._entries.get(seq_hash)
            if e is None:
                meta = self._disk_meta.get(seq_hash)
                if meta is None:
                    return None
                mode = meta[2]
            else:
                mode = e.mode
        arrays = self.fetch_page(seq_hash, mode)
        if arrays is None:
            return None
        with self._mu:
            e = self._entries.get(seq_hash)
            if e is None:
                # a concurrent publish evicted/spilled the entry between
                # the fetch and here — treat as a miss; the next
                # rebalance pass re-finds the gap
                return None
            return (e.parent, e.tokens_hash, e.mode,
                    tuple(a.clone() for a in arrays), e.sum_,
                    set(e.sources))

    # -- source lifecycle -----------------------------------------------------

    def note_holder(self, source: str, seq_hash: int) -> bool:
        """Dedup fast path: record `source` as a holder when this host
        already stores the hash (RAM or NVMe tier). Reachability-checked
        like every served call — a killed or partitioned owner must not
        count as holding bytes it cannot serve (raises
        PoolHostUnavailable; the cluster skips it)."""
        self._check_reachable()
        with self._mu:
            e = self._entries.get(seq_hash)
            if e is not None:
                e.sources.add(source)
                return True
            return seq_hash in self._disk_meta

    def evict_source(self, source: str) -> List[int]:
        """Forget a dead source worker; single-source entries drop (the
        SharedKvPool.evict_source contract). Returns dropped hashes so
        the cluster can decide which are globally gone."""
        dropped: List[int] = []
        with self._mu:
            for h in [h for h, e in self._entries.items()
                      if source in e.sources]:
                e = self._entries[h]
                e.sources.discard(source)
                if not e.sources:
                    del self._entries[h]
                    dropped.append(h)
        return dropped

    # -- discovery ------------------------------------------------------------

    async def register(self, kv, lease_id: int = 0) -> None:
        """Advertise `kv_pool/{host}` in the discovery KV under the
        host's lease (the key vanishes with the host — liveness is the
        lease's job, membership the watch listener's)."""
        from dynamo_tpu_torch.runtime.transports.codec import packb
        await kv.put(pool_host_key(self.host_id),
                     packb({"host": self.host_id,
                            "capacity_pages": self.capacity_pages}),
                     lease_id=lease_id)


class ClusterKvPool:
    """Worker-side facade over the replicated pool-host fleet.

    Interface-identical to `SharedKvPool`, so the engine attach path
    (`attach_kv_pool` → `scheduler._pool_claim` → `_match_prefix` pool
    rung) and the publish path (`PoolPublishStream`) work unchanged.
    Every fetched page is checksum-verified on the serving host
    (quarantine on mismatch, replica-local); every publish carries the
    ownership epoch it was placed under so membership changes fence
    stale writes instead of misplacing them.
    """

    def __init__(self, membership: Optional[PoolMembership] = None,
                 replicas: int = 2, vnodes: int = 64,
                 name: str = "kv-pool-cluster",
                 rebalance_budget: int = 256):
        if membership is None:
            membership = PoolMembership(
                HashRing(vnodes=vnodes, replicas=replicas))
        self.membership = membership
        self.name = name
        self.rebalance_budget = rebalance_budget
        self._hosts: Dict[str, KvPoolHost] = {}
        self._events: Dict[str, List[Tuple[str, int, int, int, int]]] = {}
        # sources that ever published/noted each hash — Removed-event
        # addressing when an entry leaves its last owner
        self._hash_sources: Dict[int, Set[str]] = {}
        self._hash_meta: Dict[int, Tuple[int, int]] = {}
        self._pending_rebalance: List[Tuple[str, str, int]] = []
        self._mu = threading.RLock()
        # membership changes only ENQUEUE rebalance work (watch listeners
        # must stay cheap); run_rebalance drains under a bounded budget
        self.membership.on_change(self._on_membership_change)
        self._sync_ring_stats()

    # -- membership / hosts ---------------------------------------------------

    def _sync_ring_stats(self) -> None:
        RING_STATS.hosts = len(self.membership.live_hosts())
        RING_STATS.epoch = self.membership.epoch

    def _on_membership_change(self, kind: str, host: str,
                              epoch: int) -> None:
        with self._mu:
            self._pending_rebalance.append((kind, host, epoch))
        self._sync_ring_stats()

    def add_host(self, host: KvPoolHost) -> None:
        """Join: register the host object and enter it into ring
        membership (ownership epoch bumps; the enqueued join handoff
        copies its owed entries under run_rebalance's budget)."""
        host.epoch_fn = lambda: self.membership.epoch
        host.on_removed = self._host_dropped_entry
        with self._mu:
            self._hosts[host.host_id] = host
        self.membership.join(host.host_id)

    def remove_host(self, host_id: str) -> None:
        """Graceful leave: membership drops (epoch bump), survivors
        re-replicate from their own copies."""
        self.membership.leave(host_id)
        with self._mu:
            self._hosts.pop(host_id, None)

    def kill_host(self, host_id: str) -> None:
        """Crash-leave (chaos): the process dies first, the watch delete
        lands after — exactly the ordering the epoch fence exists for."""
        with self._mu:
            h = self._hosts.get(host_id)
        if h is not None:
            h.kill()
        self.membership.leave(host_id)
        with self._mu:
            self._hosts.pop(host_id, None)

    def partition_host(self, host_id: str, flag: bool = True) -> None:
        """Network partition: unreachable but still a ring MEMBER (no
        lease expiry yet) — fetchers fail over past it, publishes land
        on the reachable owners (quorum 1 holds), and no rebalance runs
        because membership never changed."""
        with self._mu:
            h = self._hosts.get(host_id)
        if h is not None:
            h.partition(flag)

    def attach_watch(self, client) -> None:
        """Ride the component instance watch: pool-host instance
        puts/deletes (pool-host:{host} ids, runtime/placement.py) drive
        ring membership at watch-event time."""
        client.add_listener(self.membership.on_instance)

    def _live_owner_objs(self, seq_hash: int) -> List[KvPoolHost]:
        """Ring owners (current membership epoch) resolved to host
        objects, ring order preserved — the fetch walk's replica list."""
        owners = self.membership.owners_for(seq_hash)
        with self._mu:
            return [self._hosts[h] for h in owners if h in self._hosts]

    # -- events (router index plumbing) ---------------------------------------

    def _emit(self, source: str, kind: str, seq_hash: int, parent: int,
              tokens_hash: int) -> None:
        with self._mu:
            self._events.setdefault(source, []).append(
                (kind, 0, seq_hash, parent, tokens_hash))

    def drain_events(self, source: str) -> List[Tuple[str, int, int, int, int]]:
        with self._mu:
            return self._events.pop(source, [])

    def _host_dropped_entry(self, host_id: str, e: PoolEntry) -> None:
        """A host permanently lost an entry (disk eviction / quarantine).
        Only when NO registered owner still holds it does the cluster
        emit Removed events — replicas make single-host loss invisible
        to the router index."""
        if self.__contains__(e.seq_hash):
            return
        with self._mu:
            sources = self._hash_sources.pop(e.seq_hash, set())
            self._hash_meta.pop(e.seq_hash, None)
            POOL_STATS.entries = len(self._hash_meta)
        for src in sources:
            self._emit(src, "removed", e.seq_hash, e.parent, e.tokens_hash)

    # -- SharedKvPool facade --------------------------------------------------

    def __contains__(self, seq_hash: int) -> bool:
        with self._mu:
            hosts = list(self._hosts.values())
        return any(h.alive and h.contains(seq_hash) for h in hosts)

    def __len__(self) -> int:
        seen: Set[int] = set()
        with self._mu:
            hosts = list(self._hosts.values())
        for h in hosts:
            if h.alive:
                seen.update(h.hashes())
        return len(seen)

    def note_source(self, source: str, seq_hash: int, parent: int,
                    tokens_hash: int) -> bool:
        """Dedup fast path: record `source` as a holder on the live
        owners already storing this hash (their one stored copy was
        checksum-verified at publish — no bytes move). False when no
        REACHABLE owner holds it (publish the bytes instead): a killed
        or partitioned host is skipped by note_holder's reachability
        check, so the fast path never reports "stored" for bytes no
        live owner can actually serve."""
        found = False
        for host in self._live_owner_objs(seq_hash):
            try:
                if host.note_holder(source, seq_hash):
                    found = True
            except PoolHostUnavailable:
                continue
        if not found:
            return False
        POOL_STATS.dedup_hits += 1
        with self._mu:
            srcs = self._hash_sources.setdefault(seq_hash, set())
            newly = source not in srcs
            srcs.add(source)
            self._hash_meta[seq_hash] = (parent, tokens_hash)
        if newly:
            self._emit(source, "stored", seq_hash, parent, tokens_hash)
        return True

    def publish(self, source: str, seq_hash: int, parent: int,
                tokens_hash: int, arrays, mode: str = "",
                sum_: Optional[int] = None) -> str:
        """Quorum-1 replicated publish: write to every live ring owner
        under the CURRENT ownership epoch (stale-epoch writes are fenced
        host-side; a membership change mid-publish is retried once under
        the new epoch, then costs at worst a repair — never a misplaced
        copy). One landed checksum-carrying copy is a
        success — availability over replication, with the gap counted
        (publish_quorum_degraded) and closed by the async repair pass.
        Returns the SharedKvPool result vocabulary: "new" / "dup" /
        "quant-mismatch" / "unavailable" (no owner reachable)."""
        arrays = tuple(torch.as_tensor(a) for a in arrays)
        if sum_ is None:
            sum_ = tensor_checksum(*arrays)
            INTEGRITY.pages_hashed += 1
        REMOTE_STATS.publishes += 1
        owners: List[str] = []
        results: List[str] = []
        landed: List[str] = []
        for _attempt in range(2):
            # atomic (epoch, owners) snapshot under ONE ring lock hold:
            # reading epoch and owners_for separately lets a membership
            # change slip between them — new-ring owners tagged with
            # the old epoch, every owner fencing a healthy publish
            epoch, owners = self.membership.owners_with_epoch(seq_hash)
            results = []
            for host_id in owners:
                with self._mu:
                    host = self._hosts.get(host_id)
                if host is None:
                    continue
                try:
                    results.append(host.publish_page(
                        source, seq_hash, parent, tokens_hash, arrays,
                        mode=mode, sum_=sum_, ring_epoch=epoch))
                except PoolHostUnavailable:
                    continue
            landed = [r for r in results if r in ("new", "dup")]
            if landed or not results \
                    or any(r != "stale-epoch" for r in results):
                break
            # membership changed between the snapshot and the writes:
            # every owner fenced the now-stale epoch. Re-resolve under
            # the new membership and retry ONCE — further churn falls
            # to the repair pass instead of looping here.
        if not landed:
            if "quant-mismatch" in results:
                POOL_STATS.quant_rejected += 1
                return "quant-mismatch"
            return "unavailable"
        if len(landed) < max(1, len(owners)):
            REMOTE_STATS.publish_quorum_degraded += 1
        if "new" in landed:
            POOL_STATS.publishes += 1
        else:
            POOL_STATS.dedup_hits += 1
        with self._mu:
            srcs = self._hash_sources.setdefault(seq_hash, set())
            newly = source not in srcs
            srcs.add(source)
            self._hash_meta[seq_hash] = (parent, tokens_hash)
            # O(1) distinct-hash gauge: len(self) unions every host's
            # hashes (O(total entries)) — too slow for the hot publish
            # path; _hash_meta tracks distinct published hashes and is
            # pruned when the last owner drops one
            POOL_STATS.entries = len(self._hash_meta)
        if newly:
            self._emit(source, "stored", seq_hash, parent, tokens_hash)
        return "new" if "new" in landed else "dup"

    def fetch(self, seq_hash: int, mode: str = "") -> Optional[Tuple]:
        """Replica walk with mid-fetch failover: try the ring owners in ring
        order; each serving host verifies against the traveling checksum
        before answering (rot quarantines on THAT replica only), an
        unreachable host fails the walk over to the next replica, and an
        exhausted walk returns None: the prefix walk keeps its committed
        pages and recomputes the tail (latency, never tokens). The engine
        claims ONE page a call, so a host dying mid-stream costs exactly
        the failed page's retry on the next replica. Each served page is
        one sample of the `pool:{host}` link of the transfer cost model
        (JAX :754-777), so the router prices replica fetches from
        measurements (a cold link answers from the fleet-median prior)."""
        hosts = self._live_owner_objs(seq_hash)
        if not hosts:
            POOL_STATS.fetch_misses += 1
            return None
        for i, host in enumerate(hosts):
            t0 = time.perf_counter()
            try:
                arrays = host.fetch_page(seq_hash, mode)
            except PoolHostUnavailable:
                REMOTE_STATS.fetch_failovers += 1
                continue
            if arrays is None:
                # miss or replica-local quarantine: the next replica holds
                # an independently verified copy
                REMOTE_STATS.fetch_failovers += 1
                continue
            TRANSFER_MODEL.observe(f"pool:{host.host_id}",
                                   sum(a.nbytes for a in arrays),
                                   max(time.perf_counter() - t0, 1e-9))
            POOL_STATS.fetch_hits += 1
            REMOTE_STATS.fetch_pages += 1
            if i > 0:
                log.info("pool fetch %x failed over to replica %s "
                         "(%d hop(s))", seq_hash, host.host_id, i)
            return arrays
        REMOTE_STATS.fetch_exhausted += 1
        POOL_STATS.fetch_misses += 1
        return None

    def evict_source(self, source: str) -> int:
        """Dead source worker (watch delete): forget it on every host;
        hashes it alone sourced drop everywhere, and globally-gone
        hashes emit Removed events (the SharedKvPool contract)."""
        with self._mu:
            hosts = list(self._hosts.values())
            self._events.pop(source, None)
        candidates: Set[int] = set()
        for h in hosts:
            candidates.update(h.evict_source(source))
        dropped = 0
        for sh in candidates:
            if not self.__contains__(sh):
                dropped += 1
                with self._mu:
                    sources = self._hash_sources.pop(sh, set())
                    meta = self._hash_meta.pop(sh, (0, 0))
                for src in sources:
                    if src != source:
                        self._emit(src, "removed", sh, meta[0], meta[1])
        with self._mu:
            for sh, srcs in list(self._hash_sources.items()):
                srcs.discard(source)
            POOL_STATS.entries = len(self._hash_meta)
        if dropped:
            POOL_STATS.source_evictions += 1
        return dropped

    def snapshot(self) -> dict:
        with self._mu:
            hosts = dict(self._hosts)
        return {"hosts": {hid: len(h) for hid, h in hosts.items()},
                "entries": len(self),
                "epoch": self.membership.epoch,
                "ring": self.membership.ring.snapshot()}

    # -- rebalance ------------------------------------------------------------

    def owner_hosts(self, seq_hash: int) -> List[str]:
        """Live owners actually HOLDING the hash under the current
        membership epoch (diagnosis + conservation checks)."""
        return [h.host_id for h in self._live_owner_objs(seq_hash)
                if h.alive and not h.partitioned
                and h.contains(seq_hash)]

    def under_replicated(self) -> List[int]:
        """Hashes below their target copy count min(R, live hosts) under
        the current membership — the repair pass's work list."""
        target = min(self.membership.ring.replicas,
                     len(self.membership.live_hosts()))
        if target == 0:
            return []
        seen: Set[int] = set()
        with self._mu:
            hosts = list(self._hosts.values())
        for h in hosts:
            if h.alive and not h.partitioned:
                seen.update(h.hashes())
        return [sh for sh in seen
                if len(self.owner_hosts(sh)) < target]

    def run_rebalance(self, budget: Optional[int] = None) -> dict:
        """Drain pending membership changes by converging placement: for
        every resident hash, ensure each CURRENT ring owner holds a copy
        (leave → survivors re-replicate; join → amortized handoff to the
        new owner). Bounded: at most `budget` page copies per call (the
        drain discipline — a storm converges over several paced calls,
        `pending` in the summary says how much is left). Every copy
        carries the ownership epoch captured at scan time, so a
        membership change racing this pass fences the in-flight copies
        (stale-epoch rejected host-side) rather than misplacing them;
        the next call rescans under the new epoch. Copies are read
        through the verifying fetch path (rot never replicates) and fire
        the `pool.rebalance` failpoint (a dropped copy is re-found by
        the next pass — repair is idempotent)."""
        budget = self.rebalance_budget if budget is None else budget
        with self._mu:
            pending = self._pending_rebalance
            self._pending_rebalance = []
        if not pending and not self.under_replicated():
            return {"copied": 0, "pending": 0, "fenced": 0}
        RING_STATS.rebalances += 1
        epoch = self.membership.epoch
        copied = fenced = skipped = 0
        with self._mu:
            hosts = {hid: h for hid, h in self._hosts.items()}
        resident: Set[int] = set()
        for h in hosts.values():
            if h.alive and not h.partitioned:
                resident.update(h.hashes())
        for sh in sorted(resident):
            if copied >= budget:
                break
            owners = self.membership.owners_for(sh)
            holders = [hid for hid in owners
                       if hid in hosts and hosts[hid].alive
                       and not hosts[hid].partitioned
                       and hosts[hid].contains(sh)]
            missing = [hid for hid in owners
                       if hid in hosts and hid not in holders]
            if not missing or not holders:
                continue
            src_host = hosts[holders[0]]
            page = src_host.read_page(sh)
            if page is None:
                continue
            parent, tokens_hash, mode, arrays, sum_, sources = page
            source = next(iter(sources), f"rebalance:{src_host.host_id}")
            for hid in missing:
                if copied >= budget:
                    break
                try:
                    if faults.REGISTRY.enabled:
                        faults.REGISTRY.fire_sync("pool.rebalance")
                    r = hosts[hid].publish_page(
                        source, sh, parent, tokens_hash, arrays,
                        mode=mode, sum_=sum_, ring_epoch=epoch)
                except (faults.FaultInjected, PoolHostUnavailable):
                    skipped += 1   # next pass re-finds the gap
                    continue
                if r == "stale-epoch":
                    fenced += 1    # membership moved under us
                    continue
                if r in ("new", "dup"):
                    copied += 1
                    REMOTE_STATS.repair_pages += 1
        with self._mu:
            still_pending = len(self._pending_rebalance)
        under = len(self.under_replicated())
        RING_STATS.rebalanced_pages += copied
        RING_STATS.under_replicated = under
        self._sync_ring_stats()
        if fenced and self.membership.epoch != epoch:
            with self._mu:   # rescan under the new epoch next call
                self._pending_rebalance.append(
                    ("epoch", "*", self.membership.epoch))
                still_pending = len(self._pending_rebalance)
        return {"copied": copied, "fenced": fenced, "skipped": skipped,
                "pending": still_pending, "under_replicated": under}
