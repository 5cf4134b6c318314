"""Consistent-hash placement for the cross-host KV pool service.

Copied whole from dynamo_tpu/runtime/placement.py (:1-265). `HashRing`
gives each pool host `vnodes` points on a 64-bit ring; a page hash's
owners are the first R distinct hosts clockwise from the key's point
(element 0 the primary). The ring point is BLAKE2b over stable strings, so
the same membership gives the same owners in every process, and for the
same integer keys the port's owners are the JAX package's. Every
membership change bumps the ownership `epoch`, the pool hosts' write fence
(engine/pool_service.py). `PoolMembership` is the ring plus a watch-event
feed (`on_instance`, the `Client.add_listener` callback shape):
`pool-host:{host}` instance puts join, deletes leave, at event time; the
router reads it to stop pricing pool prefixes once no pool host is live
(kv_router/router.py `_split_pool_scores`).
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HashRing", "PoolMembership", "POOL_HOST_INSTANCE_PREFIX",
    "pool_host_instance_id", "is_pool_host_instance",
    "pool_host_of_instance",
]

# Pool hosts advertise themselves as component instances under this
# worker-id prefix (next to the engine workers the router already
# watches), so ONE instance watch feeds both the corpse-routing fence
# and pool-host membership — mirror of kv_router/protocols.py's
# `pool:{worker_id}` source-id convention.
POOL_HOST_INSTANCE_PREFIX = "pool-host:"


def pool_host_instance_id(host: str) -> str:
    return f"{POOL_HOST_INSTANCE_PREFIX}{host}"


def is_pool_host_instance(worker_id: str) -> bool:
    return worker_id.startswith(POOL_HOST_INSTANCE_PREFIX)


def pool_host_of_instance(worker_id: str) -> str:
    return worker_id[len(POOL_HOST_INSTANCE_PREFIX):]


def _point(s: str) -> int:
    """Stable 64-bit ring point (blake2b — fast, seedless, identical
    across processes; hash() is salted per-process and unusable here)."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes + ownership epoch.

    Thread-safe: membership changes arrive from watch pumps while
    engine threads resolve owners during prefix walks. `replicas` is R,
    the target copy count per key (default 2 — one host death never
    loses an entry); `owners_for` returns min(R, hosts) distinct hosts,
    so a one-host ring degrades to R=1 rather than failing.
    """

    def __init__(self, vnodes: int = 64, replicas: int = 2):
        if vnodes < 1 or replicas < 1:
            raise ValueError("vnodes and replicas must be >= 1")
        self.vnodes = vnodes
        self.replicas = replicas
        self.epoch = 0                       # ownership epoch (write fence)
        self._hosts: Dict[str, None] = {}    # insertion-ordered set
        self._points: List[int] = []         # sorted vnode points
        self._owner_at: List[str] = []       # host owning _points[i]
        self._mu = threading.RLock()

    # -- membership -----------------------------------------------------------

    def __len__(self) -> int:
        with self._mu:
            return len(self._hosts)

    def __contains__(self, host: str) -> bool:
        with self._mu:
            return host in self._hosts

    @property
    def hosts(self) -> Tuple[str, ...]:
        with self._mu:
            return tuple(self._hosts)

    def add(self, host: str) -> bool:
        """Join. Returns True when membership changed (and the ownership
        epoch was bumped — every placement computed before this call is
        now stale and must be fenced by the serving hosts)."""
        with self._mu:
            if host in self._hosts:
                return False
            self._hosts[host] = None
            for v in range(self.vnodes):
                p = _point(f"{host}#{v}")
                i = bisect.bisect_left(self._points, p)
                self._points.insert(i, p)
                self._owner_at.insert(i, host)
            self.epoch += 1
            return True

    def remove(self, host: str) -> bool:
        """Leave (death or drain). Returns True when membership changed
        (ownership epoch bumped — see `add`)."""
        with self._mu:
            if host not in self._hosts:
                return False
            del self._hosts[host]
            keep = [(p, h) for p, h in zip(self._points, self._owner_at)
                    if h != host]
            self._points = [p for p, _ in keep]
            self._owner_at = [h for _, h in keep]
            self.epoch += 1
            return True

    # -- placement ------------------------------------------------------------

    def owners_for(self, key: int, r: Optional[int] = None) -> List[str]:
        """The first min(r, hosts) DISTINCT hosts clockwise from `key`'s
        ring point, in ring order — element 0 is the primary, the rest
        are replicas. Deterministic for a given membership; every
        consumer must treat the result as valid only under the current
        ownership epoch (membership changes invalidate it — the serving
        host's stale-epoch fence catches writers that don't recheck)."""
        r = self.replicas if r is None else r
        with self._mu:
            if not self._points:
                return []
            r = min(r, len(self._hosts))
            i = bisect.bisect_right(self._points, _point(f"k{key:x}"))
            owners: List[str] = []
            n = len(self._points)
            for step in range(n):
                h = self._owner_at[(i + step) % n]
                if h not in owners:
                    owners.append(h)
                    if len(owners) == r:
                        break
            return owners

    def owners_with_epoch(self, key: int,
                          r: Optional[int] = None) -> Tuple[int, List[str]]:
        """Atomic (epoch, owners) snapshot under ONE lock hold — the
        pair a fenced write needs: owners computed under a ring tagged
        with THAT ring's epoch. Reading `epoch` and `owners_for` as two
        separate calls lets a membership change slip between them,
        yielding new-ring owners tagged with the old epoch — every
        serving host then fences the write and a healthy publish
        reports unavailable."""
        with self._mu:
            return self.epoch, self.owners_for(key, r)

    def lookup(self, key: int) -> Optional[str]:
        """Primary owner only (epoch-fenced like owners_for: valid for
        the current membership epoch, rechecked by the serving host)."""
        owners = self.owners_for(key, r=1)
        return owners[0] if owners else None

    def snapshot(self) -> dict:
        with self._mu:
            return {"hosts": list(self._hosts), "epoch": self.epoch,
                    "vnodes": self.vnodes, "replicas": self.replicas}


class PoolMembership:
    """Watch-fed pool-host liveness view (ring membership + event feed).

    One object shared by: the cluster pool (placement + rebalance
    trigger), and the router (`KvRouter._split_pool_scores` — a pool
    prefix is only fetchable while SOME member can serve it, so an
    empty membership zeroes pool pricing at watch-event time).

    `on_instance(kind, worker_id, info)` is `Client.add_listener`
    callback-shaped: pool-host instance puts join the ring, deletes
    leave it (each bumping the ownership epoch); non-pool-host instance
    events are ignored, so the same listener can watch a mixed
    component. Callbacks registered via `on_change(cb)` run
    synchronously after each membership change — the cluster pool hangs
    its rebalance trigger there (kept cheap: the listener only ENQUEUES
    rebalance work; the copies run under `run_rebalance`'s bounded
    budget, the drain discipline)."""

    def __init__(self, ring: Optional[HashRing] = None):
        self.ring = ring if ring is not None else HashRing()
        self._change_cbs: List = []

    def on_change(self, cb) -> None:
        """cb(kind, host, epoch) after each membership change
        (kind 'join'/'leave'); runs synchronously — keep it cheap."""
        self._change_cbs.append(cb)

    def live_hosts(self) -> Tuple[str, ...]:
        return self.ring.hosts

    @property
    def epoch(self) -> int:
        return self.ring.epoch

    def join(self, host: str) -> bool:
        changed = self.ring.add(host)
        if changed:
            self._fire("join", host)
        return changed

    def leave(self, host: str) -> bool:
        changed = self.ring.remove(host)
        if changed:
            self._fire("leave", host)
        return changed

    def _fire(self, kind: str, host: str) -> None:
        for cb in list(self._change_cbs):
            cb(kind, host, self.ring.epoch)

    def on_instance(self, kind: str, worker_id: str, info) -> None:
        """Client.add_listener-compatible watch feed."""
        if not is_pool_host_instance(worker_id):
            return
        host = pool_host_of_instance(worker_id)
        if kind == "delete":
            self.leave(host)
        elif kind == "put":
            self.join(host)

    def owners_for(self, key: int, r: Optional[int] = None) -> List[str]:
        # placement answers are epoch-scoped: pair with `epoch` and let
        # the serving host's stale-epoch fence reject a racing change
        return self.ring.owners_for(key, r)

    def owners_with_epoch(self, key: int,
                          r: Optional[int] = None) -> Tuple[int, List[str]]:
        # the atomic pairing of the two reads above — what an
        # epoch-fenced write path must use (HashRing.owners_with_epoch)
        return self.ring.owners_with_epoch(key, r)
