"""Deterministic fault injection: a failpoint registry.

Copied whole from dynamo_tpu/runtime/faults.py (:1-370). Named failpoint
sites are armed by seeded schedules, so every failure mode is a replayable
artifact: the same seed fires the same faults in the same order.

The port's transports carry the control-plane and transport sites
(`transport.send`, `transport.recv`, `watch.stream`, `discovery.store`,
`discovery.heartbeat`, `lease.expiry`, `event.plane`: transports/base.py,
memory.py, tcp.py). The data-plane sites of the KV tiers, the transfer
plane and the shared pool (`offload.*`, `transfer.link`,
`remote_transfer.fetch_page`, `pool.*`, `queue.dequeue`) stay in the site
catalog, so a recorded JAX plan arms here unchanged. The KV tiers fire
theirs: `offload.write_tier` / `offload.read_tier` (engine/offload.py),
`pool.fetch` (engine/kv_pool.py), `pool.remote_fetch` and `pool.rebalance`
(engine/pool_service.py); the transfer plane's and the queue's wait for
ROADMAP A9. `corrupt_array` takes numpy arrays and CPU torch tensors (the
port's tier slabs) alike.

Fault kinds: `drop` (the op raises FaultInjected, a ConnectionError, so
the recovery layers treat it as any transport death), `delay` (seeded
jitter up to delay_s), `corrupt` (flip nbytes seeded byte positions),
`duplicate` (the site delivers twice), `fail_n` (fail the first n hits,
then pass) and `slow` (a persistent multiplicative degradation the site
applies to its own base duration).

Disarmed, a call site costs one attribute read (`if REGISTRY.enabled:`).
Each armed site owns one `random.Random(seed)`; every hit consumes a fixed
number of draws per spec whatever the outcome, so the decision sequence is
a pure function of (seed, specs, hit index).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence

SITES = (
    "transport.send",
    "transport.recv",
    "remote_transfer.fetch_page",
    "transfer.link",
    "offload.write_tier",
    "offload.read_tier",
    "pool.fetch",
    "pool.remote_fetch",
    "pool.rebalance",
    "queue.dequeue",
    "discovery.heartbeat",
    # control-plane sites (this PR's scale harness)
    "watch.stream",
    "discovery.store",
    "lease.expiry",
    "event.plane",
)

KINDS = ("drop", "delay", "corrupt", "duplicate", "fail_n", "slow")


class FaultInjected(ConnectionError):
    """Raised at a site for drop/fail_n outcomes. A ConnectionError
    subclass on purpose: every recovery layer (reliability migration,
    transfer reconnect, queue redelivery) already treats connection
    death as survivable — injected faults must ride the same paths."""

    def __init__(self, site: str):
        super().__init__(f"fault injected at {site}")
        self.site = site


@dataclasses.dataclass
class FaultSpec:
    """One rule inside a schedule. ``p`` is the per-hit probability
    (seeded); ``n`` bounds how many hits the rule may fire on in total
    (0 = unbounded) — `fail_n` uses it as the fail-then-ok budget, and
    a `corrupt` with n=1 models a transient single corruption that a
    bounded re-fetch must absorb. ``skip`` makes the rule dormant for
    the first `skip` hits, so a fault can be pinned to a deterministic
    hit index (a `fail_n` with skip=k, n=1 cuts exactly the k-th
    chunk/op — the transfer.link resume matrix rides this).
    ``delay_min_s`` floors the seeded delay draw (delay in
    [delay_min_s, delay_s]); delay_min_s == delay_s is a deterministic
    stall of exactly that length. ``factor`` is the `slow` kind's
    persistent multiplicative degradation (1.0 = healthy)."""

    kind: str
    p: float = 1.0
    n: int = 0
    delay_s: float = 0.0
    nbytes: int = 1
    skip: int = 0
    delay_min_s: float = 0.0
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")


@dataclasses.dataclass
class Outcome:
    """Merged per-hit decision a site acts on."""

    drop: bool = False
    delay_s: float = 0.0
    corrupt: bool = False
    duplicate: bool = False
    nbytes: int = 0
    slow_factor: float = 1.0

    @property
    def fired(self) -> bool:
        return self.drop or self.corrupt or self.duplicate \
            or self.delay_s > 0 or self.slow_factor != 1.0


class FaultSchedule:
    """Seeded decision stream for one site.

    Serializable (`to_dict`/`from_dict`) so a chaos run's exact fault
    plan is a recordable artifact. Decisions consume the rng in hit
    order; two schedules with equal (seed, specs) produce identical
    decision sequences — the replayability contract.
    """

    def __init__(self, seed: int, specs: Sequence[FaultSpec]):
        self.seed = int(seed)
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self._rng = random.Random(self.seed)
        self._fired: List[int] = [0] * len(self.specs)
        self.hits = 0

    def decide(self) -> Outcome:
        out = Outcome()
        self.hits += 1
        for i, spec in enumerate(self.specs):
            # one draw per spec per hit, unconditionally: outcomes never
            # shift the stream, so hit k's decision depends only on k
            roll = self._rng.random()
            if spec.n and self._fired[i] >= spec.n:
                continue
            if spec.skip and self.hits <= spec.skip:
                # dormant for the first `skip` hits: the roll above was
                # still consumed, so skipping never shifts the stream
                continue
            if spec.kind == "fail_n":
                # deterministic: fails exactly the first n (post-skip) hits
                self._fired[i] += 1
                out.drop = True
                continue
            if roll >= spec.p:
                continue
            self._fired[i] += 1
            if spec.kind == "drop":
                out.drop = True
            elif spec.kind == "delay":
                lo = min(spec.delay_min_s, spec.delay_s)
                out.delay_s = max(
                    out.delay_s,
                    lo + self._rng.random() * (spec.delay_s - lo))
            elif spec.kind == "corrupt":
                out.corrupt = True
                out.nbytes = max(out.nbytes, spec.nbytes)
            elif spec.kind == "duplicate":
                out.duplicate = True
            elif spec.kind == "slow":
                # persistent degradation: every firing hit reports the
                # same multiplicative factor — the call site applies it
                # to its own base duration, so a factor=10 worker is
                # 10x slow for as long as the rule stays armed
                out.slow_factor = max(out.slow_factor, spec.factor)
        return out

    def corrupt_positions(self, length: int, nbytes: int) -> List[int]:
        """Seeded byte offsets to flip for a corrupt outcome."""
        if length <= 0:
            return []
        return [self._rng.randrange(length)
                for _ in range(max(1, nbytes))]

    def reset(self) -> None:
        """Rewind to hit 0 (same seed -> same decisions again)."""
        self._rng = random.Random(self.seed)
        self._fired = [0] * len(self.specs)
        self.hits = 0

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSchedule":
        return cls(d["seed"], [FaultSpec(**s) for s in d.get("specs", [])])


class FaultRegistry:
    """Site -> armed schedule, plus the counters /metrics surfaces.

    The module-level ``REGISTRY`` is the process-wide instance every
    instrumented call site consults; tests arm/disarm it around each
    scenario (see tests/test_faults.py's autouse fixture)."""

    def __init__(self):
        self._schedules: Dict[str, FaultSchedule] = {}
        self.enabled = False
        # observability: per-site hit and injected-fault counts
        # (frontend/service.py folds these into /metrics gauges)
        self.site_hits: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    # -- arming ---------------------------------------------------------------

    def arm(self, site: str, schedule: FaultSchedule) -> None:
        if site not in SITES:
            raise ValueError(f"unknown failpoint site {site!r} "
                             f"(expected one of {SITES})")
        self._schedules[site] = schedule
        self.enabled = True

    def arm_from_dict(self, plan: Dict[str, dict]) -> None:
        """Arm many sites from a recorded {site: schedule_dict} plan."""
        for site, sched in plan.items():
            self.arm(site, FaultSchedule.from_dict(sched))

    def to_dict(self) -> Dict[str, dict]:
        return {site: s.to_dict() for site, s in self._schedules.items()}

    def disarm(self, site: Optional[str] = None) -> None:
        if site is None:
            self._schedules.clear()
        else:
            self._schedules.pop(site, None)
        self.enabled = bool(self._schedules)

    def reset_counters(self) -> None:
        self.site_hits.clear()
        self.injected.clear()

    def armed(self, site: str) -> bool:
        return site in self._schedules

    # -- decision plumbing ----------------------------------------------------

    def _decide(self, site: str) -> Optional[Outcome]:
        sched = self._schedules.get(site)
        if sched is None:
            return None
        self.site_hits[site] = self.site_hits.get(site, 0) + 1
        out = sched.decide()
        if out.fired:
            self.injected[site] = self.injected.get(site, 0) + 1
        return out

    # -- site hooks -----------------------------------------------------------

    def decide(self, site: str) -> Optional[Outcome]:
        """Call-site-managed outcome: no sleep, no raise — the site
        applies drop/delay/duplicate itself (the event-plane delivery
        path uses this to schedule DELAYED puts instead of blocking the
        publisher, which is what makes injected lag also reorder)."""
        return self._decide(site)

    def slow_factor(self, site: str) -> float:
        """Persistent-degradation multiplier for sites that scale their
        own base duration by the `slow` kind (1.0 when disarmed). Counts
        as a hit: the decision stream stays a pure function of hit
        index, same as every other site hook."""
        out = self._decide(site)
        return 1.0 if out is None else out.slow_factor

    async def fire(self, site: str) -> Outcome:
        """Async sites: apply delay, raise on drop, return the outcome
        (sites that can duplicate inspect ``outcome.duplicate``)."""
        out = self._decide(site)
        if out is None:
            return Outcome()
        if out.delay_s > 0:
            import asyncio
            await asyncio.sleep(out.delay_s)
        if out.drop:
            raise FaultInjected(site)
        return out

    def fire_sync(self, site: str) -> Outcome:
        """Sync sites (engine/offload threads, lease bookkeeping):
        delay blocks the calling thread, drop raises."""
        out = self._decide(site)
        if out is None:
            return Outcome()
        if out.delay_s > 0:
            time.sleep(out.delay_s)
        if out.drop:
            raise FaultInjected(site)
        return out

    def corrupt_bytes(self, site: str, payload: bytes) -> bytes:
        """Byte-payload sites: seeded byte flips when the schedule says
        corrupt; drop raises; delay is ignored (wire sites pair this
        with an async fire on the framing path when delay matters)."""
        out = self._decide(site)
        if out is None or not out.corrupt:
            if out is not None and out.drop:
                raise FaultInjected(site)
            return payload
        sched = self._schedules[site]
        buf = bytearray(payload)
        for pos in sched.corrupt_positions(len(buf), out.nbytes):
            buf[pos] ^= 0xFF
        return bytes(buf)

    def corrupt_array(self, site: str, arr) -> bool:
        """ndarray sites (tier slabs): flip seeded bytes in place.
        Returns True when a corruption was injected."""
        out = self._decide(site)
        if out is None or not out.corrupt:
            return False
        if hasattr(arr, "untyped_storage"):      # a CPU torch tensor
            import torch
            flat = arr.reshape(-1).view(torch.uint8)
        else:
            import numpy as np
            flat = arr.reshape(-1).view(np.uint8)
        sched = self._schedules[site]
        for pos in sched.corrupt_positions(flat.shape[0], out.nbytes):
            flat[pos] ^= 0xFF
        return True

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {"hits": dict(self.site_hits),
                "injected": dict(self.injected)}


# the process-wide registry every instrumented site consults
REGISTRY = FaultRegistry()
