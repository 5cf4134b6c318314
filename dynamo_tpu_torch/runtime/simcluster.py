"""Simulated O(1000)-worker cluster on the in-process control plane.

Copied from dynamo_tpu/runtime/simcluster.py (all of it). A fleet of MOCK
workers (no model, no data plane: each is an instance key under its own
lease, a live $STATS responder and a synthetic KV-event stream) plus one
real `KvRouter` + `Client` of the port on the other side, driven through
seeded storms on the control-plane failpoint sites (runtime/faults.py:
watch.stream, discovery.store, lease.expiry, event.plane) and through
direct fleet churn (rolling restarts, lease-expiry bursts, kill / revive),
while a schedule-load generator measures latency and enforces the routing
contracts:

- **zero scheduling errors**: `KvRouter.schedule` never raises while
  capacity exists;
- **no corpse routing**: once a worker's delete/draining watch event has
  been APPLIED (the client listener fired), schedule() never returns it;
- **degraded-mode round trip**: an event-plane lag storm drives the router
  into, and back out of, the stale-snapshot degraded mode with no errors.

`routing_ab` (transfer-aware vs prefix-only scoring on simulated TTFT),
`fail_slow_ab` (fail-slow detection off vs on), `re_role_worker` (the
re-role fence through the real control plane) and `autoscale_storm` (the
closed-loop autoscaler over a virtual clock, `TrafficShape` arrivals) are
the A/B and controller runs. Everything is seeded: storm targets are a
pure function of the seed (`pick_storm_targets`), failpoint schedules are
`FaultSchedule`s, and re-registration jitter draws from per-worker seeded
rngs. The synthetic events carry the port's page hashes (BLAKE2b, where
JAX takes xxh3): the router's overlap scores differ from JAX's in value,
never the autoscale storm, whose traffic model hashes nothing. Each
schedule decision records a `router.schedule` span under the tracer's
`scope:router` (JAX :411).
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import random
import time
from typing import Dict, List, Optional

from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheEvent, KvCacheStoreData, KvCacheStoredBlockData, RouterEvent,
    compute_page_hashes,
)
from dynamo_tpu_torch.kv_router.publisher import KV_EVENTS_SUBJECT
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.backoff import Backoff
from dynamo_tpu_torch.runtime.component import STATUS_DRAINING
from dynamo_tpu_torch.runtime.cpstats import CP_STATS
from dynamo_tpu_torch.runtime.transports.codec import packb
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from dynamo_tpu_torch.runtime.tracing import TRACER

log = logging.getLogger("dynamo_tpu_torch.simcluster")


@dataclasses.dataclass
class SimConfig:
    workers: int = 64
    streams: int = 1024          # logical streams cycling through the load gen
    prefix_families: int = 32    # distinct shared-prefix families (system prompts)
    family_pages: int = 8        # full KV pages per family prefix
    stores_per_worker: int = 4   # families each worker claims pages for
    block_size: int = 16
    lease_ttl_s: float = 3.0
    scrape_interval_s: float = 0.5
    degraded_lag_s: float = 0.75
    seed: int = 0
    namespace: str = "sim"
    component: str = "worker"
    endpoint: str = "generate"


def pick_storm_targets(seed: int, worker_ids: List[str],
                       fraction: float) -> List[str]:
    """Deterministic storm membership + order: a pure function of
    (seed, fleet, fraction) so a storm is replayable from its seed."""
    rng = random.Random(seed)
    ids = sorted(worker_ids)
    rng.shuffle(ids)
    count = max(1, int(len(ids) * fraction))
    return ids[:count]


def family_tokens(family: int, block_size: int, pages: int) -> List[int]:
    """Deterministic token prefix for one shared-prefix family."""
    return [(family * 977 + 31 * i) % 50000 for i in range(block_size * pages)]


def percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, int(p * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[k]


class SimWorker:
    """One mock worker: lease + instance key + $STATS responder +
    synthetic KV events. Deliberately NOT a DistributedRuntime — a
    thousand of those would each spawn lease-watch machinery the sim
    drives centrally instead."""

    def __init__(self, plane: MemoryPlane, cfg: SimConfig, worker_id: str,
                 rng: random.Random):
        self.plane = plane
        self.cfg = cfg
        self.worker_id = worker_id
        self.rng = rng
        self.lease = None
        self._unserve_stats = None
        self.alive = False          # the heartbeat loop skips dead workers
        self.generation = 0
        self.backoff = Backoff(base_s=0.02, max_s=1.0, jitter=1.0,
                               stable_reset_s=5.0,
                               rng=random.Random(rng.randrange(1 << 30)))
        self._event_id = 0
        # serving role carried in the instance key ("prefill"/"decode";
        # None = aggregated wildcard) — what the autoscaler re-roles
        self.role: Optional[str] = None
        self.re_roles = 0

    # -- discovery ------------------------------------------------------------

    @property
    def key(self) -> str:
        c = self.cfg
        return (f"{c.namespace}/components/{c.component}/"
                f"{c.endpoint}:{self.worker_id}")

    @property
    def _subject(self) -> str:
        c = self.cfg
        return f"{c.namespace}|{c.component}.{c.endpoint}-{self.worker_id}"

    def _info(self, status: Optional[str] = None) -> bytes:
        c = self.cfg
        info = {"namespace": c.namespace, "component": c.component,
                "endpoint": c.endpoint, "worker_id": self.worker_id,
                "subject": self._subject}
        if self.role is not None:
            info["role"] = self.role
        if status:
            info["status"] = status
        return json.dumps(info).encode()

    async def _kv_retry(self, op, attempts: int = 8):
        """Discovery ops ride out store-unavailable windows (the
        discovery.store failpoint) with the worker's jittered backoff —
        what a real worker's registration loop does."""
        for i in range(attempts):
            try:
                return await op()
            except ConnectionError:
                if i == attempts - 1:
                    raise
                await self.backoff.sleep()

    async def register(self) -> None:
        self.lease = await self._kv_retry(
            lambda: self.plane.kv.grant_lease(self.cfg.lease_ttl_s))
        await self._kv_retry(
            lambda: self.plane.kv.put(self.key, self._info(),
                                      self.lease.id))

        async def stats(_payload: bytes) -> bytes:
            return packb(self._stats())

        self._unserve_stats = await self.plane.messaging.serve(
            f"$STATS.{self._subject}", stats)
        self.alive = True
        self.generation += 1

    def _stats(self) -> dict:
        pages = self.cfg.family_pages * self.cfg.stores_per_worker
        return {
            "request_active_slots": self.rng.randrange(0, 8),
            "request_total_slots": 8,
            "kv_active_blocks": self.rng.randrange(0, pages + 1),
            "kv_total_blocks": max(pages, 1) * 4,
            "num_requests_waiting": 0,
            "gpu_cache_usage_perc": self.rng.random() * 0.5,
            "gpu_prefix_cache_hit_rate": self.rng.random(),
            # synthetic ledger figures (observability/ledger.py fields a
            # real engine publishes): the fleet rollup scrapes these
            # through the same WorkerMetrics plumbing a live fleet feeds
            "engine_steps": self._event_id * 7,
            "engine_tok_s": round(800.0 + self.rng.random() * 400.0, 1),
            "engine_pad_frac": round(self.rng.random() * 0.3, 3),
        }

    async def mark_draining(self) -> None:
        await self._kv_retry(
            lambda: self.plane.kv.put(self.key, self._info(STATUS_DRAINING),
                                      self.lease.id if self.lease else 0))

    async def assign_role(self, role: Optional[str]) -> None:
        """Declare/replace this worker's serving role in place (initial
        fleet split; NOT the re-role path — no drain fence)."""
        self.role = role
        if self.alive:
            await self._kv_retry(
                lambda: self.plane.kv.put(self.key, self._info(),
                                          self.lease.id if self.lease
                                          else 0))

    async def set_role(self, role: str) -> None:
        """Graceful re-role: the autoscaler's "this decode worker
        becomes a prefill worker" actuation, sim leg (the real-worker
        twin is `ServedEndpoint.re_role`). Fence ordering: DRAINING
        re-put under the OLD role first (watching routers drop it from
        `ids_for_role(old)` at event-apply time), then deregister +
        re-register under the new role — there is no window where the
        worker is schedulable for its old role."""
        if role == self.role:
            return
        await self.mark_draining()
        await asyncio.sleep(0)       # let the draining watch tick land
        await self.deregister()
        self.role = role
        await self.register()
        self.re_roles += 1

    async def deregister(self) -> None:
        self.alive = False
        await self._kv_retry(lambda: self.plane.kv.delete(self.key))
        if self.lease is not None:
            try:
                await self.lease.revoke()
            except ConnectionError:
                pass   # store window: lease expiry covers the revoke
            self.lease = None
        if self._unserve_stats is not None:
            await self._unserve_stats()
            self._unserve_stats = None

    def kill(self) -> None:
        """Process death: heartbeats stop, the lease expires on its own
        and the instance key vanishes through the lease-expiry path."""
        self.alive = False

    async def restart_with_jitter(self) -> float:
        """Re-registration with seeded jitter + flap hysteresis: the
        whole point is that a storm of restarts does NOT stampede
        discovery in one synchronized wave."""
        delay = self.backoff.next_delay()
        await asyncio.sleep(delay)
        await self.register()
        return delay

    # -- synthetic KV-event stream -------------------------------------------

    async def publish_family_pages(self, families: List[int],
                                   pages: Optional[int] = None) -> int:
        """Publish Stored chains claiming the first `pages` pages of each
        family prefix — the shape a real allocator emits after a prefill
        of a shared system prompt."""
        c = self.cfg
        n_events = 0
        for fam in families:
            toks = family_tokens(fam, c.block_size, c.family_pages)
            th = compute_page_hashes(toks, c.block_size)
            depth = pages if pages is not None else c.family_pages
            parent = None
            blocks = []
            for i in range(min(depth, len(th))):
                # block hashes are worker-unique chained ids; generation
                # salt keeps a restarted worker's chains distinct
                bh = hash((self.worker_id, self.generation, fam, i)) \
                    & 0x7FFFFFFFFFFFFFFF
                blocks.append(KvCacheStoredBlockData(bh, th[i]))
            ev = RouterEvent(
                self.worker_id,
                KvCacheEvent(self._event_id,
                             KvCacheStoreData(parent_hash=parent,
                                              blocks=blocks)),
                ts=time.time())
            self._event_id += 1
            await self.plane.messaging.publish(
                f"{c.namespace}.{c.component}.{KV_EVENTS_SUBJECT}",
                packb(ev.pack()))
            n_events += 1
        return n_events


class SimCluster:
    """The harness: fleet + router + load generator + storms."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.plane = MemoryPlane()
        self.workers: Dict[str, SimWorker] = {}
        self.rt = None
        self.client = None
        self.router: Optional[KvRouter] = None
        self._hb_task: Optional[asyncio.Task] = None
        # contract accounting
        self.schedule_errors = 0
        self.dead_picks = 0           # schedule returned a fenced worker
        self.schedule_calls = 0
        self.latencies_us: List[float] = []
        self._fenced: set = set()     # applied delete/draining fence
        # logical streams: (family, distinct suffix salt)
        self._streams = [(i % cfg.prefix_families, i)
                         for i in range(cfg.streams)]

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> "SimCluster":
        cfg = self.cfg
        self.rt = await DistributedRuntime.create_local(self.plane,
                                                        "sim-router")
        comp = self.rt.namespace(cfg.namespace).component(cfg.component)
        self.client = comp.endpoint(cfg.endpoint).client()
        await self.client.start()

        def on_instance(kind, worker_id, info):
            # the dead/draining fence the routing contract is checked
            # against: "after its watch event is applied" == after this
            # listener ran
            if kind == "delete":
                self._fenced.add(worker_id)
            elif info is not None and info.get("status") == STATUS_DRAINING:
                self._fenced.add(worker_id)
            else:
                self._fenced.discard(worker_id)

        self.client.add_listener(on_instance)
        self.router = KvRouter(comp, self.client, cfg.block_size,
                               scrape_interval_s=cfg.scrape_interval_s)
        # the router's lag threshold is a class constant (JAX: a
        # constructor argument); the sim sets it on its instance
        self.router.DEGRADED_LAG_S = cfg.degraded_lag_s
        await self.router.start()

        t0 = time.perf_counter()
        ids = [f"w{i:04d}" for i in range(cfg.workers)]
        for i in range(0, len(ids), 64):      # registration waves
            wave = []
            for wid in ids[i:i + 64]:
                w = SimWorker(self.plane, cfg, wid,
                              random.Random(self.rng.randrange(1 << 30)))
                self.workers[wid] = w
                wave.append(w.register())
            await asyncio.gather(*wave)
        self.register_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for i in range(0, len(ids), 64):
            await asyncio.gather(*(
                self._seed_events(self.workers[wid]) for wid in ids[i:i + 64]))
        self.seed_events_s = time.perf_counter() - t0

        self._hb_task = asyncio.create_task(self._heartbeat_loop())
        await self.router.aggregator.scrape_once()
        await self._drain_event_queue()
        return self

    async def _seed_events(self, w: SimWorker) -> None:
        fams = [w.rng.randrange(self.cfg.prefix_families)
                for _ in range(self.cfg.stores_per_worker)]
        await w.publish_family_pages(fams)

    async def _heartbeat_loop(self) -> None:
        """One task heartbeats the whole fleet (a real fleet has one loop
        per process; the sim centralizes them to stay at one task)."""
        interval = self.cfg.lease_ttl_s / 3
        while True:  # dynalint: backoff-ok=fixed-cadence heartbeat loop, paced by lease TTL
            await asyncio.sleep(interval)
            for w in list(self.workers.values()):
                if w.alive and w.lease is not None:
                    keep = getattr(w.lease, "keep_alive", None)
                    if keep is not None:
                        try:
                            keep()
                        except faults.FaultInjected:
                            pass   # lost heartbeat: deadline not refreshed

    async def _drain_event_queue(self, timeout_s: float = 5.0) -> None:
        """Wait until the router has caught up with published events."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if CP_STATS.event_backlog == 0 and not self.router.degraded:
                return
            await asyncio.sleep(0.02)

    async def stop(self) -> None:
        if self._hb_task:
            self._hb_task.cancel()
        if self.router is not None:
            await self.router.stop()
        if self.client is not None:
            await self.client.stop()
        if self.rt is not None:
            await self.rt.shutdown()

    # -- load generation ------------------------------------------------------

    def _stream_tokens(self, stream_idx: int) -> List[int]:
        fam, salt = self._streams[stream_idx % len(self._streams)]
        cfg = self.cfg
        toks = family_tokens(fam, cfg.block_size, cfg.family_pages)
        # per-stream divergent suffix (under one page: doesn't index)
        return toks + [salt % 50000, (salt * 7) % 50000]

    async def schedule_once(self, stream_idx: int) -> Optional[str]:
        toks = self._stream_tokens(stream_idx)
        t0 = time.perf_counter()
        # one span a decision under the "router" scope (a no-op while
        # tracing is off, so the capacity numbers are unaffected)
        with TRACER.scope_span("router.schedule", "router",
                               stream=stream_idx) as sp:
            try:
                pick = await self.router.schedule(toks)
            except Exception:
                self.schedule_errors += 1
                log.exception("schedule failed for stream %d", stream_idx)
                sp.set(error_pick=True)
                return None
            finally:
                self.schedule_calls += 1
            sp.set(instance=pick)
        self.latencies_us.append((time.perf_counter() - t0) * 1e6)
        # contract: the fence reflects APPLIED watch events; a pick
        # inside it means the router routed onto a known corpse
        if pick in self._fenced:
            self.dead_picks += 1
            log.error("dead/draining worker %s picked post-fence", pick)
        return pick

    async def run_load(self, calls: int, concurrency: int = 32) -> dict:
        """Run `calls` schedule decisions at bounded concurrency; the
        per-call latency lands in self.latencies_us."""
        rng = random.Random(self.rng.randrange(1 << 30))
        sem = asyncio.Semaphore(concurrency)
        before = len(self.latencies_us)

        async def one(i: int):
            async with sem:
                await self.schedule_once(rng.randrange(len(self._streams)))

        t0 = time.perf_counter()
        await asyncio.gather(*(one(i) for i in range(calls)))
        wall = time.perf_counter() - t0
        lat = sorted(self.latencies_us[before:])
        return {"calls": calls, "wall_s": round(wall, 3),
                "calls_per_s": round(calls / wall, 1) if wall else 0.0,
                "p50_us": round(percentile(lat, 0.50), 1),
                "p99_us": round(percentile(lat, 0.99), 1)}

    # -- storms ---------------------------------------------------------------

    async def storm_rolling_restart(self, fraction: float = 0.3,
                                    batch: int = 8,
                                    load_calls: int = 0) -> dict:
        """Drain + deregister + jittered re-register a seeded fraction of
        the fleet, `batch` workers at a time, optionally under schedule
        load. Replacement workers re-register under the same id (a k8s
        rolling update), exercising fence-then-revive end to end."""
        targets = pick_storm_targets(self.rng.randrange(1 << 30),
                                     list(self.workers), fraction)
        load_task = (asyncio.create_task(self.run_load(load_calls))
                     if load_calls else None)
        t0 = time.perf_counter()
        jitters: List[float] = []
        for i in range(0, len(targets), batch):
            group = [self.workers[w] for w in targets[i:i + batch]]
            await asyncio.gather(*(w.mark_draining() for w in group))
            await asyncio.sleep(0)           # let the watch tick land
            await asyncio.gather(*(w.deregister() for w in group))

            async def revive(w: SimWorker):
                jitters.append(await w.restart_with_jitter())
                await self._seed_events(w)

            await asyncio.gather(*(revive(w) for w in group))
        storm_s = time.perf_counter() - t0
        if load_task is not None:
            load = await load_task
        else:
            load = None
        await self._drain_event_queue()
        return {"targets": len(targets), "storm_s": round(storm_s, 3),
                "mean_jitter_s": round(sum(jitters) / len(jitters), 4)
                if jitters else 0.0,
                "load": load,
                "errors": self.schedule_errors,
                "dead_picks": self.dead_picks}

    async def storm_lease_expiry(self, fraction: float = 0.2,
                                 load_calls: int = 0) -> dict:
        """Kill heartbeats for a seeded fraction; their leases expire in
        one burst (a mass watch-delete flood), then everyone restarts
        with jittered, hysteresis-grown delays."""
        targets = pick_storm_targets(self.rng.randrange(1 << 30),
                                     list(self.workers), fraction)
        load_task = (asyncio.create_task(self.run_load(load_calls))
                     if load_calls else None)
        for wid in targets:
            self.workers[wid].kill()
        # wait for the burst: every killed worker's key must vanish
        deadline = time.monotonic() + self.cfg.lease_ttl_s * 4
        while time.monotonic() < deadline:
            if all(w not in self.client.instances for w in targets):
                break
            await asyncio.sleep(0.05)
        expired = [w for w in targets if w not in self.client.instances]
        await asyncio.gather(*(self.workers[w].restart_with_jitter()
                               for w in targets))
        for wid in targets:
            await self._seed_events(self.workers[wid])
        if load_task is not None:
            await load_task
        await self._drain_event_queue()
        return {"targets": len(targets), "expired": len(expired),
                "errors": self.schedule_errors,
                "dead_picks": self.dead_picks}

    async def kill_fraction(self, fraction: float = 0.3,
                            wait_expiry: bool = True) -> List[str]:
        """Kill a seeded fraction of the fleet (heartbeats stop; leases
        expire) WITHOUT restarting — the two-phase primitive the fleet
        SLO storm scrapes through: kill, watch
        the availability series burn, then `revive()` and watch the
        alert clear."""
        targets = pick_storm_targets(self.rng.randrange(1 << 30),
                                     list(self.workers), fraction)
        for wid in targets:
            self.workers[wid].kill()
        if wait_expiry:
            deadline = time.monotonic() + self.cfg.lease_ttl_s * 4
            while time.monotonic() < deadline:
                if all(w not in self.client.instances for w in targets):
                    break
                await asyncio.sleep(0.05)
        return targets

    async def revive(self, targets: List[str]) -> None:
        """Restart previously-killed workers (jittered) and re-seed
        their KV events — the recovery leg of the SLO storm."""
        await asyncio.gather(*(self.workers[w].restart_with_jitter()
                               for w in targets))
        for wid in targets:
            await self._seed_events(self.workers[wid])
        await self._drain_event_queue()

    async def storm_watch_disconnect(self, kills: int = 3,
                                     load_calls: int = 0) -> dict:
        """Arm the watch.stream failpoint to kill the next `kills` watch
        deliveries; every watcher must resume with backoff + resync. The
        convergence check registers fresh workers DURING the storm and
        asserts the client sees the exact live fleet afterwards."""
        resyncs_before = CP_STATS.watch_resyncs
        faults.REGISTRY.arm("watch.stream", faults.FaultSchedule(
            self.rng.randrange(1 << 30),
            [faults.FaultSpec("fail_n", n=kills)]))
        extra = []
        for i in range(2):
            wid = f"storm-extra-{len(self.workers) + i}"
            w = SimWorker(self.plane, self.cfg, wid,
                          random.Random(self.rng.randrange(1 << 30)))
            self.workers[wid] = w
            extra.append(w)
        await asyncio.gather(*(w.register() for w in extra))
        if load_calls:
            await self.run_load(load_calls)
        # convergence: the resumed watcher's resync must surface the
        # extras even though their put events died with the stream
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if all(w.worker_id in self.client.instances for w in extra):
                break
            await asyncio.sleep(0.05)
        faults.REGISTRY.disarm("watch.stream")
        converged = all(w.worker_id in self.client.instances for w in extra)
        return {"kills": kills,
                "resyncs": CP_STATS.watch_resyncs - resyncs_before,
                "converged": converged,
                "errors": self.schedule_errors,
                "dead_picks": self.dead_picks}

    async def storm_event_lag(self, delay_s: float = 1.5,
                              bursts: int = 4,
                              load_calls: int = 0) -> dict:
        """Arm event.plane delay so KV events arrive late (and out of
        order); the router must enter the stale-snapshot degraded mode,
        keep scheduling without errors, and exit once caught up."""
        entries_before = self.router.degraded_entries
        faults.REGISTRY.arm("event.plane", faults.FaultSchedule(
            self.rng.randrange(1 << 30),
            [faults.FaultSpec("delay", p=1.0, delay_s=delay_s)]))
        ids = list(self.workers)
        for _ in range(bursts):
            wids = [ids[self.rng.randrange(len(ids))] for _ in range(8)]
            await asyncio.gather(*(self._seed_events(self.workers[w])
                                   for w in wids))
            await asyncio.sleep(delay_s / bursts)
        if load_calls:
            await self.run_load(load_calls)
        # wait for the delayed deliveries to land and the lag to surface
        deadline = time.monotonic() + delay_s * 4 + 5.0
        entered = False
        while time.monotonic() < deadline:
            if self.router.degraded:
                entered = True
                break
            await asyncio.sleep(0.02)
        faults.REGISTRY.disarm("event.plane")
        # fresh (undelayed) events + idle ticks pull the lag back down
        await self._seed_events(self.workers[ids[0]])
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if not self.router.degraded:
                break
            await asyncio.sleep(0.05)
        return {"delay_s": delay_s,
                "entered": entered,
                "exited": not self.router.degraded,
                "degraded_entries":
                    self.router.degraded_entries - entries_before,
                "errors": self.schedule_errors,
                "dead_picks": self.dead_picks}

    # -- profiling ------------------------------------------------------------

    async def measure_scrape(self) -> float:
        t0 = time.perf_counter()
        await self.router.aggregator.scrape_once()
        return time.perf_counter() - t0

    async def event_rate_probe(self, events: int,
                               publishers: int = 32) -> dict:
        """Publish `events` Stored events as fast as the loop allows and
        measure how far the router's application lags behind arrival."""
        ids = list(self.workers)[:publishers]
        applied_before = self.router.events_applied
        t0 = time.perf_counter()
        per_pub = max(1, events // max(1, len(ids)))
        for start in range(0, per_pub):
            await asyncio.gather(*(
                self.workers[w].publish_family_pages(
                    [self.workers[w].rng.randrange(
                        self.cfg.prefix_families)], pages=1)
                for w in ids))
        publish_s = time.perf_counter() - t0
        peak_backlog = CP_STATS.event_backlog
        await self._drain_event_queue(timeout_s=30.0)
        total_s = time.perf_counter() - t0
        applied = self.router.events_applied - applied_before
        return {"published": per_pub * len(ids),
                "publish_s": round(publish_s, 3),
                "applied": applied,
                "applied_per_s": round(applied / total_s, 1)
                if total_s else 0.0,
                "peak_backlog": peak_backlog,
                "peak_lag_s": round(self.router.event_lag_s, 4),
                "drain_s": round(total_s - publish_s, 3)}

    # -- transfer-aware routing A/B -------------------------------------------

    async def routing_ab(self, requests: int = 2000,
                         block_bytes: int = 256 * 1024,
                         prefill_s: float = 0.04,
                         arrival_spacing_s: Optional[float] = None,
                         flaky_p: float = 0.25,
                         flaky_delay_s: float = 0.35,
                         cold_fraction: float = 0.15,
                         warm_samples: int = 3) -> dict:
        """Prefix-overlap-only vs transfer-aware scheduling over a fleet
        with HETEROGENEOUS link speeds, measured on simulated TTFT.

        Every per-link property is a pure function of the cluster seed:
        wire bandwidth draws from a two-decade tier ladder, and each
        link owns a seeded `transfer.link`-style delay FaultSchedule
        (the same FaultSpec machinery the chaos harness arms globally —
        here instantiated per link so flaky links stall deterministic
        transfers). A request's simulated TTFT = queue wait at its
        chosen worker + prefill + bytes_to_move/bandwidth + the seeded
        stall; bytes_to_move follows the radix index's REAL overlap for
        the chosen worker, so warm prefixes genuinely ship less. Both
        modes run the identical seeded request stream against
        identically seeded load snapshots; the transfer-aware mode's
        cost model learns only from the transfers the simulation
        completes (delivered goodput incl. stalls — lossy-link reality),
        with a seeded fraction of links left COLD to exercise the
        fleet-median fallback in anger.

        Returns a seeded-replayable report: per-mode TTFT percentiles
        and the p99/p50 improvement of transfer-aware over prefix-only."""
        import heapq
        import zlib

        from dynamo_tpu_torch.kv_router.scheduler import (
            DefaultWorkerSelector, TransferAwareSelector,
        )
        from dynamo_tpu_torch.kv_router.scoring import (
            ProcessedEndpoints, WorkerMetrics,
        )
        from dynamo_tpu_torch.observability.fleet import TransferCostModel

        seed = self.cfg.seed
        ids = sorted(self.workers)
        if arrival_spacing_s is None:
            # constant per-worker offered load regardless of fleet size
            # (~5 arrivals/s/worker): queueing pressure — the thing
            # transfer-aware backlog scoring manages — survives scaling
            # the A/B from the tier-1 smoke to the 1000-worker artifact
            arrival_spacing_s = 0.192 / max(1, len(ids))

        def link_seed(wid: str, salt: int) -> int:
            return (seed * 1000003 + salt) ^ zlib.crc32(wid.encode())

        # two-decade bandwidth ladder, seeded per link: most links are
        # datacenter-fast, a tail is congested/oversubscribed — the
        # heterogeneity transfer-aware routing exists to see
        tiers = (2e9, 8e8, 2e8, 1e7)
        weights = (0.4, 0.3, 0.2, 0.1)
        bw: Dict[str, float] = {}
        flaky: Dict[str, faults.FaultSchedule] = {}
        cold: set = set()
        for wid in ids:
            r = random.Random(link_seed(wid, 1))
            bw[wid] = r.choices(tiers, weights)[0]
            # per-link seeded delay faults (the transfer.link site's
            # delay kind, one schedule per link): slow links are also
            # likelier to stall
            p = flaky_p if bw[wid] <= 2e8 else flaky_p / 5
            flaky[wid] = faults.FaultSchedule(
                link_seed(wid, 2),
                [faults.FaultSpec("delay", p=p, delay_s=flaky_delay_s,
                                  delay_min_s=flaky_delay_s / 2)])
            if r.random() < cold_fraction:
                cold.add(wid)

        def seeded_endpoints() -> ProcessedEndpoints:
            # identical load snapshot for both modes (fresh objects:
            # optimistic bumps mutate them during a mode)
            pages = self.cfg.family_pages * self.cfg.stores_per_worker
            eps = ProcessedEndpoints()
            for wid in ids:
                r = random.Random(link_seed(wid, 3))
                eps.workers[wid] = WorkerMetrics(
                    request_active_slots=r.randrange(0, 8),
                    request_total_slots=8,
                    kv_active_blocks=r.randrange(0, pages + 1),
                    kv_total_blocks=max(pages, 1) * 4)
            return eps

        block_size = self.cfg.block_size

        def run_mode(selector, model) -> dict:
            self.router.scheduler.selector = selector
            self.router.scheduler.update_endpoints(seeded_endpoints())
            for sched in flaky.values():
                sched.reset()    # same seeded stall stream per mode
            if model is not None:
                # warm the measured-bandwidth table the way a live
                # fleet would (a few completed sends per link), minus
                # the seeded cold set — those exercise the fleet-median
                # fallback during the measured run
                for wid in ids:
                    if wid in cold:
                        continue
                    for k in range(warm_samples):
                        nb = block_bytes * (4 + k)
                        model.observe(wid, nb, nb / bw[wid])
            rng = random.Random(seed + 17)
            busy_until: Dict[str, float] = {}
            inflight: list = []    # (finish_t, wid, nbytes) heap
            ttfts: List[float] = []
            slow_picks = 0
            for i in range(requests):
                now = i * arrival_spacing_s
                while inflight and inflight[0][0] <= now:
                    _, fwid, fbytes = heapq.heappop(inflight)
                    if model is not None:
                        model.note_done(fwid, fbytes)
                toks = self._stream_tokens(
                    rng.randrange(len(self._streams)))
                overlap = self.router.find_matches_for_tokens(toks)
                pick = self.router.scheduler.schedule(
                    len(toks), overlap).worker_id
                required = -(-len(toks) // block_size)
                matched = overlap.scores.get(pick, 0)
                nbytes = max(0, required - matched) * block_bytes
                stall = flaky[pick].decide().delay_s
                xfer_s = nbytes / bw[pick] + stall
                start = max(now, busy_until.get(pick, 0.0))
                finish = start + prefill_s + xfer_s
                busy_until[pick] = finish
                ttfts.append(finish - now)
                if bw[pick] <= 2e8:
                    slow_picks += 1
                if model is not None and nbytes > 0:
                    # the model learns delivered goodput incl. the
                    # seeded stall — lossy links estimate slower than
                    # their wire speed
                    model.observe(pick, nbytes, max(xfer_s, 1e-6))
                    model.note_inflight(pick, nbytes)
                    heapq.heappush(inflight, (finish, pick, nbytes))
            lat = sorted(ttfts)
            return {
                "requests": requests,
                "ttft_p50_ms": round(percentile(lat, 0.50) * 1e3, 2),
                "ttft_p95_ms": round(percentile(lat, 0.95) * 1e3, 2),
                "ttft_p99_ms": round(percentile(lat, 0.99) * 1e3, 2),
                "ttft_mean_ms": round(sum(lat) / len(lat) * 1e3, 2),
                "slow_link_picks": slow_picks,
            }

        saved = self.router.scheduler.selector
        try:
            prefix_only = run_mode(
                DefaultWorkerSelector(rng=random.Random(seed + 5)), None)
            model = TransferCostModel()
            aware_sel = TransferAwareSelector(
                cost_model=model, rng=random.Random(seed + 5))
            aware_sel.DEFAULT_BLOCK_BYTES = block_bytes
            aware = run_mode(aware_sel, model)
        finally:
            self.router.scheduler.selector = saved
        return {
            "seed": seed,
            "workers": len(ids),
            "block_bytes": block_bytes,
            "bandwidth_tiers": list(tiers),
            "cold_links": len(cold),
            "flaky_delay_s": flaky_delay_s,
            "prefix_only": prefix_only,
            "transfer_aware": aware,
            "p99_improvement": round(
                1.0 - aware["ttft_p99_ms"]
                / max(prefix_only["ttft_p99_ms"], 1e-9), 4),
            "p50_improvement": round(
                1.0 - aware["ttft_p50_ms"]
                / max(prefix_only["ttft_p50_ms"], 1e-9), 4),
            "measured_links": len(model.links()),
            "mean_abs_est_err": round(model.mean_abs_est_err(), 4),
        }

    # -- fail-slow detection A/B ----------------------------------------------

    async def fail_slow_ab(self, requests: int = 2000,
                           service_s: float = 0.05,
                           arrival_spacing_s: Optional[float] = None,
                           degraded_fraction: float = 0.08,
                           slow_factors: tuple = (4.0, 8.0, 16.0),
                           noise_frac: float = 0.05,
                           eval_interval_s: float = 0.25,
                           min_evidence: int = 6,
                           slow_share: float = 0.25,
                           hedge_quantile: float = 0.95,
                           hedge_min_delay_s: float = 0.02,
                           hedge_budget_frac: float = 0.1,
                           hedge_burst: int = 2,
                           replay_check: bool = True) -> dict:
        """Detection-OFF vs detection-ON (scoring + SLOW share + hedged
        dispatch) over a fleet with seeded GRAY-FAILED workers, measured
        on simulated TTFT — the fail-slow twin of `routing_ab`.

        A seeded fraction of workers is degraded through the persistent
        ``slow`` fault kind (runtime/faults.py): each owns a
        FaultSchedule with one ``FaultSpec("slow", p=1.0, factor=f)``,
        so its service time is multiplied by a seeded factor on every
        request it serves — alive, answering, dragging p99, exactly the
        failure the crash-stop planes cannot see. Both modes run the
        identical seeded arrival stream with per-request seeded service
        noise (noise draws key on the request index, not on mode
        decisions, so mode divergence cannot skew the comparison).

        OFF: least-backlog dispatch, blind to latency. ON: the same
        dispatch feeding a `HealthScorer` (virtual clock, evaluated at
        ``eval_interval_s``); a SLOW-marked worker keeps only
        ``slow_share`` of its dispatch (the residual traffic is the
        probe stream — never full eviction), and a request whose primary
        exceeds the adaptive TTFT quantile hedges once to the
        least-backlog healthy alternative under a per-class
        `HedgeBudget`, first token wins.

        Contracts checked here and gated by the chaos scenario:
        p99(ON) beats p99(OFF); ``dropped`` == 0 (every request produced
        a first token); ``false_ejections`` == 0 (no healthy worker ever
        marked SLOW — the min-evidence floor + MAD robustness at work);
        and with ``replay_check`` the ON mode runs twice and the SLOW
        decision timelines must be bit-identical (`timeline_replay_ok`).
        """
        import zlib

        from dynamo_tpu_torch.runtime.health import HealthScorer, HedgeBudget

        seed = self.cfg.seed
        ids = sorted(self.workers)
        if arrival_spacing_s is None:
            # ~0.6 of fleet service capacity: loaded but not saturated,
            # so queue wait reflects dispatch quality, not overload
            arrival_spacing_s = service_s / (0.6 * max(1, len(ids)))

        def wseed(wid: str, salt: int) -> int:
            return (seed * 1000003 + salt) ^ zlib.crc32(wid.encode())

        # seeded gray-failure membership: persistent slow factor per
        # degraded worker via the "slow" fault kind
        degraded: Dict[str, faults.FaultSchedule] = {}
        factors: Dict[str, float] = {}
        for wid in ids:
            r = random.Random(wseed(wid, 11))
            if r.random() < degraded_fraction:
                f = slow_factors[r.randrange(len(slow_factors))]
                factors[wid] = f
                degraded[wid] = faults.FaultSchedule(
                    wseed(wid, 12),
                    [faults.FaultSpec("slow", p=1.0, factor=f)])
        if degraded_fraction > 0 and not degraded and ids:
            # tiny fleets must still contain one gray failure
            wid = ids[random.Random(seed + 13).randrange(len(ids))]
            factors[wid] = slow_factors[0]
            degraded[wid] = faults.FaultSchedule(
                wseed(wid, 12),
                [faults.FaultSpec("slow", p=1.0,
                                  factor=slow_factors[0])])

        def svc_time(wid: str, req_rng: random.Random) -> float:
            sf = (degraded[wid].decide().slow_factor
                  if wid in degraded else 1.0)
            return service_s * sf * (
                1.0 + noise_frac * (req_rng.random() * 2.0 - 1.0))

        def run_mode(detect: bool) -> dict:
            for sched in degraded.values():
                sched.reset()       # same seeded factor stream per mode
            scorer = HealthScorer(min_evidence=min_evidence,
                                  clock=lambda: 0.0)
            budget = HedgeBudget(hedge_budget_frac, hedge_burst)
            gate_rng = random.Random(seed + 29)   # SLOW-share dispatch
            busy = {w: 0.0 for w in ids}
            obs: List[float] = []                 # hedge-delay window
            ttfts: List[float] = []
            next_eval = eval_interval_s
            fired = wins = denied = dropped = 0
            for i in range(requests):
                now = i * arrival_spacing_s
                if detect:
                    while now >= next_eval:
                        scorer.evaluate(now=next_eval)
                        next_eval += eval_interval_s
                req_rng = random.Random(seed * 7919 + i)
                pick = min(ids, key=lambda w: (busy[w], w))
                if detect and scorer.is_slow(pick) \
                        and gate_rng.random() >= slow_share:
                    healthy = [w for w in ids if not scorer.is_slow(w)]
                    if healthy:
                        pick = min(healthy, key=lambda w: (busy[w], w))
                svc = svc_time(pick, req_rng)
                start = max(now, busy[pick])
                finish = start + svc
                busy[pick] = finish
                scorer.observe(pick, svc)
                ttft = finish - now
                if ttft != ttft or ttft < 0:       # pragma: no cover
                    dropped += 1                   # no first token
                budget.on_request("")
                if detect:
                    delay = (max(percentile(sorted(obs), hedge_quantile),
                                 hedge_min_delay_s)
                             if len(obs) >= 20 else float("inf"))
                    if ttft > delay:
                        if not budget.try_fire(""):
                            denied += 1
                        else:
                            alts = [w for w in ids if w != pick
                                    and not scorer.is_slow(w)]
                            if alts:
                                h = min(alts,
                                        key=lambda w: (busy[w], w))
                                hsvc = svc_time(h, req_rng)
                                hstart = max(now + delay, busy[h])
                                hfinish = hstart + hsvc
                                busy[h] = hfinish
                                scorer.observe(h, hsvc)
                                fired += 1
                                if hfinish < finish:
                                    # first token wins; the primary is
                                    # abandoned pre-commit
                                    wins += 1
                                    ttft = hfinish - now
                obs.append(ttft)
                del obs[:-200]
                ttfts.append(ttft)
            false_ej = sorted(w for w in scorer.slow_workers()
                              if w not in degraded)
            detected = sorted(w for w in scorer.slow_workers()
                              if w in degraded)
            lat = sorted(ttfts)
            return {
                "requests": requests,
                "ttft_p50_ms": round(percentile(lat, 0.50) * 1e3, 2),
                "ttft_p95_ms": round(percentile(lat, 0.95) * 1e3, 2),
                "ttft_p99_ms": round(percentile(lat, 0.99) * 1e3, 2),
                "ttft_mean_ms": round(sum(lat) / len(lat) * 1e3, 2),
                "dropped": dropped,
                "hedges_fired": fired,
                "hedge_wins": wins,
                "hedge_budget_denied": denied,
                "false_ejections": false_ej,
                "detected_slow": detected,
                "timeline": list(scorer.timeline),
            }

        off = run_mode(False)
        on = run_mode(True)
        replay_ok = True
        if replay_check:
            on2 = run_mode(True)
            replay_ok = (json.dumps(on["timeline"], sort_keys=True)
                         == json.dumps(on2["timeline"], sort_keys=True))
        return {
            "seed": seed,
            "workers": len(ids),
            "degraded_workers": len(degraded),
            "slow_factors": {w: factors[w] for w in sorted(factors)},
            "detection_off": off,
            "detection_on": on,
            "p99_improvement": round(
                1.0 - on["ttft_p99_ms"]
                / max(off["ttft_p99_ms"], 1e-9), 4),
            "p95_improvement": round(
                1.0 - on["ttft_p95_ms"]
                / max(off["ttft_p95_ms"], 1e-9), 4),
            "timeline_replay_ok": replay_ok,
        }

    # -- closed-loop autoscale storm ------------------------------------------

    async def _await_fence(self, wid: str, timeout_s: float = 2.0) -> bool:
        """Wait until the client APPLIED the worker's draining/delete
        watch event (status draining or key gone) — the point after
        which the re-role fence contract is checkable."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            info = self.client.instances.get(wid)
            if info is None or info.get("status") == STATUS_DRAINING:
                return True
            await asyncio.sleep(0.005)
        return False

    async def _await_role_visible(self, wid: str, role: str,
                                  timeout_s: float = 2.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            info = self.client.instances.get(wid)
            if info is not None and info.get("role") == role \
                    and info.get("status") != STATUS_DRAINING:
                return True
            await asyncio.sleep(0.005)
        return False

    async def re_role_worker(self, wid: str, role: str,
                             old_role: Optional[str] = None) -> int:
        """Drive one worker's graceful re-role through the REAL control
        plane and enforce the drain-vs-schedule fence: after the
        draining event is applied, the worker must never appear in
        `ids_for_role(old_role)` again until its ready re-put under the
        NEW role. Returns the number of fence violations observed (0 =
        contract held). Storm pacing (cooldown/hysteresis) is
        owned by the calling controller."""
        w = self.workers[wid]
        old_role = old_role if old_role is not None else w.role
        violations = 0
        await w.mark_draining()
        if await self._await_fence(wid) and old_role is not None \
                and wid in self.client.ids_for_role(old_role):
            violations += 1
            log.error("re-role fence violation: %s still schedulable "
                      "for %s after draining applied", wid, old_role)
        await w.set_role(role)
        await self._await_role_visible(wid, role)
        if old_role is not None and wid in self.client.ids_for_role(old_role):
            violations += 1
            log.error("re-role fence violation: %s schedulable for OLD "
                      "role %s after re-registering as %s",
                      wid, old_role, role)
        await self._seed_events(w)
        return violations

    async def autoscale_storm(self, traffic, ticks: int = 360,
                              n_prefill: Optional[int] = None,
                              controller: bool = True,
                              asc_cfg=None,
                              degraded_window: tuple = (0, 0),
                              prompt_tokens: tuple = (200, 600),
                              decode_tokens: tuple = (24, 96),
                              prefill_tok_s: float = 400.0,
                              decode_slots: int = 12,
                              base_itl_s: float = 0.05,
                              ttft_objective_s: float = 3.0,
                              itl_objective_s: float = 0.25,
                              drain_ticks: int = 2,
                              warmup_ticks: int = 10) -> dict:
        """Seeded diurnal + flash-crowd storm over a virtual clock: the
        closed-loop autoscaler run.

        The TRAFFIC/SERVICE model is virtual and pure — arrivals,
        prefill-queue drain, decode-stream progress, TTFT/ITL samples
        are all functions of (seed, traffic shape, role layout) at
        integer virtual seconds — so the controller's decision timeline
        replays bit-identically from the same plan. The CONTROL PLANE
        is real: every re-role decision actuates through
        `SimWorker.set_role` (draining fence -> deregister ->
        re-register) against the live Client/watch machinery, with the
        drain-vs-schedule fence contract checked per actuation
        (`fence_violations` must stay 0).

        Per tick: arrivals join the prefill queue; active prefill
        workers drain it FIFO at `prefill_tok_s` (completions sample
        TTFT = completion - arrival and spawn a decode stream on the
        least-loaded non-draining decode worker); decode workers serve
        streams at `base_itl_s`, stretched by the over-subscription
        ratio when streams exceed `decode_slots`; the rollup-schema
        series (`serving/ttft_p95`, `serving/itl_p99`, `role/*/...`)
        are recorded at the virtual timestamp; the SLO watchdog
        evaluates; and — controller mode — the autoscaler ticks on
        `signals_from_store` over those same series. Re-role drains
        MIGRATE in-flight decode streams to surviving decode workers
        (`migrated` counted, `dropped` must stay 0); ticks inside
        `degraded_window` freeze the controller (zero decisions, the
        `frozen_degraded` counter advances instead).
        """
        from dynamo_tpu_torch.observability.slo import SloSpec, SloWatchdog
        from dynamo_tpu_torch.observability.timeseries import SeriesStore
        from dynamo_tpu_torch.runtime.autoscaler import (
            ROLE_DECODE, ROLE_PREFILL, AutoscalerConfig, AutoscalerStats,
            FleetAutoscaler, signals_from_store,
        )
        cfg = self.cfg
        ids = sorted(self.workers)
        if n_prefill is None:
            n_prefill = len(ids) // 2
        # deterministic initial split, declared on the real instance keys
        role_of: Dict[str, str] = {}
        for i, wid in enumerate(ids):
            role_of[wid] = ROLE_PREFILL if i < n_prefill else ROLE_DECODE
        await asyncio.gather(*(self.workers[wid].assign_role(role_of[wid])
                               for wid in ids))

        store = SeriesStore(interval_s=1.0, capacity=max(600, ticks + 8))
        wd = SloWatchdog(store, [
            SloSpec(name="ttft_p95", series="serving/ttft_p95",
                    objective=ttft_objective_s, mode="above", target=0.9,
                    short_window_s=8.0, long_window_s=24.0,
                    burn_threshold=2.0, min_samples=3),
            SloSpec(name="itl_p99", series="serving/itl_p99",
                    objective=itl_objective_s, mode="above", target=0.9,
                    short_window_s=8.0, long_window_s=24.0,
                    burn_threshold=2.0, min_samples=3),
        ], degraded_fn=lambda: False)
        stats = AutoscalerStats()
        asc = FleetAutoscaler(
            asc_cfg or AutoscalerConfig(
                # role minimums at HALF the steady split: the do-no-harm
                # floor that keeps a lagging occupancy signal from
                # draining decode below its sustainable capacity
                min_prefill=max(1, n_prefill // 2),
                min_decode=max(1, (len(ids) - n_prefill) // 2),
                # actuation bounds scale with fleet size (2 moves per
                # decision is controller-speed at 16 workers and
                # wedged-slow at 64)
                cooldown_s=8.0, hysteresis_ticks=3,
                max_moves=max(2, len(ids) // 8),
                max_moves_per_window=max(10, len(ids) // 2),
                window_s=60.0,
                queue_hi=2.0, queue_lo=0.25, occ_hi=0.9, occ_lo=0.3,
                burn_hi=2.0,
                target_prefill_frac=n_prefill / max(1, len(ids))),
            stats=stats)

        # virtual fleet state
        draining: Dict[str, list] = {}       # wid -> [ticks_left, to_role]
        spares: List[str] = []               # shed workers (add pool)
        queue: List[list] = []               # [rid, arrival_ts, remaining]
        streams: Dict[str, List[list]] = {   # wid -> [[rid, remaining], ..]
            wid: [] for wid in ids if role_of[wid] == ROLE_DECODE}
        ttft_window: List[float] = []
        ttfts: List[float] = []
        completed = migrated = dropped = 0
        fence_violations = 0
        decisions_in_degraded = 0
        ttft_bad_ticks = itl_bad_ticks = 0
        peak_queue = 0.0
        rid_seq = 0
        req_rng_base = cfg.seed * 7919

        def active(role: str) -> List[str]:
            return [w for w, r in role_of.items()
                    if r == role and w not in draining]

        for t in range(ticks):
            ts = float(t)
            deg = degraded_window[0] <= t < degraded_window[1]
            # 1. arrivals
            for _ in range(traffic.arrivals(t)):
                rid_seq += 1
                r = random.Random(req_rng_base + rid_seq)
                queue.append([rid_seq, ts,
                              r.randint(*prompt_tokens),
                              r.randint(*decode_tokens)])
            peak_queue = max(peak_queue, float(len(queue)))
            # 2. prefill service (pooled FIFO drain)
            p_active = active(ROLE_PREFILL)
            capacity = len(p_active) * prefill_tok_s
            used = 0.0
            while queue and capacity > 0:
                item = queue[0]
                take = min(item[2], capacity)
                item[2] -= take
                capacity -= take
                used += take
                if item[2] <= 0:
                    queue.pop(0)
                    completed += 1
                    ttft = (ts + 1.0) - item[1]
                    ttfts.append(ttft)
                    ttft_window.append(ttft)
                    del ttft_window[:-50]
                    d_active = sorted(active(ROLE_DECODE),
                                      key=lambda w: (len(streams.get(w, ())),
                                                     w))
                    if d_active:
                        streams.setdefault(d_active[0], []).append(
                            [item[0], item[3]])
                    else:
                        dropped += 1     # no decode target: contract break
            p_occ = used / max(1.0, len(p_active) * prefill_tok_s)
            # 3. decode service
            itl_samples: List[float] = []
            d_active = active(ROLE_DECODE)
            total_streams = 0
            for wid in sorted(streams):
                ss = streams[wid]
                if not ss:
                    continue
                total_streams += len(ss)
                itl = base_itl_s * max(1.0, len(ss) / decode_slots)
                itl_samples.extend([itl] * len(ss))
                per_stream = 1.0 / itl
                for s in ss:
                    s[1] -= per_stream
                streams[wid] = [s for s in ss if s[1] > 0]
            total_slots = max(1, len(d_active) * decode_slots)
            d_occ = total_streams / total_slots
            # 4. drain progress: completions flip the role on the REAL
            # control plane and migrate leftover decode streams
            for wid in list(draining):
                draining[wid][0] -= 1
                if draining[wid][0] > 0:
                    continue
                to_role = draining.pop(wid)[1]
                leftover = streams.pop(wid, [])
                if leftover:
                    targets = sorted(active(ROLE_DECODE),
                                     key=lambda w: (len(streams.get(w, ())),
                                                    w))
                    if targets:
                        for i, s in enumerate(leftover):
                            streams.setdefault(
                                targets[i % len(targets)], []).append(s)
                        migrated += len(leftover)
                    else:
                        dropped += len(leftover)
                old = role_of.pop(wid)
                if to_role is None:       # shed: park the worker
                    spares.append(wid)
                    await self.workers[wid].mark_draining()
                    await self.workers[wid].deregister()
                else:
                    role_of[wid] = to_role
                    if to_role == ROLE_DECODE:
                        streams.setdefault(wid, [])
                    fence_violations += await self.re_role_worker(
                        wid, to_role, old_role=old)
            # 5. record the rollup-schema series at the virtual ts
            rec = store.record
            if ttft_window:
                rec("serving/ttft_p95",
                    percentile(sorted(ttft_window), 0.95), ts)
            rec("serving/itl_p99",
                percentile(sorted(itl_samples), 0.99)
                if itl_samples else base_itl_s, ts)
            for role, occ, qd in ((ROLE_PREFILL, p_occ, float(len(queue))),
                                  (ROLE_DECODE, d_occ,
                                   float(max(0, total_streams
                                             - total_slots)))):
                ready = len(active(role))
                drn = sum(1 for w in draining if role_of.get(w) == role)
                rec(f"role/{role}/workers", float(ready), ts)
                rec(f"role/{role}/draining", float(drn), ts)
                rec(f"role/{role}/queue_depth", qd, ts)
                rec(f"role/{role}/occupancy", occ, ts)
                rec(f"role/{role}/availability",
                    ready / max(1, ready + drn), ts)
            sv = store.get("serving/ttft_p95")
            if sv is not None and sv.latest() is not None \
                    and sv.latest() > ttft_objective_s:
                ttft_bad_ticks += 1
            if (store.get("serving/itl_p99").latest() or 0.0) \
                    > itl_objective_s:
                itl_bad_ticks += 1
            # 6. watchdog + controller (warmup ticks give the series
            # their first samples before the controller may act)
            wd.evaluate(ts)
            if not controller or t < warmup_ticks:
                continue
            sig = signals_from_store(store, wd, ts, degraded=deg,
                                     drains_active=len(draining))
            candidates = {
                ROLE_DECODE: sorted(active(ROLE_DECODE),
                                    key=lambda w: (len(streams.get(w, ())),
                                                   w)),
                ROLE_PREFILL: sorted(active(ROLE_PREFILL)),
            }
            decisions = asc.decide(sig, candidates)
            if deg and decisions:
                decisions_in_degraded += len(decisions)
            for d in decisions:
                if d.kind in ("re_role_to_prefill", "re_role_to_decode"):
                    for wid in d.workers:
                        draining[wid] = [drain_ticks, d.to_role]
                        await self.workers[wid].mark_draining()
                        if await self._await_fence(wid) and \
                                wid in self.client.ids_for_role(
                                    role_of[wid]):
                            fence_violations += 1
                elif d.kind == "shed":
                    for wid in d.workers:
                        draining[wid] = [drain_ticks, None]
                        await self.workers[wid].mark_draining()
                elif d.kind == "add":
                    for _ in range(d.count):
                        if not spares:
                            break
                        wid = spares.pop()
                        role_of[wid] = d.to_role
                        if d.to_role == ROLE_DECODE:
                            streams.setdefault(wid, [])
                        w = self.workers[wid]
                        w.role = d.to_role
                        await w.register()
                        await self._seed_events(w)

        lat = sorted(ttfts)
        report = {
            "mode": "controller" if controller else "static",
            "workers": len(ids),
            "n_prefill_initial": n_prefill,
            "ticks": ticks,
            "requests": rid_seq,
            "completed": completed,
            "ttft_p50_s": round(percentile(lat, 0.50), 3),
            "ttft_p95_s": round(percentile(lat, 0.95), 3),
            "ttft_p99_s": round(percentile(lat, 0.99), 3),
            "peak_queue": peak_queue,
            "slo": {
                "ttft_bad_ticks": ttft_bad_ticks,
                "itl_bad_ticks": itl_bad_ticks,
                "alerts": list(wd.alerts),
                "firing_at_end": wd.firing(),
            },
            "streams": {"completed": completed, "migrated": migrated,
                        "dropped": dropped},
            "roles_final": {
                "prefill": len(active(ROLE_PREFILL)),
                "decode": len(active(ROLE_DECODE)),
                "spares": len(spares),
            },
            "fence_violations": fence_violations,
            "degraded_window": list(degraded_window),
        }
        if controller:
            report["controller"] = asc.summary()
            report["controller"]["frozen_degraded"] = stats.frozen_degraded
            report["controller"]["cooldown_suppressed"] = \
                stats.cooldown_suppressed
            report["controller"]["hysteresis_suppressed"] = \
                stats.hysteresis_suppressed
            report["controller"]["guard_blocked"] = stats.guard_blocked
            report["decisions_in_degraded"] = decisions_in_degraded
        return report

    def summary(self) -> dict:
        lat = sorted(self.latencies_us)
        return {
            "workers": len(self.workers),
            "streams": self.cfg.streams,
            "schedule_calls": self.schedule_calls,
            "schedule_errors": self.schedule_errors,
            "dead_picks": self.dead_picks,
            "p50_us": round(percentile(lat, 0.50), 1),
            "p99_us": round(percentile(lat, 0.99), 1),
            "register_s": round(self.register_s, 3),
            "indexer_nodes": self.router.indexer.num_nodes(),
            "eviction_backlog": self.router.indexer.eviction_backlog(),
            "watch_resyncs": CP_STATS.watch_resyncs,
            "degraded_entries": self.router.degraded_entries,
        }
