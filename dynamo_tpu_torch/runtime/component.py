"""Discoverable component model: Namespace -> Component -> Endpoint -> Client.

Copied from dynamo_tpu/runtime/component.py. An endpoint instance registers
the KV key `{ns}/components/{comp}/{endpoint}:{worker_id}` under the
worker's primary lease and serves the request subject
`{ns}|{comp}.{endpoint}-{worker_id}` (:77-84); clients watch the KV prefix
to track live instances and route random / round-robin / direct (:465-560).
`Endpoint.serve` (:194-280) rebuilds the request Context, calls home over
the data plane and pumps the engine's frames; `$STATS.{subject}` answers
the stats handler. `ServedEndpoint.mark_draining` / `drain` (:307-360) are
the graceful drain, counted on DRAIN_STATS (:44-57, :334-336; /metrics:
llm_drain_*): a stream cut at the drain deadline ends without a finish
frame, and the frontend's reliability layer migrates it. Payloads are
MessagePack through the port's codec (transports/codec.py), so the wire is
the JAX package's.

Frames an engine yields may be dataclasses (the port's protocol objects):
they cross the wire as their dict forms (protocols/common.to_wire), as the
JAX package sends `model_dump(exclude_none=True)`.

`ServedEndpoint.re_role` (:363-405) re-registers a live instance under a
new serving role through the DRAINING fence (the autoscaler's actuation on
a real worker), and `Client.ids_for_role` / `draining_ids` (:600-628) read
the watch-maintained role caches. Every served dispatch records a
`worker.generate` span (:236-254) under the wire-carried trace, and the
engine's own spans nest under it.
"""
from __future__ import annotations

import asyncio
import json
import logging
import random
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from dynamo_tpu_torch.protocols.common import to_wire
from dynamo_tpu_torch.runtime import dataplane
from dynamo_tpu_torch.runtime.backoff import Backoff
from dynamo_tpu_torch.runtime.cpstats import CP_STATS
from dynamo_tpu_torch.runtime.deadline import with_deadline
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, FnEngine
from dynamo_tpu_torch.runtime.tracing import TRACER
from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb

log = logging.getLogger("dynamo_tpu_torch.component")

# upper bound on waiting for a dispatch ack (the request-plane round trip;
# response frames ride the data plane with their own inactivity handling),
# tightened further by the request Context's deadline when one is armed
DISPATCH_ACK_TIMEOUT_S = 30.0

# instance lifecycle states carried in the instance-key JSON ("status").
# READY is implicit (absent == ready); DRAINING = planned maintenance:
# routers stop NEW assignments while in-flight streams finish
STATUS_READY = "ready"
STATUS_DRAINING = "draining"


class DrainStats:
    """Process-local drain counters (/metrics: llm_drain_*)."""

    def __init__(self):
        self.drains_started = 0
        self.drains_completed = 0
        self.drained_streams = 0       # finished within the deadline
        self.cancelled_streams = 0     # cut at the deadline (migrate)

    def snapshot(self):
        return dict(self.__dict__)


DRAIN_STATS = DrainStats()


def instance_status(info: Optional[Dict[str, Any]]) -> str:
    """Lifecycle status of an instance-key value (absent => ready)."""
    if not info:
        return STATUS_READY
    return info.get("status", STATUS_READY)


def instance_role(info: Optional[Dict[str, Any]]) -> Optional[str]:
    """Serving role carried in the instance-key JSON ("role": "prefill" /
    "decode" on disaggregated fleets; JAX component.py:67). Absent =>
    None: a role-less instance serves everything, so role-filtered
    callers (observability/fleet.FleetRollup) treat None as a wildcard."""
    if not info:
        return None
    return info.get("role")


def instance_key(ns: str, comp: str, endpoint: str, worker_id: str) -> str:
    return f"{ns}/components/{comp}/{endpoint}:{worker_id}"


def instance_subject(ns: str, comp: str, endpoint: str, worker_id: str) -> str:
    return f"{ns}|{comp}.{endpoint}-{worker_id}"


class DecodedSubscription:
    """MessagePack-decoding view over a transport subscription stream that
    keeps its batching surface (next_batch / depth / aclose): the router's
    event pump needs per-tick batches and the live backlog."""

    def __init__(self, raw):
        self._raw = raw

    def __aiter__(self):
        return self

    async def __anext__(self):
        subj, payload = await self._raw.__anext__()
        return subj, unpackb(payload)

    async def next_batch(self, max_items: int = 4096,
                         timeout: Optional[float] = None) -> list:
        batch = await self._raw.next_batch(max_items, timeout)
        return [(s, unpackb(p)) for s, p in batch]

    def depth(self) -> int:
        return self._raw.depth()

    async def aclose(self) -> None:
        await self._raw.aclose()


class Namespace:
    def __init__(self, runtime, name: str):
        self._rt = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self._rt, self, name)


class Component:
    def __init__(self, runtime, namespace: Namespace, name: str):
        self._rt = runtime
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._rt, self, name)

    async def publish(self, subject: str, payload: Any) -> None:
        await self._rt.messaging.publish(
            f"{self.namespace.name}.{self.name}.{subject}", packb(payload))

    async def subscribe(self, subject: str):
        return DecodedSubscription(await self._rt.messaging.subscribe(
            f"{self.namespace.name}.{self.name}.{subject}"))


class Endpoint:
    def __init__(self, runtime, component: Component, name: str):
        self._rt = runtime
        self.component = component
        self.name = name

    @property
    def ns(self) -> str:
        return self.component.namespace.name

    def key_for(self, worker_id: str) -> str:
        return instance_key(self.ns, self.component.name, self.name, worker_id)

    def subject_for(self, worker_id: str) -> str:
        return instance_subject(self.ns, self.component.name, self.name,
                                worker_id)

    async def serve(
        self,
        engine: AsyncEngine | Callable,
        metadata: Optional[Dict[str, Any]] = None,
        stats_handler: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> "ServedEndpoint":
        """Register and start serving this endpoint instance: decode the
        request envelope, rebuild the Context, call home over the data
        plane, run the engine, pump its frames into the stream."""
        if not isinstance(engine, AsyncEngine):
            engine = FnEngine(engine)
        rt = self._rt
        worker_id = rt.worker_id
        subject = self.subject_for(worker_id)
        # live response-pump tasks: graceful drain waits for this to empty
        inflight: set = set()

        async def handle(payload: bytes) -> bytes:
            env = unpackb(payload)
            ctx = Context(env.get("request_id"), env.get("baggage") or {})
            # deadlines cross the wire as remaining seconds (clocks differ)
            if env.get("deadline_s") is not None:
                ctx.set_deadline(float(env["deadline_s"]))
            try:
                _, writer = await dataplane.call_home(
                    env["connection_info"], env["stream_id"], ctx)
            except Exception as e:  # noqa: BLE001 — reported in the ack
                return packb({"ok": False, "error": str(e)})
            req = unpackb(env["payload"])

            async def run():
                # one span a served dispatch, parented under the
                # dispatching attempt by the wire-carried trace; the
                # engine's spans nest under it through ctx.trace
                span = TRACER.begin_span("worker.generate", ctx.trace,
                                         request_id=ctx.id, subject=subject)
                if span is not None:
                    ctx.trace = span.context()
                failed = True
                try:
                    try:
                        gen = engine.generate(req, ctx)
                    except Exception as e:  # noqa: BLE001 — engine rejected
                        log.exception("engine failure on %s", subject)
                        await dataplane.close_with_error(
                            writer, f"{type(e).__name__}: {e}")
                        return
                    # generator-time failures are forwarded by pump_stream
                    await dataplane.pump_stream(writer, _packed(gen), ctx)
                    failed = False
                finally:
                    TRACER.end_span(span, error=failed)

            task = asyncio.create_task(run())
            inflight.add(task)
            task.add_done_callback(inflight.discard)
            return packb({"ok": True})

        unserve = await rt.messaging.serve(subject, handle)
        info = {
            "namespace": self.ns,
            "component": self.component.name,
            "endpoint": self.name,
            "worker_id": worker_id,
            "subject": subject,
            **(metadata or {}),
        }
        await rt.kv.put(self.key_for(worker_id), json.dumps(info).encode(),
                        rt.lease.id if rt.lease else 0)
        served = ServedEndpoint(self, worker_id, unserve, inflight, info)
        rt.register_served(served)
        if stats_handler is not None:
            async def stats(payload: bytes) -> bytes:
                return packb(stats_handler())
            served._unserve_stats = await rt.messaging.serve(
                f"$STATS.{subject}", stats)
        return served

    def client(self) -> "Client":
        return Client(self._rt, self)


def _packed(gen) -> AsyncIterator[bytes]:
    async def inner():
        async for item in gen:
            yield packb(to_wire(item))
    return inner()


class ServedEndpoint:
    def __init__(self, endpoint: Endpoint, worker_id: str, unserve,
                 inflight: set, info: Dict[str, Any]):
        self.endpoint = endpoint
        self.worker_id = worker_id
        self._unserve = unserve
        self._unserve_stats = None
        # live response pumps (graceful drain waits on this emptying)
        self.inflight = inflight
        self.info = dict(info)
        self._shut = False
        self.draining = False

    async def mark_draining(self) -> None:
        """Flip this instance to DRAINING: the instance key is re-put with
        status=draining (same lease), so every watching client and router
        fences it out of NEW assignments while the request subject stays
        up for in-flight streams."""
        self.draining = True
        rt = self.endpoint._rt
        info = {**self.info, "status": STATUS_DRAINING}
        await rt.kv.put(self.endpoint.key_for(self.worker_id),
                        json.dumps(info).encode(),
                        rt.lease.id if rt.lease else 0)

    async def drain(self, timeout_s: float = 30.0,
                    poll_s: float = 0.05,
                    force: Optional[Callable[[], bool]] = None) -> dict:
        """Maintenance shutdown of this instance: mark DRAINING, wait up to
        timeout_s for in-flight response streams (`force()` returning True
        skips the wait), cancel what is left, then deregister and unserve.
        Returns a summary dict; the counts land on DRAIN_STATS."""
        DRAIN_STATS.drains_started += 1
        started_with = len(self.inflight)
        try:
            await self.mark_draining()
        except Exception:  # dynalint: swallow-ok=the-drain-proceeds-unfenced
            log.exception("drain: marking %s draining failed; "
                          "draining anyway", self.worker_id)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while self.inflight and loop.time() < deadline \
                and not (force is not None and force()):
            await asyncio.sleep(poll_s)
        cancelled = len(self.inflight)
        for task in list(self.inflight):
            # the cut stream ends without a finish frame: the reliability
            # layer migrates it with its committed prefix
            task.cancel()
        DRAIN_STATS.drained_streams += max(0, started_with - cancelled)
        DRAIN_STATS.cancelled_streams += cancelled
        if cancelled:
            log.warning("drain %s: %d stream(s) cut at the deadline "
                        "(migrating)", self.worker_id, cancelled)
        await self.shutdown()
        DRAIN_STATS.drains_completed += 1
        return {"worker_id": self.worker_id, "inflight_at_start":
                started_with, "cancelled": cancelled}

    async def re_role(self, role: str, drain_timeout_s: float = 30.0,
                      poll_s: float = 0.05) -> dict:
        """Re-register this LIVE instance under a new serving role: the
        real-worker leg of the autoscaler's "this decode worker becomes a
        prefill worker" actuation (runtime/autoscaler.py).

        Fence ordering: the instance key is re-put with status=DRAINING
        first, so every watching client and router drops it from
        `ids_for_role(old_role)` the moment that event is applied; then
        in-flight response streams get up to `drain_timeout_s` to finish
        (they are NOT cancelled: a role change is planned maintenance of
        the routing table, not of the streams); only then does the ready
        re-put under the NEW role land. Between the two puts the instance
        is schedulable for neither role."""
        rt = self.endpoint._rt
        from_role = self.info.get("role")
        started_with = len(self.inflight)
        try:
            await self.mark_draining()
        except Exception:  # dynalint: swallow-ok=re-role-proceeds-without-fence
            log.exception("re_role: marking %s draining failed; "
                          "re-roling anyway", self.worker_id)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + drain_timeout_s
        while self.inflight and loop.time() < deadline:
            await asyncio.sleep(poll_s)
        lingering = len(self.inflight)
        if lingering:
            log.warning("re_role %s: %d stream(s) still in flight at the "
                        "drain deadline; re-roling around them",
                        self.worker_id, lingering)
        self.info["role"] = role
        self.info.pop("status", None)
        self.draining = False
        await rt.kv.put(self.endpoint.key_for(self.worker_id),
                        json.dumps(self.info).encode(),
                        rt.lease.id if rt.lease else 0)
        return {"worker_id": self.worker_id, "from_role": from_role,
                "to_role": role, "inflight_at_start": started_with,
                "lingering": lingering}

    async def shutdown(self):
        # idempotent and ordered: the instance KEY goes first so watching
        # routers stop picking this instance BEFORE the request subject
        # disappears
        if self._shut:
            return
        self._shut = True
        await self.endpoint._rt.kv.delete(self.endpoint.key_for(self.worker_id))
        await self._unserve()
        if self._unserve_stats is not None:
            await self._unserve_stats()


class Client:
    """Routes requests to live endpoint instances: a watch on the instance
    prefix, random / round-robin / direct routing and the streaming request
    path over the data plane."""

    def __init__(self, runtime, endpoint: Endpoint):
        self._rt = runtime
        self.endpoint = endpoint
        self.instances: Dict[str, Dict[str, Any]] = {}
        self._rr = 0
        self._watch_task: Optional[asyncio.Task] = None
        self._ready = asyncio.Event()
        # instance-change listeners: cb(kind, worker_id, info) fired on
        # every watch event as it arrives (the KV router evicts a dead or
        # draining worker's index entries here)
        self._listeners: List[Callable[[str, str, Optional[dict]], None]] \
            = []
        # cached ready / draining id lists, invalidated by watch events
        self._ids_dirty = True
        self._ready_cache: List[str] = []
        self._draining_cache: List[str] = []
        # per-role dispatchable ids (the re-role fence reads them); role-less
        # instances are wildcards kept apart, so an aggregated fleet
        # answers every role without a scan per call
        self._role_cache: Dict[str, List[str]] = {}
        self._roleless_cache: List[str] = []

    def add_listener(self,
                     cb: Callable[[str, str, Optional[dict]], None]) -> None:
        """Register cb(kind, worker_id, info); kind is "put" / "delete".
        Called synchronously from the watch pump: keep it cheap."""
        self._listeners.append(cb)

    async def start(self) -> "Client":
        self._prefix = instance_key(self.endpoint.ns,
                                    self.endpoint.component.name,
                                    self.endpoint.name, "")
        snapshot, stream = await self._rt.kv.watch_prefix(self._prefix)
        for e in snapshot:
            self._apply("put", e.key, e.value)
        self._ready.set()
        self._watch_task = asyncio.create_task(self._watch_loop(stream))
        return self

    async def _watch_loop(self, stream) -> None:
        """Watch pump: applies events in per-tick batches, and on a
        watch-stream failure resumes with bounded backoff + jitter and a
        full snapshot resync."""
        backoff = Backoff(base_s=0.05, max_s=2.0, stable_reset_s=10.0)
        try:
            while True:
                try:
                    batch = await stream.next_batch()
                    CP_STATS.watch_queue_depth = stream.depth()
                    self._apply_batch(batch)
                    backoff.reset()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — the pump must outlive it
                    log.warning("instance watch for %s failed; resuming "
                                "with resync", self._prefix, exc_info=True)
                    try:
                        await stream.aclose()
                    except Exception:  # dynalint: swallow-ok=best-effort-close
                        pass
                    await backoff.sleep()
                    try:
                        snapshot, stream = await self._rt.kv.watch_prefix(
                            self._prefix)
                    except Exception:  # dynalint: swallow-ok=retried-next-round
                        log.warning("watch re-establish failed for %s",
                                    self._prefix, exc_info=True)
                        continue
                    CP_STATS.watch_resyncs += 1
                    self._resync(snapshot)
        finally:
            try:
                await stream.aclose()
            except Exception:  # dynalint: swallow-ok=teardown-best-effort
                pass

    def _apply_batch(self, events) -> None:
        """Coalesce a tick's events per key (last state wins) and apply
        once per key."""
        if not events:
            return
        final: Dict[str, Any] = {}
        for ev in events:
            final[ev.key] = ev
        CP_STATS.watch_events_applied += len(final)
        CP_STATS.watch_events_coalesced += len(events) - len(final)
        for ev in final.values():
            self._apply(ev.kind, ev.key, ev.value)

    def _resync(self, snapshot) -> None:
        """Reconcile full state after a watch gap: deletes missed while the
        stream was down still fire the listeners."""
        seen = set()
        for e in snapshot:
            seen.add(e.key.rsplit(":", 1)[-1])
            self._apply("put", e.key, e.value)
        gone = [w for w in self.instances if w not in seen]
        for worker_id in gone:
            self._apply("delete", self.endpoint.key_for(worker_id), None)
        CP_STATS.watch_events_applied += len(snapshot) + len(gone)

    def _apply(self, kind: str, key: str, value: Optional[bytes]):
        worker_id = key.rsplit(":", 1)[-1]
        info: Optional[Dict[str, Any]] = None
        if kind == "put" and value is not None:
            try:
                info = json.loads(value)
            except (ValueError, TypeError):
                return
            self.instances[worker_id] = info
        elif kind == "delete":
            self.instances.pop(worker_id, None)
        self._ids_dirty = True
        for cb in self._listeners:
            try:
                cb(kind, worker_id, info)
            except Exception:  # dynalint: swallow-ok=must-not-kill-the-watch
                log.exception("instance listener failed for %s", worker_id)

    async def wait_for_instances(self, timeout: float = 10.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while not self.instances:
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(
                    f"no instances of {self.endpoint.subject_for('*')}")
            await asyncio.sleep(0.02)

    def _recompute_ids(self) -> None:
        ready: List[str] = []
        draining: List[str] = []
        roleless: List[str] = []
        by_role: Dict[str, List[str]] = {}
        for w in sorted(self.instances):
            info = self.instances[w]
            if instance_status(info) == STATUS_DRAINING:
                draining.append(w)
                continue
            ready.append(w)
            role = instance_role(info)
            if role is not None:
                by_role.setdefault(role, []).append(w)
            else:
                roleless.append(w)
        self._ready_cache, self._draining_cache = ready, draining
        self._role_cache = by_role
        self._roleless_cache = roleless
        self._ids_dirty = False

    def instance_ids(self) -> List[str]:
        """Dispatchable instance ids. DRAINING instances are excluded
        unless every live instance is draining (a probe on a draining but
        alive worker beats failing the request outright)."""
        if self._ids_dirty:
            self._recompute_ids()
        return self._ready_cache if self._ready_cache \
            else sorted(self.instances)

    def draining_ids(self) -> List[str]:
        if self._ids_dirty:
            self._recompute_ids()
        return self._draining_cache

    def ids_for_role(self, role: str) -> List[str]:
        """Dispatchable instance ids serving `role`: the re-role fence. A
        worker flipped to DRAINING (the first leg of `re_role` /
        `SimWorker.set_role`) leaves this list the moment its watch event
        is APPLIED, and only re-enters under its NEW role's list with the
        ready re-put. Role-less instances count for every role. Returns the
        watch-maintained cache: callers must not mutate it."""
        if self._ids_dirty:
            self._recompute_ids()
        declared = self._role_cache.get(role, [])
        if not self._roleless_cache:
            return declared
        if not declared:
            return self._roleless_cache
        return sorted(declared + self._roleless_cache)

    def _pick_random(self) -> str:
        return random.choice(self.instance_ids())

    def _pick_round_robin(self) -> str:
        ids = self.instance_ids()
        self._rr = (self._rr + 1) % len(ids)
        return ids[self._rr]

    async def generate(self, request: Any, context: Optional[Context] = None,
                       instance: Optional[str] = None,
                       policy: str = "random") -> AsyncIterator[Any]:
        """Send a request; yields response frames (decoded MessagePack)."""
        if not self.instances:
            await self.wait_for_instances()
        if instance is None:
            instance = (self._pick_round_robin() if policy == "round_robin"
                        else self._pick_random())
        ctx = context or Context()
        subject = self.endpoint.subject_for(instance)

        server = await self._rt.data_plane()
        stream = server.register()
        envelope = packb({
            "request_id": ctx.id,
            "baggage": ctx.baggage,
            "payload": packb(to_wire(request)),
            "connection_info": server.connection_info,
            "stream_id": stream.stream_id,
            "deadline_s": ctx.time_remaining(),
        })
        try:
            ack = unpackb(await with_deadline(
                self._rt.messaging.request(
                    subject, envelope, timeout=DISPATCH_ACK_TIMEOUT_S),
                DISPATCH_ACK_TIMEOUT_S, ctx))
        except BaseException:
            server.unregister(stream.stream_id)
            raise
        if not ack.get("ok"):
            server.unregister(stream.stream_id)
            raise RuntimeError(ack.get("error", "request rejected"))

        async def gen():
            stopped = False
            async for data in server.stream_responses(stream):
                if ctx.is_stopped and not stopped:
                    stopped = True
                    await server.send_stop(stream)
                yield unpackb(data)

        return gen()

    async def scrape_stats(self, timeout: float = 2.0) -> Dict[str, Dict]:
        """Collect the stats handler's reply from each live instance,
        concurrently: a cycle costs one timeout whatever the fleet size."""
        async def one(worker_id: str):
            subject = f"$STATS.{self.endpoint.subject_for(worker_id)}"
            try:
                raw = await self._rt.messaging.request(subject, b"",
                                                       timeout=timeout)
                return worker_id, unpackb(raw)
            except Exception:  # noqa: BLE001 — a dead instance scrapes empty
                return worker_id, None

        results = await asyncio.gather(*(one(w) for w in self.instance_ids()))
        return {w: stats for w, stats in results if stats is not None}

    async def stop(self):
        if self._watch_task:
            self._watch_task.cancel()
            self._watch_task = None
