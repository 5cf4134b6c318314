"""The port's failpoint registry (dynamo_tpu_torch/runtime/faults.py)
against the JAX package's, and the failpoints of the port's transports.

(a) One plan dict (every fault kind over several sites, seed per site)
    armed with `arm_from_dict` on both registries: the decision sequences
    of `decide`, the corrupted bytes of `corrupt_bytes` and
    `corrupt_array`, the outcomes of
    `fire` / `fire_sync` and the snapshots and recorded plans are equal.
(b) Each failpoint the port's transports carry fires on both packages'
    memory planes with the same observable effect: `transport.send` and
    `discovery.store` on KV ops and requests, `transport.recv` and
    `event.plane` on publish (drop, duplicate, delay reorders),
    `discovery.heartbeat` on a lease keep-alive, `lease.expiry` on the
    watchdog, `watch.stream` on a watch delivery (and the port Client's
    watch pump resyncs after it).
(c) The TCP client's failpoints: `transport.send` on a frame sent to the
    port's control-plane server, `discovery.heartbeat` on its keep-alive
    loop (every round lost: the lease is lost).
"""
import asyncio
import dataclasses

import numpy as np
import pytest

from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime.transports import memory as jmemory
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime.transports import memory as tmemory

PKGS = ((jfaults, jmemory), (tfaults, tmemory))
T = 30.0


@pytest.fixture(autouse=True)
def clean_registries():
    for f, _ in PKGS:
        f.REGISTRY.disarm()
        f.REGISTRY.reset_counters()
    yield
    for f, _ in PKGS:
        f.REGISTRY.disarm()
        f.REGISTRY.reset_counters()


def both(case):
    (jf, jm), (tf, tm) = PKGS
    want, got = case(jf, jm), case(tf, tm)
    assert got == want
    return got


def arm(F, site, *specs, seed=0):
    F.REGISTRY.arm(site, F.FaultSchedule(
        seed, [F.FaultSpec(**s) for s in specs]))


# -- (a) one plan, one seed: equal decisions -----------------------------------

PLAN = {
    "transport.send": {"seed": 11, "specs": [
        {"kind": "delay", "p": 0.6, "delay_s": 0.02, "delay_min_s": 0.005},
        {"kind": "drop", "p": 0.1}]},
    "transport.recv": {"seed": 211, "specs": [
        {"kind": "duplicate", "p": 0.3, "n": 5},
        {"kind": "fail_n", "n": 2, "skip": 3}]},
    "event.plane": {"seed": 341, "specs": [
        {"kind": "delay", "p": 0.3, "delay_s": 0.8},
        {"kind": "drop", "p": 0.05}]},
    "offload.write_tier": {"seed": 7, "specs": [
        {"kind": "corrupt", "p": 0.4, "n": 6, "nbytes": 3}]},
    "discovery.heartbeat": {"seed": 441, "specs": [
        {"kind": "slow", "p": 0.5, "factor": 4.0},
        {"kind": "slow", "p": 1.0, "factor": 2.0}]},
}


def test_plan_decisions_and_snapshots_equal():
    def case(F, M):
        F.REGISTRY.arm_from_dict(PLAN)
        seq = {site: [dataclasses.asdict(F.REGISTRY.decide(site))
                      for _ in range(200)] for site in PLAN}
        for site, outs in seq.items():
            assert any(o != dataclasses.asdict(F.Outcome())
                       for o in outs), site
        return seq, F.REGISTRY.snapshot(), F.REGISTRY.to_dict()
    seq, snap, plan = both(case)
    assert {k: v["seed"] for k, v in plan.items()} == {
        k: v["seed"] for k, v in PLAN.items()}
    assert snap["hits"] == {site: 200 for site in PLAN}


def test_plan_corrupt_bytes_and_slow_factor_equal():
    def case(F, M):
        F.REGISTRY.arm_from_dict(PLAN)
        payload = bytes(range(64))
        out = [F.REGISTRY.corrupt_bytes("offload.write_tier", payload)
               for _ in range(20)]
        assert any(o != payload for o in out)
        slow = [F.REGISTRY.slow_factor("discovery.heartbeat")
                for _ in range(20)]
        assert set(slow) == {2.0, 4.0}
        return out, slow, F.REGISTRY.snapshot()
    both(case)


def test_plan_corrupt_array_equal():
    """The tier slabs' corruption (in place, seeded byte positions) on the
    same float32 array: the same bytes flipped on the same hits."""
    def case(F, M):
        F.REGISTRY.arm_from_dict(PLAN)
        base = np.arange(32, dtype=np.float32).reshape(4, 8)
        out = []
        for _ in range(20):
            arr = base.copy()
            hit = F.REGISTRY.corrupt_array("offload.write_tier", arr)
            out.append((hit, arr.tobytes()))
            assert hit == (arr.tobytes() != base.tobytes())
        assert any(hit for hit, _ in out)
        return out, F.REGISTRY.snapshot()
    both(case)


def test_fire_and_fire_sync_outcomes_equal():
    def case(F, M):
        arm(F, "queue.dequeue", {"kind": "fail_n", "n": 2},
            {"kind": "duplicate", "p": 0.5}, seed=5)
        log = []
        for _ in range(6):
            try:
                log.append(dataclasses.asdict(
                    F.REGISTRY.fire_sync("queue.dequeue")))
            except F.FaultInjected as e:
                assert isinstance(e, ConnectionError)
                log.append(str(e))

        async def fire_all():
            for _ in range(6):
                try:
                    log.append(dataclasses.asdict(
                        await F.REGISTRY.fire("queue.dequeue")))
                except F.FaultInjected as e:
                    log.append(str(e))
        asyncio.run(asyncio.wait_for(fire_all(), T))
        assert log[:2] == ["fault injected at queue.dequeue"] * 2
        return log, F.REGISTRY.snapshot()
    both(case)


def test_schedule_round_trip_and_catalog():
    def case(F, M):
        sched = F.FaultSchedule(42, [F.FaultSpec("corrupt", p=0.4, n=3,
                                                 nbytes=2),
                                     F.FaultSpec("drop", p=0.1)])
        first = [dataclasses.asdict(sched.decide()) for _ in range(50)]
        clone = F.FaultSchedule.from_dict(sched.to_dict())
        assert [dataclasses.asdict(clone.decide())
                for _ in range(50)] == first
        sched.reset()
        assert [dataclasses.asdict(sched.decide())
                for _ in range(50)] == first
        with pytest.raises(ValueError):
            F.FaultSpec("explode")
        with pytest.raises(ValueError):
            F.REGISTRY.arm("no.such.site", sched)
        return first, F.SITES, F.KINDS
    both(case)


# -- (b) the memory plane's failpoints -----------------------------------------

def test_site_transport_send_and_discovery_store_on_kv_ops():
    def case(F, M):
        async def main():
            kv = M.MemoryKVStore()
            out = []
            arm(F, "transport.send", {"kind": "fail_n", "n": 1})
            with pytest.raises(ConnectionError):
                await kv.put("k", b"v")
            await kv.put("k", b"v")
            arm(F, "discovery.store", {"kind": "fail_n", "n": 3})
            for op in (kv.get("k"), kv.get_prefix("k"), kv.delete("k")):
                with pytest.raises(F.FaultInjected):
                    await op
            out.append(await kv.get("k"))
            await kv.delete("k")
            out.append(await kv.get("k"))
            return out
        got = asyncio.run(asyncio.wait_for(main(), T))
        assert got == [b"v", None]
        return got, F.REGISTRY.snapshot()
    both(case)


def test_site_transport_send_on_request():
    def case(F, M):
        async def main():
            msg = M.MemoryMessaging()

            async def handler(payload):
                return payload + b"!"
            await msg.serve("s", handler)
            arm(F, "transport.send", {"kind": "fail_n", "n": 1})
            with pytest.raises(ConnectionError):
                await msg.request("s", b"a")
            return await msg.request("s", b"b")
        got = asyncio.run(asyncio.wait_for(main(), T))
        assert got == b"b!"
        return got, F.REGISTRY.snapshot()
    both(case)


def test_site_transport_recv_drops_and_duplicates_deliveries():
    def case(F, M):
        async def main():
            msg = M.MemoryMessaging()
            sub = await msg.subscribe("ev.>")
            arm(F, "transport.recv", {"kind": "fail_n", "n": 1},
                {"kind": "duplicate", "p": 1.0, "n": 2})
            for p in (b"lost", b"doubled", b"normal"):
                await msg.publish("ev.a", p)
            return [(await asyncio.wait_for(sub.__anext__(), 5))[1]
                    for _ in range(3)]
        got = asyncio.run(asyncio.wait_for(main(), T))
        assert got == [b"doubled", b"doubled", b"normal"]
        return got, F.REGISTRY.snapshot()
    both(case)


def test_site_event_plane_delay_reorders_and_drop_loses():
    def case(F, M):
        async def main():
            msg = M.MemoryMessaging()
            sub = await msg.subscribe("ev.>")
            arm(F, "event.plane", {"kind": "delay", "p": 1.0, "n": 1,
                                   "delay_s": 0.2, "delay_min_s": 0.2},
                {"kind": "drop", "p": 1.0, "n": 1, "skip": 2})
            for p in (b"delayed", b"prompt", b"dropped", b"last"):
                await msg.publish("ev.a", p)
            return [(await asyncio.wait_for(sub.__anext__(), 5))[1]
                    for _ in range(3)]
        got = asyncio.run(asyncio.wait_for(main(), T))
        assert got == [b"prompt", b"last", b"delayed"]
        return got, F.REGISTRY.snapshot()
    both(case)


def test_site_discovery_heartbeat_drop_skips_lease_refresh():
    def case(F, M):
        async def main():
            kv = M.MemoryKVStore()
            lease = await kv.grant_lease(ttl=30.0)
            before = kv._lease_deadline[lease.id]
            arm(F, "discovery.heartbeat", {"kind": "fail_n", "n": 1})
            lease.keep_alive()
            same = kv._lease_deadline[lease.id] == before
            lease.keep_alive()
            later = kv._lease_deadline[lease.id] > before
            await lease.revoke()
            return same, later
        got = asyncio.run(asyncio.wait_for(main(), T))
        assert got == (True, True)
        return got, F.REGISTRY.snapshot()
    both(case)


def test_site_lease_expiry_force_expires_lease():
    def case(F, M):
        async def main():
            kv = M.MemoryKVStore()
            lease = await kv.grant_lease(ttl=0.9)
            await kv.put("k", b"v", lease.id)
            arm(F, "lease.expiry", {"kind": "drop", "p": 1.0, "n": 1})
            t0 = asyncio.get_running_loop().time()
            await asyncio.wait_for(lease.lost.wait(), 10)
            # forced on a watchdog tick, before the natural deadline
            assert asyncio.get_running_loop().time() - t0 < 0.85
            return await kv.get("k")
        got = asyncio.run(asyncio.wait_for(main(), T))
        assert got is None
        return got, F.REGISTRY.snapshot()["injected"]
    both(case)


def test_site_watch_stream_drop_raises_into_consumer():
    def case(F, M):
        async def main():
            kv = M.MemoryKVStore()
            _, stream = await kv.watch_prefix("p/")
            arm(F, "watch.stream", {"kind": "fail_n", "n": 1})
            await kv.put("p/a", b"1")
            with pytest.raises(F.FaultInjected):
                await asyncio.wait_for(stream.__anext__(), 5)
            snapshot2, stream2 = await kv.watch_prefix("p/")
            await kv.put("p/b", b"2")
            ev = await asyncio.wait_for(stream2.__anext__(), 5)
            await stream.aclose()
            await stream2.aclose()
            return [e.key for e in snapshot2], ev.key
        got = asyncio.run(asyncio.wait_for(main(), T))
        assert got == (["p/a"], "p/b")
        return got, F.REGISTRY.snapshot()
    both(case)


def test_watch_stream_fault_client_pump_resyncs():
    """The port's Client watch pump outlives an injected disconnect: it
    re-establishes the watch, resyncs from the snapshot and still sees an
    instance registered while the stream was down."""
    from dynamo_tpu_torch.runtime.cpstats import CP_STATS
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import FnEngine

    async def echo(request, context):
        yield request

    async def main():
        plane = tmemory.MemoryPlane()
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = await crt.namespace("ns").component("c").endpoint(
            "e").client().start()
        resyncs = CP_STATS.watch_resyncs
        arm(tfaults, "watch.stream", {"kind": "fail_n", "n": 1})
        wrt = await DistributedRuntime.create_local(plane, "w1")
        await wrt.namespace("ns").component("c").endpoint("e").serve(
            FnEngine(echo))
        for _ in range(200):
            if client.instance_ids() == ["w1"]:
                break
            await asyncio.sleep(0.02)
        ids = client.instance_ids()
        await client.stop()
        await wrt.shutdown()
        await crt.shutdown()
        return ids, CP_STATS.watch_resyncs - resyncs

    ids, resynced = asyncio.run(asyncio.wait_for(main(), T))
    assert ids == ["w1"]
    assert resynced >= 1
    assert tfaults.REGISTRY.snapshot()["injected"]["watch.stream"] == 1


# -- (c) the TCP client's failpoints -------------------------------------------

def test_tcp_transport_send_and_heartbeat():
    from dynamo_tpu_torch.runtime.transports.server import (
        ControlPlaneServer,
    )
    from dynamo_tpu_torch.runtime.transports.tcp import ControlPlaneClient

    async def main():
        server = await ControlPlaneServer(port=0).start()
        cp = await ControlPlaneClient("127.0.0.1", server.port).connect()
        try:
            # the first hit is the client's own frame: it never leaves
            arm(tfaults, "transport.send", {"kind": "fail_n", "n": 1})
            with pytest.raises(tfaults.FaultInjected):
                await cp.put("k", b"v")
            await cp.put("k", b"v")
            assert await cp.get("k") == b"v"
            tfaults.REGISTRY.disarm()
            # every keep-alive round lost: the lease expires on the server
            lease = await cp.grant_lease(ttl=0.6)
            await cp.put("leased", b"x", lease.id)
            arm(tfaults, "discovery.heartbeat", {"kind": "drop", "p": 1.0})
            for _ in range(100):
                if await cp.get("leased") is None:
                    break
                await asyncio.sleep(0.05)
            return await cp.get("leased")
        finally:
            tfaults.REGISTRY.disarm()
            await cp.close()
            await server.stop()

    assert asyncio.run(asyncio.wait_for(main(), T)) is None
    snap = tfaults.REGISTRY.snapshot()
    assert snap["injected"]["transport.send"] == 1
    assert snap["injected"]["discovery.heartbeat"] >= 1
