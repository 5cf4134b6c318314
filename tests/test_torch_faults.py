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
(d) The disaggregation's failpoints, each site's decisions under one
    seeded schedule equal to the JAX site's, with its outcome counters:
    `queue.dequeue` (delay and drop fire before the pop: no item lost),
    `transfer.link` in `_chunk_gate` (a drop resumes from the acked
    frontier and re-ships no committed page), the wire corruption of
    `remote_transfer.fetch_page` (the chunk is refused, re-sent, never
    injected) and the local backend's staging hop (re-fetch within its
    budget, IntegrityError past it and a local re-prefill on the decode
    side; int8 pages verified in their stored form). The end-to-end
    cases drive one request through each package's disaggregated stack
    on the same weights under the same armed schedule: equal tokens and
    counters, and the stream equals the JAX single engine's.
(e) tools/torch_chaos_replay.py: --list equals the port's SCENARIOS and
    --dump-plan the JAX plans.
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


# -- (d) the disaggregation's failpoints ---------------------------------------

def _queues():
    from dynamo_tpu.disagg.protocols import RemotePrefillRequest as JReq
    from dynamo_tpu.disagg.queue import PrefillQueue as JQueue
    from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest as TReq
    from dynamo_tpu_torch.disagg.queue import PrefillQueue as TQueue
    return {jfaults: (JQueue, JReq, jmemory), tfaults: (TQueue, TReq, tmemory)}


@pytest.mark.parametrize("kind", ["drop", "delay"])
def test_queue_dequeue_fires_before_the_pop(kind):
    """Six items through a leased and a plain dequeue under a seeded
    schedule: the same outcome sequence in both packages, every item
    delivered once, and the registry's counts equal."""
    spec = ({"kind": "drop", "p": 0.5} if kind == "drop"
            else {"kind": "delay", "p": 0.5, "delay_s": 0.01})

    def case(F, M):
        Queue, Req, _ = _queues()[F]

        async def main():
            plane = M.MemoryPlane()
            q = Queue(plane.messaging, "ns", "m")
            for i in range(6):
                await q.enqueue(Req(engine_id="e", request_id=f"r{i}",
                                    token_ids=[i], page_ids=[i]))
            arm(F, "queue.dequeue", spec, seed=353)
            seen, outcomes = [], []
            while len(seen) < 6:
                leased = len(seen) % 2 == 0
                try:
                    if leased:
                        got = await q.dequeue_leased(timeout=0.5)
                        req, token = got
                        await q.ack(token)
                    else:
                        req = await q.dequeue(timeout=0.5)
                except F.FaultInjected:
                    outcomes.append("drop")
                    continue
                outcomes.append(req.request_id)
                seen.append(req.request_id)
            return (outcomes, sorted(seen), await q.depth(),
                    F.REGISTRY.snapshot())
        return asyncio.run(asyncio.wait_for(main(), T))

    outcomes, seen, depth, snap = both(case)
    assert seen == [f"r{i}" for i in range(6)] and depth == 0
    fired = snap["injected"].get("queue.dequeue", 0)
    assert fired > 0
    if kind == "drop":
        assert outcomes.count("drop") == fired


def test_transfer_link_gate_decisions_equal_to_jax():
    """The `transfer.link` site of each package's sender under one seeded
    schedule (drops and a bounded stall): the same chunks are cut."""
    from dynamo_tpu.disagg.remote_transfer import (
        RemoteTransferBackend as JBackend,
    )
    from dynamo_tpu_torch.disagg.remote_transfer import (
        RemoteTransferBackend as TBackend,
    )

    def case(F, M):
        backend = (JBackend if F is jfaults else TBackend)(
            M.MemoryPlane().kv)
        arm(F, "transfer.link", {"kind": "delay", "p": 1.0, "n": 1,
                                 "skip": 2, "delay_s": 0.01,
                                 "delay_min_s": 0.01},
            {"kind": "drop", "p": 0.3}, seed=53)

        async def main():
            cut = []
            for i in range(24):
                try:
                    await backend._chunk_gate(i)
                except F.FaultInjected:
                    cut.append(i)
            return cut, F.REGISTRY.snapshot()
        return asyncio.run(asyncio.wait_for(main(), T))

    cut, snap = both(case)
    assert cut and snap["injected"]["transfer.link"] == len(cut) + 1


@pytest.fixture(scope="module")
def stacks():
    """Each package's disaggregated stack on the same weights: the JAX
    package's tiny float32 engines (seed 0) and the port's on those
    weights (params_from_jax). `oracle(prompt)`: the JAX single engine's
    greedy tokens."""
    import types

    import jax

    from dynamo_tpu import disagg as jdisagg
    from dynamo_tpu.engine.config import (
        EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
    )
    from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
    from dynamo_tpu.engine.scheduler import SamplingParams as JSamplingParams
    from dynamo_tpu.llm import worker as jworker
    from dynamo_tpu.runtime import engine as jengine, integrity as jintegrity
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.remote_transfer import (
        KvTransferServer, RemoteTransferBackend,
    )
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.transfer import LocalTransferBackend
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )
    from dynamo_tpu_torch.llm import worker as tworker
    from dynamo_tpu_torch.models.llama import params_from_jax
    from dynamo_tpu_torch.runtime import (
        engine as tengine, integrity as tintegrity,
    )
    from tools.torch_chaos import CFG, ENGINE_KW, ChaosEnv, pre_request
    import test_chaos as jchaos

    tdisagg = types.SimpleNamespace(
        PrefillQueue=PrefillQueue, KvTransferServer=KvTransferServer,
        RemoteTransferBackend=RemoteTransferBackend,
        DisaggregatedRouter=DisaggregatedRouter,
        LocalTransferBackend=LocalTransferBackend,
        DisaggDecodeWorker=DisaggDecodeWorker, PrefillWorker=PrefillWorker)
    jcfg = JModelConfig(dtype="float32", max_model_len=512,
                        decode_kernel="off")

    def jengine_of():
        return JNativeEngine(jcfg, JEngineConfig(**ENGINE_KW), seed=0)
    oracle_engine = jengine_of()
    tenv = ChaosEnv(params_from_jax(jax.device_get(oracle_engine.params),
                                    CFG, "cpu"))

    def stack(F, M, d, worker, engine, integrity, engine_of, request):
        return types.SimpleNamespace(
            F=F, M=M, d=d, Worker=worker.NativeEngineWorker,
            Context=engine.Context, integrity=integrity,
            engine=engine_of, request=request)

    def oracle(prompt):
        return oracle_engine.generate(list(prompt), JSamplingParams(
            max_tokens=4, temperature=0.0, ignore_eos=True), "o")
    return types.SimpleNamespace(
        jax=stack(jfaults, jmemory, jdisagg, jworker, jengine, jintegrity,
                  jengine_of, jchaos.pre_request),
        torch=stack(tfaults, tmemory, tdisagg, tworker, tengine, tintegrity,
                    tenv.engine, pre_request),
        oracle=oracle)


def both_stacks(stacks, case):
    want, got = case(stacks.jax), case(stacks.torch)
    assert got == want
    return got


def _stats(S):
    """The integrity and transfer counters the port carries (JAX's
    `parallel_transfers` belongs to the sharded streams, ROADMAP A9)."""
    from dynamo_tpu_torch.runtime import integrity
    return {f.name: getattr(getattr(S.integrity, name), f.name)
            for name in ("STATS", "XFER_STATS")
            for f in dataclasses.fields(getattr(integrity, name))}


async def _disagg_one(S, prompt, transfer, remote_server=False):
    """One request through package S's decode worker, fed by its prefill
    worker over `transfer` (the TCP plane when `remote_server`):
    (tokens, decode worker, transfer server or None)."""
    from tools.torch_chaos import as_dict
    d = S.d
    plane = S.M.MemoryPlane()
    queue = d.PrefillQueue(plane.messaging, "ns", "tiny")
    decode = d.DisaggDecodeWorker(
        S.engine(), plane.messaging, d.DisaggregatedRouter(4, 8), queue,
        worker_id="dec-0", prefill_timeout_s=60.0)
    server = None
    if remote_server:
        server = await d.KvTransferServer(decode, "dec-0").start()
        await server.register(plane.kv)
        tx = transfer(plane.kv)
    else:
        tx = transfer()
        tx.register("dec-0", decode)
    prefill = d.PrefillWorker(S.Worker(S.engine()), queue, tx,
                              plane.messaging, dequeue_timeout_s=0.05)
    await decode.start()
    await prefill.start()
    try:
        toks = []
        async for f in decode.generate(S.request("r0", prompt, 4),
                                       S.Context("r0")):
            f = as_dict(f)
            assert f.get("finish_reason") != "error", f
            toks.extend(f.get("token_ids", ()))
        return toks, decode, server
    finally:
        await prefill.stop()
        await decode.stop()
        if server is not None:
            await server.stop()
            await tx.close()


PROMPT = [(11 * 3 + j) % 200 + 3 for j in range(30)]   # 4 pages of 8
TX = 120.0     # the first request of a package builds its engines' graphs


def _remote_case(site, spec):
    """A case of both_stacks: one request over the TCP transfer plane
    (one-page chunks, stop-and-wait) with `site` armed: its tokens, the
    site's injections, the counters' deltas, the pages the server took
    in and the decode side's salvages."""
    def case(S):
        arm(S.F, site, spec)
        before = _stats(S)

        def tx(kv):
            return S.d.RemoteTransferBackend(kv, chunk_pages=1,
                                             window_chunks=1, link_retries=3)
        toks, decode, server = asyncio.run(asyncio.wait_for(
            _disagg_one(S, PROMPT, tx, remote_server=True), TX))
        delta = {k: v - before[k] for k, v in _stats(S).items()}
        return (toks, S.F.REGISTRY.snapshot()["injected"], delta,
                server.received_pages, decode.salvaged_prefills)
    return case


def test_transfer_link_drop_resumes_from_the_acked_frontier(stacks):
    """One link cut after the first chunk's ack: both packages resume
    from the acked frontier, re-ship no committed page and serve the
    JAX single engine's tokens, with equal counters."""
    # hits: chunk 0 passes, chunk 1 is cut, then the resume's chunks pass
    toks, injected, d, received, salvaged = both_stacks(stacks, _remote_case(
        "transfer.link", {"kind": "fail_n", "n": 1, "skip": 1}))
    assert toks == stacks.oracle(PROMPT)
    assert injected == {"transfer.link": 1}
    assert d["resumes"] == 1                  # one page was committed
    assert d["pages_sent"] == 4 and received == 4   # none re-sent
    assert salvaged == 0


def test_corrupted_chunk_refused_and_resent(stacks):
    """One chunk corrupted on the wire: both packages' receivers refuse
    it, the sender re-sends it and it is never injected; equal counters
    and the JAX single engine's tokens."""
    toks, injected, d, received, salvaged = both_stacks(stacks, _remote_case(
        "remote_transfer.fetch_page",
        {"kind": "corrupt", "p": 1.0, "n": 1, "skip": 1}))
    assert toks == stacks.oracle(PROMPT)
    assert injected == {"remote_transfer.fetch_page": 1}
    assert d["mismatches"] == 1 and d["refetches"] == 1
    assert d["pages_verified"] == 4           # the bad chunk never landed
    assert received == 4 and salvaged == 0


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_windowed_link_drop_injects_each_page_once(stacks, cut):
    """The port's serving sender (a window of 4 one-page chunks) cut at
    chunk `cut` before it reads an ack: the reconnected sender's
    handshake can read the frontier while the cut connection's queued
    chunks still inject, and the chunk both send lands once. The drop is
    absorbed and the stream is the JAX single engine's."""
    S = stacks.torch
    arm(S.F, "transfer.link", {"kind": "fail_n", "n": 1, "skip": cut})

    def tx(kv):
        return S.d.RemoteTransferBackend(kv, chunk_pages=1, window_chunks=4,
                                         link_retries=3)
    toks, decode, server = asyncio.run(asyncio.wait_for(
        _disagg_one(S, PROMPT, tx, remote_server=True), TX))
    assert toks == stacks.oracle(PROMPT)
    assert S.F.REGISTRY.snapshot()["injected"] == {"transfer.link": 1}
    assert server.received_pages == 4 and decode.salvaged_prefills == 0


def _stage_inputs(kind, F):
    rng = np.random.default_rng(5)
    shape = (2, 2, 3, 8, 4)
    if kind == "int8":
        k = rng.integers(-127, 127, shape, dtype=np.int8)
        v = rng.integers(-127, 127, shape, dtype=np.int8)
        ks = rng.random(shape[:-1], dtype=np.float32)
        vs = rng.random(shape[:-1], dtype=np.float32)
        arrs = [k, v, ks, vs]
    else:
        arrs = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)] + [None, None]
    if F is tfaults:
        import torch
        arrs = [torch.from_numpy(a.copy()) if a is not None else None
                for a in arrs]
        if kind == "bf16":
            arrs[:2] = [a.to(torch.bfloat16) for a in arrs[:2]]
    elif kind == "bf16":
        import jax.numpy as jnp
        arrs[:2] = [jnp.asarray(a, jnp.bfloat16) for a in arrs[:2]]
    return arrs


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("corruptions", [1, 3])
def test_local_staging_hop_equal_to_jax(kind, corruptions):
    """The local backend's chaos staging hop on the same pages: within
    the re-fetch budget the pages come back intact after as many
    re-fetches as corruptions; past it (3 corruptions, 2 re-fetches)
    IntegrityError. The integrity counters move as JAX's."""
    from dynamo_tpu.disagg.transfer import LocalTransferBackend as JLocal
    from dynamo_tpu.runtime.integrity import STATS as JINTEGRITY
    from dynamo_tpu_torch.disagg.transfer import (
        LocalTransferBackend as TLocal, host_view,
    )
    from dynamo_tpu_torch.runtime.integrity import STATS as TINTEGRITY

    def case(F, M):
        local, stats = ((JLocal, JINTEGRITY) if F is jfaults
                        else (TLocal, TINTEGRITY))
        arrs = _stage_inputs(kind, F)
        arm(F, "remote_transfer.fetch_page",
            {"kind": "corrupt", "p": 1.0, "n": corruptions}, seed=7)
        before = stats.snapshot()

        async def main():
            try:
                out = await local._verified_stage("r", [5, 6, 7], *arrs)
            except Exception as e:  # noqa: BLE001 — the outcome compared
                return type(e).__name__
            got = [np.asarray(host_view(o) if F is tfaults else o)
                   if o is not None else None for o in out]
            want = [np.asarray(host_view(a) if F is tfaults else a)
                    if a is not None else None for a in arrs]
            return all((g is None and w is None) or (
                g.tobytes() == w.tobytes()) for g, w in zip(got, want))
        res = asyncio.run(asyncio.wait_for(main(), T))
        return res, {k: v - before[k] for k, v in stats.snapshot().items()}

    res, delta = both(case)
    if corruptions == 1:
        assert res is True and delta["refetches"] == 1
        assert delta["pages_verified"] == 3
    else:
        assert res == "IntegrityError" and delta["reprefills"] == 1
        assert delta["quarantined"] == 3 and delta["pages_verified"] == 0


@pytest.mark.parametrize("corruptions", [1, 3])
def test_local_backend_refetch_or_reprefill(stacks, corruptions):
    """A disaggregated request over each package's local backend with the
    staging hop armed: one corruption is re-fetched and injected
    verified; past the budget the decode side prefills locally. Equal
    tokens and counters in both packages, and the JAX single engine's
    stream either way."""
    def case(S):
        arm(S.F, "remote_transfer.fetch_page",
            {"kind": "corrupt", "p": 1.0, "n": corruptions})
        before = _stats(S)
        toks, decode, _ = asyncio.run(asyncio.wait_for(
            _disagg_one(S, PROMPT, S.d.LocalTransferBackend), TX))
        delta = {k: v - before[k] for k, v in _stats(S).items()}
        return toks, delta, decode.full_reprefills, decode.remote_prefills

    toks, d, reprefills, remote = both_stacks(stacks, case)
    assert toks == stacks.oracle(PROMPT) and remote == 1
    if corruptions == 1:
        assert d["refetches"] == 1 and d["pages_verified"] == 4
        assert reprefills == 0
    else:
        assert d["pages_verified"] == 0 and d["reprefills"] == 1
        assert reprefills == 1


# -- (e) the replay tool -------------------------------------------------------

def test_torch_chaos_replay_list_and_plans():
    import json
    import subprocess
    import sys

    import test_chaos as jchaos
    from tools import torch_chaos
    out = subprocess.run(
        [sys.executable, "tools/torch_chaos_replay.py", "--list"],
        capture_output=True, text=True, check=True)
    assert out.stdout.split() == list(torch_chaos.SCENARIOS) \
        == list(jchaos.SCENARIOS)
    for name, (_fn, jplan) in jchaos.SCENARIOS.items():
        dump = subprocess.run(
            [sys.executable, "tools/torch_chaos_replay.py", name,
             "--dump-plan"], capture_output=True, text=True, check=True)
        jplan = {k: v for k, v in jplan.items() if k != "sharded"}
        assert json.loads(dump.stdout) == jplan, name
