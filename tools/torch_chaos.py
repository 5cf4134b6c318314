"""The chaos scenarios on dynamo_tpu_torch: seeded fault plans over the port's
serving graph, each a plain function of a plan that asserts its own contract.

The counterpart of the scenarios in tests/test_chaos.py (:155-1106), with the
same committed plan dicts (the transfer storm's without its `sharded` key:
phase E, the sharded parallel streams, waits for ROADMAP A9). Every engine is
the `tiny` model in float32 on the CPU. A scenario takes its weights and its
oracle from a `ChaosEnv`: by default the port's own seeded weights and the
port's single engine (what tools/torch_chaos_replay.py runs, with no JAX on
the machine); tests/test_torch_chaos.py and tests/test_torch_chaos_disagg.py
pass the JAX weights and the JAX single-engine oracle, so the port is held
to the reference token for token. This module imports nothing of JAX.

Contracts, as in JAX: nothing hangs (every scenario under a wall deadline),
every greedy or seeded-sampled stream equals the oracle, and neither a worker
death, a drain, a cut link nor a corrupted page is ever client-visible.

Scenarios (`SCENARIOS`: name -> (runner, committed plan)):
- aggregated_zero_drop: jitter, aborts and a worker killed mid-flight;
- disagg_prefill_death: a prefill worker dies holding queue items, whose
  leases redeliver them to the survivor;
- disagg_transfer_storm: phases A-D over the TCP transfer plane (a sender
  killed inside a stalled transfer resumes from the acked frontier, seeded
  link cuts, the transfer server restarted on a new port, a link dead for
  good after 3 of 4 chunks salvaged);
- rolling_restart: every worker drained and replaced under load;
- control_plane_storm: the simulated fleet under watch disconnects, a store
  brown-out, event lag and heartbeat loss;
- pool_host_storm: the replicated KV pool under a host death mid-fetch, a
  partition, replica rot and a host killed mid-rebalance;
- fail_slow_storm: gray failures, detection on against off.
"""
from __future__ import annotations

import asyncio
from typing import Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import NativeEngine
from dynamo_tpu_torch.engine.scheduler import SamplingParams
from dynamo_tpu_torch.frontend.reliability import (
    CircuitBreaker, ReliabilityMetrics, ReliabilityPolicy, ReliableClient,
)
from dynamo_tpu_torch.llm.worker import NativeEngineWorker, serve_llm_worker
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest, SamplingOptions, StopConditions, to_wire,
)
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.component import DRAIN_STATS
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

CFG = ModelConfig(dtype="float32", max_model_len=512)
PAGE = 8
ENGINE_KW = dict(page_size=PAGE, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)

# -- the committed fault plans (tests/test_chaos.py :55-150, :1014) -----------

AGGREGATED_PLAN = {
    "transport.send": {"seed": 11, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.02}]},
    "transport.recv": {"seed": 211, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.01}]},
}

DISAGG_PLAN = {
    "transport.send": {"seed": 23, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.01}]},
    "transport.recv": {"seed": 223, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.005}]},
    "queue.dequeue": {"seed": 323, "specs": [
        {"kind": "delay", "p": 0.5, "delay_s": 0.01}]},
}

ROLLING_PLAN = {
    "transport.send": {"seed": 31, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.005}]},
    "transport.recv": {"seed": 231, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.003}]},
}

# the doomed sender's third chunk stalls for exactly 30 s (it is killed
# inside the stall, holding a part-committed transfer), seeded link cuts
# land on the rest, and the queue is jittered
TRANSFER_STORM_PLAN = {
    "transfer.link": {"seed": 53, "specs": [
        {"kind": "delay", "p": 1.0, "n": 1, "skip": 2,
         "delay_s": 30.0, "delay_min_s": 30.0},
        {"kind": "drop", "p": 0.12}]},
    "queue.dequeue": {"seed": 353, "specs": [
        {"kind": "delay", "p": 0.5, "delay_s": 0.01}]},
}

# `pool.remote_fetch` hit k is the k-th live replica fetch attempt: hit 2
# is the mid-fetch host death (phase A), hit 8 the rot (phase C); the
# "pool" key is the cluster's geometry, not a fault site
POOL_STORM_PLAN = {
    "pool.remote_fetch": {"seed": 61, "specs": [
        {"kind": "fail_n", "n": 1, "skip": 1},
        {"kind": "corrupt", "p": 1.0, "n": 1, "skip": 7}]},
    "pool.rebalance": {"seed": 161, "specs": [
        {"kind": "drop", "p": 0.4}]},
    "pool": {"hosts": 4, "replicas": 2, "extra_entries": 12},
}

CONTROL_PLANE_PLAN = {
    "watch.stream": {"seed": 41, "specs": [
        {"kind": "fail_n", "n": 2}]},
    "discovery.store": {"seed": 241, "specs": [
        {"kind": "fail_n", "n": 3},
        {"kind": "delay", "p": 0.05, "delay_s": 0.01}]},
    "event.plane": {"seed": 341, "specs": [
        {"kind": "delay", "p": 0.3, "delay_s": 0.8},
        {"kind": "drop", "p": 0.02}]},
    "discovery.heartbeat": {"seed": 441, "specs": [
        {"kind": "drop", "p": 0.05}]},
}

# the A/B geometry (not a fault site): the gray failures are per-worker
# seeded `slow` schedules built inside SimCluster.fail_slow_ab
FAILSLOW_PLAN = {
    "failslow": {"workers": 32, "requests": 1500, "seed": 7,
                 "min_p99_margin": 0.25},
}


class ChaosEnv:
    """What a scenario's engines and oracle come from. `params`: the
    engines' weights (default: the port's seed-0 init). `oracle(prompt,
    sampling, rid)` -> the expected tokens, `sampling` a dict of
    SamplingParams fields (default: the port's single engine on the same
    weights)."""

    def __init__(self, params=None,
                 oracle: Optional[Callable[[list, dict, str], list]] = None):
        self._params = params
        self._oracle = oracle
        self._oracle_engine = None
        self._cache: dict = {}

    @property
    def params(self):
        if self._params is None:
            self._params = NativeEngine(CFG, EngineConfig(**ENGINE_KW),
                                        device="cpu", seed=0).params
        return self._params

    def engine(self) -> NativeEngine:
        return NativeEngine(CFG, EngineConfig(**ENGINE_KW), device="cpu",
                            params=self.params)

    def expect(self, prompt, rid: str, **sampling) -> list:
        sampling = dict(dict(temperature=0.0, ignore_eos=True), **sampling)
        key = (tuple(prompt), tuple(sorted(sampling.items())))
        if key not in self._cache:
            if self._oracle is not None:
                got = self._oracle(list(prompt), sampling, rid)
            else:
                if self._oracle_engine is None:
                    self._oracle_engine = self.engine()
                got = self._oracle_engine.generate(
                    list(prompt), SamplingParams(**sampling), rid)
            self._cache[key] = list(got)
        return self._cache[key]


def prompt_for(i):
    return [(37 * i + j) % 200 + 3 for j in range(12 + (i % 3) * 4)]


def pre_request(rid, prompt, max_tokens, sampling=None):
    return to_wire(PreprocessedRequest(
        request_id=rid, token_ids=prompt,
        sampling=sampling or SamplingOptions(),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True)))


def as_dict(frame) -> dict:
    """A frame as its wire dict (the disagg worker yields EngineOutputs
    in process)."""
    return frame if isinstance(frame, dict) else to_wire(frame)


def injected() -> int:
    return sum(faults.REGISTRY.snapshot()["injected"].values())


async def fleet(plane, env: ChaosEnv, names, warm: bool = False) -> dict:
    """name -> (runtime, worker, served endpoint) of aggregated workers on
    `ns.backend`; `warm` runs one short request through each engine before
    its instance registers, as a deployment does before readiness."""
    out = {}
    for name in names:
        rt = await DistributedRuntime.create_local(plane, name)
        eng = env.engine()
        if warm:
            await asyncio.to_thread(
                eng.generate, prompt_for(0),
                SamplingParams(max_tokens=2, temperature=0.0,
                               ignore_eos=True), f"warmup-{name}")
        w = await NativeEngineWorker(eng).start()
        out[name] = (rt, w, await serve_llm_worker(rt, "ns", "backend", w))
    return out


async def client_of(plane, n: int, component: str = "backend"):
    crt = await DistributedRuntime.create_local(plane, "cl")
    client = await crt.namespace("ns").component(component).endpoint(
        "generate").client().start()
    for _ in range(500):
        if len(client.instances) == n:
            break
        await asyncio.sleep(0.02)
    assert len(client.instances) == n, client.instances
    return crt, client


# -- aggregated: jitter, aborts, a worker killed mid-flight -------------------

def run_aggregated_zero_drop(plan, env: ChaosEnv) -> dict:
    want = {i: env.expect(prompt_for(i), f"o{i}", max_tokens=6)
            for i in range(18)}

    async def main():
        faults.REGISTRY.arm_from_dict(plan)
        plane = MemoryPlane()
        workers = await fleet(plane, env, ("w1", "w2"))
        crt, client = await client_of(plane, 2)
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client,
            ReliabilityPolicy(stall_timeout_s=10.0, dispatch_timeout_s=10.0,
                              max_attempts=8, backoff_base_s=0.05,
                              backoff_max_s=0.5),
            breaker=CircuitBreaker(failure_threshold=1, cooldown_s=60.0,
                                   metrics=metrics),
            metrics=metrics)

        async def request(i, abort_after=None):
            ctx = Context()
            toks = []
            async for frame in rel.generate(
                    pre_request(f"r{i}", prompt_for(i), 6), ctx):
                assert frame.get("finish_reason") != "error", (i, frame)
                toks.extend(frame.get("token_ids", ()))
                if abort_after is not None and len(toks) >= abort_after:
                    ctx.stop_generating()
                    return "aborted", i, toks
            return "done", i, toks

        # phase 1: concurrent load with jitter and mid-stream aborts
        for kind, i, toks in await asyncio.gather(*(
                request(i, abort_after=2 if i % 4 == 3 else None)
                for i in range(8))):
            if kind == "done":
                assert toks == want[i], (i, toks, want[i])
            else:
                assert toks == want[i][:len(toks)], (i, toks)

        # phase 2: kill w2 mid-flight (engine loop and runtime gone)
        rt2, w2, _ = workers.pop("w2")
        tasks = [asyncio.create_task(request(8 + i)) for i in range(5)]
        for _ in range(500):
            if w2.engine.has_work():
                break
            await asyncio.sleep(0.005)
        await w2.stop()
        kill = asyncio.create_task(rt2.shutdown())
        for kind, i, toks in await asyncio.gather(*tasks):
            assert kind == "done" and toks == want[i], (i, toks, want[i])
        await kill

        # phase 3: the instance pruned, the survivor serves everything
        for _ in range(200):
            if len(client.instances) == 1:
                break
            await asyncio.sleep(0.05)
        assert list(client.instances) == ["w1"]
        for kind, i, toks in await asyncio.gather(*(
                request(13 + i) for i in range(5))):
            assert kind == "done" and toks == want[i], (i, toks, want[i])

        for rt, w, _ in workers.values():
            await w.stop()
            await rt.shutdown()
        await crt.shutdown()
        return metrics.snapshot()

    try:
        snap = asyncio.run(asyncio.wait_for(main(), 300))
    finally:
        faults.REGISTRY.disarm()
    assert snap["migrations"] + snap["retries"] >= 1, snap
    assert injected() > 0
    return {"reliability": snap, "faults": faults.REGISTRY.snapshot()}


# -- disaggregated: a prefill worker dies holding queue items -----------------

def run_disagg_prefill_death(plan, env: ChaosEnv) -> dict:
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.transfer import LocalTransferBackend
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )

    prompts = {i: list(range(100 + 7 * i, 120 + 7 * i)) for i in range(4)}
    want = {i: env.expect(p, f"o{i}", max_tokens=6)
            for i, p in prompts.items()}

    class HoldTransfer(LocalTransferBackend):
        """Wedges every transfer: the worker using it dies mid-item."""

        async def send_pages(self, *a, **k):
            await asyncio.Event().wait()

    async def main():
        faults.REGISTRY.arm_from_dict(plan)
        plane = MemoryPlane()
        queue = PrefillQueue(plane.messaging, "ns", "tiny")
        router = DisaggregatedRouter(max_local_prefill_length=4,
                                     max_prefill_queue_size=16)
        decode = DisaggDecodeWorker(
            env.engine(), plane.messaging, router, queue,
            worker_id="dec-0", prefill_timeout_s=60.0)
        transfer = LocalTransferBackend()
        transfer.register("dec-0", decode)
        doomed = PrefillWorker(
            NativeEngineWorker(env.engine()), queue, HoldTransfer(),
            plane.messaging, dequeue_timeout_s=0.1, lease_s=0.5)
        survivor = PrefillWorker(
            NativeEngineWorker(env.engine()), queue, transfer,
            plane.messaging, dequeue_timeout_s=0.1, lease_s=5.0)
        await decode.start()
        await doomed.start()

        async def request(i):
            toks = []
            async for frame in decode.generate(
                    pre_request(f"r{i}", prompts[i], 6), Context(f"r{i}")):
                frame = as_dict(frame)
                assert frame.get("finish_reason") != "error", frame
                toks.extend(frame.get("token_ids", ()))
            return i, toks

        tasks = [asyncio.create_task(request(i)) for i in prompts]
        # kill the doomed worker once it holds dequeued items: without
        # leases they would be lost and the streams would time out
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 30
        while not doomed._handling:
            assert loop.time() < deadline, \
                "the doomed prefill worker never picked up work"
            await asyncio.sleep(0.02)
        await doomed.stop()
        await survivor.start()
        for i, toks in await asyncio.wait_for(asyncio.gather(*tasks), 300):
            assert toks == want[i], (i, toks, want[i])
        out = (plane.messaging.redeliveries, survivor.completed,
               decode.remote_prefills)
        await survivor.stop()
        await decode.stop()
        return out

    try:
        redelivered, completed, remote = asyncio.run(
            asyncio.wait_for(main(), 300))
    finally:
        faults.REGISTRY.disarm()
    assert remote == len(prompts)          # everything went remote
    assert redelivered >= 1, "no queue item was ever redelivered"
    assert completed >= 1, "the survivor never completed a redelivered item"
    return {"redelivered": redelivered, "survivor_completed": completed,
            "remote_prefills": remote, "faults": faults.REGISTRY.snapshot()}


# -- rolling restart under load -----------------------------------------------

def run_rolling_restart(plan, env: ChaosEnv) -> dict:
    want = {i: env.expect(prompt_for(i), f"o{i}", max_tokens=6)
            for i in range(12)}
    drains_before = DRAIN_STATS.drains_completed

    async def main():
        faults.REGISTRY.arm_from_dict(plan)
        plane = MemoryPlane()
        workers = await fleet(plane, env, ("w1", "w2"), warm=True)
        crt, client = await client_of(plane, 2)
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client,
            ReliabilityPolicy(stall_timeout_s=10.0, dispatch_timeout_s=10.0,
                              max_attempts=8, backoff_base_s=0.05,
                              backoff_max_s=0.5),
            breaker=CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                                   metrics=metrics),
            metrics=metrics)

        async def request(i):
            toks = []
            async for frame in rel.generate(
                    pre_request(f"r{i}", prompt_for(i), 6), Context()):
                assert frame.get("finish_reason") != "error", (i, frame)
                toks.extend(frame.get("token_ids", ()))
            return i, toks

        tasks = [asyncio.create_task(request(i)) for i in range(12)]
        await asyncio.sleep(0.05)
        for n, tag in enumerate(("w1", "w2")):
            rt, w, served = workers.pop(tag)
            # the first drain's short deadline cuts streams (they migrate);
            # the second has room to finish them
            await served.drain(timeout_s=0.5 if n == 0 else 30.0,
                               poll_s=0.02)
            await w.stop()
            await rt.shutdown()
            workers.update(await fleet(plane, env, (f"{tag}-replacement",),
                                       warm=True))
        for i, toks in await asyncio.gather(*tasks):
            assert toks == want[i], (i, toks, want[i])

        for _ in range(200):
            if sorted(client.instance_ids()) == ["w1-replacement",
                                                 "w2-replacement"]:
                break
            await asyncio.sleep(0.05)
        assert sorted(client.instance_ids()) == ["w1-replacement",
                                                 "w2-replacement"]
        i, toks = await request(11)
        assert toks == want[11]
        for rt, w, _ in workers.values():
            await w.stop()
            await rt.shutdown()
        await crt.shutdown()
        return metrics.snapshot()

    try:
        snap = asyncio.run(asyncio.wait_for(main(), 300))
    finally:
        faults.REGISTRY.disarm()
    assert DRAIN_STATS.drains_completed >= drains_before + 2
    assert injected() > 0
    return {"reliability": snap, "drains": DRAIN_STATS.snapshot(),
            "faults": faults.REGISTRY.snapshot()}


# -- disaggregated: the transfer storm over the TCP transfer plane ------------

def run_disagg_transfer_storm(plan, env: ChaosEnv) -> dict:
    """Phases A-D of the JAX storm (chunk_pages 1: every transfer is a
    4-chunk stream; window_chunks 1: at any cut the frontier equals the
    chunks acked):

    A. a prefill worker is killed inside its stalled transfer after
       chunks committed; the re-leased item's new sender resumes from the
       acked frontier;
    B. seeded link cuts on the survivor, each absorbed by a resume;
    C. the decode side's transfer server restarts on a new port, and the
       sender resolves the endpoint again;
    D. the link dies for good after 3 of 4 chunks committed: the decode
       side salvages the committed prefix.

    Contract: every stream equals the oracle, >= 1 resume, >= 1 salvaged
    page, and no majority-committed transfer is re-prefilled from zero."""
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.remote_transfer import (
        KvTransferServer, RemoteTransferBackend,
    )
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )
    from dynamo_tpu_torch.runtime.integrity import XFER_STATS
    from dynamo_tpu_torch.runtime.tracing import TRACER

    # 30-token prompts: 4 pages, 4 one-page chunks a transfer
    prompts = {i: [(11 * i + j) % 200 + 3 for j in range(30)]
               for i in range(8)}
    want = {i: env.expect(p, f"o{i}", max_tokens=4)
            for i, p in prompts.items()}
    r0, s0 = XFER_STATS.resumes, XFER_STATS.salvaged_pages
    plan = {k: v for k, v in plan.items() if k != "sharded"}

    async def main():
        faults.REGISTRY.arm_from_dict(plan)
        plane = MemoryPlane()
        queue = PrefillQueue(plane.messaging, "ns", "tiny")
        router = DisaggregatedRouter(max_local_prefill_length=4,
                                     max_prefill_queue_size=32)
        decode = DisaggDecodeWorker(
            env.engine(), plane.messaging, router, queue,
            worker_id="dec-0", prefill_timeout_s=90.0)
        server = await KvTransferServer(decode, "dec-0").start()
        await server.register(plane.kv)
        doomed = PrefillWorker(
            NativeEngineWorker(env.engine()), queue,
            RemoteTransferBackend(plane.kv, chunk_pages=1, window_chunks=1),
            plane.messaging, dequeue_timeout_s=0.1, max_inflight=1,
            lease_s=0.5)
        surv_tx = RemoteTransferBackend(plane.kv, chunk_pages=1,
                                        window_chunks=1)
        survivor = PrefillWorker(
            NativeEngineWorker(env.engine()), queue, surv_tx,
            plane.messaging, dequeue_timeout_s=0.1, lease_s=10.0)
        await decode.start()
        await doomed.start()

        async def request(i):
            ctx = Context(f"r{i}")
            # the request's trace roots here (no frontend in this stack),
            # so a traced replay captures the transfer's tree
            ctx.trace = TRACER.start_trace(f"storm-r{i}")
            toks = []
            async for frame in decode.generate(
                    pre_request(f"r{i}", prompts[i], 4), ctx):
                frame = as_dict(frame)
                assert frame.get("finish_reason") != "error", frame
                toks.extend(frame.get("token_ids", ()))
            return i, toks

        # A: kill the doomed sender inside its stall, after commits
        tasks = [asyncio.create_task(request(i)) for i in range(3)]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60
        while not any(s.committed_pages >= 2
                      for s in server._sessions.values()):
            assert loop.time() < deadline, \
                "no chunk ever committed before the kill"
            await asyncio.sleep(0.02)
        await doomed.stop()
        await survivor.start()
        for i, toks in await asyncio.wait_for(asyncio.gather(*tasks), 180):
            assert toks == want[i], (i, toks, want[i])
        assert plane.messaging.redeliveries >= 1, \
            "the dead sender's lease never redelivered"

        # B: seeded link cuts under load on the survivor
        for i, toks in await asyncio.wait_for(asyncio.gather(
                *(request(3 + i) for i in range(3))), 180):
            assert toks == want[i], (i, toks, want[i])

        # C: the transfer server restarts on a new port
        await server.stop()
        server2 = await KvTransferServer(decode, "dec-0").start()
        await server2.register(plane.kv)
        assert server2.port != server.port
        i, toks = await asyncio.wait_for(request(6), 180)
        assert toks == want[i], (i, toks, want[i])
        assert server2.received_pages >= 1   # re-resolved, not wedged

        # D: the link dies for good after 3 of 4 chunks committed
        faults.REGISTRY.disarm("transfer.link")
        faults.REGISTRY.arm("transfer.link", faults.FaultSchedule(
            plan["transfer.link"]["seed"],
            [faults.FaultSpec("fail_n", n=1000, skip=3)]))
        surv_tx.link_retries = 1
        i, toks = await asyncio.wait_for(request(7), 180)
        assert toks == want[i], (i, toks, want[i])
        faults.REGISTRY.disarm("transfer.link")
        assert decode.salvaged_prefills >= 1, "phase D never salvaged"
        assert decode.majority_committed_full_reprefills == 0, \
            "a majority-committed transfer was re-prefilled from zero"
        summary = {
            "remote_prefills": decode.remote_prefills,
            "salvaged_prefills": decode.salvaged_prefills,
            "full_reprefills": decode.full_reprefills,
            "redeliveries": plane.messaging.redeliveries,
            "resumes": XFER_STATS.resumes - r0,
            "salvaged_pages": XFER_STATS.salvaged_pages - s0,
        }
        await survivor.stop()
        await decode.stop()
        await server2.stop()
        await surv_tx.close()
        return summary

    try:
        summary = asyncio.run(asyncio.wait_for(main(), 300))
    finally:
        faults.REGISTRY.disarm()
    assert summary["resumes"] >= 1, summary
    assert summary["salvaged_pages"] >= 1, summary
    summary["faults"] = faults.REGISTRY.snapshot()
    return summary


# -- the cross-host KV pool service -------------------------------------------

def run_pool_host_storm(plan, env: ChaosEnv) -> dict:
    """A. a pool host dies serving a page mid-walk: the walk fails over to
    the sibling replica, frontier-exact; B. the warm prefix's first owner
    is partitioned: a seeded-sampled stream walks past it, and a publish
    owned by it lands quorum-1; C. bytes rot on one replica: it quarantines
    the page locally and the sibling serves; D. a host joins and an
    original one is killed mid-rebalance under seeded copy drops: repair
    converges and no stale-epoch write lands. Every stream equals the
    oracle (greedy and seeded-sampled)."""
    from dynamo_tpu_torch.engine.kv_cache import page_hash
    from dynamo_tpu_torch.engine.pool_service import (
        REMOTE_STATS, RING_STATS, ClusterKvPool, KvPoolHost,
    )
    from dynamo_tpu_torch.runtime.integrity import STATS as INTEGRITY

    plan = dict(plan)
    geo = plan.pop("pool", {"hosts": 4, "replicas": 2, "extra_entries": 12})
    REMOTE_STATS.reset()
    RING_STATS.reset()
    prompt = [(13 * j) % 200 + 3 for j in range(32)]   # exactly 4 pages
    gp = dict(max_tokens=4, temperature=0.0, ignore_eos=True)
    sp = dict(max_tokens=4, temperature=0.9, top_k=8, seed=1234,
              ignore_eos=True)
    want_g = env.expect(prompt, "og", **gp)
    want_s = env.expect(prompt, "os", **sp)

    def arrs(i):
        r = np.random.default_rng(i)
        shape = (2, 2, 2, 4)
        return (torch.from_numpy(r.standard_normal(shape).astype(np.float32)),
                torch.from_numpy(r.standard_normal(shape).astype(np.float32)))

    def consumer(tag):
        e = env.engine()
        e.attach_kv_pool(cluster, tag)
        return e

    faults.REGISTRY.arm_from_dict(plan)
    try:
        cluster = ClusterKvPool(replicas=geo["replicas"])
        for i in range(geo["hosts"]):
            cluster.add_host(KvPoolHost(f"ph{i}", capacity_pages=256))
        cluster.run_rebalance()          # drain the join events (empty pool)
        seeder = consumer("seed")
        seeder.generate(prompt, SamplingParams(**gp), "seed-r")
        seeder.drain_kv_events()
        seeder._pool_stream.drain()
        # the 3 matched prefix pages' chained content hashes
        phashes, parent = [], 0
        for p in range(3):
            parent = page_hash(parent, prompt[p * PAGE:(p + 1) * PAGE])
            phashes.append(parent)

        # A: a host death mid-fetch -> frontier-exact failover
        a = consumer("A")
        assert a.generate(prompt, SamplingParams(**gp), "a") == want_g
        assert a.scheduler.pool_fetched_pages == 3   # no page fell back
        assert REMOTE_STATS.fetch_failovers == 1
        assert REMOTE_STATS.fetch_exhausted == 0

        # B: the warm prefix's first owner partitioned
        h0 = phashes[0]
        part = cluster.membership.owners_for(h0)[0]
        cluster.partition_host(part)
        f0 = REMOTE_STATS.fetch_failovers
        b = consumer("B")
        assert b.generate(prompt, SamplingParams(**sp), "b") == want_s
        assert b.scheduler.pool_fetched_pages == 3
        assert REMOTE_STATS.fetch_failovers > f0     # walked past it
        pub_sh = 0x9000
        while part not in cluster.membership.owners_for(pub_sh):
            pub_sh += 1
        assert cluster.publish("w-pub", pub_sh, 0, pub_sh,
                               arrs(pub_sh)) == "new"
        assert REMOTE_STATS.publish_quorum_degraded >= 1
        cluster.partition_host(part, False)          # heal

        # C: rot on one replica -> replica-local quarantine
        q0 = INTEGRITY.quarantined
        owners_before = set(cluster.owner_hosts(h0))
        assert len(owners_before) == 2
        assert cluster.fetch(h0) is not None         # the sibling serves
        assert INTEGRITY.quarantined == q0 + 1
        assert len(owners_before - set(cluster.owner_hosts(h0))) == 1

        # repair the degraded publish and the rot-dropped copy first, so
        # no more than R-1 owners of an entry ever die under-repaired
        for _ in range(40):
            if cluster.run_rebalance()["under_replicated"] == 0:
                break
        assert not cluster.under_replicated()

        # D: a join, then an original host killed mid-rebalance
        extra = []
        for i in range(geo["extra_entries"]):
            sh = 0x5000 + i
            assert cluster.publish("w-pub", sh, 0, i, arrs(i)) == "new"
            extra.append(sh)
        cluster.add_host(KvPoolHost("ph-new", capacity_pages=256))
        cluster.run_rebalance(budget=6)              # handoff mid-flight
        victim = [h for h in cluster.membership.live_hosts()
                  if h != "ph-new"][0]
        cluster.kill_host(victim)
        for _ in range(60):
            if cluster.run_rebalance(budget=8)["under_replicated"] == 0:
                break
        assert not cluster.under_replicated()
        target = min(geo["replicas"], len(cluster.membership.live_hosts()))
        for sh in extra + phashes + [pub_sh]:
            assert len(cluster.owner_hosts(sh)) >= target, hex(sh)
            assert cluster.fetch(sh) is not None, hex(sh)
        assert REMOTE_STATS.stale_epoch_landed == 0
        assert RING_STATS.rebalanced_pages > 0

        # a fresh consumer over the converged cluster, fully pool-served
        e = consumer("E")
        assert e.generate(prompt, SamplingParams(**gp), "e") == want_g
        assert e.scheduler.pool_fetched_pages == 3
        return {"remote": REMOTE_STATS.snapshot(),
                "ring": RING_STATS.snapshot(),
                "hosts": {hid: len(h) for hid, h in cluster._hosts.items()},
                "faults": faults.REGISTRY.snapshot()}
    finally:
        faults.REGISTRY.disarm()
        REMOTE_STATS.reset()
        RING_STATS.reset()
        INTEGRITY.reset()


# -- the simulated fleet -------------------------------------------------------

def run_control_plane_storm(plan, env: ChaosEnv = None) -> dict:
    """A simulated fleet of 48 under watch disconnects, a discovery-store
    brown-out, event-plane lag, reorder and drops, and heartbeat loss,
    while a rolling restart cycles a quarter of it under schedule load.
    Contract: zero scheduling errors, zero picks past a fence, the fleet
    converges, and the event lag round-trips the degraded mode."""
    from dynamo_tpu_torch.runtime.cpstats import CP_STATS
    from dynamo_tpu_torch.runtime.simcluster import SimCluster, SimConfig
    CP_STATS.reset()

    async def main():
        sim = await SimCluster(SimConfig(
            workers=48, streams=384, seed=23, lease_ttl_s=2.0,
            scrape_interval_s=0.1, degraded_lag_s=0.5)).start()
        try:
            faults.REGISTRY.arm_from_dict(plan)
            await sim.run_load(300)
            rr = await sim.storm_rolling_restart(fraction=0.25,
                                                 load_calls=300)
            assert rr["errors"] == 0 and rr["dead_picks"] == 0, rr
            lag = await sim.storm_event_lag(delay_s=1.0, load_calls=150)
            faults.REGISTRY.disarm()
            assert lag["entered"] and lag["exited"], lag
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 15
            while len(sim.client.instances) < len(sim.workers):
                assert loop.time() < deadline, \
                    (len(sim.client.instances), len(sim.workers))
                await asyncio.sleep(0.1)
            summary = sim.summary()
            assert summary["schedule_errors"] == 0, summary
            assert summary["dead_picks"] == 0, summary
            return {"summary": summary, "rolling_restart": rr,
                    "event_lag": lag, "faults": faults.REGISTRY.snapshot()}
        finally:
            faults.REGISTRY.disarm()
            await sim.stop()

    return asyncio.run(asyncio.wait_for(main(), 180))


def run_fail_slow_storm(plan, env: ChaosEnv = None) -> dict:
    """Gray failures: a seeded fraction of a simulated fleet degrades
    through the persistent `slow` kind, and the detection plane (health
    scorer, SLOW dispatch share, hedging) runs against a detection-blind
    baseline over the same seeded requests. Contracts: p99 TTFT beats the
    baseline by the plan's margin, zero dropped streams in both modes,
    zero false ejections, and the SLOW timeline replays bit-identically."""
    from dynamo_tpu_torch.runtime.simcluster import SimCluster, SimConfig
    plan = dict(plan)
    geo = dict(plan.pop("failslow", {}))
    workers = int(geo.get("workers", 32))
    requests = int(geo.get("requests", 1500))
    seed = int(geo.get("seed", 7))
    min_margin = float(geo.get("min_p99_margin", 0.25))

    async def main():
        faults.REGISTRY.arm_from_dict(plan)
        # a virtual-time model over the worker id set: no control plane
        sim = SimCluster(SimConfig(workers=workers, seed=seed))
        sim.workers = {f"w{i:04d}": None for i in range(workers)}
        try:
            return await sim.fail_slow_ab(requests=requests)
        finally:
            faults.REGISTRY.disarm()

    rep = asyncio.run(asyncio.wait_for(main(), 300))
    on, off = rep["detection_on"], rep["detection_off"]
    assert rep["p99_improvement"] >= min_margin, (
        rep["p99_improvement"], min_margin)
    assert on["dropped"] == 0 and off["dropped"] == 0, (on, off)
    assert on["false_ejections"] == [], on["false_ejections"]
    assert rep["timeline_replay_ok"], "SLOW timeline diverged on replay"
    assert rep["degraded_workers"] >= 1, rep
    assert on["detected_slow"], rep
    assert on["hedges_fired"] >= 1, on
    trimmed = dict(rep)
    trimmed["detection_on"] = dict(on)
    trimmed["detection_off"] = {k: v for k, v in off.items()
                                if k != "timeline"}
    return trimmed


# name -> (runner, committed default plan): tools/torch_chaos_replay.py's
# menu, in the JAX package's order
SCENARIOS = {
    "aggregated_zero_drop": (run_aggregated_zero_drop, AGGREGATED_PLAN),
    "disagg_prefill_death": (run_disagg_prefill_death, DISAGG_PLAN),
    "disagg_transfer_storm": (run_disagg_transfer_storm,
                              TRANSFER_STORM_PLAN),
    "rolling_restart": (run_rolling_restart, ROLLING_PLAN),
    "control_plane_storm": (run_control_plane_storm, CONTROL_PLANE_PLAN),
    "pool_host_storm": (run_pool_host_storm, POOL_STORM_PLAN),
    "fail_slow_storm": (run_fail_slow_storm, FAILSLOW_PLAN),
}


def run_scenario(name: str, plan=None, env: Optional[ChaosEnv] = None):
    """Run one named scenario under `plan` (default: its committed plan).
    Raises AssertionError on a contract violation; returns a summary."""
    fn, default_plan = SCENARIOS[name]
    return fn(plan if plan is not None else default_plan, env or ChaosEnv())
