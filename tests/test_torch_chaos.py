"""Chaos scenarios on the port's `tiny` engines (float32, the JAX weights
carried over by params_from_jax), through the port's reliability layer and
fault injection, held against the JAX single-engine oracle.

The scenarios of tests/test_chaos.py :318, :531 and :1135, each under a
seeded fault plan armed on the port's failpoint registry (the same plan
dicts as the JAX scenarios; the hedged one adds transport jitter of its
own):

- aggregated: jitter on the control plane, client aborts mid-stream, and
  one of two workers killed mid-flight; every completed stream equals the
  oracle, every aborted one a prefix of it, and the survivor serves the
  fleet after the dead instance is pruned;
- rolling restart: both workers drained and replaced one at a time under
  live streaming load (the first drain's short deadline cuts streams,
  which migrate); every stream equals the oracle and the drains count on
  DRAIN_STATS;
- hedged: every request races a hedge across two workers; greedy and
  seeded-sampled streams equal the unhedged oracle.

Gates: zero client-visible errors, token identity with the oracle, and
injected-fault counts above 0.
"""
import asyncio

import jax
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import SamplingParams as JSamplingParams
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import SamplingParams
from dynamo_tpu_torch.frontend.reliability import (
    CircuitBreaker, ReliabilityMetrics, ReliabilityPolicy, ReliableClient,
)
from dynamo_tpu_torch.llm.worker import NativeEngineWorker, serve_llm_worker
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest, SamplingOptions, StopConditions, to_wire,
)
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.component import DRAIN_STATS
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.health import HEDGE_STATS, HealthScorer
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

torch.set_num_threads(1)

T = 300.0
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)

# the JAX scenarios' committed plans (tests/test_chaos.py)
AGGREGATED_PLAN = {
    "transport.send": {"seed": 11, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.02}]},
    "transport.recv": {"seed": 211, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.01}]},
}
ROLLING_PLAN = {
    "transport.send": {"seed": 31, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.005}]},
    "transport.recv": {"seed": 231, "specs": [
        {"kind": "delay", "p": 1.0, "delay_s": 0.003}]},
}
HEDGE_PLAN = {
    "transport.send": {"seed": 17, "specs": [
        {"kind": "delay", "p": 0.5, "delay_s": 0.005}]},
}


@pytest.fixture(autouse=True)
def disarm_after():
    faults.REGISTRY.disarm()
    faults.REGISTRY.reset_counters()
    yield
    faults.REGISTRY.disarm()
    faults.REGISTRY.reset_counters()


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax_params, TCFG, "cpu")


def make_engine(params):
    return TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cpu",
                         params=params)


def prompt_for(i):
    return [(37 * i + j) % 200 + 3 for j in range(12 + (i % 3) * 4)]


def pre_request(rid, prompt, max_tokens, sampling=None):
    return to_wire(PreprocessedRequest(
        request_id=rid, token_ids=prompt,
        sampling=sampling or SamplingOptions(),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True)))


_ORACLE: dict = {}


def oracle(n, max_tokens=6):
    """The JAX single-engine greedy streams of prompts 0..n-1."""
    missing = [i for i in range(n) if i not in _ORACLE]
    if missing:
        eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
        for i in missing:
            _ORACLE[i] = eng.generate(prompt_for(i), JSamplingParams(
                max_tokens=max_tokens, temperature=0.0, ignore_eos=True),
                f"o{i}")
    return {i: _ORACLE[i] for i in range(n)}


async def _fleet(plane, params, names):
    fleet = {}
    for name in names:
        rt = await DistributedRuntime.create_local(plane, name)
        w = await NativeEngineWorker(make_engine(params)).start()
        served = await serve_llm_worker(rt, "ns", "backend", w)
        fleet[name] = (rt, w, served)
    return fleet


async def _client(plane, n):
    crt = await DistributedRuntime.create_local(plane, "cl")
    client = await crt.namespace("ns").component("backend").endpoint(
        "generate").client().start()
    for _ in range(500):
        if len(client.instances) == n:
            break
        await asyncio.sleep(0.02)
    assert len(client.instances) == n, client.instances
    return crt, client


def _injected():
    return sum(faults.REGISTRY.snapshot()["injected"].values())


# -- aggregated: jitter, aborts, a worker killed mid-flight -------------------

def test_chaos_jitter_abort_and_worker_death_zero_drop(port_params):
    want = oracle(18)

    async def main():
        faults.REGISTRY.arm_from_dict(AGGREGATED_PLAN)
        plane = MemoryPlane()
        fleet = await _fleet(plane, port_params, ("w1", "w2"))
        crt, client = await _client(plane, 2)
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
        rt2, w2, _ = fleet.pop("w2")
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

        for rt, w, _ in fleet.values():
            await w.stop()
            await rt.shutdown()
        await crt.shutdown()
        return metrics.snapshot()

    snap = asyncio.run(asyncio.wait_for(main(), T))
    assert snap["migrations"] + snap["retries"] >= 1, snap
    assert _injected() > 0


# -- rolling restart under load -----------------------------------------------

def test_chaos_rolling_restart_zero_drop_token_identical(port_params):
    want = oracle(12)
    drains_before = DRAIN_STATS.drains_completed

    async def main():
        faults.REGISTRY.arm_from_dict(ROLLING_PLAN)
        plane = MemoryPlane()
        fleet = {}

        async def spawn(tag):
            rt = await DistributedRuntime.create_local(plane, tag)
            eng = make_engine(port_params)
            # warm the engine before the instance registers, as a real
            # deployment does before readiness
            await asyncio.to_thread(
                eng.generate, prompt_for(0),
                SamplingParams(max_tokens=2, temperature=0.0,
                               ignore_eos=True), f"warmup-{tag}")
            w = await NativeEngineWorker(eng).start()
            fleet[tag] = (rt, w, await serve_llm_worker(rt, "ns", "backend",
                                                        w))

        await spawn("w1")
        await spawn("w2")
        crt, client = await _client(plane, 2)
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
            rt, w, served = fleet.pop(tag)
            # the first drain's short deadline cuts streams (they migrate);
            # the second has room to finish them
            await served.drain(timeout_s=0.5 if n == 0 else 30.0,
                               poll_s=0.02)
            await w.stop()
            await rt.shutdown()
            await spawn(f"{tag}-replacement")
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
        for rt, w, _ in fleet.values():
            await w.stop()
            await rt.shutdown()
        await crt.shutdown()
        return metrics.snapshot()

    asyncio.run(asyncio.wait_for(main(), T))
    assert DRAIN_STATS.drains_completed >= drains_before + 2
    assert _injected() > 0


# -- hedged streams ------------------------------------------------------------

def _hedge_policy():
    # a zero hedge delay: every request's hedge fires before its primary's
    # first frame can arrive, however fast the engines are
    return ReliabilityPolicy(
        hedge_enabled=True, hedge_min_delay_s=0.0, hedge_max_delay_s=0.0,
        hedge_budget_frac=1.0, hedge_burst=64, stall_timeout_s=30.0,
        dispatch_timeout_s=10.0, max_attempts=6, backoff_base_s=0.05)


def test_hedged_streams_token_identical_aggregated(jax_params, port_params):
    greedy = oracle(4)
    jeng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    sampled = {i: jeng.generate(prompt_for(i), JSamplingParams(
        max_tokens=6, temperature=0.8, top_k=40, seed=500 + i,
        ignore_eos=True), f"so{i}") for i in range(4)}

    async def main():
        faults.REGISTRY.arm_from_dict(HEDGE_PLAN)
        plane = MemoryPlane()
        fleet = await _fleet(plane, port_params, ("w1", "w2"))
        crt, client = await _client(plane, 2)
        HEDGE_STATS.reset()
        rel = ReliableClient(client, _hedge_policy(), health=HealthScorer())

        async def collect(request, rid):
            toks = []
            async for frame in rel.generate(request, Context(rid)):
                assert frame.get("finish_reason") != "error", (rid, frame)
                toks.extend(frame.get("token_ids", ()))
            return toks

        try:
            for i in range(4):
                toks = await collect(pre_request(f"hg{i}", prompt_for(i), 6),
                                     f"hg{i}")
                assert toks == greedy[i], (i, toks, greedy[i])
            for i in range(4):
                toks = await collect(pre_request(
                    f"hs{i}", prompt_for(i), 6,
                    SamplingOptions(temperature=0.8, top_k=40,
                                    seed=500 + i)), f"hs{i}")
                assert toks == sampled[i], (i, toks, sampled[i])
        finally:
            for rt, w, _ in fleet.values():
                await w.stop()
                await rt.shutdown()
            await crt.shutdown()
        return HEDGE_STATS.snapshot()

    snap = asyncio.run(asyncio.wait_for(main(), T))
    assert snap["fired"] == 8, snap
    assert snap["wins"] + snap["losses"] == snap["fired"], snap
    assert _injected() > 0
