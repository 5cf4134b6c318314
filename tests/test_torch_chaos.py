"""Chaos scenarios on the port's `tiny` engines (float32, the JAX weights
carried over by params_from_jax), through the port's reliability layer and
fault injection, held against the JAX single-engine oracle.

The aggregated scenarios of tests/test_chaos.py :155 and :414 run through
their runners in tools/torch_chaos.py (the same plan dicts, armed on the
port's failpoint registry); the hedged one (:1135) adds transport jitter of
its own:

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

The disaggregated, pool and simulated-fleet scenarios are in
tests/test_torch_chaos_disagg.py. Gates: zero client-visible errors, token
identity with the oracle, and injected-fault counts above 0.
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
from dynamo_tpu_torch.frontend.reliability import (
    ReliabilityPolicy, ReliableClient,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols.common import SamplingOptions
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.health import HEDGE_STATS, HealthScorer
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from tools.torch_chaos import (
    AGGREGATED_PLAN, CFG as TCFG, ENGINE_KW, ROLLING_PLAN, ChaosEnv,
    client_of, fleet, injected, pre_request, prompt_for, run_scenario,
)

torch.set_num_threads(1)

T = 300.0
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
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
def env(jax_params):
    """The port's engines on the JAX weights, held to the JAX engine."""
    jeng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)

    def oracle(prompt, sampling, rid):
        return jeng.generate(prompt, JSamplingParams(**sampling), rid)
    return ChaosEnv(params_from_jax(jax_params, TCFG, "cpu"), oracle)


def test_plans_equal_to_jax():
    import test_chaos as jchaos
    assert AGGREGATED_PLAN == jchaos.AGGREGATED_PLAN
    assert ROLLING_PLAN == jchaos.ROLLING_PLAN


# -- aggregated: jitter, aborts, a worker killed mid-flight -------------------

def test_chaos_jitter_abort_and_worker_death_zero_drop(env):
    run_scenario("aggregated_zero_drop", env=env)


# -- rolling restart under load -----------------------------------------------

def test_chaos_rolling_restart_zero_drop_token_identical(env):
    run_scenario("rolling_restart", env=env)


# -- hedged streams ------------------------------------------------------------

def _hedge_policy():
    # a zero hedge delay: every request's hedge fires before its primary's
    # first frame can arrive, however fast the engines are
    return ReliabilityPolicy(
        hedge_enabled=True, hedge_min_delay_s=0.0, hedge_max_delay_s=0.0,
        hedge_budget_frac=1.0, hedge_burst=64, stall_timeout_s=30.0,
        dispatch_timeout_s=10.0, max_attempts=6, backoff_base_s=0.05)


def test_hedged_streams_token_identical_aggregated(env):
    greedy = {i: env.expect(prompt_for(i), f"o{i}", max_tokens=6)
              for i in range(4)}
    sampled = {i: env.expect(prompt_for(i), f"so{i}", max_tokens=6,
                             temperature=0.8, top_k=40, seed=500 + i)
               for i in range(4)}

    async def main():
        faults.REGISTRY.arm_from_dict(HEDGE_PLAN)
        plane = MemoryPlane()
        workers = await fleet(plane, env, ("w1", "w2"))
        crt, client = await client_of(plane, 2)
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
            for rt, w, _ in workers.values():
                await w.stop()
                await rt.shutdown()
            await crt.shutdown()
        return HEDGE_STATS.snapshot()

    snap = asyncio.run(asyncio.wait_for(main(), T))
    assert snap["fired"] == 8, snap
    assert snap["wins"] + snap["losses"] == snap["fired"], snap
    assert injected() > 0
