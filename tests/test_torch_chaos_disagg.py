"""The disaggregated, pool and simulated-fleet chaos scenarios on the port,
held to the JAX package (tests/test_chaos.py :324-1104, :1193-1270).

The runners are tools/torch_chaos.py's, under the JAX plans (the transfer
storm's without its `sharded` key: phase E waits for ROADMAP A9), on the
port's `tiny` float32 engines with the JAX weights (params_from_jax):

- disagg_prefill_death: a prefill worker dies holding leased queue items;
  the survivor completes every redelivered one;
- disagg_transfer_storm, phases A-D: a sender killed inside a stalled
  transfer resumes from the acked frontier, seeded link cuts, the transfer
  server restarted on a new port, a link dead for good salvaged;
- pool_host_storm: a pool host death mid-fetch, a partition, replica rot
  and a host killed mid-rebalance;
- control_plane_storm (slow, as in JAX) and fail_slow_storm (its 1000-worker
  case slow, as in JAX) on the simulated fleet;
- hedged streams on the disaggregated path.

Gates: the JAX asserts (zero client-visible errors, resumes, salvages,
fencing, the p99 margin), every stream token-identical to the JAX
single-engine oracle (exact, float32), and the simulated fleet's reports
equal to the JAX simcluster's on the same plan (the control-plane storm's
less its wall-clock fields, WALL_CLOCK). Each scenario keeps its JAX wall
deadline.
"""
import asyncio

import jax
import pytest
import torch

import test_chaos as jchaos
from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import SamplingParams as JSamplingParams
from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
from dynamo_tpu_torch.disagg.transfer import LocalTransferBackend
from dynamo_tpu_torch.disagg.worker import DisaggDecodeWorker, PrefillWorker
from dynamo_tpu_torch.frontend.reliability import (
    ReliabilityPolicy, ReliableClient,
)
from dynamo_tpu_torch.llm.worker import NativeEngineWorker, serve_llm_worker
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols.common import SamplingOptions
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.health import HEDGE_STATS, HealthScorer
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from tools import torch_chaos
from tools.torch_chaos import (
    CFG as TCFG, ENGINE_KW, ChaosEnv, client_of, pre_request, prompt_for,
    run_scenario,
)

torch.set_num_threads(1)

JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")


@pytest.fixture(autouse=True)
def disarm_after():
    for reg in (faults.REGISTRY, jchaos.faults.REGISTRY):
        reg.disarm()
        reg.reset_counters()
    yield
    for reg in (faults.REGISTRY, jchaos.faults.REGISTRY):
        reg.disarm()
        reg.reset_counters()


@pytest.fixture(scope="module")
def env():
    """The port's engines on the JAX weights, held to the JAX engine."""
    jeng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)

    def oracle(prompt, sampling, rid):
        return jeng.generate(prompt, JSamplingParams(**sampling), rid)
    return ChaosEnv(params_from_jax(jax.device_get(jeng.params), TCFG,
                                    "cpu"), oracle)


def test_plans_and_scenarios_equal_to_jax():
    jplan = dict(jchaos.TRANSFER_STORM_PLAN)
    jplan.pop("sharded")             # phase E's geometry (ROADMAP A9)
    assert torch_chaos.TRANSFER_STORM_PLAN == jplan
    for name in ("DISAGG_PLAN", "POOL_STORM_PLAN", "CONTROL_PLANE_PLAN",
                 "FAILSLOW_PLAN", "AGGREGATED_PLAN", "ROLLING_PLAN"):
        assert getattr(torch_chaos, name) == getattr(jchaos, name), name
    assert list(torch_chaos.SCENARIOS) == list(jchaos.SCENARIOS)


def test_chaos_disagg_prefill_worker_death_zero_drop(env):
    out = run_scenario("disagg_prefill_death", env=env)
    assert out["faults"]["injected"].get("queue.dequeue", 0) > 0, out


def test_chaos_disagg_transfer_storm(env):
    out = run_scenario("disagg_transfer_storm", env=env)
    assert out["salvaged_prefills"] >= 1, out
    assert out["faults"]["injected"].get("transfer.link", 0) > 0, out


def test_chaos_pool_host_storm(env):
    out = run_scenario("pool_host_storm", env=env)
    assert out["ring"]["rebalanced_pages"] > 0, out


# the control-plane storm's report fields read off the wall clock: latency
# percentiles, rates and phase durations, and the heartbeat site, whose
# keep-alive rounds are timer-driven (its hits follow the run's length)
WALL_CLOCK = {"summary": ("p50_us", "p99_us", "register_s"),
              "rolling_restart": ("storm_s", "load")}


def _without_wall_clock(rep):
    rep = {k: dict(v) for k, v in rep.items()}
    for key, fields in WALL_CLOCK.items():
        for f in fields:
            rep[key].pop(f)
    rep["faults"] = {k: {s: n for s, n in v.items()
                         if s != "discovery.heartbeat"}
                     for k, v in rep["faults"].items()}
    return rep


@pytest.mark.slow
def test_chaos_control_plane_storm():
    got = run_scenario("control_plane_storm")
    want = jchaos.run_scenario("control_plane_storm")
    assert _without_wall_clock(got) == _without_wall_clock(want)


def test_chaos_fail_slow_storm():
    got = run_scenario("fail_slow_storm")
    assert got == jchaos.run_scenario("fail_slow_storm")


@pytest.mark.slow
def test_chaos_fail_slow_storm_1000_workers():
    plan = {"failslow": {"workers": 1000, "requests": 40000, "seed": 7,
                         "min_p99_margin": 0.30}}
    rep = run_scenario("fail_slow_storm", plan)
    on = rep["detection_on"]
    assert len(on["detected_slow"]) >= rep["degraded_workers"] // 2, rep
    assert rep == jchaos.run_scenario("fail_slow_storm", plan)


# -- hedged dispatch on the disaggregated path ---------------------------------

def _hedge_policy():
    # a zero hedge delay: every request's hedge fires before its primary's
    # first frame can arrive, whatever the load (JAX's 0-10 ms window and
    # 5 s stall made the race depend on the machine's speed)
    return ReliabilityPolicy(
        hedge_enabled=True, hedge_min_delay_s=0.0, hedge_max_delay_s=0.0,
        hedge_budget_frac=1.0, hedge_burst=64, stall_timeout_s=60.0,
        dispatch_timeout_s=30.0, max_attempts=6, backoff_base_s=0.05)


def test_hedged_streams_token_identical_disagg(env):
    """Hedges race across two decode workers, each driving its own remote
    prefill through the shared queue: the loser's prefill is wasted work,
    never wrong tokens."""
    greedy = {i: env.expect(prompt_for(i), f"o{i}", max_tokens=6)
              for i in range(3)}
    sampled = {i: env.expect(prompt_for(i), f"do{i}", max_tokens=6,
                             temperature=0.8, top_k=40, seed=700 + i)
               for i in range(3)}

    async def main():
        plane = MemoryPlane()
        queue = PrefillQueue(plane.messaging, "ns", "tiny")
        router = DisaggregatedRouter(max_local_prefill_length=4,
                                     max_prefill_queue_size=32)
        transfer = LocalTransferBackend()
        decodes, rts = [], []
        for i in range(2):
            dec = DisaggDecodeWorker(
                env.engine(), plane.messaging, router, queue,
                worker_id=f"dec-{i}", prefill_timeout_s=60.0)
            transfer.register(f"dec-{i}", dec)
            await dec.start()
            decodes.append(dec)
            rt = await DistributedRuntime.create_local(plane, f"d{i}")
            await serve_llm_worker(rt, "ns", "decode", dec)
            rts.append(rt)
        prefill = PrefillWorker(
            NativeEngineWorker(env.engine()), queue, transfer,
            plane.messaging, dequeue_timeout_s=0.1, lease_s=30.0)
        await prefill.start()
        crt, client = await client_of(plane, 2, component="decode")
        HEDGE_STATS.reset()
        rel = ReliableClient(client, _hedge_policy(), health=HealthScorer())

        async def collect(request, rid):
            toks = []
            async for frame in rel.generate(request, Context(rid)):
                assert frame.get("finish_reason") != "error", (rid, frame)
                toks.extend(frame.get("token_ids", ()))
            return toks

        try:
            for i in range(3):
                toks = await collect(pre_request(f"dg{i}", prompt_for(i), 6),
                                     f"dg{i}")
                assert toks == greedy[i], (i, toks, greedy[i])
            for i in range(3):
                toks = await collect(pre_request(
                    f"ds{i}", prompt_for(i), 6,
                    SamplingOptions(temperature=0.8, top_k=40,
                                    seed=700 + i)), f"ds{i}")
                assert toks == sampled[i], (i, toks, sampled[i])
            remote = sum(d.remote_prefills for d in decodes)
        finally:
            await prefill.stop()
            for d in decodes:
                await d.stop()
            for rt in rts + [crt]:
                await rt.shutdown()
        return HEDGE_STATS.snapshot(), remote

    snap, remote = asyncio.run(asyncio.wait_for(main(), 300))
    assert snap["fired"] == 6, snap
    assert snap["wins"] + snap["losses"] == snap["fired"], snap
    assert remote >= 1, "nothing ever took the remote prefill path"
