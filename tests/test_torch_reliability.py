"""The port's reliability layer (dynamo_tpu_torch/frontend/reliability.py)
against the JAX package's.

(a) tests/test_reliability.py's 22 cases on the port: the circuit breaker
    (its sequences of allow / blocked / state on a simulated clock are
    also equal to the JAX breaker's), admission, mid-stream migration over
    the port's EchoTokenEngine, retry exhaustion, request-scoped errors,
    duplicate ids, deadlines, caller abort, the leased queue's redelivery,
    and hedging. Stall, hedge and abort cases use delays far from the
    timeouts they rely on (a worker that hangs forever, a first frame 1 s
    late against a hedge delay of at most 0.05 s), so they hold under
    parallel test workers.
(b) A migration on the port's `tiny` engine (float32, the JAX weights
    carried over by params_from_jax): a worker that stops mid-stream is
    replaced by the other, which re-prefills prompt + committed tokens; the
    stream is token-identical to the JAX single-engine stream.
(c) Two `python -m dynamo_tpu_torch.run in=endpoint ... --device cpu`
    worker processes on a port control-plane server process (tiny, float32,
    the bridged weights through `--weights`); the worker serving a stream
    is SIGKILLed mid-stream; the stream completes through the reliable
    client, token-identical to the JAX single-engine stream.
"""
import asyncio
import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import SamplingParams as JSamplingParams
from dynamo_tpu.frontend import reliability as jrel
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.frontend import reliability as trel
from dynamo_tpu_torch.frontend.reliability import (
    AdmissionControl, AdmissionShed, CircuitBreaker, ReliabilityMetrics,
    ReliabilityPolicy, ReliableClient,
)
from dynamo_tpu_torch.llm.worker import (
    EchoTokenEngine, NativeEngineWorker, serve_llm_worker,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols.common import (
    EngineOutput, FinishReason, PreprocessedRequest, StopConditions, to_wire,
)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context, FnEngine
from dynamo_tpu_torch.runtime.health import HEDGE_STATS, HealthScorer
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 120.0
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)


def run(coro, timeout=T):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def pre_request(rid, prompt, max_tokens):
    return to_wire(PreprocessedRequest(
        request_id=rid, token_ids=prompt,
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True)))


# -- circuit breaker ----------------------------------------------------------

def _breaker_script(R, clock):
    """tests/test_reliability.py's opens-after-n / re-admit sequence;
    returns what it observed at each step."""
    metrics = R.ReliabilityMetrics()
    br = R.CircuitBreaker(failure_threshold=3, cooldown_s=5.0,
                          probe_successes=2, metrics=metrics,
                          clock=lambda: clock[0])
    seen = [br.allow("w")]
    br.record_failure("w")
    br.record_failure("w")
    seen.append(br.allow("w"))
    br.record_failure("w")
    seen += [br.allow("w"), sorted(br.blocked()), br.state_of("w"),
             metrics.breaker_opens.get()]
    clock[0] = 4.9
    seen.append(br.allow("w"))
    clock[0] = 5.1
    seen += [br.allow("w"), br.state_of("w")]
    br.on_dispatch("w")
    seen.append(br.allow("w"))
    br.record_failure("w")
    seen += [br.allow("w"), metrics.breaker_opens.get()]
    clock[0] = 10.2
    seen.append(br.allow("w"))
    br.on_dispatch("w")
    br.record_success("w")
    seen.append(br.allow("w"))
    br.on_dispatch("w")
    br.record_success("w")
    seen += [br.allow("w"), sorted(br.blocked()),
             metrics.breaker_closes.get(), br.allow("other"),
             metrics.snapshot()]
    return seen


def test_breaker_opens_after_n_failures_and_readmits_after_probe():
    got = _breaker_script(trel, [0.0])
    assert got == _breaker_script(jrel, [0.0])
    assert got[:6] == [True, True, False, ["w"], "open", 1]
    assert got[6:9] == [False, True, "half_open"]
    assert got[9:12] == [False, False, 1]
    assert got[12:17] == [True, True, True, [], 1]
    assert got[17] is True


def test_breaker_abandoned_probe_is_released_not_leaked():
    clock = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown_s=1.0,
                        clock=lambda: clock[0])
    br.record_failure("w")
    clock[0] = 1.5
    assert br.allow("w")
    br.on_dispatch("w")
    assert not br.allow("w")
    br.release_probe("w")
    assert br.allow("w")
    br.on_dispatch("w")
    br.record_success("w")
    assert br.blocked() == set()


def test_breaker_success_resets_failure_streak():
    br = CircuitBreaker(failure_threshold=2, cooldown_s=1.0)
    for _ in range(5):
        br.record_failure("w")
        br.record_success("w")
    assert br.allow("w")


# -- latency-tripped SLOW state ------------------------------------------------

def test_slow_state_reduces_share_but_never_ejects():
    clock = [0.0]
    br = CircuitBreaker(slow_share=0.25, reearn_s=10.0,
                        clock=lambda: clock[0])
    assert br.dispatch_weight("w") == 1.0
    br.trip_slow("w")
    assert br.is_slow("w")
    assert br.state_of("w") == "slow"
    assert br.dispatch_weight("w") == 0.25
    assert br.allow("w")
    assert br.blocked() == set()


def test_slow_clear_reearns_traffic_linearly():
    def ramp(R):
        clock = [0.0]
        br = R.CircuitBreaker(slow_share=0.25, reearn_s=10.0,
                              clock=lambda: clock[0])
        br.trip_slow("w")
        br.clear_slow("w")
        out = [br.is_slow("w"), br.dispatch_weight("w")]
        for t in (2.5, 5.0, 7.5, 10.5, 11.0):
            clock[0] = t
            out.append(br.dispatch_weight("w"))
        return out
    got = ramp(trel)
    assert got == ramp(jrel)
    assert got[0] is False
    assert got[1] == pytest.approx(0.25)
    assert got[3] == pytest.approx(0.625)
    assert got[5:] == [1.0, 1.0]


def test_slow_is_orthogonal_to_error_states():
    clock = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown_s=5.0,
                        probe_successes=1, clock=lambda: clock[0])
    br.trip_slow("w")
    br.record_failure("w")
    assert br.state_of("w") == "open"
    assert not br.allow("w")
    clock[0] = 5.1
    br.on_dispatch("w")
    br.record_success("w")
    assert br.state_of("w") == "slow"
    assert br.dispatch_weight("w") == br.slow_share
    br.clear_slow("w")
    clock[0] = 100.0
    assert br.state_of("w") == "closed"


def test_slow_trip_is_idempotent_and_forget_clears_it():
    br = CircuitBreaker()
    br.trip_slow("w")
    br.trip_slow("w")
    assert br.is_slow("w")
    br.forget("w")
    assert not br.is_slow("w")
    assert br.dispatch_weight("w") == 1.0
    br.clear_slow("ghost")


def test_watch_delete_evicts_breaker_and_health_three_generations():
    class StubClient:
        def __init__(self):
            self.listeners = []

        def add_listener(self, fn):
            self.listeners.append(fn)

        def instance_ids(self):
            return []

    stub = StubClient()
    health = HealthScorer(min_evidence=3, enter_evals=1, exit_evals=1,
                          clock=lambda: 0.0)
    br = CircuitBreaker(failure_threshold=2, cooldown_s=1e9)
    rel = ReliableClient(stub, ReliabilityPolicy(), breaker=br,
                         health=health)
    assert stub.listeners == [rel._on_instance_event]
    for generation in range(3):
        br.record_failure("w0")
        br.record_failure("w0")
        assert not br.allow("w0"), generation
        for _ in range(4):
            for w, v in (("w0", 9.0), ("a", 0.05), ("b", 0.05),
                         ("c", 0.05)):
                health.observe(w, v)
        health.evaluate(float(generation))
        assert health.is_slow("w0"), generation
        rel._on_instance_event("delete", "w0", None)
        assert br.allow("w0"), generation
        assert br.state_of("w0") == "closed"
        assert not health.is_slow("w0"), generation
        assert health.evidence("w0") == 0, generation


def test_watch_delete_reaches_the_layer_through_the_client():
    """A real instance deletion (the worker shuts down) reaches the
    breaker through the runtime Client's watch listeners."""
    async def main():
        plane = MemoryPlane()
        wrt = await DistributedRuntime.create_local(plane, "gone")
        await serve_llm_worker(wrt, "ns", "backend", EchoTokenEngine())
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = await crt.namespace("ns").component("backend").endpoint(
            "generate").client().start()
        await client.wait_for_instances()
        br = CircuitBreaker(failure_threshold=1, cooldown_s=1e9)
        ReliableClient(client, breaker=br, health=HealthScorer())
        br.record_failure("gone")
        assert br.blocked() == {"gone"}
        await wrt.shutdown()
        for _ in range(200):
            if not br.blocked():
                break
            await asyncio.sleep(0.02)
        blocked = br.blocked()
        await crt.shutdown()
        return blocked

    assert run(main()) == set()


# -- admission control (load shedding) ----------------------------------------

def test_admission_caps_and_sheds():
    async def main():
        metrics = ReliabilityMetrics()
        adm = AdmissionControl(max_inflight=1, max_queued=1,
                               queue_timeout_s=5.0, retry_after_s=7,
                               metrics=metrics)
        await adm.acquire()
        waiter = asyncio.create_task(adm.acquire())
        await asyncio.sleep(0.01)
        with pytest.raises(AdmissionShed) as exc:
            await adm.acquire()
        assert exc.value.retry_after_s == 7
        assert metrics.shed_requests.get() == 1
        adm.release()
        await asyncio.wait_for(waiter, 1.0)
        adm.release()
        assert adm.active == 0

    run(main())


def test_admission_queue_timeout_sheds():
    async def main():
        adm = AdmissionControl(max_inflight=1, max_queued=4,
                               queue_timeout_s=0.05)
        await adm.acquire()
        with pytest.raises(AdmissionShed):
            await adm.acquire()
        adm.release()
        assert adm.active == 0

    run(main())


# -- migration / retry over the memory plane (echo workers) --------------------

class FlakyEngine(EchoTokenEngine):
    """Streams `hang_after` tokens then hangs forever: a worker whose
    engine died while its transport stayed up."""

    def __init__(self, hang_after=3):
        super().__init__()
        self.hang_after = hang_after

    async def generate(self, request, context):
        n = 0
        async for frame in super().generate(request, context):
            yield frame
            n += len(frame.token_ids)
            if n >= self.hang_after:
                await asyncio.Event().wait()


async def _serving_pair(plane, flaky_after=3):
    w1 = await DistributedRuntime.create_local(plane, "flaky")
    await serve_llm_worker(w1, "ns", "backend", FlakyEngine(flaky_after))
    w2 = await DistributedRuntime.create_local(plane, "good")
    await serve_llm_worker(w2, "ns", "backend", EchoTokenEngine())
    crt = await DistributedRuntime.create_local(plane, "cl")
    client = crt.namespace("ns").component("backend").endpoint(
        "generate").client()
    await client.start()
    await client.wait_for_instances()
    for _ in range(200):
        if len(client.instances) == 2:
            break
        await asyncio.sleep(0.02)
    return [w1, w2, crt], client


def test_mid_stream_migration_no_dup_no_gap():
    async def main():
        rts, client = await _serving_pair(MemoryPlane())
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client,
            ReliabilityPolicy(stall_timeout_s=1.0, max_attempts=6,
                              backoff_base_s=0.01),
            breaker=CircuitBreaker(failure_threshold=1, cooldown_s=60.0,
                                   metrics=metrics),
            metrics=metrics)
        prompt = list(range(10, 22))
        try:
            for i in range(4):
                toks, finishes = [], []
                async for frame in rel.generate(
                        pre_request(f"m{i}", prompt, 12), Context(f"m{i}")):
                    toks.extend(frame.get("token_ids", ()))
                    if frame.get("finish_reason"):
                        finishes.append(frame["finish_reason"])
                assert toks == prompt, (i, toks)
                assert finishes == ["length"], finishes
        finally:
            for rt in rts:
                await rt.shutdown()
        return metrics.snapshot()

    snap = run(main())
    assert snap["migrations"] >= 1
    assert snap["stall_fires"] >= 1
    assert snap["breaker_opens"] == 1


def test_dispatch_retry_exhaustion_yields_error_frame():
    async def main():
        plane = MemoryPlane()
        wrt = await DistributedRuntime.create_local(plane, "w")
        served = await serve_llm_worker(wrt, "ns", "backend",
                                        EchoTokenEngine())
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = crt.namespace("ns").component("backend").endpoint(
            "generate").client()
        await client.start()
        await client.wait_for_instances()
        await served.shutdown()
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client, ReliabilityPolicy(max_attempts=3, backoff_base_s=0.01,
                                      dispatch_timeout_s=0.5,
                                      instance_wait_s=0.2),
            metrics=metrics)
        frames = [f async for f in rel.generate(
            pre_request("x", [1, 2, 3], 3), Context("x"))]
        await crt.shutdown()
        await wrt.shutdown()
        return frames, metrics.snapshot()

    frames, snap = run(main())
    assert len(frames) == 1
    assert frames[0]["finish_reason"] == "error"
    assert snap["retries"] == 2


def test_request_scoped_error_forwarded_not_retried():
    calls = {"n": 0}

    async def rejecting(request, context):
        calls["n"] += 1
        yield EngineOutput(finish_reason=FinishReason.ERROR, retryable=False,
                           text="token id 999 outside the model vocab")

    async def main():
        plane = MemoryPlane()
        wrt = await DistributedRuntime.create_local(plane, "w")
        await serve_llm_worker(wrt, "ns", "backend", FnEngine(rejecting))
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = crt.namespace("ns").component("backend").endpoint(
            "generate").client()
        await client.start()
        await client.wait_for_instances()
        metrics = ReliabilityMetrics()
        breaker = CircuitBreaker(failure_threshold=1, metrics=metrics)
        rel = ReliableClient(client, ReliabilityPolicy(backoff_base_s=0.01),
                             breaker=breaker, metrics=metrics)
        frames = [f async for f in rel.generate(
            pre_request("oov", [1, 2, 3], 3), Context("oov"))]
        await crt.shutdown()
        await wrt.shutdown()
        return frames, breaker.blocked(), metrics.snapshot()

    frames, blocked, snap = run(main())
    assert calls["n"] == 1
    assert frames[-1]["finish_reason"] == "error"
    assert "vocab" in frames[-1]["text"]
    assert blocked == set()
    assert snap["retries"] == 0 and snap["migrations"] == 0


def _raw_and_reliable(pkg):
    """Each package's RemoteEngineSink over one counting echo worker, with
    reliability=False (the raw single dispatch) and by default (the
    ReliableClient): which layer each sink holds, the tokens and finish
    reasons each streams, and the dispatches the worker saw."""
    if pkg == "jax":
        from dynamo_tpu.llm import pipeline, worker
        from dynamo_tpu.protocols.common import (
            PreprocessedRequest as Pre, StopConditions as Stop)
        from dynamo_tpu.runtime.distributed import DistributedRuntime as DRT
        from dynamo_tpu.runtime.engine import Context as Ctx
        from dynamo_tpu.runtime.transports.memory import MemoryPlane as Plane
        R = jrel
    else:
        from dynamo_tpu_torch.llm import pipeline, worker
        from dynamo_tpu_torch.protocols.common import (
            PreprocessedRequest as Pre, StopConditions as Stop)
        DRT, Ctx, Plane, R = DistributedRuntime, Context, MemoryPlane, trel
    calls = {"n": 0}

    class Counting(worker.EchoTokenEngine):
        async def generate(self, request, context):
            calls["n"] += 1
            async for frame in super().generate(request, context):
                yield frame

    def field(frame, name):
        return frame.get(name) if isinstance(frame, dict) else getattr(
            frame, name)

    async def main():
        plane = Plane()
        wrt = await DRT.create_local(plane, "w")
        await worker.serve_llm_worker(wrt, "ns", "backend", Counting())
        crt = await DRT.create_local(plane, "cl")
        client = crt.namespace("ns").component("backend").endpoint(
            "generate").client()
        await client.start()
        await client.wait_for_instances()
        out = []
        try:
            for reliability in (False, None):
                sink = pipeline.RemoteEngineSink(client,
                                                 reliability=reliability)
                pre = Pre(request_id=f"r{reliability}",
                          token_ids=list(range(30, 39)),
                          stop=Stop(max_tokens=9, ignore_eos=True))
                toks, fin = [], []
                async for f in sink.generate(pre, Ctx(pre.request_id)):
                    toks.extend(field(f, "token_ids") or ())
                    if field(f, "finish_reason"):
                        fin.append(str(getattr(field(f, "finish_reason"),
                                               "value", field(
                                                   f, "finish_reason"))))
                out.append((isinstance(sink.reliable, R.ReliableClient),
                            sink.reliable is None, toks, fin, calls["n"]))
        finally:
            await crt.shutdown()
            await wrt.shutdown()
        return out

    return run(main())


def test_raw_sink_single_dispatch_equal_to_jax():
    got = _raw_and_reliable("torch")
    assert got == _raw_and_reliable("jax")
    toks = list(range(30, 39))
    assert got == [(False, True, toks, ["length"], 1),
                   (True, False, toks, ["length"], 2)]


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def _tengine(jax_params):
    return TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cpu",
                         params=params_from_jax(jax_params, TCFG, "cpu"))


def test_duplicate_in_flight_id_rejected_without_clobbering(jax_params):
    async def main():
        worker = await NativeEngineWorker(_tengine(jax_params)).start()
        try:
            req = pre_request("dup", list(range(10, 26)), 4)
            first_toks, dup_frames = [], []

            async def first():
                async for f in worker.generate(req, Context("dup")):
                    first_toks.extend(f.token_ids)
                    if f.finish_reason:
                        return f.finish_reason.value

            t = asyncio.create_task(first())
            for _ in range(500):
                if "dup" in worker._queues:
                    break
                await asyncio.sleep(0.005)
            async for f in worker.generate(req, Context("dup2")):
                dup_frames.append(f)
            reason = await asyncio.wait_for(t, 60)
        finally:
            await worker.stop()
        return first_toks, reason, dup_frames

    first_toks, reason, dup_frames = run(main())
    assert reason == "length" and len(first_toks) == 4
    assert dup_frames[-1].finish_reason == FinishReason.ERROR
    assert dup_frames[-1].retryable is False
    assert "already in flight" in dup_frames[-1].text


def test_deadline_propagates_and_fails_cleanly():
    seen = {}

    class WedgedEngine(EchoTokenEngine):
        async def generate(self, request, context):
            seen["remaining"] = context.time_remaining()
            await asyncio.Event().wait()
            yield  # pragma: no cover

    async def main():
        plane = MemoryPlane()
        wrt = await DistributedRuntime.create_local(plane, "w")
        await serve_llm_worker(wrt, "ns", "backend", WedgedEngine())
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = crt.namespace("ns").component("backend").endpoint(
            "generate").client()
        await client.start()
        await client.wait_for_instances()
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client, ReliabilityPolicy(stall_timeout_s=30.0,
                                      request_deadline_s=0.4,
                                      backoff_base_s=0.01),
            metrics=metrics)
        t0 = time.monotonic()
        frames = [f async for f in rel.generate(
            pre_request("d1", [1, 2, 3], 3), Context("d1"))]
        elapsed = time.monotonic() - t0
        await crt.shutdown()
        await wrt.shutdown()
        return frames, elapsed, metrics.snapshot()

    frames, elapsed, snap = run(main())
    assert frames[-1]["finish_reason"] == "error"
    assert "deadline" in frames[-1]["text"]
    assert elapsed < 20.0          # the 30 s stall timeout did not govern
    assert snap["deadline_exceeded"] == 1
    assert seen["remaining"] is not None and 0 < seen["remaining"] <= 0.4


def test_caller_abort_mid_migration_stays_cancelled():
    async def main():
        rts, client = await _serving_pair(MemoryPlane(), flaky_after=2)
        rel = ReliableClient(
            client,
            ReliabilityPolicy(stall_timeout_s=1.0, max_attempts=10,
                              backoff_base_s=0.2),
            breaker=CircuitBreaker(failure_threshold=1, cooldown_s=60.0))
        ctx = Context("a1")
        prompt = list(range(5, 17))
        toks, finishes = [], []
        try:
            async for frame in rel.generate(
                    pre_request("a1", prompt, 12), ctx):
                toks.extend(frame.get("token_ids", ()))
                if frame.get("finish_reason"):
                    finishes.append(frame["finish_reason"])
                if len(toks) == 2:
                    ctx.stop_generating()
        finally:
            for rt in rts:
                await rt.shutdown()
        return toks, finishes

    toks, finishes = run(main())
    assert toks[:2] == [5, 6]
    assert finishes[-1] == "cancelled"


# -- leased work queue ---------------------------------------------------------

def test_queue_lease_redelivery_and_ack():
    async def main():
        mq = MemoryPlane().messaging
        await mq.queue_push("q", b"item")
        got = await mq.queue_pop_leased("q", timeout=0.2, lease_s=0.1)
        assert got is not None and got[0] == b"item"
        assert await mq.queue_depth("q") == 0
        await asyncio.sleep(0.15)
        got2 = await mq.queue_pop_leased("q", timeout=1.0, lease_s=5.0)
        assert got2 is not None and got2[0] == b"item"
        assert mq.redeliveries == 1
        await mq.queue_ack("q", got2[1])
        await asyncio.sleep(0.02)
        assert await mq.queue_pop_leased("q", timeout=0.05) is None

    run(main())


def test_queue_poison_item_dropped_after_max_redeliveries():
    async def main():
        mq = MemoryPlane().messaging
        mq.MAX_REDELIVERIES = 2
        await mq.queue_push("q", b"poison")
        for _ in range(3):
            got = await mq.queue_pop_leased("q", timeout=0.5, lease_s=0.01)
            assert got is not None
            await asyncio.sleep(0.02)
        assert await mq.queue_pop_leased("q", timeout=0.05) is None
        assert mq.redeliveries == 2

    run(main())


# -- hedged dispatch -----------------------------------------------------------

class SlowFirstFrameEngine(EchoTokenEngine):
    """Healthy but laggy: every stream's first frame comes `first_frame_s`
    late (a gray-failed worker: alive, correct, slow)."""

    def __init__(self, first_frame_s=1.0):
        super().__init__()
        self.first_frame_s = first_frame_s

    async def generate(self, request, context):
        await asyncio.sleep(self.first_frame_s)
        async for frame in super().generate(request, context):
            yield frame


async def _hedge_fleet(plane, engines):
    rts = []
    for name, engine in engines:
        rt = await DistributedRuntime.create_local(plane, name)
        await serve_llm_worker(rt, "ns", "backend", engine)
        rts.append(rt)
    crt = await DistributedRuntime.create_local(plane, "cl")
    client = crt.namespace("ns").component("backend").endpoint(
        "generate").client()
    await client.start()
    await client.wait_for_instances()
    for _ in range(200):
        if len(client.instances) >= len(engines):
            break
        await asyncio.sleep(0.02)
    assert len(client.instances) == len(engines), client.instances
    rts.append(crt)
    return rts, client


def _hedge_policy(**kw):
    kw.setdefault("hedge_enabled", True)
    kw.setdefault("hedge_min_delay_s", 0.0)
    kw.setdefault("hedge_max_delay_s", 0.05)
    kw.setdefault("hedge_budget_frac", 1.0)
    kw.setdefault("hedge_burst", 16)
    kw.setdefault("stall_timeout_s", 30.0)
    kw.setdefault("backoff_base_s", 0.01)
    return ReliabilityPolicy(**kw)


def test_hedge_first_frame_wins_and_loser_is_cancelled():
    async def main():
        rts, client = await _hedge_fleet(
            MemoryPlane(), [("w1", SlowFirstFrameEngine()),
                            ("w2", SlowFirstFrameEngine())])
        HEDGE_STATS.reset()
        rel = ReliableClient(client, _hedge_policy(),
                             health=HealthScorer())
        prompt = list(range(40, 50))
        try:
            for i in range(3):
                toks = []
                async for frame in rel.generate(
                        pre_request(f"h{i}", prompt, 10), Context(f"h{i}")):
                    assert frame.get("finish_reason") != "error", frame
                    toks.extend(frame.get("token_ids", ()))
                assert toks == prompt, (i, toks)
        finally:
            for rt in rts:
                await rt.shutdown()
        return HEDGE_STATS.snapshot()

    snap = run(main())
    assert snap["fired"] == 3, snap
    assert snap["wins"] + snap["losses"] == snap["fired"], snap
    assert snap["fired_by_class"] == {"": 3}, snap


def test_hedge_no_candidate_on_single_instance_fleet():
    async def main():
        rts, client = await _hedge_fleet(
            MemoryPlane(), [("w1", SlowFirstFrameEngine())])
        HEDGE_STATS.reset()
        rel = ReliableClient(client, _hedge_policy(), health=HealthScorer())
        toks = []
        try:
            async for frame in rel.generate(
                    pre_request("h", [5, 6, 7], 3), Context("h")):
                toks.extend(frame.get("token_ids", ()))
        finally:
            for rt in rts:
                await rt.shutdown()
        return toks, HEDGE_STATS.snapshot()

    toks, snap = run(main())
    assert toks == [5, 6, 7]
    assert snap["no_candidate"] == 1, snap
    assert snap["fired"] == 0, snap


def test_hedge_budget_denied_counts_and_serves():
    async def main():
        rts, client = await _hedge_fleet(
            MemoryPlane(), [("w1", SlowFirstFrameEngine()),
                            ("w2", SlowFirstFrameEngine())])
        HEDGE_STATS.reset()
        rel = ReliableClient(
            client, _hedge_policy(hedge_budget_frac=0.0, hedge_burst=0),
            health=HealthScorer())
        toks = []
        try:
            async for frame in rel.generate(
                    pre_request("h", [5, 6, 7], 3), Context("h")):
                toks.extend(frame.get("token_ids", ()))
        finally:
            for rt in rts:
                await rt.shutdown()
        return toks, HEDGE_STATS.snapshot()

    toks, snap = run(main())
    assert toks == [5, 6, 7]
    assert snap["budget_denied"] == 1, snap
    assert snap["fired"] == 0, snap


def test_hedge_suppressed_once_tokens_commit():
    async def main():
        rts, client = await _serving_pair(MemoryPlane())
        HEDGE_STATS.reset()
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client,
            # the hedge delay is far past the stall timeout: no race ever
            # fires, which isolates the guard
            _hedge_policy(hedge_min_delay_s=60.0, hedge_max_delay_s=60.0,
                          stall_timeout_s=1.0, max_attempts=6),
            breaker=CircuitBreaker(failure_threshold=1, cooldown_s=60.0,
                                   metrics=metrics),
            metrics=metrics, health=HealthScorer())
        prompt = list(range(10, 22))
        try:
            for i in range(4):
                toks = []
                async for frame in rel.generate(
                        pre_request(f"s{i}", prompt, 12), Context(f"s{i}")):
                    toks.extend(frame.get("token_ids", ()))
                assert toks == prompt, (i, toks)
        finally:
            for rt in rts:
                await rt.shutdown()
        return metrics.snapshot(), HEDGE_STATS.snapshot()

    rsnap, hsnap = run(main())
    assert rsnap["migrations"] >= 1, rsnap
    assert hsnap["suppressed_commit"] >= 1, hsnap
    assert hsnap["fired"] == 0, hsnap


# -- (b) migration on the tiny engine, against the JAX oracle ------------------

PROMPT = [(37 * j) % 200 + 3 for j in range(20)]


def _jax_oracle(max_tokens, prompt=PROMPT, **engine_kw):
    eng = JNativeEngine(JCFG, JEngineConfig(**dict(ENGINE_KW, **engine_kw)),
                        seed=0)
    return eng.generate(prompt, JSamplingParams(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True), "o")


class StopsMidStream(NativeEngineWorker):
    """A NativeEngineWorker whose streams go silent after `after` tokens:
    the engine keeps running, the transport stays up, nothing more is
    sent (an engine wedged behind a live connection)."""

    def __init__(self, engine, after):
        super().__init__(engine)
        self.after = after

    async def generate(self, request, context):
        n = 0
        async for frame in super().generate(request, context):
            yield frame
            n += len(frame.token_ids)
            if n >= self.after:
                await asyncio.Event().wait()


def test_migration_on_tiny_engine_token_identical_to_jax(jax_params):
    oracle = _jax_oracle(24)

    async def main():
        plane = MemoryPlane()
        w1 = await StopsMidStream(_tengine(jax_params), after=7).start()
        w2 = await NativeEngineWorker(_tengine(jax_params)).start()
        r1 = await DistributedRuntime.create_local(plane, "a-stops")
        await serve_llm_worker(r1, "ns", "backend", w1)
        r2 = await DistributedRuntime.create_local(plane, "b-good")
        await serve_llm_worker(r2, "ns", "backend", w2)
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = await crt.namespace("ns").component("backend").endpoint(
            "generate").client().start()
        for _ in range(200):
            if len(client.instances) == 2:
                break
            await asyncio.sleep(0.02)
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client, ReliabilityPolicy(stall_timeout_s=2.0,
                                      backoff_base_s=0.01),
            breaker=CircuitBreaker(failure_threshold=1, cooldown_s=60.0,
                                   metrics=metrics),
            metrics=metrics)
        # round robin starts past the first sorted id: pin the first
        # dispatch to the stalling worker
        rel._rr = len(client.instance_ids()) - 1
        toks, fins = [], []
        try:
            async for f in rel.generate(pre_request("t0", PROMPT, 24),
                                        Context("t0")):
                toks.extend(f.get("token_ids", ()))
                if f.get("finish_reason"):
                    fins.append(f["finish_reason"])
        finally:
            for rt in (crt, r1, r2):
                await rt.shutdown()
            await w1.stop()
            await w2.stop()
        return toks, fins, metrics.snapshot()

    toks, fins, snap = run(main())
    assert snap["migrations"] == 1, snap
    assert fins == ["length"]
    assert toks == oracle, (toks, oracle)


# -- (c) a worker process SIGKILLed mid-stream --------------------------------

class _Proc:
    """A `python -m` child of the repo root with its output in a list."""

    def __init__(self, args, env=None):
        import threading
        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "DYN_LEASE_TTL_S": "30", **(env or {})},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def _drain(self):
        for line in iter(self.proc.stdout.readline, ""):
            self.lines.append(line.rstrip("\n"))

    def wait_line(self, prefix, timeout=120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in self.lines:
                if line.startswith(prefix):
                    return line
            assert self.proc.poll() is None, "\n".join(self.lines[-30:])
            time.sleep(0.05)
        raise AssertionError(f"no {prefix!r}: " + "\n".join(self.lines[-30:]))

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._t.join(timeout=10)


def _tiny_hf_dir(path):
    """A float32 checkpoint of `tiny`'s geometry, written by transformers:
    the port's workers (run.py --dtype float32) and the JAX oracle
    (load_model_dir(dtype="float32")) load the same files."""
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, rope_theta=500000.0, rms_norm_eps=1e-5,
        max_position_embeddings=2048, tie_word_embeddings=False,
        # about the JAX init's 1 / sqrt(fan_in) at d = 128
        initializer_range=0.1, dtype="float32")).save_pretrained(
            path, safe_serialization=True)
    return str(path)


def test_worker_process_sigkilled_mid_stream(tmp_path):
    # run.py serves the checkpoint at the card's geometry: pages of 64, 512
    # of them, 8 slots, chunks of 512, 2048 tokens of context; the oracle
    # runs the JAX engine at that geometry on the same files
    from dynamo_tpu.models.loader import load_model_dir
    ckpt = _tiny_hf_dir(tmp_path / "tiny_f32")
    jcfg, jparams = load_model_dir(ckpt, dtype="float32")
    max_tokens = 160
    oracle = JNativeEngine(
        dataclasses.replace(jcfg, decode_kernel="off"),
        JEngineConfig(page_size=64, num_pages=512, max_slots=8,
                      max_prefill_chunk=512, max_model_len=2048),
        params=jparams).generate(PROMPT, JSamplingParams(
            max_tokens=max_tokens, temperature=0.0, ignore_eos=True), "o")
    procs = []
    try:
        server = _Proc(["dynamo_tpu_torch.runtime.transports.server",
                        "--host", "127.0.0.1", "--port", "0"])
        procs.append(server)
        cp = int(server.wait_line("READY control-plane=:").rsplit(":", 1)[1])
        workers = {}
        for _ in range(2):
            w = _Proc(["dynamo_tpu_torch.run", "in=endpoint:ns.llm.generate",
                       "out=native", ckpt, "--device", "cpu",
                       "--dtype", "float32", "--control-port", str(cp)])
            procs.append(w)
            line = w.wait_line("READY endpoint=", 240)
            workers[line.split(" worker=", 1)[1].split()[0]] = w

        async def main():
            rt = await DistributedRuntime.connect("127.0.0.1", cp)
            try:
                client = await rt.namespace("ns").component("llm").endpoint(
                    "generate").client().start()
                for _ in range(500):
                    if len(client.instances) == 2:
                        break
                    await asyncio.sleep(0.02)
                dispatched = []
                raw = client.generate

                async def spy(request, context=None, instance=None, **kw):
                    dispatched.append(instance)
                    return await raw(request, context, instance=instance,
                                     **kw)
                client.generate = spy
                metrics = ReliabilityMetrics()
                rel = ReliableClient(
                    client, ReliabilityPolicy(stall_timeout_s=30.0,
                                              backoff_base_s=0.05),
                    metrics=metrics)
                toks, fins, killed = [], [], None
                async for f in rel.generate(
                        pre_request("k0", PROMPT, max_tokens),
                        Context("k0")):
                    toks.extend(f.get("token_ids", ()))
                    if f.get("finish_reason"):
                        fins.append(f["finish_reason"])
                    if killed is None and len(toks) >= 4:
                        killed = dispatched[0]
                        workers[killed].proc.send_signal(signal.SIGKILL)
                        at = len(toks)
                await client.stop()
                return toks, fins, killed, at, dispatched, metrics.snapshot()
            finally:
                await rt.shutdown()

        toks, fins, killed, at, dispatched, snap = run(main(), 240)
        assert workers[killed].proc.wait(timeout=30) == -signal.SIGKILL
        assert at < max_tokens
        assert fins == ["length"]
        assert snap["migrations"] == 1, snap
        assert len(toks) == max_tokens
        assert dispatched[-1] != killed
        assert toks == oracle, (at, toks, oracle)
    finally:
        for p in procs:
            p.kill()

