"""The port's tracer (dynamo_tpu_torch/runtime/tracing.py) against the JAX
package's (dynamo_tpu/runtime/tracing.py).

(a) The wire form of a trace context, the sampling verdicts (a pure
    function of seed and trace id), the bounded ring (oldest records
    overwritten) and the rule that an errored span survives sampling out:
    equal to the JAX tracer's on the same inputs.
(b) The spans the reliability layer records for one request that stalls
    mid-stream and migrates (one echo worker that goes silent after 3
    tokens on its first stream): the same span names, attributes, errors
    and parent links as the JAX layer's, and the attempt outcomes agree
    with the migration counter. Switched off, the tracer records nothing.
(c) The DYN_TRACE* knobs (read in a fresh process of each package),
    `scope_span`, `defer_phase`, `reset`, `dropped` and `chrome_trace`:
    equal to JAX's (the chrome export but for its `metadata.source`).
(d) One disaggregated request (HTTP frontend -> ReliableClient ->
    DisaggDecodeWorker with a remote prefill over the leased queue and the
    local transfer backend) in each package on the same weights: exactly
    one request trace, one tree holding every leg (worker.generate
    included), the transfer's bytes and pages, `scope:engine` records,
    the decode.emit counts adding up to the tokens served, and the
    multiset of (span, parent span) names equal to JAX's. Tracing on and
    off serve the same tokens.
(e) The scope spans off the request path (`pool.fetch.remote`,
    `pool.rebalance`, `router.schedule`) equal to JAX's on the same seeded
    operations; the profiler hook's one-owner rule; the explain tool
    rendering the committed JAX artifacts as tools/trace_explain.py does;
    and `torch_chaos_replay.py --trace` writing its artifacts.
"""
import asyncio
import collections
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dynamo_tpu.frontend import reliability as jrel
from dynamo_tpu.llm import worker as jworker
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JPre, StopConditions as JStop,
)
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu.runtime.distributed import DistributedRuntime as JDRT
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.transports.memory import MemoryPlane as JPlane
from dynamo_tpu_torch.frontend import reliability as trel
from dynamo_tpu_torch.llm import worker as tworker
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest as TPre, StopConditions as TStop, to_wire,
)
from dynamo_tpu_torch.runtime import tracing as ttracing
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime as TDRT
from dynamo_tpu_torch.runtime.engine import Context as TContext
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane as TPlane

T = 60.0
LAYER_SPANS = ("schedule", "attempt", "hedge")

PKG = {
    "jax": dict(rel=jrel, worker=jworker, tracing=jtracing, DRT=JDRT,
                Context=JContext, Plane=JPlane,
                pre=lambda rid, p, n: JPre(
                    request_id=rid, token_ids=p,
                    stop=JStop(max_tokens=n, ignore_eos=True)
                ).model_dump(exclude_none=True)),
    "torch": dict(rel=trel, worker=tworker, tracing=ttracing, DRT=TDRT,
                  Context=TContext, Plane=TPlane,
                  pre=lambda rid, p, n: to_wire(TPre(
                      request_id=rid, token_ids=p,
                      stop=TStop(max_tokens=n, ignore_eos=True)))),
}


def _tracer(tracing, **kw):
    return tracing.Tracer().configure(**kw)


def test_trace_context_wire_form_equal_to_jax():
    def forms(tracing):
        TC = tracing.TraceContext
        out = [TC("t1", "s1", True).to_wire(), TC("t2").to_wire(),
               TC("t3", "s3", False).to_wire()]
        for d in (None, {}, {"sid": "x"}, {"tid": "a"},
                  {"tid": 7, "sid": 9, "s": 0}, {"tid": "b", "s": 1}):
            c = TC.from_wire(d)
            out.append(None if c is None
                       else (c.trace_id, c.span_id, c.sampled))
        return out
    assert forms(ttracing) == forms(jtracing)


def test_sampling_verdicts_equal_to_jax():
    ids = [f"req-{i}" for i in range(400)]
    for rate, seed in ((0.3, 7), (0.5, 0), (0.0, 1), (1.0, 2)):
        got = [_tracer(ttracing, enabled=True, sample_rate=rate,
                       seed=seed).sampled(i) for i in ids]
        assert got == [_tracer(jtracing, enabled=True, sample_rate=rate,
                               seed=seed).sampled(i) for i in ids]
        if 0.0 < rate < 1.0:
            assert 0 < sum(got) < len(ids)
    t = _tracer(ttracing, enabled=True, sample_rate=0.3, seed=7)
    j = _tracer(jtracing, enabled=True, sample_rate=0.3, seed=7)
    assert [t.start_trace(i).sampled for i in ids] == \
        [j.start_trace(i).sampled for i in ids]
    assert _tracer(ttracing, enabled=False).start_trace("x") is None


def _ring_and_sampling(tracing):
    """Twelve events into a ring of five, then one sampled-out trace's
    plain and errored spans: what drain returns, minus ids and times."""
    tr = _tracer(tracing, enabled=True, ring_capacity=5)
    ctx = tr.start_trace("ring")
    for i in range(12):
        tr.event(f"e{i}", ctx, i=i)
    ring = [(r["name"], r["attrs"]) for r in tr.drain()]
    tr.configure(sample_rate=0.0)
    out = tr.start_trace("out")
    with tr.span("kept-out", out):
        pass
    try:
        with tr.span("failed", out, step=1):
            raise ValueError
    except ValueError:
        pass
    s = tr.begin_span("manual", out)
    tr.end_span(s, error=True, why="x")
    tr.record_span("measured", out, 0.5)
    tr.event("instant", out)
    errs = [(r["name"], r["attrs"], r["error"]) for r in tr.drain()]
    return ring, errs, out.sampled, tr.drain()


def test_ring_bound_and_error_survival_equal_to_jax():
    got = _ring_and_sampling(ttracing)
    assert got == _ring_and_sampling(jtracing)
    assert got[0] == [(f"e{i}", {"i": i}) for i in range(7, 12)]
    assert got[1] == [("failed", {"step": 1}, True),
                      ("manual", {"why": "x"}, True)]
    assert got[2] is False and got[3] == []


def _hang_once(worker_mod):
    """The package's EchoTokenEngine, silent after 3 tokens on its first
    stream only (a worker that stalled once, its transport up)."""
    class HangOnce(worker_mod.EchoTokenEngine):
        calls = 0

        async def generate(self, request, context):
            HangOnce.calls += 1
            first, n = HangOnce.calls == 1, 0
            async for frame in super().generate(request, context):
                yield frame
                n += len(frame["token_ids"] if isinstance(frame, dict)
                         else frame.token_ids)
                if first and n >= 3:
                    await asyncio.Event().wait()
    return HangOnce()


async def _migrated_spans(pkg):
    m = PKG[pkg]
    R, tracer = m["rel"], m["tracing"].TRACER
    plane = m["Plane"]()
    wrt = await m["DRT"].create_local(plane, "w")
    await m["worker"].serve_llm_worker(wrt, "ns", "backend",
                                       _hang_once(m["worker"]))
    crt = await m["DRT"].create_local(plane, "cl")
    client = crt.namespace("ns").component("backend").endpoint(
        "generate").client()
    await client.start()
    await client.wait_for_instances()
    metrics = R.ReliabilityMetrics()
    # the stall is a worker silent forever, far past the 1 s stall timeout
    rel = R.ReliableClient(
        client, R.ReliabilityPolicy(stall_timeout_s=1.0, max_attempts=4,
                                    backoff_base_s=0.01),
        breaker=R.CircuitBreaker(failure_threshold=5, metrics=metrics),
        metrics=metrics)
    prompt = list(range(10, 20))
    saved = (tracer.enabled, tracer.sample_rate)
    tracer.drain()
    tracer.configure(enabled=True, sample_rate=1.0)
    try:
        toks = []
        async for frame in rel.generate(m["pre"]("t0", prompt, 10),
                                        m["Context"]("t0")):
            toks.extend(frame.get("token_ids", ()))
        spans = [s for s in tracer.drain() if s["name"] in LAYER_SPANS]
        tracer.configure(enabled=False)
        off = [f async for f in rel.generate(m["pre"]("t1", prompt, 4),
                                             m["Context"]("t1"))]
        off_spans = tracer.drain()
    finally:
        tracer.configure(enabled=saved[0], sample_rate=saved[1])
        await crt.shutdown()
        await wrt.shutdown()
    index = {s["span_id"]: i for i, s in enumerate(spans)}
    shape = [(s["name"], s["attrs"], s["error"],
              index.get(s["parent_id"], s["parent_id"] or "root"))
             for s in spans]
    return (toks, shape, len({s["trace_id"] for s in spans}),
            metrics.snapshot()["migrations"], len(off), off_spans)


def test_migration_spans_equal_to_jax():
    got = asyncio.run(asyncio.wait_for(_migrated_spans("torch"), T))
    assert got == asyncio.run(asyncio.wait_for(_migrated_spans("jax"), T))
    toks, shape, traces, migrations, n_off, off_spans = got
    assert toks == list(range(10, 20))
    assert traces == 1 and migrations == 1
    attempts = [a for name, a, _e, _p in shape if name == "attempt"]
    assert [(a["attempt"], a["engine_request_id"], a["resumed_tokens"],
             a["outcome"], a["instance"]) for a in attempts] == [
        (1, "t0", 0, "migrated", "w"), (2, "t0~a2", 3, "success", "w")]
    assert sum(name == "schedule" for name, *_ in shape) == 2
    assert n_off > 0 and off_spans == []


# -- (c) knobs, scope spans, the deferred recorder, the chrome export ---------

@pytest.mark.parametrize("env", [
    {"DYN_TRACE": "1", "DYN_TRACE_SAMPLE": "0.25", "DYN_TRACE_SEED": "9",
     "DYN_TRACE_RING": "77"},
    {"DYN_TRACE": "0", "DYN_TRACE_SAMPLE": "1.0"},
    {}], ids=["on", "off", "unset"])
def test_env_knobs_equal_to_jax(env):
    def configured(module):
        code = (f"import json; from {module} import TRACER as t; "
                "print(json.dumps([t.enabled, t.sample_rate, t.seed, "
                "t.ring_capacity, t.sampled('req-1'), t.sampled('req-2')]))")
        full = {k: v for k, v in os.environ.items()
                if not k.startswith("DYN_TRACE")}
        full.update(env, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", code], env=full,
                             capture_output=True, text=True, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])
    got = configured("dynamo_tpu_torch.runtime.tracing")
    assert got == configured("dynamo_tpu.runtime.tracing")
    assert got[0] is (env.get("DYN_TRACE", "") not in ("", "0"))


def _scope_records(tracing):
    tr = _tracer(tracing, enabled=True, ring_capacity=4)
    with tr.scope_span("pool.rebalance", "pool", epoch=3, changes=1):
        pass
    try:
        with tr.scope_span("router.schedule", "router", stream=5) as sp:
            sp.set(error_pick=True)
            raise ValueError
    except ValueError:
        pass
    tr.defer_phase("engine", "plan", 0.25)
    tr.defer_phase("engine", "fetch", 0.5)
    recs = [(r["trace_id"], r["name"], r["parent_id"], r["attrs"],
             r["error"], round(r["dur"], 6) if r["name"] in ("plan", "fetch")
             else r["dur"] > 0) for r in tr.drain(clear=False)]
    tr.defer_phase("engine", "commit", 0.1)     # a 5th record: one dropped
    dropped = tr.dropped()
    tr.reset()
    off = _tracer(tracing, enabled=False)
    off.defer_phase("engine", "plan", 1.0)
    with off.scope_span("x", "pool"):
        pass
    return recs, dropped, tr.drain(), off.drain(), off.dropped()


def test_scope_span_and_defer_phase_equal_to_jax():
    got = _scope_records(ttracing)
    assert got == _scope_records(jtracing)
    recs, dropped, after_reset, off, off_dropped = got
    # drained oldest first: the deferred phases start dt before their end
    assert [r[:2] for r in recs] == [
        ("scope:engine", "fetch"), ("scope:engine", "plan"),
        ("scope:pool", "pool.rebalance"), ("scope:router", "router.schedule")]
    assert recs[1][5] == 0.25 and recs[3][4] is True
    assert dropped == 1 and after_reset == [] and off == [] \
        and off_dropped == 0


def _chrome(tracing):
    tr = _tracer(tracing, enabled=True)
    ctx = tr.start_trace("chrome")
    with tr.span("http.request", ctx, route="/v1") as root:
        tr.event("decode.emit", root.context(), n=2)
        try:
            with tr.span("attempt", root.context(), attempt=1):
                raise RuntimeError
        except RuntimeError:
            pass
    tr.defer_phase("engine", "plan", 0.002)
    spans = tr.drain()
    # ids and times differ between the runs: pin them to the same values
    for i, s in enumerate(spans):
        s["ts"], s["dur"] = 1.0 + i * 0.125, (0.0 if s["name"] ==
                                              "decode.emit" else 0.0625)
    ids = {s["span_id"]: f"s{i}" for i, s in enumerate(spans)}
    for s in spans:
        s["span_id"] = ids[s["span_id"]]
        s["parent_id"] = ids.get(s["parent_id"], s["parent_id"])
    out = tracing.chrome_trace(spans)
    return out, tracing.chrome_trace([])


def test_chrome_trace_equal_to_jax():
    got, empty = _chrome(ttracing)
    want, jempty = _chrome(jtracing)
    assert got["metadata"].pop("source") == "dynamo_tpu_torch.runtime.tracing"
    want["metadata"].pop("source")
    assert got == want and empty == jempty == {"traceEvents": []}
    phases = [e["ph"] for e in got["traceEvents"]]
    assert phases.count("i") == 1 and phases.count("X") == 3


# -- (d) one disaggregated request, traced end to end --------------------------

REQUIRED_LEGS = {"http.request", "schedule", "attempt", "worker.generate",
                 "prefill.remote", "queue.wait", "prefill.run",
                 "kv.transfer", "decode.emit"}


@pytest.fixture(scope="module")
def disagg_weights():
    import jax

    from dynamo_tpu.engine.config import (
        EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
    )
    from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
    from dynamo_tpu_torch.engine.config import ModelConfig as TModelConfig
    from dynamo_tpu_torch.models.llama import params_from_jax
    jeng = JNativeEngine(JModelConfig(dtype="float32", max_model_len=512,
                                      decode_kernel="off"),
                         JEngineConfig(**DISAGG_KW), seed=0)
    jp = jax.device_get(jeng.params)
    return jp, params_from_jax(
        jp, TModelConfig(dtype="float32", max_model_len=512), "cpu")


DISAGG_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)


async def _serve_disagg_request(pkg, weights, traced=True):
    """HTTP frontend -> ReliableClient over the memory plane ->
    DisaggDecodeWorker (remote prefill through the leased queue and the
    local transfer backend) in one package. Returns (status, body,
    drained spans)."""
    from tests.http_client import request
    if pkg == "jax":
        from dynamo_tpu.disagg import (
            DisaggDecodeWorker, DisaggregatedRouter, LocalTransferBackend,
            PrefillQueue, PrefillWorker,
        )
        from dynamo_tpu.engine.config import EngineConfig, ModelConfig
        from dynamo_tpu.engine.engine import NativeEngine
        from dynamo_tpu.frontend.discovery import ModelWatcher, register_model
        from dynamo_tpu.frontend.service import HttpService
        from dynamo_tpu.llm.model_card import ModelDeploymentCard
        from dynamo_tpu.llm.worker import NativeEngineWorker, serve_llm_worker
        tracer, DRT, Plane = jtracing.TRACER, JDRT, JPlane

        def make_engine():
            return NativeEngine(ModelConfig(dtype="float32",
                                            max_model_len=512,
                                            decode_kernel="off"),
                                EngineConfig(**DISAGG_KW),
                                params=weights[0], seed=0)
    else:
        from dynamo_tpu_torch.disagg.queue import PrefillQueue
        from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
        from dynamo_tpu_torch.disagg.transfer import LocalTransferBackend
        from dynamo_tpu_torch.disagg.worker import (
            DisaggDecodeWorker, PrefillWorker,
        )
        from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
        from dynamo_tpu_torch.engine.engine import NativeEngine
        from dynamo_tpu_torch.frontend.discovery import (
            ModelWatcher, register_model,
        )
        from dynamo_tpu_torch.frontend.service import HttpService
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.worker import (
            NativeEngineWorker, serve_llm_worker,
        )
        tracer, DRT, Plane = ttracing.TRACER, TDRT, TPlane

        def make_engine():
            return NativeEngine(ModelConfig(dtype="float32",
                                            max_model_len=512),
                                EngineConfig(**DISAGG_KW),
                                params=weights[1], device="cpu")

    card = ModelDeploymentCard(name="tiny", arch="tiny",
                               tokenizer_kind="byte", context_length=512,
                               eos_token_ids=[2])
    saved = (tracer.enabled, tracer.sample_rate)
    tracer.configure(enabled=traced, sample_rate=1.0)
    tracer.drain()
    plane = Plane()
    wrt = await DRT.create_local(plane, "dec-0")
    queue = PrefillQueue(plane.messaging, "ns", "tiny")
    router = DisaggregatedRouter(max_local_prefill_length=4,
                                 max_prefill_queue_size=4, model="tiny")
    decode = DisaggDecodeWorker(make_engine(), plane.messaging, router,
                                queue, worker_id="dec-0",
                                prefill_timeout_s=30.0)
    transfer = LocalTransferBackend()
    transfer.register("dec-0", decode)
    prefill = PrefillWorker(NativeEngineWorker(make_engine()), queue,
                            transfer, plane.messaging)
    await decode.start()
    await prefill.start()
    await serve_llm_worker(wrt, "ns", "backend", decode)
    frt = await DRT.create_local(plane, "front")
    svc = await HttpService("127.0.0.1", 0).start()
    watcher = await ModelWatcher(frt, svc.models).start()
    await register_model(frt.kv, "tiny", "ns", "backend", card,
                         model_type="chat")
    for _ in range(100):
        if "tiny" in svc.models.chat:
            break
        await asyncio.sleep(0.02)
    try:
        status, body = await request(
            "127.0.0.1", svc.port, "POST", "/v1/chat/completions",
            {"model": "tiny", "max_tokens": 6, "messages": [
                {"role": "user", "content": "trace this slow request"}]})
        assert decode.remote_prefills == 1, "remote prefill path not taken"
    finally:
        await watcher.stop()
        await svc.stop()
        await prefill.stop()
        await decode.stop()
        await frt.shutdown()
        await wrt.shutdown()
        spans = tracer.drain()
        tracer.configure(enabled=saved[0], sample_rate=saved[1])
    return status, json.loads(body), spans


def _request_tree(spans):
    traces = collections.defaultdict(list)
    for s in spans:
        if not s["trace_id"].startswith("scope:"):
            traces[s["trace_id"]].append(s)
    assert len(traces) == 1, sorted(traces)
    (tid, mine), = traces.items()
    by_id = {s["span_id"]: s for s in mine}
    edges = collections.Counter(
        (s["name"], by_id[s["parent_id"]]["name"]
         if s["parent_id"] in by_id else "") for s in mine)
    return tid, mine, edges


def test_disagg_request_one_trace_tree_equal_to_jax(disagg_weights,
                                                    tmp_path):
    st, body, spans = asyncio.run(asyncio.wait_for(
        _serve_disagg_request("torch", disagg_weights), T))
    jst, jbody, jspans = asyncio.run(asyncio.wait_for(
        _serve_disagg_request("jax", disagg_weights), T))
    assert st == jst == 200
    assert body["choices"] == jbody["choices"]
    tid, mine, edges = _request_tree(spans)
    _, jmine, jedges = _request_tree(jspans)
    names = {s["name"] for s in mine}
    assert REQUIRED_LEGS <= names, REQUIRED_LEGS - names
    # one tree: a single root, every parent inside the trace
    ids = {s["span_id"] for s in mine}
    roots = [s for s in mine if s["parent_id"] not in ids]
    assert [s["name"] for s in roots] == ["http.request"]
    xfer = [s for s in mine if s["name"] == "kv.transfer"]
    assert xfer and all(s["attrs"]["bytes"] > 0 and s["attrs"]["pages"] > 0
                        for s in xfer)
    assert any(s["trace_id"] == "scope:engine" for s in spans)
    # the emits' token counts add up to what the client got, in both
    for got, b in ((mine, body), (jmine, jbody)):
        emitted = sum(s["attrs"]["n"] for s in got
                      if s["name"] == "decode.emit")
        assert emitted == b["usage"]["completion_tokens"]
    assert edges == jedges

    # the export round-trips through the port's explain tool
    from tools.torch_trace_explain import explain, load_spans, pick_trace
    out = tmp_path / "trace.jsonl"
    out.write_text("".join(json.dumps(s) + "\n" for s in spans))
    loaded = load_spans(str(out))
    assert pick_trace(loaded) == tid
    text = explain(loaded, tid)
    for needle in ("http.request", "worker.generate", "kv transfer",
                   "queue wait", "decode:", "attempts:"):
        assert needle in text, (needle, text)


def test_tracing_on_and_off_serve_the_same_tokens(disagg_weights):
    on = asyncio.run(asyncio.wait_for(
        _serve_disagg_request("torch", disagg_weights), T))
    off = asyncio.run(asyncio.wait_for(
        _serve_disagg_request("torch", disagg_weights, traced=False), T))
    assert on[0] == off[0] == 200
    assert on[1]["choices"] == off[1]["choices"]
    assert on[1]["usage"] == off[1]["usage"]
    assert on[2] and off[2] == []


# -- (e) scope spans off the request path, the profiler hook, the tools -------

def _pool_spans(pkg):
    if pkg == "jax":
        from dynamo_tpu.engine import pool_service as ps
        tracer = jtracing.TRACER

        def arrays(i):
            r = np.random.default_rng(i)
            return (r.standard_normal((2, 2, 2, 4)).astype(np.float32),
                    r.standard_normal((2, 2, 2, 4)).astype(np.float32))
    else:
        import torch

        from dynamo_tpu_torch.engine import pool_service as ps
        tracer = ttracing.TRACER

        def arrays(i):
            r = np.random.default_rng(i)
            return tuple(torch.from_numpy(
                r.standard_normal((2, 2, 2, 4)).astype(np.float32))
                for _ in range(2))
    saved = (tracer.enabled, tracer.sample_rate)
    tracer.configure(enabled=True, sample_rate=1.0)
    tracer.drain()
    try:
        cl = ps.ClusterKvPool(replicas=2)
        for i in range(3):
            cl.add_host(ps.KvPoolHost(f"h{i}", capacity_pages=64))
        cl.run_rebalance()
        for i in range(6):
            assert cl.publish("w", 0x700 + i, 0, i, arrays(i)) == "new"
        for i in range(6):
            assert cl.fetch(0x700 + i) is not None
        cl.kill_host("h1")
        for _ in range(10):
            if cl.run_rebalance()["under_replicated"] == 0:
                break
        spans = tracer.drain()
    finally:
        tracer.configure(enabled=saved[0], sample_rate=saved[1])
        ps.REMOTE_STATS.reset()
        ps.RING_STATS.reset()
    return [(s["trace_id"], s["name"], s["parent_id"], s["error"],
             {k: v for k, v in (s["attrs"] or {}).items()})
            for s in spans if s["trace_id"] == "scope:pool"]


def test_pool_scope_spans_equal_to_jax():
    got = _pool_spans("torch")
    assert got == _pool_spans("jax")
    names = collections.Counter(s[1] for s in got)
    assert names["pool.fetch.remote"] == 6 and names["pool.rebalance"] >= 2


def _router_spans(pkg):
    if pkg == "jax":
        from dynamo_tpu.runtime import simcluster as sc
        tracer = jtracing.TRACER
    else:
        from dynamo_tpu_torch.runtime import simcluster as sc
        tracer = ttracing.TRACER

    async def main():
        sim = await sc.SimCluster(sc.SimConfig(workers=4, streams=16,
                                               seed=3)).start()
        try:
            tracer.drain()
            await sim.run_load(24, concurrency=4)
            return tracer.drain(), sorted(sim.workers)
        finally:
            await sim.stop()

    saved = (tracer.enabled, tracer.sample_rate)
    tracer.configure(enabled=True, sample_rate=1.0)
    try:
        spans, workers = asyncio.run(asyncio.wait_for(main(), T))
    finally:
        tracer.configure(enabled=saved[0], sample_rate=saved[1])
    mine = [s for s in spans if s["name"] == "router.schedule"]
    assert all(s["attrs"]["instance"] in workers for s in mine)
    # the picks score the port's page hashes (ROADMAP C), the streams the
    # same seeded draws
    return sorted((s["trace_id"], s["parent_id"], s["error"],
                   s["attrs"]["stream"]) for s in mine)


def test_router_schedule_scope_spans_equal_to_jax():
    got = _router_spans("torch")
    assert len(got) == 24 and got == _router_spans("jax")


def test_profiler_hook_one_owner(monkeypatch, tmp_path):
    from tools.torch_chaos import ChaosEnv, pre_request
    env = ChaosEnv()
    monkeypatch.setenv(tworker.PROFILE_DIR_ENV, str(tmp_path))

    async def main():
        w1 = await tworker.NativeEngineWorker(env.engine()).start()
        w2 = await tworker.NativeEngineWorker(env.engine()).start()
        owners = (w1._profiler is not None, w2._profiler is not None)
        toks = []
        async for f in w1.generate(pre_request("p0", [5, 6, 7, 8], 3),
                                   TContext("p0")):
            toks.extend(f.token_ids)
        await w2.stop()           # not the owner: the session runs on
        after_w2 = (tworker._PROFILE_OWNER is w1, os.listdir(tmp_path))
        await w1.stop()
        return owners, toks, after_w2, w1.profile_path

    owners, toks, (still_owner, files_before), path = asyncio.run(
        asyncio.wait_for(main(), T))
    assert owners == (True, False) and len(toks) == 3
    assert still_owner and files_before == []
    assert tworker._PROFILE_OWNER is None
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


@pytest.mark.parametrize("artifact", ["TRACE_DISAGG_r08.jsonl",
                                      "CHAOS_TRACE.jsonl"])
@pytest.mark.parametrize("view", [[], ["--list"], ["--summary"]],
                         ids=["tree", "list", "summary"])
def test_explain_tool_renders_like_jax(artifact, view):
    from tools import torch_trace_explain, trace_explain

    def render(main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([artifact, *view]) == 0
        return buf.getvalue()
    got = render(torch_trace_explain.main)
    assert got and got == render(trace_explain.main)


def test_chaos_replay_trace_writes_artifacts(tmp_path):
    from tools import torch_chaos_replay, torch_trace_explain
    trace, rec = tmp_path / "storm.jsonl", tmp_path / "runs.jsonl"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert torch_chaos_replay.main(
            ["pool_host_storm", "--trace", str(trace),
             "--record", str(rec)]) == 0
    record = json.loads(buf.getvalue())
    assert record["ok"] and record["trace_spans"] > 0
    spans = torch_trace_explain.load_spans(str(trace))
    assert len(spans) == record["trace_spans"]
    assert {s["name"] for s in spans} >= {"pool.fetch.remote",
                                          "pool.rebalance"}
    chrome = json.loads((tmp_path / "storm.jsonl.chrome.json").read_text())
    assert len(chrome["traceEvents"]) == len(spans)
    assert json.loads(rec.read_text())["scenario"] == "pool_host_storm"
    assert not ttracing.TRACER.drain()
