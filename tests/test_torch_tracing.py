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
"""
import asyncio

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
