"""The port's pipeline graph (dynamo_tpu_torch/runtime/pipeline.py) and the
model pipelines that stream through it (llm/pipeline.py), against the JAX
package's.

(a) The six cases of tests/test_pipeline_graph.py on each package: chain
    order, nested segments, a dynamic sink swap, operator replacement and
    the errors, LocalPipeline's segment hot swap, and the SDK's
    Service.link / unlink.
(b) tiny in float32 on the CPU (JAX's weights carried over): the frames of
    one greedy and one seeded-sampled chat through LocalPipeline's and
    RemotePipeline's Segment equal the frames the sink gives when called
    directly (the path before the Segment) and JAX's token streams.
(c) `pipeline.segment.set_sink(...)` mid-run on a RemotePipeline: the
    stream in flight keeps the worker it started with, the next request
    goes to the new one.
"""
import asyncio

import jax
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols.common import to_wire

torch.set_num_threads(1)
T = 120.0
PKGS = ["jax", "torch"]


def _graph(pkg):
    if pkg == "jax":
        from dynamo_tpu.runtime import pipeline
    else:
        from dynamo_tpu_torch.runtime import pipeline
    return pipeline


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, T))


async def collect(it):
    return [x async for x in it]


async def echo_engine(request, context):
    for i in range(request["n"]):
        yield {"i": i, "via": request.get("via", [])}


def _ops(pkg):
    Operator = _graph(pkg).Operator

    class Doubler(Operator):
        """Request-transforming operator: doubles n, stamps itself."""

        async def generate(self, request, context, downstream):
            request = {**request, "n": request["n"] * 2,
                       "via": request.get("via", []) + ["doubler"]}
            async for frame in downstream.generate(request, context):
                yield frame

    class Suffixer(Operator):
        """Response-transforming operator: appends a trailer frame."""

        async def generate(self, request, context, downstream):
            async for frame in downstream.generate(request, context):
                yield frame
            yield {"trailer": True}
    return Doubler, Suffixer


# -- (a) the graph's cases on both packages ----------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_chain_composition_and_order(pkg):
    Doubler, Suffixer = _ops(pkg)
    seg = _graph(pkg).source(Doubler(), Suffixer()).link(echo_engine)
    out = run(collect(seg.generate({"n": 2}, None)))
    assert [f.get("i") for f in out[:-1]] == [0, 1, 2, 3]
    assert all(f["via"] == ["doubler"] for f in out[:-1])
    assert out[-1] == {"trailer": True}


@pytest.mark.parametrize("pkg", PKGS)
def test_segments_nest_as_sinks(pkg):
    Doubler, Suffixer = _ops(pkg)
    g = _graph(pkg)
    inner = g.source(Suffixer()).link(echo_engine)
    outer = g.source(Doubler()).link(inner)
    out = run(collect(outer.generate({"n": 1}, None)))
    assert [f.get("i") for f in out[:-1]] == [0, 1]
    assert out[-1] == {"trailer": True}


@pytest.mark.parametrize("pkg", PKGS)
def test_dynamic_sink_rewiring(pkg):
    seg = _graph(pkg).source().link(echo_engine)
    assert len(run(collect(seg.generate({"n": 3}, None)))) == 3

    async def other_engine(request, context):
        yield {"other": True}

    seg.set_sink(other_engine)
    assert run(collect(seg.generate({"n": 3}, None))) == [{"other": True}]


@pytest.mark.parametrize("pkg", PKGS)
def test_operator_replacement_and_errors(pkg):
    g = _graph(pkg)
    Doubler, Suffixer = _ops(pkg)
    seg = g.Segment()
    with pytest.raises(RuntimeError, match="no sink"):
        run(collect(seg.generate({}, None)))
    with pytest.raises(TypeError):
        seg.link(42)
    seg.link(g.FnOperator(Doubler().generate)).link(g.FnSink(echo_engine))
    with pytest.raises(ValueError, match="already has a sink"):
        seg.link(echo_engine)
    seg.set_operator(0, Suffixer())
    out = run(collect(seg.generate({"n": 1}, None)))
    assert out[-1] == {"trailer": True} and len(out) == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_local_pipeline_segment_hot_swap(pkg):
    """The token flow rides the graph: swapping the sink swaps the engine
    under a live model without rebuilding the preprocessor."""
    if pkg == "jax":
        from dynamo_tpu.llm import model_card, pipeline
        from dynamo_tpu.protocols.openai import CompletionRequest
        from dynamo_tpu.runtime.engine import Context
        req = CompletionRequest(model="m", prompt="hi")

        def frame(tok):
            return {"token_ids": [tok], "finish_reason": "stop"}

        def ids(f):
            return f["token_ids"]
    else:
        from dynamo_tpu_torch.llm import model_card, pipeline
        from dynamo_tpu_torch.protocols.common import (
            EngineOutput, FinishReason,
        )
        from dynamo_tpu_torch.protocols.openai import CompletionRequest
        from dynamo_tpu_torch.runtime.engine import Context
        req = CompletionRequest.from_json({"model": "m", "prompt": "hi"})

        def frame(tok):
            return EngineOutput(token_ids=[tok],
                                finish_reason=FinishReason.STOP)

        def ids(f):
            return f.token_ids
    card = model_card.ModelDeploymentCard(
        name="m", arch="tiny", tokenizer_kind="byte", context_length=512,
        eos_token_ids=[2])

    class TokenEngine:
        def __init__(self, tok):
            self.tok = tok

        async def generate(self, request, context):
            yield frame(self.tok)

    pipe = pipeline.LocalPipeline(card, TokenEngine(65))
    pre, _ = pipe.preprocessor.preprocess_completion(req, "r1")
    out1 = run(collect(pipe._token_stream(pre, Context("r1"))))
    assert ids(out1[0]) == [65]
    sink = pipeline.LocalEngineSink(TokenEngine(66))
    pipe.segment.set_sink(sink.generate if pkg == "jax" else sink)
    out2 = run(collect(pipe._token_stream(pre, Context("r2"))))
    assert ids(out2[0]) == [66]


@pytest.mark.parametrize("pkg", PKGS)
def test_sdk_dynamic_link_unlink(pkg):
    if pkg == "jax":
        from dynamo_tpu.sdk.service import collect_graph, service
    else:
        from dynamo_tpu_torch.sdk.service import collect_graph, service

    @service(name="LinkFront", namespace="t")
    class LinkFront:
        pass

    @service(name="LinkMid", namespace="t")
    class LinkMid:
        pass

    @service(name="LinkLeaf", namespace="t")
    class LinkLeaf:
        pass

    # left-to-right chaining along the request path
    assert LinkFront.link(LinkMid).link(LinkLeaf) is LinkLeaf
    order = [s.name for s in collect_graph(LinkFront)]
    assert order == ["LinkLeaf", "LinkMid", "LinkFront"]  # deps first
    assert LinkFront.__service_spec__.dependencies["link_mid"] is LinkMid

    @service(name="LinkMid2", namespace="t")
    class LinkMid2:
        pass

    with pytest.raises(ValueError, match="already depends"):
        LinkFront.link(LinkMid2, attr="link_mid")
    LinkFront.unlink(LinkMid)
    LinkFront.link(LinkMid2, attr="link_mid")
    assert LinkFront.__service_spec__.dependencies["link_mid"] is LinkMid2
    with pytest.raises(TypeError, match="not a @service"):
        LinkFront.link(object)


# -- (b) serving frames through the Segment ------------------------------------------

JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
EOS = {2}
CONTENT = "stream the port's frames through the pipeline graph"
SAMPLING = {"greedy": {}, "sampled": {"temperature": 0.9, "seed": 7,
                                      "ext": {"top_k": 40}}}


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def _chat(pkg, kind):
    body = {"model": "tiny", "max_tokens": 10,
            "messages": [{"role": "user", "content": CONTENT}],
            **SAMPLING[kind]}
    if pkg == "jax":
        from dynamo_tpu.protocols.openai import ChatCompletionRequest
        return ChatCompletionRequest.model_validate(body)
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    return ChatCompletionRequest.from_json(body)


async def _served(pkg, engine, remote):
    """(pipeline, direct sink fn, teardown) over a worker of `engine`,
    remote on an in-process memory plane or local."""
    if pkg == "jax":
        from dynamo_tpu.llm import model_card, pipeline, worker
        from dynamo_tpu.runtime.distributed import DistributedRuntime
        from dynamo_tpu.runtime.transports.memory import MemoryPlane
    else:
        from dynamo_tpu_torch.llm import model_card, pipeline, worker
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
        from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
    card = model_card.ModelDeploymentCard(name="tiny", arch="tiny",
                                          context_length=512)
    w = await worker.NativeEngineWorker(engine).start()
    rts = []
    if not remote:
        pipe = pipeline.LocalPipeline(card, w)
        direct = w.generate
    else:
        plane = MemoryPlane()
        wrt = await DistributedRuntime.create_local(plane, "w0")
        crt = await DistributedRuntime.create_local(plane, "fe")
        rts += [wrt, crt]
        await worker.serve_llm_worker(wrt, "ns", "llm", w)
        client = crt.namespace("ns").component("llm").endpoint(
            "generate").client()
        await client.start()
        await client.wait_for_instances()
        pipe = pipeline.RemotePipeline(card, client, reliability=False)
        direct = pipe.sink.generate

    async def teardown():
        for rt in rts:
            await rt.shutdown()
        await w.stop()
    return pipe, direct, teardown


def _norm(pkg, frames):
    """Frames as dicts, None fields left out, the finish reason a str."""
    out = []
    for f in frames:
        d = dict(f) if pkg == "jax" else to_wire(f)
        out.append({k: v for k, v in d.items() if v is not None})
    return out


async def _frames(pkg, engine, kind, remote, through_segment):
    pipe, direct, teardown = await _served(pkg, engine, remote)
    try:
        if pkg == "jax":
            from dynamo_tpu.runtime.engine import Context
        else:
            from dynamo_tpu_torch.runtime.engine import Context
        pre, _ = pipe.preprocessor.preprocess_chat(_chat(pkg, kind), "rid")
        gen = pipe._token_stream if through_segment else direct
        return _norm(pkg, [f async for f in gen(pre, Context("rid"))])
    finally:
        await teardown()


def _ids(frames):
    return ([t for f in frames for t in f.get("token_ids", [])],
            [f["finish_reason"] for f in frames if f.get("finish_reason")])


@pytest.mark.parametrize("remote", [False, True], ids=["local", "remote"])
@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_segment_frames_equal_direct_sink_and_jax(jax_params, kind, remote):
    def tengine():
        return TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW),
                             eos_token_ids=EOS, device="cpu",
                             params=params_from_jax(jax_params, TCFG, "cpu"))

    async def main():
        seg = await _frames("torch", tengine(), kind, remote, True)
        direct = await _frames("torch", tengine(), kind, remote, False)
        jeng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW),
                             eos_token_ids=EOS, seed=0, params=jax_params)
        jseg = await _frames("jax", jeng, kind, remote, True)
        return seg, direct, jseg
    seg, direct, jseg = run(main())
    assert seg == direct
    assert _ids(seg) == _ids(jseg)
    assert len(_ids(seg)[0]) == 10 and _ids(seg)[1] == ["length"]


# -- (c) a sink swap mid-run ---------------------------------------------------------

def test_remote_set_sink_mid_run_keeps_the_stream_in_flight():
    """Two echo worker groups on one memory plane; a RemotePipeline bound
    to the first. Mid-stream the segment's sink is swapped to the second
    group's RemoteEngineSink: the open stream finishes from the first
    group, token for token, and a new request is served by the second."""
    from dynamo_tpu_torch.llm import model_card, pipeline, worker
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    async def main():
        plane = MemoryPlane()
        rts, clients, served = [], {}, {"a": 0, "b": 0}
        for group in ("a", "b"):
            rt = await DistributedRuntime.create_local(plane, f"w-{group}")
            rts.append(rt)
            echo = worker.EchoTokenEngine(delay_s=0.01)

            async def counted(request, context, echo=echo, group=group):
                served[group] += 1
                async for f in echo.generate(request, context):
                    yield f
            await rt.namespace("ns").component(group).endpoint(
                "generate").serve(counted)
        fe = await DistributedRuntime.create_local(plane, "fe")
        rts.append(fe)
        for group in ("a", "b"):
            c = fe.namespace("ns").component(group).endpoint(
                "generate").client()
            await c.start()
            await c.wait_for_instances()
            clients[group] = c
        card = model_card.ModelDeploymentCard(name="echo", arch="tiny",
                                              context_length=512)
        pipe = pipeline.RemotePipeline(card, clients["a"],
                                       reliability=False)
        req = ChatCompletionRequest.from_json(
            {"model": "echo", "max_tokens": 24,
             "messages": [{"role": "user", "content": "a swap mid-run"}]})
        pre, _ = pipe.preprocessor.preprocess_chat(req, "r0")
        first, got = [], []
        async for f in pipe._token_stream(pre, Context("r0")):
            got += f.token_ids
            if len(got) == 5:
                pipe.segment.set_sink(pipeline.RemoteEngineSink(
                    clients["b"], reliability=False))
        first = got
        pre1, _ = pipe.preprocessor.preprocess_chat(req, "r1")
        second = [t async for f in pipe._token_stream(pre1, Context("r1"))
                  for t in f.token_ids]
        for rt in rts[::-1]:
            await rt.shutdown()
        return first, second, pre.token_ids, dict(served)
    first, second, prompt, served = run(main())
    assert first == prompt[:24] == second
    assert served == {"a": 1, "b": 1}
