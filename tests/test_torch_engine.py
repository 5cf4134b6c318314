"""The port's engine slice (dynamo_tpu_torch) against the JAX package's
NativeEngine on the `tiny` config in float32, with the JAX weights carried
over by `params_from_jax`.

Streams must be TOKEN-IDENTICAL: greedy, seeded-sampled (the port
reimplements the JAX PRNG), a prompt longer than max_prefill_chunk
(chunked prefill), concurrent requests that trigger mixed prefill+decode
steps, and a chat request through both packages' LocalPipeline. The JAX
oracle runs its gather decode (decode_kernel="off") and, for one short
run, the Pallas kernel in interpret mode; the port always runs its
ragged-kernel decode (the plain version on CPU).

Also here: the port's package rules — it imports no JAX and nothing of
dynamo_tpu, and its engine refuses to run without CUDA unless the CPU is
asked for.
"""
import ast
import asyncio
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models.llama import params_from_jax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# the JAX oracle decodes through its XLA gather path; one test switches it
# to the Pallas kernel in interpret mode
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
# the geometry of tests/test_engine.py's make_engine, so the JAX programs
# are shared with that file through the persistent compilation cache
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
EOS = {2}


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def _pair(jax_params, jcfg=JCFG, **kw):
    cfg = dict(ENGINE_KW, **kw)
    jeng = JNativeEngine(jcfg, JEngineConfig(**cfg), eos_token_ids=EOS,
                         seed=0)
    teng = TNativeEngine(TCFG, TEngineConfig(**cfg), eos_token_ids=EOS,
                         params=params_from_jax(jax_params, TCFG, "cpu"),
                         device="cpu")
    return jeng, teng


def _drive(eng, request_cls, params_cls, reqs):
    """Add every request up front, step to completion; token streams."""
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    finish = {}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
            if ev.finished:
                finish[ev.request_id] = ev.finish_reason
    return out, finish


def _assert_identical(jax_params, reqs, jcfg=JCFG, **kw):
    jeng, teng = _pair(jax_params, jcfg, **kw)
    jout = _drive(jeng, JRequest, JSamplingParams, reqs)
    tout = _drive(teng, TRequest, TSamplingParams, reqs)
    assert tout == jout
    assert set(tout[1]) == {rid for rid, _, _ in reqs}   # all finished
    assert sum(len(t) for t in tout[0].values()) > len(reqs)
    return teng


def test_greedy_token_identical(jax_params):
    _assert_identical(jax_params, [
        ("g", range(10, 30), dict(max_tokens=12))])


def test_seeded_sampled_token_identical(jax_params):
    _assert_identical(jax_params, [
        ("s1", range(40, 61), dict(max_tokens=10, temperature=0.8,
                                   top_k=20, seed=7)),
        ("s2", range(3, 20), dict(max_tokens=9, temperature=1.1,
                                  top_p=0.9, seed=3)),
        ("s3", range(90, 110), dict(max_tokens=7, temperature=0.7, seed=11,
                                    repetition_penalty=1.3))])


def test_chunked_prefill_token_identical(jax_params):
    """A 75-token prompt through 32-token chunks."""
    _assert_identical(jax_params, [
        ("long", list(range(5, 80)), dict(max_tokens=8))])


def test_mixed_steps_token_identical(jax_params):
    """Staggered prompt lengths put later prefills next to running decodes:
    the port must plan mixed steps and match the JAX streams."""
    rng = np.random.default_rng(2)
    reqs = [(f"m{i}", rng.integers(3, 250, n).tolist(),
             dict(max_tokens=10, temperature=0.9 if i % 2 else 0.0,
                  seed=100 + i))
            for i, n in enumerate((9, 40, 17, 70))]
    teng = _assert_identical(jax_params, reqs)
    assert teng.metrics().mixed_steps > 0
    assert teng.metrics().decode_windows > 0


def test_pallas_interpret_oracle_token_identical(jax_params):
    """One short run against the JAX engine with its ragged Pallas kernel
    in interpret mode (the kernel-mode decode window the port mirrors)."""
    jcfg = dataclasses.replace(JCFG, decode_kernel="interpret")
    _assert_identical(jax_params, [
        ("k", range(30, 47), dict(max_tokens=4))], jcfg=jcfg,
        decode_steps=2)


@pytest.mark.parametrize("depth", [1, 2])
def test_scheduler_plans_match(depth):
    """The copied scheduler plans the same steps as the JAX one: plan kind,
    tokens, positions, kv lengths, page tables (with the pipelined decode's
    page lookahead at depth 2), window sizes and stop ids, step for
    step."""
    from dynamo_tpu.engine.scheduler import Scheduler as JScheduler
    from dynamo_tpu_torch.engine.scheduler import Scheduler as TScheduler
    cfg = dict(ENGINE_KW, num_pages=40, pipeline_depth=depth)
    js = JScheduler(JEngineConfig(**cfg))
    ts = TScheduler(TEngineConfig(**cfg))
    rng = np.random.default_rng(4)
    for i, n in enumerate((12, 50, 7, 33, 90)):
        prompt = rng.integers(3, 250, n).tolist()
        stops = tuple(range(300, 300 + i % 3 * 5))
        js.add_request(JRequest(f"r{i}", prompt, JSamplingParams(
            max_tokens=6 + i, stop_token_ids=stops)))
        ts.add_request(TRequest(f"r{i}", prompt, TSamplingParams(
            max_tokens=6 + i, stop_token_ids=stops)))
    for step in range(60):
        jp, tp = js.schedule(), ts.schedule()
        assert type(jp).__name__ == type(tp).__name__, step
        if jp is None:
            break
        for f in ("tokens", "positions", "kv_lens", "last_idx",
                  "page_table"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
        tok = 3 + step
        if type(jp).__name__ == "DecodePlan":
            assert tp.n_window == jp.n_window
            np.testing.assert_array_equal(tp.stop_ids, jp.stop_ids)
            for s in (js, ts):
                for seq in [x for x in s.running if x is not None]:
                    s.commit_decode_token(seq, tok)
                    p = s.params[seq.request_id]
                    if len(seq.output) >= p.max_tokens:
                        s.finish(seq)
            continue
        for s, plan in ((js, jp), (ts, tp)):
            for i in reversed(range(len(plan.seqs))):
                seq = plan.seqs[i]
                if seq is None:
                    continue
                if getattr(plan, "is_decode", [False] * 99)[i]:
                    s.commit_decode_token(seq, tok)
                    if len(seq.output) >= s.params[seq.request_id].max_tokens:
                        s.finish(seq)
                else:
                    s.commit_prefill_row(
                        plan, i, tok if plan.is_last_chunk[i] else None)
    assert not ts.waiting and not any(ts.running)


def _chat_through(pkg: str, params_tree, content: str, **kw):
    """One chat request through a package's LocalPipeline over its
    NativeEngineWorker; returns (text, finish_reason, completion tokens)."""
    if pkg == "jax":
        from dynamo_tpu.llm.model_card import ModelDeploymentCard
        from dynamo_tpu.llm.pipeline import LocalPipeline
        from dynamo_tpu.llm.worker import NativeEngineWorker
        from dynamo_tpu.protocols.delta import aggregate_chat_chunks
        from dynamo_tpu.protocols.openai import ChatCompletionRequest
        from dynamo_tpu.runtime.engine import Context
        engine = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    else:
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.pipeline import LocalPipeline
        from dynamo_tpu_torch.llm.worker import NativeEngineWorker
        from dynamo_tpu_torch.protocols.delta import aggregate_chat_chunks
        from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
        from dynamo_tpu_torch.runtime.engine import Context
        engine = TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cpu",
                               params=params_from_jax(params_tree, TCFG))
    card = ModelDeploymentCard(name="tiny", arch="tiny", context_length=512)

    async def go():
        worker = await NativeEngineWorker(engine).start()
        try:
            pipe = LocalPipeline(card, worker)
            req = ChatCompletionRequest(
                model="tiny", messages=[{"role": "user", "content": content}],
                **kw)
            chunks = [c async for c in pipe.generate_chat(req, Context())]
        finally:
            await worker.stop()
        agg = aggregate_chat_chunks(chunks)
        return (agg.choices[0].message.content, agg.choices[0].finish_reason,
                agg.usage.completion_tokens)

    return asyncio.run(go())


@pytest.mark.parametrize("kw", [
    dict(max_tokens=12),
    dict(max_tokens=10, temperature=0.9, seed=5, ext={"top_k": 30},
         stop="zz"),
])
def test_local_pipeline_chat_identical(jax_params, kw):
    content = "port the decode kernel, keep the streams identical"
    want = _chat_through("jax", jax_params, content, **kw)
    got = _chat_through("torch", jax_params, content, **kw)
    assert got == want
    assert got[2] >= 1


def test_default_chat_template_matches_jinja():
    """The port renders the default template without jinja2; same text as
    the JAX package's jinja2 render, so the same token ids."""
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
    from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
    from dynamo_tpu.protocols.openai import ChatCompletionRequest as JChat
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor as TPre
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest as TChat
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "héllo <|x|> {{ y }}"},
            {"role": "assistant", "content": None},
            {"role": "user", "content": ""}]
    jpre, _ = JPre(JCard(name="tiny")).preprocess_chat(
        JChat(model="tiny", messages=msgs, max_tokens=5, seed=3), "r")
    tpre, _ = TPre(TCard(name="tiny")).preprocess_chat(
        TChat(model="tiny", messages=msgs, max_tokens=5, seed=3), "r")
    assert tpre.token_ids == jpre.token_ids
    assert tpre.stop.max_tokens == jpre.stop.max_tokens
    assert tpre.sampling.seed == jpre.sampling.seed == 3


def test_run_batch_cpu(tmp_path, capsys):
    """`python -m dynamo_tpu_torch.run in=batch:FILE out=native tiny
    --device cpu`: one JSON line per prompt."""
    from dynamo_tpu_torch.run import amain
    path = tmp_path / "prompts.jsonl"
    path.write_text("".join(json.dumps({"prompt": p}) + "\n"
                            for p in ("hello", "paged attention")))
    asyncio.run(amain([f"in=batch:{path}", "out=native", "tiny",
                       "--device", "cpu", "--max-tokens", "6"]))
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["prompt"] for x in lines] == ["hello", "paged attention"]
    assert all(x["completion_tokens"] == 6 and x["finish_reason"] == "length"
               for x in lines)


def test_engine_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW))
    with pytest.raises(RuntimeError, match="CUDA"):
        TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cuda")
    eng = TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cpu")
    assert eng.generate([5, 6, 7], TSamplingParams(max_tokens=2)) \
        and eng.device.type == "cpu"
    from dynamo_tpu_torch.run import amain
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(amain(["in=none", "out=native", "tiny"]))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


# the JAX stack, the JAX package, and the packages the machine with the
# card may lack (the port depends on torch and numpy only)
BANNED_ROOTS = ("jax", "jaxlib", "flax", "dynamo_tpu", "pydantic", "jinja2",
                "xxhash", "msgpack")


def _banned(path: pathlib.Path):
    return [mod for mod in _imports(path)
            if mod.split(".")[0] in BANNED_ROOTS]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "dynamo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(REPO)}: {mod}" for f in files
           for mod in _banned(f)]
    assert not bad, bad


def test_import_rule_catches_violations(tmp_path):
    """The walker above sees every import form, and the rule rejects the
    JAX package and the dependencies the port may not have."""
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom dynamo_tpu.engine import "
                 "config\nfrom jax import lax\nimport dynamo_tpu_torch\n"
                 "import pydantic\nfrom msgpack import packb\n")
    assert list(_imports(f)) == ["jax.numpy", "dynamo_tpu.engine", "jax",
                                 "dynamo_tpu_torch", "pydantic", "msgpack"]
    assert _banned(f) == ["jax.numpy", "dynamo_tpu.engine", "jax",
                          "pydantic", "msgpack"]


def test_echo_engine_through_local_pipeline():
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.pipeline import LocalPipeline
    from dynamo_tpu_torch.llm.worker import EchoTokenEngine
    from dynamo_tpu_torch.protocols.delta import aggregate_chat_chunks
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.engine import Context
    pipe = LocalPipeline(ModelDeploymentCard(name="tiny"), EchoTokenEngine())

    async def go():
        req = ChatCompletionRequest(
            model="tiny", max_tokens=8,
            messages=[{"role": "user", "content": "hi"}])
        return [c async for c in pipe.generate_chat(req, Context())]

    agg = aggregate_chat_chunks(asyncio.run(go()))
    assert agg.choices[0].message.content == "<|user|>"
    assert agg.choices[0].finish_reason == "length"
    assert agg.usage.completion_tokens == 8
