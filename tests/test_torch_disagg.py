"""The port's disaggregated prefill/decode (dynamo_tpu_torch/disagg/) against
the JAX package's (tests/test_disagg.py's scenarios, held to the reference).

On the `tiny` config in float32 with the JAX weights carried over by
`params_from_jax`, on the CPU with the in-memory control plane:
- the local/remote decision over a grid, equal to the JAX router's, and its
  live reload;
- the prefill queue: the payload equal to the JAX queue's, touch, and
  redelivery after a consumer's death;
- the scheduler's remote hooks step for step against the JAX scheduler
  (page ids, epochs, parked and gated state, salvage counts);
- `extract_pages` bytes equal to the JAX engine's, bf16 and int8 pages
  (scales included), after the same pages were injected into both;
- remote alloc + inject + activate token-identical to the local engine and
  to the JAX engine doing the same, at pipeline_depth 1 and 2 (at depth 2
  the activation lands while a decode window is in flight);
- the disagg workers end to end (LocalTransferBackend) token-identical to
  the aggregated port engine and to the JAX disagg workers, greedy and
  seeded-sampled; a short prompt stays local; abort, timeout and failure
  paths; the prefill worker's drain;
- an inject keeps the decode engine's window graphs, its staged inputs and
  the device carry (the same objects after it).

Tolerances: token identity for streams; byte equality for extracted pages;
the cache after an inject equal to the JAX cache (|diff| <= 1e-6, in fact
0) outside the port's scratch page.
"""
import asyncio
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import (
    DisaggDecodeWorker as JDecodeWorker,
    DisaggregatedRouter as JRouter,
    LocalTransferBackend as JLocalTransfer, PrefillQueue as JQueue,
    PrefillWorker as JPrefillWorker,
    RemotePrefillRequest as JRemoteRequest,
)
from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
    Scheduler as JScheduler,
)
from dynamo_tpu.llm.worker import NativeEngineWorker as JWorker
from dynamo_tpu.protocols.common import (
    PreprocessedRequest as JPre, SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.transports.memory import MemoryPlane as JPlane
from dynamo_tpu_torch.disagg.protocols import (
    PrefillCompletion, RemotePrefillRequest,
)
from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.router import DisaggregatedRouter, config_key
from dynamo_tpu_torch.disagg.transfer import LocalTransferBackend
from dynamo_tpu_torch.disagg.worker import DisaggDecodeWorker, PrefillWorker
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
    Scheduler as TScheduler,
)
from dynamo_tpu_torch.llm.worker import NativeEngineWorker
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest, SamplingOptions, StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.codec import unpackb
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

torch.set_num_threads(1)

JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=512)
# tests/test_disagg.py's geometry (also tests/test_torch_engine.py's)
PAGE = 8
ENGINE_KW = dict(page_size=PAGE, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
PROMPT = list(range(100, 120))   # 20 tokens -> 3 pages
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
SAMPLED = dict(max_tokens=6, temperature=0.8, top_k=20, seed=7,
               ignore_eos=True)


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax_params, TCFG, "cpu")


def port_engine(port_params, cfg=TCFG, **kw):
    return TNativeEngine(cfg, TEngineConfig(**dict(ENGINE_KW, **kw)),
                         params=port_params, device="cpu")


def jax_engine(jax_params, cfg=JCFG, **kw):
    return JNativeEngine(cfg, JEngineConfig(**dict(ENGINE_KW, **kw)),
                         params=jax_params, seed=0)


def t_pre(rid, prompt, **kw):
    sp = dict(GREEDY, **kw)
    return PreprocessedRequest(
        request_id=rid, token_ids=list(prompt),
        sampling=SamplingOptions(temperature=sp["temperature"],
                                 top_k=sp.get("top_k"), seed=sp.get("seed")),
        stop=StopConditions(max_tokens=sp["max_tokens"], ignore_eos=True))


def j_pre(rid, prompt, **kw):
    sp = dict(GREEDY, **kw)
    return JPre(
        request_id=rid, token_ids=list(prompt),
        sampling=JSampling(temperature=sp["temperature"],
                           top_k=sp.get("top_k"), seed=sp.get("seed")),
        stop=JStop(max_tokens=sp["max_tokens"], ignore_eos=True))


async def t_drive(gen):
    toks, reason = [], None
    async for f in gen:
        toks.extend(f.token_ids)
        if f.finish_reason is not None:
            reason = f.finish_reason.value
    return toks, reason


async def j_drive(gen):
    toks, reason = [], None
    async for f in gen:
        toks.extend(f.get("token_ids", ()))
        if f.get("finish_reason") not in (None, "prefill_done"):
            reason = f["finish_reason"]
    return toks, reason


# -- the decision and the queue ------------------------------------------------

def test_router_decisions_match_jax_over_grid():
    for local, qsize in ((1000, 2), (10, 2), (0, 1), (500, 4)):
        t = DisaggregatedRouter(local, qsize)
        j = JRouter(local, qsize)
        for length in (0, 5, 10, 11, 499, 500, 501, 999, 1000, 1001, 3000):
            for hit in (0, 64, 512, 2048):
                for depth in (0, 1, 2, 3, 4):
                    assert t.prefill_remote(length, hit, depth) == \
                        j.prefill_remote(length, hit, depth), \
                        (local, qsize, length, hit, depth)


def test_router_threshold_live_reload():
    async def main():
        plane = MemoryPlane()
        r = DisaggregatedRouter(max_local_prefill_length=1000, model="m")
        task = r.start_watching(plane.kv)
        await asyncio.sleep(0.05)
        await plane.kv.put(config_key("m"),
                           b'{"max_local_prefill_length": 10, '
                           b'"max_prefill_queue_size": 5}')
        for _ in range(100):
            if r.max_local_prefill_length == 10:
                break
            await asyncio.sleep(0.01)
        await plane.kv.put(config_key("m"), b"not json")   # ignored
        await asyncio.sleep(0.05)
        task.cancel()
        return r.max_local_prefill_length, r.max_prefill_queue_size

    assert asyncio.run(main()) == (10, 5)


def test_prefill_queue_roundtrip_matches_jax_payload():
    kw = dict(engine_id="e1", request_id="r1", token_ids=[1, 2, 3],
              page_ids=[4, 5], num_cached_tokens=8, page_size=8,
              alloc_epoch=3, notify_subject="disagg.prefill_done.e1",
              deadline_unix=123.5, enqueued_unix=100.25,
              trace={"tid": "t1", "sid": "s1", "s": 1})

    async def main():
        plane = MemoryPlane()
        q = PrefillQueue(plane.messaging, "ns", "model-a")
        req = RemotePrefillRequest(
            sampling=SamplingOptions(temperature=0.5, seed=4),
            stop=StopConditions(max_tokens=7, ignore_eos=True), **kw)
        await q.enqueue(req)
        assert await q.depth() == 1
        raw = await plane.messaging.queue_pop(q.name, timeout=1.0)
        await plane.messaging.queue_push(q.name, raw)
        got, token = await q.dequeue_leased(timeout=1.0)
        assert await q.depth() == 0
        await q.ack(token)
        empty = await q.dequeue_leased(timeout=0.05)
        return req, got, empty, raw

    req, got, empty, raw = asyncio.run(main())
    assert got == req and empty is None
    # the JAX queue's payload for the same item, its trace context included
    jreq = JRemoteRequest(sampling=JSampling(temperature=0.5, seed=4),
                          stop=JStop(max_tokens=7, ignore_eos=True), **kw)
    jdump = jreq.model_dump()
    assert jdump["trace"] == kw["trace"]
    assert unpackb(raw) == jdump
    assert JQueue(None, "ns", "model-a").name == \
        PrefillQueue(None, "ns", "model-a").name


def test_prefill_queue_touch_extends_lease():
    async def main():
        plane = MemoryPlane()
        queue = PrefillQueue(plane.messaging, "ns", "tiny")
        await queue.enqueue(RemotePrefillRequest(
            engine_id="dec-0", request_id="q1", token_ids=[1, 2, 3],
            page_ids=[0], page_size=8))
        item, token = await queue.dequeue_leased(timeout=1.0, lease_s=0.3)
        await asyncio.sleep(0.2)
        assert await queue.touch(token, lease_s=0.6)   # re-armed
        await asyncio.sleep(0.3)          # past the first deadline
        assert await queue.depth() == 0
        assert plane.messaging.redeliveries == 0
        await asyncio.sleep(0.5)          # past the touched one too
        assert await queue.depth() == 1   # redelivered now
        got2 = await queue.dequeue_leased(timeout=1.0, lease_s=5.0)
        assert got2 is not None and got2[0].request_id == "q1"
        assert not await queue.touch(token, lease_s=1.0)   # a dead token
        await queue.ack(got2[1])
        assert await queue.depth() == 0

    asyncio.run(asyncio.wait_for(main(), 30))


# -- the scheduler hooks, step for step ----------------------------------------

def test_scheduler_remote_hooks_match_jax():
    """One script of remote allocations, early-decode gates, salvage,
    release and a prefill-only park through both schedulers: the same page
    ids, epochs, prefix hits, parked / remote / gated state and plans."""
    jcfg = JEngineConfig(**ENGINE_KW)
    tcfg = TEngineConfig(**ENGINE_KW)
    scheds = (JScheduler(jcfg), TScheduler(tcfg))
    frontier = {"a": 0}

    def both(fn):
        return [fn(s, cls) for s, cls in zip(
            scheds, ((JRequest, JSamplingParams),
                     (TRequest, TSamplingParams)))]

    def req(classes, rid, prompt, **kw):
        r, p = classes
        return r(rid, list(prompt), p(max_tokens=4, **kw))

    def state(s, _classes=None):
        return (sorted((k, list(v.pages), v.num_cached, v.epoch)
                       for k, v in s.remote.items()),
                sorted((k, list(v.pages)) for k, v in s.parked.items()),
                sorted(s.overlap_gates),
                [(q.request_id, q.num_cached, list(q.output))
                 for q in s.waiting],
                s.allocator.num_free, s.overlap_activations)

    def plan_sig(p):
        if p is None:
            return None
        return (type(p).__name__, p.tokens.tolist(), p.page_table.tolist(),
                [q.request_id if q else None for q in p.seqs])

    allocs = both(lambda s, c: s.add_remote(req(c, "a", range(40, 60))))
    assert [(a.page_ids, a.num_cached_tokens, a.alloc_epoch)
            for a in allocs] == [(allocs[1].page_ids, 0,
                                  allocs[1].alloc_epoch)] * 2
    both(lambda s, c: s.add_remote(req(c, "b", range(40, 70))))
    assert len(set(map(str, both(state)))) == 1
    # gate "a" on a frontier that is not there yet
    both(lambda s, c: s.preactivate_remote("a", 77, 3,
                                           lambda: frontier["a"]))
    assert both(lambda s, c: s.poll_overlap_gates()) == [0, 0]
    frontier["a"] = 3
    assert both(lambda s, c: s.poll_overlap_gates()) == [1, 1]
    # "b": a partial transfer, salvaged after 2 of its 4 pages
    assert both(lambda s, c: s.salvage_remote("b", 2)) == [16, 16]
    assert len(set(map(str, both(state)))) == 1
    # the same plans from here on: a's one-token chunk, b's tail
    for _ in range(3):
        plans = both(lambda s, c: s.schedule())
        assert plan_sig(plans[0]) == plan_sig(plans[1])
        if not hasattr(plans[0], "is_last_chunk"):
            break    # idle or a decode plan: the prefills are done
        for s, p in zip(scheds, plans):
            decode_rows = getattr(p, "is_decode", [False] * len(p.seqs))
            for i in reversed(range(len(p.seqs))):
                if p.seqs[i] is not None and not decode_rows[i]:
                    s.commit_prefill_row(p, i, 5 if p.is_last_chunk[i]
                                         else None)
        assert len(set(map(str, both(state)))) == 1
    # a new remote allocation sharing b's sealed prefix (its 3 full pages
    # once its tail prefilled): the same prefix hit on both
    assert both(lambda s, c: s.peek_prefix(list(range(40, 70)))) == [24, 24]
    third = both(lambda s, c: s.add_remote(req(c, "c", range(40, 70))))
    assert third[0].page_ids == third[1].page_ids
    assert third[0].num_cached_tokens == third[1].num_cached_tokens == 24
    assert both(lambda s, c: s.cancel_overlap("c")) == [False, False]
    both(lambda s, c: s.release_remote("c"))
    # a prefill-only request parks with its pages held
    both(lambda s, c: s.add_request(dataclass_prefill_only(
        req(c, "p", range(200, 219)))))
    plans = both(lambda s, c: s.schedule())
    assert plan_sig(plans[0]) == plan_sig(plans[1])
    for s, p in zip(scheds, plans):
        for i in reversed(range(len(p.seqs))):
            if p.seqs[i] is not None and p.seqs[i].request_id == "p":
                assert s.commit_prefill_row(p, i, 9 if p.is_last_chunk[i]
                                            else None) in (None, 9)
    assert len(set(map(str, both(state)))) == 1
    assert both(lambda s, c: s.abort("p")) == [True, True]
    assert len(set(map(str, both(state)))) == 1


def dataclass_prefill_only(r):
    r.prefill_only = True
    return r


# -- page extract / inject -----------------------------------------------------

def _random_pages(tcfg, kv_quant, n, seed):
    """Random pages in the stored representation: bf16 values, or int8
    values + f32 scales."""
    rng = np.random.default_rng(seed)
    shape = (tcfg.num_layers, tcfg.num_kv_heads, n, PAGE, tcfg.head_dim)
    if kv_quant:
        vals = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        scales = [rng.random(shape[:-1]).astype(np.float32)
                  for _ in range(2)]
        return vals + scales
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_extract_pages_bytes_match_jax(kv_quant):
    """The same pages injected into the JAX and the port engine (bf16 or
    int8 caches) extract to equal bytes, padding rows included, and the
    caches agree outside the port's scratch page."""
    jcfg = JModelConfig(dtype="bfloat16", max_model_len=512,
                        decode_kernel="off")
    tcfg = TModelConfig(dtype="bfloat16", max_model_len=512)
    kw = dict(ENGINE_KW, kv_quant=kv_quant)
    # only pages move here: each engine keeps its own bf16 weights
    jeng = JNativeEngine(jcfg, JEngineConfig(**kw), seed=0)
    teng = TNativeEngine(tcfg, TEngineConfig(**kw), device="cpu")
    arrays = _random_pages(tcfg, kv_quant, 4, seed=3)
    ids = [5, 9, 2]          # 3 real pages in a frame of 4 (pow2)
    if kv_quant:
        jpages = [jnp.asarray(a) for a in arrays]
        tpages = [torch.from_numpy(a) for a in arrays]
    else:
        jpages = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
        tpages = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    jeng.inject_pages(ids, *[jax.device_put(p, jeng.cache_sharding
                                            if p.ndim == 5 else
                                            jeng.cache_scale_sharding)
                             for p in jpages])
    teng.inject_pages(ids, *tpages)

    def host(t):
        if isinstance(t, torch.Tensor):
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            return t.numpy()
        a = np.asarray(jax.device_get(t))
        return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a

    for page_ids in ([5, 9, 2], [2], [9, 5, 2, 0, 1]):
        jx = jeng.extract_pages(page_ids)
        tx = teng.extract_pages(page_ids)
        assert set(jx) == set(tx) - {"ready"}
        for key in jx:
            a, b = host(jx[key]), host(tx[key])
            assert a.shape == b.shape and a.dtype == b.dtype, key
            assert a.tobytes() == b.tobytes(), key
    # the whole cache outside the scratch page (the last one in the port)
    for key, arr in teng.cache.items():
        a = host(jeng.cache[key])
        b = host(arr)[:, :, :-1]
        if a.dtype == np.int16:   # bf16 bits
            assert np.array_equal(a, b), key
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def _prefill_only(eng, rid, prompt, params_cls, req_cls, **kw):
    r = req_cls(rid, list(prompt), params_cls(**dict(GREEDY, **kw)))
    r.prefill_only = True
    eng.add_request(r)
    outs = []
    while eng.has_work():
        outs.extend(eng.step())
    assert len(outs) == 1 and outs[0].finish_reason == "prefill_done"
    return outs[0].token


@pytest.mark.parametrize("depth", [1, 2])
def test_remote_inject_activate_matches_local_and_jax(jax_params,
                                                      port_params, depth):
    """The port's remote path (prefill-only engine -> extract -> decode
    engine's up-front allocation -> inject -> activate) gives the local
    engine's tokens and the JAX engine's doing the same. A second request
    decodes meanwhile on the decode engine, so that at depth 2 the remote
    sequence activates while a decode window is in flight."""
    other = list(range(10, 30))
    params = dict(max_tokens=12, temperature=0.0, ignore_eos=True)

    def run(eng, req_cls, params_cls, pre_eng, move):
        first = _prefill_only(pre_eng, "r", PROMPT, params_cls, req_cls)
        eng.add_request(req_cls("o", other, params_cls(**params)))
        out = {"o": [], "r": [first]}
        steps = 0
        activated = False
        while eng.has_work() or not activated:
            if not activated and steps == 3:
                pending = eng._pipeline is not None
                alloc = eng.allocate_remote(
                    req_cls("r", PROMPT, params_cls(**GREEDY)))
                move(pre_eng, eng, alloc)
                eng.activate_remote("r", first)
                activated = True
                if depth == 2 and hasattr(eng, "graphs"):
                    assert pending, "no window in flight at activation"
            for ev in eng.step():
                if ev.token is not None:
                    out[ev.request_id].append(ev.token)
            steps += 1
        return out

    def t_move(src, dst, alloc):
        pages = src.extract_pages(src.scheduler.parked["r"].pages)
        dst.inject_pages(alloc.page_ids, pages["k"], pages["v"],
                         ready=pages["ready"])
        src.release_parked("r")

    def j_move(src, dst, alloc):
        pages = src.extract_pages(src.scheduler.parked["r"].pages)
        dst.inject_pages(alloc.page_ids,
                         jax.device_put(pages["k"], dst.cache_sharding),
                         jax.device_put(pages["v"], dst.cache_sharding))
        src.release_parked("r")

    tout = run(port_engine(port_params, pipeline_depth=depth), TRequest,
               TSamplingParams, port_engine(port_params), t_move)
    jout = run(jax_engine(jax_params, pipeline_depth=depth), JRequest,
               JSamplingParams, jax_engine(jax_params), j_move)
    assert tout == jout
    local = port_engine(port_params).generate(
        PROMPT, TSamplingParams(**GREEDY), "local")
    assert tout["r"] == local
    assert len(tout["o"]) == 12


def test_inject_keeps_window_graphs_and_carry(port_params):
    """An inject writes the cache in place: the decode engine's window
    graphs, their staged input buffers, the cache tensors and the device
    carry are the same objects afterwards, and the next window re-uses the
    staged plan (no upload)."""
    # one 64-token page holds the whole request: the staged plan is reused
    # window after window (tests/test_torch_pipeline.py's geometry)
    geo = dict(page_size=64, num_pages=32, decode_steps=4)
    eng = port_engine(port_params, pipeline_depth=1, **geo)
    eng.add_request(TRequest("o", list(range(10, 30)),
                             TSamplingParams(max_tokens=40,
                                             ignore_eos=True)))
    for _ in range(4):
        eng.step()
    assert eng._dec_state is not None
    before = (eng.graphs, dict(eng.graphs._inputs), eng._dec_state,
              {k: v.data_ptr() for k, v in eng.cache.items()})
    uploads = eng.decode_plan_uploads
    alloc = eng.allocate_remote(TRequest("r", PROMPT,
                                         TSamplingParams(**GREEDY)))
    pre = port_engine(port_params, **geo)
    _prefill_only(pre, "r", PROMPT, TSamplingParams, TRequest)
    pages = pre.extract_pages(pre.scheduler.parked["r"].pages)
    eng.inject_pages(alloc.page_ids, pages["k"], pages["v"])
    after = (eng.graphs, dict(eng.graphs._inputs), eng._dec_state,
             {k: v.data_ptr() for k, v in eng.cache.items()})
    assert after[0] is before[0] and after[2] is before[2]
    assert after[1].keys() == before[1].keys() and all(
        after[1][k] is before[1][k] for k in before[1])
    assert after[3] == before[3]
    eng.step()   # the next window of "o": the staged plan, no upload
    assert eng.decode_plan_uploads == uploads
    for key in ("k", "v"):
        got = eng.cache[key].index_select(
            2, torch.tensor(alloc.page_ids))
        assert torch.equal(got, pages[key][:, :, :len(alloc.page_ids)])


# -- the workers ---------------------------------------------------------------

def _t_stack(plane, port_params, local_threshold=4, transfer=None,
             prefill_timeout_s=30.0, **prefill_kw):
    queue = PrefillQueue(plane.messaging, "ns", "tiny")
    router = DisaggregatedRouter(max_local_prefill_length=local_threshold,
                                 max_prefill_queue_size=16, model="tiny")
    decode = DisaggDecodeWorker(
        port_engine(port_params), plane.messaging, router, queue,
        worker_id="dec-0", prefill_timeout_s=prefill_timeout_s)
    if transfer is None:
        transfer = LocalTransferBackend()
    if isinstance(transfer, LocalTransferBackend):
        transfer.register("dec-0", decode)
    prefill = PrefillWorker(
        NativeEngineWorker(port_engine(port_params)), queue, transfer,
        plane.messaging, **prefill_kw)
    return decode, prefill, queue


def test_disagg_workers_match_aggregated_and_jax(jax_params, port_params):
    """Two remote requests (greedy, seeded-sampled) and a local one through
    the port's workers: the aggregated port engine's tokens, and the JAX
    disagg workers' on the same weights."""
    reqs = [("g", PROMPT, {}), ("s", list(range(60, 85)), SAMPLED),
            ("l", [3, 4, 5], {})]

    async def port():
        plane = MemoryPlane()
        decode, prefill, _ = _t_stack(plane, port_params)
        await decode.start()
        await prefill.start()
        try:
            out = {}
            for rid, prompt, kw in reqs:
                out[rid] = await t_drive(decode.generate(
                    t_pre(rid, prompt, **kw), Context(rid)))
        finally:
            await prefill.stop()
            await decode.stop()
        return out, (decode.remote_prefills, decode.local_prefills,
                     prefill.completed, decode.full_reprefills,
                     decode.salvaged_prefills)

    async def jax_side():
        plane = JPlane()
        queue = JQueue(plane.messaging, "ns", "tiny")
        router = JRouter(max_local_prefill_length=4,
                         max_prefill_queue_size=16, model="tiny")
        transfer = JLocalTransfer()
        decode = JDecodeWorker(jax_engine(jax_params), plane.messaging,
                               router, queue, worker_id="dec-0",
                               prefill_timeout_s=30.0)
        transfer.register("dec-0", decode)
        prefill = JPrefillWorker(JWorker(jax_engine(jax_params)), queue,
                                 transfer, plane.messaging)
        await decode.start()
        await prefill.start()
        try:
            out = {}
            for rid, prompt, kw in reqs:
                out[rid] = await j_drive(decode.generate(
                    j_pre(rid, prompt, **kw).model_dump(exclude_none=True),
                    JContext(rid)))
        finally:
            await prefill.stop()
            await decode.stop()
        return out

    tout, counts = asyncio.run(asyncio.wait_for(port(), 120))
    assert counts == (2, 1, 2, 0, 0)
    assert tout == asyncio.run(asyncio.wait_for(jax_side(), 120))
    agg = port_engine(port_params)
    for rid, prompt, kw in reqs:
        assert tout[rid] == (agg.generate(
            prompt, TSamplingParams(**dict(GREEDY, **kw)), rid), "length")


def test_disagg_short_prompt_stays_local(port_params):
    async def main():
        plane = MemoryPlane()
        decode, prefill, _ = _t_stack(plane, port_params,
                                      local_threshold=100)
        await decode.start()
        await prefill.start()
        try:
            toks, _ = await t_drive(decode.generate(
                t_pre("s1", range(4)), Context("s1")))
        finally:
            await prefill.stop()
            await decode.stop()
        return toks, decode.remote_prefills, decode.local_prefills, \
            decode.decisions["s1"]

    toks, n_remote, n_local, decision = asyncio.run(main())
    assert (n_remote, n_local, len(toks)) == (0, 1, 6)
    assert decision == {"prompt_len": 4, "remote": False}


def test_disagg_remote_first_token_hidden_stop_not_emitted(port_params):
    first = port_engine(port_params).generate(
        PROMPT, TSamplingParams(**GREEDY), "oracle")[0]

    async def main():
        plane = MemoryPlane()
        decode, prefill, _ = _t_stack(plane, port_params)
        await decode.start()
        await prefill.start()
        try:
            pre = t_pre("h1", PROMPT)
            pre.stop.stop_token_ids_hidden = [first]
            return await t_drive(decode.generate(pre, Context("h1"))), \
                decode.remote_prefills
        finally:
            await prefill.stop()
            await decode.stop()

    (toks, reason), n_remote = asyncio.run(main())
    assert (toks, reason, n_remote) == ([], "stop", 1)


class _GatedTransfer(LocalTransferBackend):
    def __init__(self):
        super().__init__()
        self.gate = asyncio.Event()
        self.sent = []

    async def send_pages(self, engine_id, request_id, *a, **k):
        await self.gate.wait()
        self.sent.append(request_id)
        await super().send_pages(engine_id, request_id, *a, **k)


class _HoldTransfer(LocalTransferBackend):
    """Never completes."""

    async def send_pages(self, *a, **k):
        await asyncio.Event().wait()


def test_disagg_client_abort_cancels_remote_prefill(port_params):
    """Both clients disconnect, one item mid-run (held at the transfer) and
    one still queued: both streams end cancelled, nothing is transferred
    or redelivered, and the decode side frees its allocations."""
    async def main():
        plane = MemoryPlane()
        transfer = _GatedTransfer()
        decode, prefill, queue = _t_stack(
            plane, port_params, transfer=transfer, dequeue_timeout_s=0.1,
            max_inflight=1, lease_s=30.0)
        await decode.start()
        await prefill.start()
        ctx_a, ctx_b = Context("abortA"), Context("abortB")
        task_a = asyncio.create_task(t_drive(decode.generate(
            t_pre("abortA", PROMPT), ctx_a)))
        deadline = time.monotonic() + 20
        while "abortA" not in prefill._handling:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.02)
        task_b = asyncio.create_task(t_drive(decode.generate(
            t_pre("abortB", PROMPT), ctx_b)))
        while await queue.depth() < 1:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.02)
        ctx_a.stop_generating()
        ctx_b.stop_generating()
        res = await asyncio.wait_for(asyncio.gather(task_a, task_b), 30)
        assert res == [([], "cancelled"), ([], "cancelled")]
        transfer.gate.set()
        for _ in range(100):
            if prefill.cancelled >= 2:
                break
            await asyncio.sleep(0.02)
        assert prefill.cancelled == 2
        assert transfer.sent == [] and prefill.completed == 0

        def remote_state(eng):
            return len(eng.scheduler.remote), eng.scheduler.allocator.num_free
        for _ in range(100):
            n_remote, _ = await decode.submit(remote_state)
            if n_remote == 0:
                break
            await asyncio.sleep(0.02)
        assert await decode.submit(remote_state) == \
            (0, decode.engine.cfg.num_pages)
        await asyncio.sleep(0.2)
        assert await queue.depth() == 0
        await prefill.stop()
        await decode.stop()

    asyncio.run(asyncio.wait_for(main(), 120))


def test_disagg_prefill_timeout_broadcasts_cancel(port_params):
    """A remote prefill the decode side times out on is cancelled fleet-wide
    (counted), and the stream falls back to a local prefill with the
    aggregated tokens."""
    expect = port_engine(port_params).generate(
        PROMPT, TSamplingParams(**GREEDY), "oracle")

    async def main():
        plane = MemoryPlane()
        decode, prefill, queue = _t_stack(
            plane, port_params, transfer=_HoldTransfer(),
            prefill_timeout_s=1.0, dequeue_timeout_s=0.1, lease_s=30.0)
        await decode.start()
        await prefill.start()
        try:
            toks, reason = await t_drive(decode.generate(
                t_pre("rt", PROMPT), Context("rt")))
            assert (toks, reason) == (expect, "length")
            deadline = time.monotonic() + 20
            while prefill.cancelled < 1:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.02)
            assert (prefill.cancelled, prefill.completed) == (1, 0)
            await asyncio.sleep(0.2)
            assert await queue.depth() == 0
            return decode.stats_handler()["disagg"]
        finally:
            await prefill.stop()
            await decode.stop()

    st = asyncio.run(asyncio.wait_for(main(), 120))
    # no transfer server, so no early decode: the wait timed out, nothing
    # had committed, and the request prefilled locally from token zero
    assert (st["prefill_timeouts"], st["full_reprefills"],
            st["salvaged_prefills"], st["overlap_fallbacks"]) == (1, 1, 0, 0)


def test_disagg_prefill_failure_falls_back_local(port_params):
    expect = port_engine(port_params).generate(
        PROMPT, TSamplingParams(**GREEDY), "oracle")

    class Broken(LocalTransferBackend):
        async def send_pages(self, *a, **k):
            raise RuntimeError("link down")

    async def main():
        plane = MemoryPlane()
        decode, prefill, _ = _t_stack(plane, port_params,
                                      transfer=Broken())
        await decode.start()
        await prefill.start()
        try:
            out = await t_drive(decode.generate(t_pre("f1", PROMPT),
                                                Context("f1")))
        finally:
            await prefill.stop()
            await decode.stop()
        return out, prefill.failed, decode.local_prefills, \
            decode.full_reprefills

    (toks, reason), n_failed, n_local, n_full = asyncio.run(main())
    assert (n_failed, n_local, n_full) == (1, 1, 1)
    assert (toks, reason) == (expect, "length")


def test_expired_deadline_dropped_at_dequeue(port_params):
    async def main():
        plane = MemoryPlane()
        queue = PrefillQueue(plane.messaging, "ns", "tiny")
        notify = "ns.completions.dec-0"
        sub = await plane.messaging.subscribe(notify)
        prefill = PrefillWorker(
            NativeEngineWorker(port_engine(port_params)), queue,
            LocalTransferBackend(), plane.messaging, dequeue_timeout_s=0.1)
        await queue.enqueue(RemotePrefillRequest(
            engine_id="dec-0", request_id="r-expired", token_ids=PROMPT,
            page_ids=[0, 1, 2], page_size=PAGE, notify_subject=notify,
            deadline_unix=time.time() - 1.0))
        await prefill.start()
        _subject, payload = await asyncio.wait_for(
            sub.__aiter__().__anext__(), 30)
        done = PrefillCompletion.from_bytes(payload)
        counters = (prefill.expired, prefill.completed, prefill.failed)
        depth = await queue.depth()
        await prefill.stop()
        return done, counters, depth, plane.messaging.redeliveries

    done, counters, depth, redelivered = asyncio.run(
        asyncio.wait_for(main(), 60))
    assert done.request_id == "r-expired" and "deadline" in done.error
    assert counters == (1, 0, 0) and (depth, redelivered) == (0, 0)


@pytest.mark.parametrize("how", ["death", "drain"])
def test_prefill_worker_death_or_drain_releases_item(port_params, how):
    """A prefill worker that dies (stop) or drains past its deadline while
    holding an item does not ack it: the lease redelivers it to a surviving
    worker and the stream completes with the aggregated tokens."""
    expect = port_engine(port_params).generate(
        PROMPT, TSamplingParams(**GREEDY), "oracle")

    async def main():
        plane = MemoryPlane()
        transfer = LocalTransferBackend()
        decode, doomed, queue = _t_stack(
            plane, port_params, transfer=_HoldTransfer(),
            prefill_timeout_s=60.0, dequeue_timeout_s=0.1, lease_s=0.3)
        transfer.register("dec-0", decode)
        await decode.start()
        await doomed.start()
        task = asyncio.create_task(t_drive(decode.generate(
            t_pre("r1", PROMPT), Context("r1"))))
        deadline = time.monotonic() + 20
        while "r1" not in doomed._handling:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.02)
        summary = None
        if how == "drain":
            summary = await doomed.drain(timeout_s=0.2)
        else:
            await doomed.stop()
        survivor = await PrefillWorker(
            NativeEngineWorker(port_engine(port_params)), queue, transfer,
            plane.messaging, dequeue_timeout_s=0.1, lease_s=10.0).start()
        out = await asyncio.wait_for(task, 60)
        completed = survivor.completed
        await survivor.stop()
        await decode.stop()
        return out, summary, completed, plane.messaging.redeliveries

    (toks, reason), summary, completed, redelivered = asyncio.run(
        asyncio.wait_for(main(), 120))
    assert (toks, reason) == (expect, "length")
    assert completed == 1 and redelivered >= 1
    if how == "drain":
        assert summary == {"re_leased": 1}


def test_prefill_drain_counts_as_jax(jax_params, port_params):
    """Both packages' prefill workers drained past their deadline with one
    item in flight (held at the transfer): the DRAIN_STATS deltas are
    equal (one drain started and completed, one stream left to its
    lease)."""
    from dynamo_tpu.runtime.component import DRAIN_STATS as JDRAIN
    from dynamo_tpu_torch.runtime.component import DRAIN_STATS as TDRAIN

    class JHold(JLocalTransfer):
        async def send_pages(self, *a, **k):
            await asyncio.Event().wait()

    async def run(jax_side):
        stats = JDRAIN if jax_side else TDRAIN
        before = stats.snapshot()
        if jax_side:
            plane = JPlane()
            queue = JQueue(plane.messaging, "ns", "tiny")
            decode = JDecodeWorker(
                jax_engine(jax_params), plane.messaging,
                JRouter(max_local_prefill_length=4,
                        max_prefill_queue_size=16, model="tiny"),
                queue, worker_id="dec-0", prefill_timeout_s=60.0)
            prefill = JPrefillWorker(
                JWorker(jax_engine(jax_params)), queue, JHold(),
                plane.messaging, dequeue_timeout_s=0.1, lease_s=30.0)
            gen = decode.generate(j_pre("r1", PROMPT), JContext("r1"))
        else:
            plane = MemoryPlane()
            decode, prefill, queue = _t_stack(
                plane, port_params, transfer=_HoldTransfer(),
                prefill_timeout_s=60.0, dequeue_timeout_s=0.1,
                lease_s=30.0)
            gen = decode.generate(t_pre("r1", PROMPT), Context("r1"))
        await decode.start()
        await prefill.start()
        task = asyncio.create_task((j_drive if jax_side else t_drive)(gen))
        deadline = time.monotonic() + 30
        while "r1" not in prefill._handling:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.02)
        summary = await prefill.drain(timeout_s=0.2, poll_s=0.02)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        await decode.stop()
        after = stats.snapshot()
        return summary, {k: after[k] - before[k] for k in after}

    got = asyncio.run(asyncio.wait_for(run(False), 120))
    assert got == asyncio.run(asyncio.wait_for(run(True), 120))
    assert got[0] == {"re_leased": 1}
    assert got[1]["drains_started"] == got[1]["drains_completed"] == 1
    assert got[1]["cancelled_streams"] == 1
