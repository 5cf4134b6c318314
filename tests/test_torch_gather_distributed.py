"""The port's gather decode window on the distributed path, against the JAX
package on the same config and weights (tests/torch_decode_paths.py:
`tiny` with decode_kernel="off", and a tiny Gemma-2 whose soft-caps,
sliding windows and query scale send the port's "auto" to the gather
window), on the CPU in float32, token for token.

- Behind the router: two port workers behind the port's KvRouter (the
  default TransferAwareSelector, seeded so that wave 1's two prompts land
  on different workers) and its RemotePipeline, two JAX
  workers behind the JAX router the same way, over each package's memory
  control plane; chats over two shared system prompts in two waves, one at
  a time. The picks, the matched-page counts (hashes differ by design:
  BLAKE2b against xxh3, so counts, never values), each worker's KV events
  (every hash replaced by the index of its first appearance) and the
  streams are equal; each second-wave chat lands on its prompt's worker
  with its prompt's sealed pages matched.
- A migrated stream: the port worker serving it goes silent mid-stream
  under the ReliableClient, the survivor re-prefills prompt + committed
  tokens; the stream equals the JAX engine's.
- Disaggregated over the TCP transfer plane: early decode with the
  transfer slowed (a second request's gather windows are dispatched while
  the remote sequence's last chunk is still in flight, the remote one is
  preactivated and joins when its pages commit), and a salvage (the link
  dies after committed pages; the decode side keeps them and prefills the
  rest); streams equal the JAX engine's. The extracted pages' bytes equal
  JAX's, and the cache after injecting them equals JAX's.
- Page reuse: every page of the port's cache starts as NaN and every page
  the allocator evicts is NaN again before its new owner writes it, so a
  gather base that read a stale V row (the once-a-window zeroing missed)
  or a stale K row unmasked would show in the stream; a preempted-and-
  resumed request, a salvaged one, an injected one and prefixes evicted
  and re-placed all equal the JAX engine's streams (JAX on a clean cache).
- Preemption against a gather window in flight: at depth 2 an interactive
  arrival preempts the batch decode while its follow-up window is in
  flight (in both packages at the same step); the epoch bump discards the
  carry and both streams equal JAX's.
"""
import asyncio
import random

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu_torch.disagg.queue import PrefillQueue
from dynamo_tpu_torch.disagg.remote_transfer import (
    KvTransferServer, RemoteTransferBackend,
)
from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
from dynamo_tpu_torch.disagg.worker import DisaggDecodeWorker, PrefillWorker
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.llm.worker import NativeEngineWorker
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest, StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.integrity import XFER_STATS
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from tests import torch_decode_paths as paths

torch.set_num_threads(1)

T = 120.0
PAGE = 8
ENGINE_KW = dict(page_size=PAGE, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
GREEDY = dict(max_tokens=6, temperature=0.0, ignore_eos=True)


def run(coro, timeout=T):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def t_engine(path, **kw):
    _, tcfg, _, tparams = paths.env(path)
    eng = TNativeEngine(tcfg, TEngineConfig(**dict(ENGINE_KW, **kw)),
                        params=tparams, device="cpu")
    paths.check_path(eng, path)
    return eng


def j_engine(path, **kw):
    jcfg, _, tree, _ = paths.env(path)
    return JNativeEngine(jcfg, JEngineConfig(**dict(ENGINE_KW, **kw)),
                         params=paths.jax_params(tree), seed=0)


def jax_streams(path, *requests):
    """Each (prompt, sampling overrides) alone, in turn, on one fresh JAX
    engine (one compile); no two prompts share a first page, so none hits
    another's prefix."""
    eng = j_engine(path)
    return [eng.generate(list(prompt), JSamplingParams(**dict(GREEDY, **kw)),
                         f"oracle{i}")
            for i, (prompt, kw) in enumerate(requests)]


def jax_stream(path, prompt, **kw):
    return jax_streams(path, (prompt, kw))[0]


def canonical(events):
    """KV events with every hash replaced by the index of its first
    appearance (0 stays 0)."""
    ids = {0: 0}
    return [(kind, pid) + tuple(ids.setdefault(x, len(ids))
                                for x in (h, parent, tok))
            for kind, pid, h, parent, tok in events]


# -- behind the router ---------------------------------------------------------

def _modules(pkg: str) -> dict:
    if pkg == "jax":
        from dynamo_tpu.kv_router import router, scheduler, stats
        from dynamo_tpu.llm import model_card, pipeline, worker
        from dynamo_tpu.observability import fleet
        from dynamo_tpu.protocols import common
        from dynamo_tpu.runtime import distributed, engine, health
        from dynamo_tpu.runtime.transports import memory
    else:
        from dynamo_tpu_torch.kv_router import router, scheduler, stats
        from dynamo_tpu_torch.llm import model_card, pipeline, worker
        from dynamo_tpu_torch.observability import fleet
        from dynamo_tpu_torch.protocols import common
        from dynamo_tpu_torch.runtime import distributed, engine, health
        from dynamo_tpu_torch.runtime.transports import memory
    return dict(router=router, scheduler=scheduler, stats=stats,
                card=model_card, pipeline=pipeline, worker=worker,
                fleet=fleet, common=common, distributed=distributed,
                engine=engine, health=health, memory=memory)


@pytest.fixture(autouse=True)
def _reset_router_state():
    """Both packages' process-global cost models, health scorers and
    router counters start each case empty."""
    def reset():
        for pkg in ("jax", "torch"):
            m = _modules(pkg)
            m["fleet"].TRANSFER_MODEL.reset()
            m["stats"].ROUTER_STATS.reset()
            m["health"].HEALTH.reset()
    reset()
    yield
    reset()


def _chats():
    """Two system prompts of 3 pages, user turns of 5-13 tokens: wave 1
    one chat a prompt, wave 2 two more a prompt."""
    rng = np.random.default_rng(22)
    systems = [[int(t) for t in rng.integers(3, 180, 24)] for _ in range(2)]
    waves = []
    for wave, per in ((0, 1), (1, 2)):
        chats = []
        for s in range(2):
            for k in range(per):
                user = [int(t) for t in rng.integers(
                    3, 180, int(rng.integers(5, 14)))]
                chats.append((f"c{wave}{s}{k}", s, systems[s] + user))
        waves.append(chats)
    return systems, waves


def _routed_pre(m, rid, tokens):
    C = m["common"]
    return C.PreprocessedRequest(
        request_id=rid, token_ids=list(tokens),
        stop=C.StopConditions(max_tokens=GREEDY["max_tokens"],
                              ignore_eos=True))


async def _settled(router, published):
    """Wait until the router has applied every router event the workers
    published so far (the pump runs on this loop)."""
    for _ in range(400):
        if router.events_applied >= sum(published):
            return
        await asyncio.sleep(0.005)
    raise AssertionError(
        f"router applied {router.events_applied} of {sum(published)}")


async def _routed(pkg: str, path: str):
    m = _modules(pkg)
    DRT = m["distributed"].DistributedRuntime
    plane = m["memory"].MemoryPlane()
    rts, workers, logs = [], [], {}
    published = []
    for wid in ("w0", "w1"):
        eng = t_engine(path) if pkg == "torch" else j_engine(path)
        log = logs[wid] = []
        drain = eng.drain_kv_events

        def recording(drain=drain, log=log):
            evs = drain()
            log.extend(evs)
            return evs
        eng.drain_kv_events = recording
        w = await m["worker"].NativeEngineWorker(eng).start()
        rt = await DRT.create_local(plane, wid)
        await m["worker"].serve_llm_worker(rt, "ns", "llm", w)
        publish = w.event_publisher.publish_allocator_events

        async def counting(events, publish=publish):
            n = await publish(events)
            published.append(n)
            return n
        w.event_publisher.publish_allocator_events = counting
        rts.append(rt)
        workers.append(w)
    frt = await DRT.create_local(plane, "fe")
    rts.append(frt)
    comp = frt.namespace("ns").component("llm")
    client = comp.endpoint("generate").client()
    await client.start()
    await client.wait_for_instances()
    while len(client.instance_ids()) < 2:
        await asyncio.sleep(0.01)
    router = m["router"].KvRouter(
        comp, client, PAGE,
        selector=m["scheduler"].TransferAwareSelector(rng=random.Random(4)),
        scrape_interval_s=3600.0)
    await router.start()
    picks = []
    schedule = router.schedule

    async def recorded(tokens, *a, **kw):
        scores = dict(router.find_matches_for_tokens(tokens).scores)
        wid = await schedule(tokens, *a, **kw)
        picks.append((wid, scores))
        return wid
    router.schedule = recorded
    card = m["card"].ModelDeploymentCard(name="tiny", arch="tiny",
                                         context_length=512,
                                         kv_page_size=PAGE)
    kw = {} if pkg == "torch" else {"reliability": False}
    pipe = m["pipeline"].RemotePipeline(card, client, router=router, **kw)
    _, waves = _chats()
    streams = {}
    try:
        for wave in waves:
            for rid, _s, tokens in wave:
                await _settled(router, published)
                await router.aggregator.scrape_once()
                toks = []
                async for f in pipe.sink.generate(
                        _routed_pre(m, rid, tokens),
                        m["engine"].Context(rid)):
                    toks += (f.get("token_ids", []) if isinstance(f, dict)
                             else f.token_ids)
                streams[rid] = toks
    finally:
        await router.stop()
        for rt in rts:
            await rt.shutdown()
        for w in workers:
            await w.stop()
    return picks, streams, {w: canonical(e) for w, e in logs.items()}


@pytest.mark.parametrize("path", ["gather", "gemma2"])
def test_routed_gather_workers_equal_jax(path):
    want = run(_routed("jax", path))
    got = run(_routed("torch", path))
    picks, streams, events = got
    assert picks == want[0]
    assert events == want[2]
    assert streams == want[1]
    # the oracle: each chat alone on a JAX engine that has served no other
    # chat of its system prompt
    systems, waves = _chats()
    by_system = [[(rid, t) for wave in waves for rid, s, t in wave
                  if s == k] for k in range(2)]
    for pair in zip(*by_system):
        alone = jax_streams(path, *((t, {}) for _rid, t in pair))
        for (rid, _t), want_rid in zip(pair, alone):
            assert streams[rid] == want_rid, rid
    # wave 2 lands on its prompt's wave-1 worker with the prompt's sealed
    # pages matched (3 of 8 tokens: the 24-token system prompt)
    home = {s: picks[i][0] for i, (_r, s, _t) in enumerate(waves[0])}
    assert len(set(home.values())) == 2
    for i, (rid, s, tokens) in enumerate(waves[1], start=len(waves[0])):
        wid, scores = picks[i]
        assert wid == home[s], rid
        assert scores.get(wid, 0) >= len(systems[s]) // PAGE, (rid, scores)
    assert all(k in ("stored", "removed") for e in events.values()
               for k, *_ in e)


# -- a migrated stream -----------------------------------------------------------

class StopsMidStream(NativeEngineWorker):
    """A worker whose streams go silent after `after` tokens (an engine
    wedged behind a live connection)."""

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


@pytest.mark.parametrize("path", ["gather", "gemma2"])
def test_migrated_stream_on_gather_equals_jax(path):
    from dynamo_tpu_torch.frontend.reliability import (
        CircuitBreaker, ReliabilityMetrics, ReliabilityPolicy,
        ReliableClient,
    )
    from dynamo_tpu_torch.llm.worker import serve_llm_worker
    from dynamo_tpu_torch.protocols.common import to_wire
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    prompt = [(37 * j) % 180 + 3 for j in range(20)]
    oracle = jax_stream(path, prompt, max_tokens=24)

    async def main():
        plane = MemoryPlane()
        w1 = await StopsMidStream(t_engine(path), after=7).start()
        w2 = await NativeEngineWorker(t_engine(path)).start()
        r1 = await DistributedRuntime.create_local(plane, "a-stops")
        await serve_llm_worker(r1, "ns", "backend", w1)
        r2 = await DistributedRuntime.create_local(plane, "b-good")
        await serve_llm_worker(r2, "ns", "backend", w2)
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = await crt.namespace("ns").component("backend").endpoint(
            "generate").client().start()
        while len(client.instances) < 2:
            await asyncio.sleep(0.02)
        metrics = ReliabilityMetrics()
        rel = ReliableClient(
            client, ReliabilityPolicy(stall_timeout_s=2.0,
                                      backoff_base_s=0.01),
            breaker=CircuitBreaker(failure_threshold=1, cooldown_s=60.0,
                                   metrics=metrics),
            metrics=metrics)
        rel._rr = len(client.instance_ids()) - 1   # first: the stalling one
        toks, fins = [], []
        try:
            async for f in rel.generate(to_wire(PreprocessedRequest(
                    request_id="m0", token_ids=prompt,
                    stop=StopConditions(max_tokens=24, ignore_eos=True))),
                    Context("m0")):
                toks.extend(f.get("token_ids", ()))
                if f.get("finish_reason"):
                    fins.append(f["finish_reason"])
        finally:
            for rt in (crt, r1, r2):
                await rt.shutdown()
            await w1.stop()
            await w2.stop()
        return toks, fins, metrics.snapshot(), w2.engine.decode_path

    toks, fins, snap, served = run(main())
    assert snap["migrations"] == 1, snap
    assert fins == ["length"] and served == "gather"
    assert toks == oracle


# -- disaggregated over the TCP transfer plane ------------------------------------

async def _remote_stack(plane, path, transfer, decode_kw=None):
    queue = PrefillQueue(plane.messaging, "ns", "tiny")
    router = DisaggregatedRouter(max_local_prefill_length=4,
                                 max_prefill_queue_size=8, model="tiny")
    decode = DisaggDecodeWorker(
        t_engine(path, **(decode_kw or {})), plane.messaging, router, queue,
        worker_id="dec-0", prefill_timeout_s=60.0)
    server = await KvTransferServer(decode, "dec-0").start()
    await server.register(plane.kv)
    prefill = PrefillWorker(NativeEngineWorker(t_engine(path)), queue,
                            transfer, plane.messaging)
    return decode, prefill, server


async def _drive(gen):
    toks, reason = [], None
    async for f in gen:
        toks.extend(f.token_ids)
        if f.finish_reason is not None:
            reason = f.finish_reason.value
    return toks, reason


def _pre(rid, prompt, max_tokens=6):
    return PreprocessedRequest(request_id=rid, token_ids=list(prompt),
                               stop=StopConditions(max_tokens=max_tokens,
                                                   ignore_eos=True))


class SlowLink(RemoteTransferBackend):
    """Each chunk waits `delay_s` before it is staged."""

    def __init__(self, kv, delay_s, **kw):
        super().__init__(kv, **kw)
        self.delay_s = delay_s

    async def _chunk_gate(self, chunk_idx):
        await asyncio.sleep(self.delay_s)


@pytest.mark.parametrize("path", ["gather", "gemma2"])
def test_early_decode_stages_gather_windows_before_last_chunk(path):
    """A local request decodes on the decode engine while a remote one's
    five one-page chunks arrive slowly: the remote sequence's first token
    goes out early, gather windows for the local one are dispatched while
    its last chunk is still in flight, and it joins the windows once its
    pages commit (the next window gathers its base anew). Both streams
    equal the JAX engine's."""
    remote = list(range(50, 90))        # 5 pages
    local = [3, 4, 5]                   # under the local threshold
    n_local = 160                       # still decoding when chunks land

    async def main():
        plane = MemoryPlane()
        tx = SlowLink(plane.kv, 0.1, chunk_pages=1, window_chunks=1)
        decode, prefill, server = await _remote_stack(plane, path, tx)
        eng = decode.engine
        injects = []
        inject = eng.inject_pages

        def recording(*a, **kw):
            injects.append(eng.decode_dispatches)
            return inject(*a, **kw)
        eng.inject_pages = recording
        await decode.start()
        await prefill.start()
        try:
            lt = asyncio.create_task(_drive(decode.generate(
                _pre("loc", local, n_local), Context("loc"))))
            while eng.decode_dispatches == 0:
                await asyncio.sleep(0.01)
            rem = await asyncio.wait_for(_drive(decode.generate(
                _pre("rem", remote, 12), Context("rem"))), 60)
            loc = await asyncio.wait_for(lt, 60)
        finally:
            await prefill.stop()
            await decode.stop()
            await tx.close()
            await server.stop()
        return (rem, loc, injects, decode.early_first_emits,
                eng.scheduler.overlap_activations,
                decode.stats_handler()["disagg"])

    rem, loc, injects, early, overlaps, st = run(main())
    want_rem, want_loc = jax_streams(path, (remote, {"max_tokens": 12}),
                                     (local, {"max_tokens": n_local}))
    assert rem == (want_rem, "length")
    assert loc == (want_loc, "length")
    assert early == 1 and overlaps == 1
    assert len(injects) == 5 and injects[-1] > injects[0], injects
    assert st["received_pages"] == 5
    assert st["salvaged_prefills"] == st["full_reprefills"] == 0


class CutAfter(RemoteTransferBackend):
    """Closes its pooled sockets from chunk `cut_at` on, for good."""

    def __init__(self, kv, cut_at, **kw):
        super().__init__(kv, **kw)
        self.cut_at = cut_at

    async def _chunk_gate(self, chunk_idx):
        if chunk_idx >= self.cut_at:
            for _reader, writer in list(self._conns.values()):
                writer.close()
            await asyncio.sleep(0.05)


@pytest.mark.parametrize("path", ["gather", "gemma2"])
def test_salvage_on_gather_equals_jax(path):
    """The link dies for good after 3 of 5 chunks commit: the decode side
    keeps those pages and prefills the rest, then decodes through the
    gather window; the stream equals the JAX engine's."""
    s0 = XFER_STATS.salvaged_pages
    prompt = list(range(50, 90))

    async def main():
        plane = MemoryPlane()
        tx = CutAfter(plane.kv, 3, chunk_pages=1, window_chunks=1,
                      link_retries=1)
        decode, prefill, server = await _remote_stack(plane, path, tx)
        await decode.start()
        await prefill.start()
        try:
            out = await asyncio.wait_for(_drive(decode.generate(
                _pre("rs", prompt), Context("rs"))), 90)
        finally:
            await prefill.stop()
            await decode.stop()
            await tx.close()
            await server.stop()
        return out, decode.stats_handler()["disagg"]

    out, st = run(main())
    assert out == (jax_stream(path, prompt), "length")
    assert (st["salvaged_prefills"], st["full_reprefills"]) == (1, 0)
    assert XFER_STATS.salvaged_pages - s0 == 3


def _host(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    a = np.asarray(jax.device_get(t))
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _prefill_parked(eng, req_cls, params_cls, rid, prompt):
    r = req_cls(rid, list(prompt), params_cls(**GREEDY))
    r.prefill_only = True
    eng.add_request(r)
    outs = []
    while eng.has_work():
        outs.extend(eng.step())
    return outs[0].token, eng.scheduler.parked[rid].pages


@pytest.mark.parametrize("path", paths.GATHER_PATHS)
def test_extracted_and_injected_bytes_equal_jax(path):
    """A prefill-only run in each package: the extracted pages agree
    within 1e-5 (f32; each package's own prefill sums in its own order),
    and a decode engine of each package that injects the JAX pages holds a
    byte-equal cache (the port's scratch page aside) and decodes the JAX
    stream through its gather window."""
    prompt = list(range(100, 130))      # 4 pages
    jpre, tpre = j_engine(path), t_engine(path)
    jfirst, jpages = _prefill_parked(jpre, JRequest, JSamplingParams, "r",
                                     prompt)
    tfirst, tpages = _prefill_parked(tpre, TRequest, TSamplingParams, "r",
                                     prompt)
    assert jfirst == tfirst and jpages == tpages
    jx, tx = jpre.extract_pages(jpages), tpre.extract_pages(tpages)
    assert set(tx) - {"ready"} == set(jx)
    for key in jx:
        a, b = _host(jx[key]), _host(tx[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    tx = {key: torch.from_numpy(np.array(_host(jx[key]))) for key in jx}
    tx["ready"] = None
    jdec, tdec = j_engine(path), t_engine(path)
    ja = jdec.allocate_remote(JRequest("r", prompt,
                                       JSamplingParams(**GREEDY)))
    ta = tdec.allocate_remote(TRequest("r", prompt,
                                       TSamplingParams(**GREEDY)))
    assert ja.page_ids == ta.page_ids
    jdec.inject_pages(ja.page_ids,
                      jax.device_put(jx["k"], jdec.cache_sharding),
                      jax.device_put(jx["v"], jdec.cache_sharding))
    tdec.inject_pages(ta.page_ids, tx["k"], tx["v"], ready=tx["ready"])
    for key, arr in tdec.cache.items():
        a, b = _host(jdec.cache[key]), _host(arr)[:, :, :-1]
        assert a.tobytes() == b.tobytes(), key
    out = {}
    for name, eng in (("jax", jdec), ("torch", tdec)):
        eng.activate_remote("r", tfirst)
        toks = [tfirst]
        while eng.has_work():
            toks += [ev.token for ev in eng.step() if ev.token is not None]
        out[name] = toks
    assert out["torch"] == out["jax"] == jax_stream(path, prompt)


# -- page reuse under NaN-poisoned pages -------------------------------------------

def poisoned(eng):
    """NaN in every page of the port engine's cache, and in every page the
    allocator evicts (a sealed prefix page re-placed for another owner)
    before the new owner writes it."""
    for arr in eng.cache.values():
        arr.fill_(float("nan"))
    alloc = eng.scheduler.allocator
    evict = alloc._evict_one

    def evict_poisoned():
        pid = evict()
        for arr in eng.cache.values():
            arr[:, :, pid] = float("nan")
        eng.poisoned_evictions += 1
        return pid
    alloc._evict_one = evict_poisoned
    eng.poisoned_evictions = 0
    return eng


def _to_end(eng, toks):
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                toks.setdefault(ev.request_id, []).append(ev.token)
    return toks


def _reuse_script(eng, req_cls, params_cls, move):
    """One engine: prefixes evicted and re-placed, a preempted-and-resumed
    batch request, an injected remote request and a salvaged one, all on a
    20-page pool (its pages recycled throughout)."""
    out = {}
    P = params_cls
    rng = np.random.default_rng(5)
    system = [int(t) for t in rng.integers(3, 180, 16)]
    # prefixes: a system prompt shared, then evicted by other traffic and
    # placed again
    for i in range(4):
        tail = [int(t) for t in rng.integers(3, 180, 9 + 3 * i)]
        prompt = (system if i % 2 == 0 else []) + tail
        out[f"p{i}"] = eng.generate(prompt, P(**dict(GREEDY, max_tokens=8)),
                                    f"p{i}")
    # preemption: two batch decodes hold both slots, an interactive
    # arrival preempts the younger; its pages go to the arrival and it
    # resumes from its committed prefix into recycled pages
    toks = {}
    for rid, lo in (("b", 3), ("c", 100)):
        eng.add_request(req_cls(rid, list(range(lo, lo + 30)),
                                P(**dict(GREEDY, max_tokens=30)),
                                qos="batch"))
    while sum(len(v) for v in toks.values()) < 8:
        for ev in eng.step():
            if ev.token is not None:
                toks.setdefault(ev.request_id, []).append(ev.token)
    eng.add_request(req_cls("i", list(range(60, 80)),
                            P(**dict(GREEDY, max_tokens=6)),
                            qos="interactive"))
    out.update(_to_end(eng, toks))
    # a remote request: pages injected, then activated
    out["r"] = move(eng, "r", list(range(90, 115)), salvage=None)
    # a salvaged one: 2 of 4 pages injected, the rest prefilled here
    out["s"] = move(eng, "s", list(range(120, 150)), salvage=2)
    return out


def _mover(src, req_cls, params_cls, port):
    """Prefills on `src` (one engine for every move; the prompts share no
    page) and moves the pages into the serving engine."""
    def move(eng, rid, prompt, salvage):
        first, pages = _prefill_parked(src, req_cls, params_cls, rid,
                                       prompt)
        alloc = eng.allocate_remote(req_cls(rid, prompt,
                                            params_cls(**GREEDY)))
        x = src.extract_pages(pages)
        n = len(alloc.page_ids) if salvage is None else salvage
        k, v = x["k"][:, :, :n], x["v"][:, :, :n]
        if port:
            eng.inject_pages(alloc.page_ids[:n], k, v, ready=x["ready"])
        else:
            eng.inject_pages(alloc.page_ids[:n],
                             jax.device_put(k, eng.cache_sharding),
                             jax.device_put(v, eng.cache_sharding))
        src.release_parked(rid)
        if salvage is None:
            eng.activate_remote(rid, first)
            toks = [first]
        else:
            eng.salvage_remote(rid, salvage)
            toks = []
        return _to_end(eng, {rid: toks})[rid]
    return move


@pytest.mark.parametrize("path", paths.GATHER_PATHS)
def test_stale_pages_reused_equal_jax(path):
    from dynamo_tpu.runtime.qos import QOS_STATS as JQ
    from dynamo_tpu_torch.runtime.qos import QOS_STATS as TQ
    kw = dict(num_pages=20, max_slots=2)
    JQ.reset()
    TQ.reset()
    try:
        want = _reuse_script(j_engine(path, **kw), JRequest,
                             JSamplingParams,
                             _mover(j_engine(path), JRequest,
                                    JSamplingParams, False))
        eng = poisoned(t_engine(path, **kw))
        got = _reuse_script(eng, TRequest, TSamplingParams,
                            _mover(t_engine(path), TRequest,
                                   TSamplingParams, True))
        preempts = (JQ.preemptions_total, TQ.preemptions_total)
    finally:
        JQ.reset()
        TQ.reset()
    assert got == want
    assert preempts == (1, 1) and eng.poisoned_evictions > 0
    assert all(len(v) > 0 for v in got.values())
    # every stream is the JAX engine's on a clean cache, one at a time
    assert got["r"] == jax_stream(path, range(90, 115))


# -- preemption against a gather window in flight -----------------------------------

def _preempt_in_flight(make, req_cls, params_cls, qos_stats):
    eng = make(max_slots=1, pipeline_depth=2)
    eng.add_request(req_cls("b", list(range(3, 23)),
                            params_cls(max_tokens=40, temperature=0.0,
                                       ignore_eos=True), qos="batch"))
    toks = {"b": []}
    steps = 0
    while eng._pipeline is None:
        toks["b"] += [ev.token for ev in eng.step() if ev.token is not None]
        steps += 1
        assert steps < 20, "no window in flight"
    seq = next(x for x in eng.scheduler.running if x is not None)
    epoch = seq.epoch
    eng.add_request(req_cls("i", list(range(60, 80)),
                            params_cls(max_tokens=6, temperature=0.0,
                                       ignore_eos=True), qos="interactive"))
    _to_end(eng, toks)
    return toks, steps, seq.epoch > epoch, qos_stats.preemptions_total


@pytest.mark.parametrize("path", paths.GATHER_PATHS)
def test_preempt_with_gather_window_in_flight_equals_jax(path):
    from dynamo_tpu.runtime.qos import QOS_STATS as JQ
    from dynamo_tpu_torch.runtime.qos import QOS_STATS as TQ
    JQ.reset()
    TQ.reset()
    try:
        want = _preempt_in_flight(lambda **kw: j_engine(path, **kw),
                                  JRequest, JSamplingParams, JQ)
        got = _preempt_in_flight(lambda **kw: t_engine(path, **kw),
                                 TRequest, TSamplingParams, TQ)
    finally:
        JQ.reset()
        TQ.reset()
    assert got == want
    toks, _steps, bumped, preempts = got
    assert bumped and preempts == 1
    assert [toks["b"], toks["i"]] == jax_streams(
        path, (range(3, 23), {"max_tokens": 40}), (range(60, 80), {}))
