"""The port's host-DRAM and disk KV tiers (dynamo_tpu_torch/engine/offload.py
and the engine and scheduler hooks) against the JAX package's
(tests/test_offload.py's cases, held to the reference).

On the `tiny` config in float32 with the JAX weights carried over by
`params_from_jax` (the JAX engine on its plain attention path), page 8,
num_pages 6-10, host_pages 1-16, on the CPU. Both engines' offload copies
land before `submit` returns (`_sync_copies`), so that the order of puts,
pins and evictions, and with it every counter, is deterministic. Compared:
- streams, token for token;
- `OffloadStats` after each request (the JAX fields);
- the scheduler's onboard decisions (page id, page) step for step;
- the host and disk slabs' bytes per page: f32 within 1e-5 (rtol and
  atol), int8 values byte-equal, f32 scales within 1e-6. Pages are keyed
  by their token prefix: the two packages hash pages differently
  (xxh3 and BLAKE2b), so each side's hashes are mapped to the prefix.
The port's own checks: a tiered engine is token-identical at
pipeline_depth 1 and 2 and to the JAX engine at depth 2 with an onboard
admitted while a window is in flight; a slab entry corrupted in place is
quarantined and recomputed, never served; a failed offload copy is counted
and logged; disk_pages without host_pages is refused.
The JAX cases that need `runtime/faults.py` wait for the port's faults
module.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.kv_cache import page_hash as jpage_hash
from dynamo_tpu.engine.offload import HostKvPool as JHostKvPool
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
    Scheduler as JScheduler,
)
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.kv_cache import page_hash as tpage_hash
from dynamo_tpu_torch.engine.offload import CopyStream, HostKvPool
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
    Scheduler as TScheduler,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.runtime.integrity import STATS as INTEGRITY

torch.set_num_threads(1)

JCFG = JModelConfig(dtype="float32", max_model_len=256, decode_kernel="off")
TCFG = TModelConfig(dtype="float32", max_model_len=256)
PAGE = 8
PROMPT_A = list(range(10, 34))    # 3 pages
PROMPT_B = list(range(100, 140))  # 5 pages: evicts A's pages
GREEDY = dict(max_tokens=4, temperature=0.0, ignore_eos=True)
F32_TOL = 1e-5
SCALE_TOL = 1e-6


def ekw(num_pages, host_pages=0, disk_pages=0, disk_dir=None, kv_quant="",
        **kw):
    """tests/test_offload.py's engine geometry."""
    return dict(page_size=PAGE, num_pages=num_pages, max_slots=2,
                max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                max_model_len=256, host_pages=host_pages,
                disk_pages=disk_pages, disk_dir=disk_dir, kv_quant=kv_quant,
                **kw)


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ekw(64)), seed=0)
    return jax.device_get(eng.params)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax_params, TCFG, "cpu")


@pytest.fixture(autouse=True)
def clean_integrity():
    INTEGRITY.__init__()
    yield
    INTEGRITY.__init__()


def _sync_copies(eng):
    """Make the engine's offload copies land before submit returns."""
    cs = eng._copy_stream
    if cs is None:
        return eng
    submit = cs.submit

    def sync_submit(*args):
        submit(*args)
        cs.drain()
    cs.submit = sync_submit
    return eng


def _log_onboards(eng, log):
    """Record each non-empty drain of the onboard queue as [(pid, hash)]."""
    sch = eng.scheduler
    drain = sch.drain_onboards

    def logged():
        out = drain()
        if out:
            log.append(list(out))
        return out
    sch.drain_onboards = logged


def make_pair(jax_params, port_params, **kw):
    """(JAX engine, port engine) on the same weights and config; a disk
    tier's directory gets a subdirectory for each."""
    disk = kw.pop("disk_dir", None)
    j = JNativeEngine(JCFG, JEngineConfig(**ekw(**kw, disk_dir=disk and (
        f"{disk}/jax"))), params=jax_params, seed=0)
    t = TNativeEngine(TCFG, TEngineConfig(**ekw(**kw, disk_dir=disk and (
        f"{disk}/port"))), params=port_params, device="cpu")
    return _sync_copies(j), _sync_copies(t)


def jgen(eng, prompt, rid, **sp):
    return eng.generate(prompt, JSamplingParams(**{**GREEDY, **sp}), rid)


def tgen(eng, prompt, rid, **sp):
    return eng.generate(prompt, TSamplingParams(**{**GREEDY, **sp}), rid)


def stats(pool):
    """A pool's OffloadStats as a dict of the JAX package's fields."""
    names = [f.name for f in dataclasses.fields(JHostKvPool(
        1, (1,), np.float32).stats)]
    return {n: getattr(pool.stats, n) for n in names}


def prefix_keys(streams, hash_fn):
    """{chained page hash: the token prefix it closes} over every full page
    of each token stream."""
    out = {}
    for toks in streams:
        parent = 0
        for i in range(len(toks) // PAGE):
            parent = hash_fn(parent, toks[i * PAGE:(i + 1) * PAGE])
            out[parent] = tuple(toks[:(i + 1) * PAGE])
    return out


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def slab_pages(tier, keys):
    """{token prefix: [page leaves as numpy]} of a host or disk tier."""
    slabs = [tier.k_slab, tier.v_slab]
    if tier.ks_slab is not None:
        slabs += [tier.ks_slab, tier.vs_slab]
    return {keys[h]: [_np(s[slot]) for s in slabs]
            for h, slot in tier._by_hash.items()}


def assert_slabs_equal(jtier, ttier, streams):
    jp = slab_pages(jtier, prefix_keys(streams, jpage_hash))
    tp = slab_pages(ttier, prefix_keys(streams, tpage_hash))
    assert sorted(jp) == sorted(tp)
    for key, jleaves in jp.items():
        for i, (want, got) in enumerate(zip(jleaves, tp[key])):
            assert got.shape == want.shape and got.dtype == want.dtype
            if want.dtype == np.int8:
                np.testing.assert_array_equal(got, want)
            else:
                tol = SCALE_TOL if i >= 2 else F32_TOL
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return len(jp)


def onboards_by_prefix(log, keys):
    return [[(pid, keys[h]) for pid, h in batch] for batch in log]


def run_scenario(jax_params, port_params, prompts, **kw):
    """Serve `prompts` ([(rid, tokens)]) one at a time on both engines;
    after each request compare the streams and the OffloadStats. Returns
    (jax engine, port engine, streams, onboard logs)."""
    j, t = make_pair(jax_params, port_params, **kw)
    jlog, tlog = [], []
    _log_onboards(j, jlog)
    _log_onboards(t, tlog)
    streams = []
    for rid, prompt in prompts:
        want = jgen(j, prompt, rid)
        got = tgen(t, prompt, rid)
        assert got == want, rid
        assert stats(t.host_pool) == stats(j.host_pool), rid
        streams.append(list(prompt) + got)
    keys = (prefix_keys(streams, jpage_hash), prefix_keys(streams, tpage_hash))
    assert onboards_by_prefix(tlog, keys[1]) == \
        onboards_by_prefix(jlog, keys[0])
    return j, t, streams, jlog


def test_host_pool_lru():
    """tests/test_offload.py::test_host_pool_lru on both pools."""
    a = np.ones((1, 1, 2, 2), np.float32)
    pools = (JHostKvPool(2, (1, 1, 2, 2), np.float32),
             HostKvPool(2, (1, 1, 2, 2), torch.float32))
    for pool in pools:
        pool.put(1, a, a)
        pool.put(2, 2 * a, 2 * a)
        assert 1 in pool and 2 in pool
        pool.get(1)              # refresh 1; 2 becomes LRU
        pool.put(3, 3 * a, 3 * a)
        assert 2 not in pool and 1 in pool and 3 in pool
        assert pool.stats.evicted == 1
        k, _ = pool.get(3)
        np.testing.assert_array_equal(_np(k), 3 * a)
    assert stats(pools[1]) == stats(pools[0])


def test_offload_onboard_roundtrip_tokens_match(jax_params, port_params):
    """A -> B (evicts A to host) -> A again (onboards): streams equal the
    oracle's, stats and onboard decisions equal the JAX engine's, and the
    host slab holds the same bytes per page."""
    oracle = TNativeEngine(TCFG, TEngineConfig(**ekw(64)),
                           params=port_params, device="cpu")
    expect_a = tgen(oracle, PROMPT_A, "a")
    j, t, streams, log = run_scenario(
        jax_params, port_params,
        [("a1", PROMPT_A), ("b", PROMPT_B), ("a2", PROMPT_A)],
        num_pages=8, host_pages=16)
    assert streams[2][len(PROMPT_A):] == expect_a
    st = t.host_pool.stats
    assert st.offloaded > 0 and st.onboarded > 0 and st.host_hits > 0
    assert st.onboarded == st.host_hits and log
    assert assert_slabs_equal(j.host_pool, t.host_pool, streams) > 0
    assert t.metrics().kv_host_pages_used == t.host_pool.used > 0
    assert t.metrics().kv_host_pages_total == 16
    t.close()


def test_onboard_survives_pool_pressure(jax_params, port_params):
    """host_pages 1: a pending onboard's entry must survive the offloads
    between admission and the next step; tokens stay right."""
    oracle = TNativeEngine(TCFG, TEngineConfig(**ekw(64)),
                           params=port_params, device="cpu")
    expect_a = tgen(oracle, PROMPT_A, "a")
    j, t, streams, _ = run_scenario(
        jax_params, port_params,
        [("a1", PROMPT_A), ("b", PROMPT_B), ("a2", PROMPT_A)],
        num_pages=8, host_pages=1)
    assert streams[2][len(PROMPT_A):] == expect_a
    assert_slabs_equal(j.host_pool, t.host_pool, streams)
    t.close()


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_disk_tier_spill_and_promote(jax_params, port_params, tmp_path,
                                     kv_quant):
    """Three tiers with a 2-page DRAM slab: B's pressure pushes A's pages to
    disk; re-sending A promotes them back. bf16-in-f32 and int8 pages
    (int8 values + f32 scale slabs through both tiers, never dequantized);
    both slabs hold the JAX engine's bytes."""
    oracle = TNativeEngine(TCFG, TEngineConfig(**ekw(64, kv_quant=kv_quant)),
                           params=port_params, device="cpu")
    expect_a = tgen(oracle, PROMPT_A, "a")
    j, t = make_pair(jax_params, port_params, num_pages=6, host_pages=2,
                     disk_pages=16, disk_dir=str(tmp_path),
                     kv_quant=kv_quant)
    assert (tmp_path / "port" / "kv_disk_k.bin").exists()
    if kv_quant:
        assert t.host_pool.k_slab.dtype == torch.int8
        assert t.host_pool.ks_slab.dtype == torch.float32
        assert t.host_pool.disk.ks_slab.dtype == torch.float32
    streams = []
    for rid, prompt in (("a1", PROMPT_A), ("b", PROMPT_B)):
        got = tgen(t, prompt, rid)
        assert got == jgen(j, prompt, rid)
        assert stats(t.host_pool) == stats(j.host_pool)
        streams.append(list(prompt) + got)
    st = t.host_pool.stats
    assert st.offloaded > 0 and st.disk_offloaded > 0
    assert_slabs_equal(j.host_pool, t.host_pool, streams)
    assert assert_slabs_equal(j.host_pool.disk, t.host_pool.disk,
                              streams) > 0
    got = tgen(t, PROMPT_A, "a2")
    assert got == jgen(j, PROMPT_A, "a2") == expect_a
    assert stats(t.host_pool) == stats(j.host_pool)
    assert st.disk_hits > 0 and st.onboarded > 0
    m = t.metrics()
    assert m.kv_disk_pages_total == 16 and m.kv_disk_pages_used > 0
    t.close()


def test_host_pool_scale_rot_is_caught():
    """The capture checksum covers the scale rows too: a flipped scale byte
    (values intact) quarantines the entry on read."""
    pool = HostKvPool(2, (1, 1, 2, 2), torch.int8, scale_shape=(1, 1, 2))
    k = torch.ones((1, 1, 2, 2), dtype=torch.int8)
    s = torch.full((1, 1, 2), 0.5)
    pool.put(7, k, k, s, s)
    got = pool.get(7)
    assert got is not None and len(got) == 4
    pool.ks_slab[0].view(torch.uint8)[0, 0, 0] ^= 0xFF   # rot at rest
    assert pool.get(7) is None                          # never served
    assert INTEGRITY.quarantined == 1 and 7 not in pool


def test_offload_disabled_by_default(port_params):
    eng = TNativeEngine(TCFG, TEngineConfig(**ekw(10)), params=port_params,
                        device="cpu")
    assert eng.host_pool is None and eng._copy_stream is None
    assert len(tgen(eng, list(range(20)), "x", max_tokens=3)) == 3
    assert eng.metrics().kv_host_pages_total == 0
    with pytest.raises(ValueError, match="requires host_pages"):
        TNativeEngine(TCFG, TEngineConfig(**ekw(10, disk_pages=4)),
                      params=port_params, device="cpu")


class _SlowCopyStream(CopyStream):
    """A copy stream whose pages of hash 111 take ~0.5 s to land."""

    def _land(self, pages, hashes):
        if 111 in hashes:
            time.sleep(0.5)
        super()._land(pages, hashes)


def test_copy_stream_settle_is_per_hash():
    """Admission waits only for in-flight copies of the hashes its walk
    touches; an unrelated slow copy does not stall it."""
    pool = HostKvPool(4, (1, 1, 2, 2), torch.float32)
    cs = _SlowCopyStream(pool)
    block = torch.zeros((1, 1, 1, 2, 2))
    try:
        cs.submit({"k": block, "v": block}, [111])
        t0 = time.perf_counter()
        cs.settle([222, 333])       # unrelated hashes: no wait
        assert time.perf_counter() - t0 < 0.25
        t0 = time.perf_counter()
        cs.settle([333, 111])       # overlapping hash: waits for the copy
        assert time.perf_counter() - t0 > 0.1
        assert 111 in pool
        assert pool.times.settle_s > 0.1
    finally:
        cs.close()


def test_failed_offload_is_counted_not_hidden(caplog):
    """A copy that raises costs a recompute, as in JAX, but is logged by
    name and counted in OffloadStats.failed; the drain survives it."""
    pool = HostKvPool(4, (1, 1, 2, 2), torch.float32)
    cs = CopyStream(pool)
    try:
        bad = torch.zeros((2, 1, 1, 3, 3))    # pages that fit no slot
        cs.submit({"k": bad, "v": bad}, [5, 6])
        good = torch.ones((1, 1, 1, 2, 2))
        cs.submit({"k": good, "v": good}, [7])
        cs.drain()
    finally:
        cs.close()
    assert pool.stats.failed == 2 and pool.stats.offloaded == 1
    assert 7 in pool and 5 not in pool
    assert any("kv offload of 2 page(s) failed" in r.getMessage()
               for r in caplog.records)


def test_host_pool_concurrent_puts_pins_and_verifies(tmp_path):
    """Putters (the copy thread's role) race walkers that preverify, pin,
    read and unpin, over a host tier with a disk tier below, with a short
    thread switch interval: a pinned entry always reads as its own page,
    no verify ever mismatches (a verify done ahead is never taken for a
    slot written since), no slot holds two hashes and no tier exceeds its
    capacity. Time-bounded."""
    import random
    import sys
    import threading

    pool = HostKvPool(6, (1, 1, 4, 8), torch.float32, disk_pages=8,
                      disk_dir=str(tmp_path))
    done = threading.Event()
    errors = []

    def page(h):
        return torch.full((1, 1, 4, 8), float(h))

    def putter(seed):
        rng = random.Random(seed)
        while not done.is_set():
            h = rng.randrange(1, 40)
            pool.put(h, page(h), 2 * page(h))

    def walker(seed):
        rng = random.Random(seed)
        while not done.is_set():
            hs = [rng.randrange(1, 40) for _ in range(4)]
            pool.preverify(hs)
            for h in hs:
                if pool.pin(h):
                    k, v = pool.get(h)
                    if not (bool((k == h).all()) and bool((v == 2 * h).all())):
                        errors.append(h)
                    pool.unpin(h)
            pool.forget_verified()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=putter, args=(i,))
                    for i in range(3)]
                   + [threading.Thread(target=walker, args=(10 + i,))
                      for i in range(3)])
        for th in threads:
            th.start()
        # at least 1.5 s, and until a walker has promoted from disk (at
        # most 20 s)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20 and not (
                time.monotonic() - t0 > 1.5 and pool.stats.disk_hits > 0):
            time.sleep(0.05)
        done.set()
        for th in threads:
            th.join(timeout=30)
    finally:
        done.set()
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    pool.close()
    assert errors == []
    assert INTEGRITY.mismatches == 0 and INTEGRITY.quarantined == 0
    for tier in (pool, pool.disk):
        slots = list(tier._by_hash.values())
        assert len(slots) == len(set(slots)) <= tier.capacity
        assert all(tier._hash_at[slot] == h
                   for h, slot in tier._by_hash.items())
    assert pool.stats.offloaded > 0 and pool.stats.disk_hits > 0
    assert not pool._pins


def test_scheduler_settles_only_walk_hashes():
    """The prefix walk hands exactly its candidate hash chain to
    settle_hashes before any tier lookup, in both schedulers."""
    kw = dict(page_size=4, num_pages=16, max_slots=2, max_prefill_chunk=16,
              prefill_buckets=(4, 8, 16), max_model_len=64)
    prompt = list(range(1, 11))     # 10 tokens -> 2 full pages
    for sched_cls, cfg_cls, req_cls, hash_fn in (
            (JScheduler, JEngineConfig, JRequest, jpage_hash),
            (TScheduler, TEngineConfig, TRequest, tpage_hash)):
        sched = sched_cls(cfg_cls(**kw))
        seen = []
        sched.settle_hashes = seen.append
        sched.add_request(req_cls("r", prompt))
        h1 = hash_fn(0, prompt[:4])
        assert seen == [[h1, hash_fn(h1, prompt[4:8])]]


def test_corrupt_slab_entry_quarantined_and_recomputed(jax_params,
                                                       port_params):
    """A host slab entry corrupted in place after it landed: the verify at
    pin quarantines it, the walk stops there and the rest is recomputed;
    the stream is the oracle's."""
    oracle = TNativeEngine(TCFG, TEngineConfig(**ekw(64)),
                           params=port_params, device="cpu")
    expect_a = tgen(oracle, PROMPT_A, "a")
    t = _sync_copies(TNativeEngine(TCFG, TEngineConfig(**ekw(8, 16)),
                                   params=port_params, device="cpu"))
    tgen(t, PROMPT_A, "a1")
    tgen(t, PROMPT_B, "b")
    h0 = tpage_hash(0, PROMPT_A[:PAGE])
    slot = t.host_pool._by_hash[h0]
    t.host_pool.k_slab[slot, 0, 0, 0, 0] += 1.0
    assert tgen(t, PROMPT_A, "a2") == expect_a
    assert INTEGRITY.quarantined == 1 and INTEGRITY.mismatches == 1
    assert h0 not in t.host_pool
    assert t.host_pool.stats.onboarded == t.host_pool.stats.host_hits == 0
    t.close()


def test_tiered_engine_pipeline_depths_match_jax(jax_params, port_params):
    """A tiered engine is token-identical at pipeline_depth 1 and 2 and to
    the JAX engine at depth 2, with A2's onboard admitted while D's decode
    window is in flight (the pipeline's gates on pending onboards)."""
    prompt_d = list(range(150, 170))
    params = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    kw = ekw(10, host_pages=16, decode_steps=4)

    def drive(eng, req_cls, sp_cls):
        _sync_copies(eng)
        for rid, prompt in (("a1", PROMPT_A), ("b", PROMPT_B)):
            eng.generate(prompt, sp_cls(**params), rid)
        out = {"d": [], "a2": []}
        eng.add_request(req_cls("d", prompt_d, sp_cls(**params)))
        added = False
        done = set()
        while len(done) < 2:
            for ev in eng.step():
                if ev.token is not None:
                    out[ev.request_id].append(ev.token)
                if ev.finished:
                    done.add(ev.request_id)
            if not added and len(out["d"]) >= 2:
                eng.add_request(req_cls("a2", PROMPT_A, sp_cls(**params)))
                added = True
        return out, eng.host_pool.stats

    want, jst = drive(JNativeEngine(JCFG, JEngineConfig(**kw),
                                    params=jax_params, seed=0),
                      JRequest, JSamplingParams)
    for depth in (1, 2):
        t = TNativeEngine(TCFG, TEngineConfig(**{**kw,
                                                 "pipeline_depth": depth}),
                          params=port_params, device="cpu")
        got, tst = drive(t, TRequest, TSamplingParams)
        assert got == want, depth
        assert tst.onboarded > 0 and tst.onboarded == jst.onboarded
        if depth == 2:
            assert t.pipeline_windows > 0
        t.close()
