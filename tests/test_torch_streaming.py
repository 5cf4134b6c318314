"""The port's KV streaming past the HBM page budget
(dynamo_tpu_torch/engine/streaming.py and its engine / scheduler hooks)
against the JAX package's (every case of tests/test_streaming_decode.py,
held to the reference).

On the `tiny` config in float32 with the JAX weights carried over by
`params_from_jax`, page 4: an 80-token prompt plus 16 tokens is 24 pages
against a 6-page HBM budget (4 resident, 2 hot, window halves of 4
slots). Both engines' offload copies land before `submit` returns
(`_sync_copies`), so the order of spills, pins and recomputes is
deterministic. Compared in every engine case: the streams, token for token
(with the JAX oversized-HBM oracle and the JAX streamed engine), and the
`STREAM_STATS` deltas of the run, field for field. The refusals are
compared message for message. The kernel-form partial (the ragged kernel's
plain version on the CPU) is held to `_pages_partial` at 1e-5.
"""
import json

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import streaming as jstreaming
from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu_torch.engine import streaming as tstreaming
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.ops.kv_quant import dequantize_rows, quantize_rows
from dynamo_tpu_torch.runtime import faults as tfaults

torch.set_num_threads(1)

PAGE = 4
# 80 prompt + 16 output = 24 context pages vs a 6-page HBM budget (4x)
PROMPT = [(7 * i + 3) % 250 + 1 for i in range(80)]
GREEDY = dict(max_tokens=16, temperature=0.0, ignore_eos=True)
SAMPLED = dict(max_tokens=16, temperature=0.8, top_k=20, top_p=0.9,
               seed=1234, ignore_eos=True)
TOL = 1e-5


def jcfg(kv_quant=""):
    return JModelConfig(dtype="float32", max_model_len=256,
                        kv_quant=kv_quant, decode_kernel="off")


def tcfg(kv_quant=""):
    return TModelConfig(dtype="float32", max_model_len=256,
                        kv_quant=kv_quant)


ORACLE = dict(page_size=PAGE, num_pages=64, max_slots=2,
              max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
              max_model_len=256)
STREAM = dict(ORACLE, num_pages=6, host_pages=64, stream_pages=4,
              stream_resident_pages=4, stream_hot_pages=2)


@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(jcfg(), JEngineConfig(**ORACLE), seed=0)
    return jax.device_get(eng.params)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax_params, tcfg(), "cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    for reg in (jfaults.REGISTRY, tfaults.REGISTRY):
        reg.disarm()
        reg.reset_counters()
    yield
    for reg in (jfaults.REGISTRY, tfaults.REGISTRY):
        reg.disarm()
        reg.reset_counters()


def _sync_copies(eng):
    """Make the engine's offload copies land before submit returns."""
    cs = eng._copy_stream
    submit = cs.submit

    def sync_submit(*args):
        submit(*args)
        cs.drain()
    cs.submit = sync_submit
    return eng


def jengine(params, kv_quant="", oracle=False, **kw):
    ecfg = dict(ORACLE if oracle else STREAM, kv_quant=kv_quant, **kw)
    eng = JNativeEngine(jcfg(kv_quant), JEngineConfig(**ecfg), params=params,
                        seed=0)
    return eng if oracle else _sync_copies(eng)


def tengine(params, kv_quant="", **kw):
    ecfg = dict(STREAM, kv_quant=kv_quant, **kw)
    return _sync_copies(TNativeEngine(tcfg(kv_quant), TEngineConfig(**ecfg),
                                      params=params, device="cpu"))


class Delta:
    """A STREAM_STATS delta over a block, on both packages."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        self.s0 = self.mod.STREAM_STATS.snapshot()
        return self

    def __exit__(self, *exc):
        s1 = self.mod.STREAM_STATS.snapshot()
        self.d = {k: s1[k] - self.s0[k] for k in self.s0}


def streamed(side, eng, prompt, params):
    """Generate on `eng`, returning (tokens, STREAM_STATS delta)."""
    sp = JSamplingParams if side == "jax" else TSamplingParams
    with Delta(jstreaming if side == "jax" else tstreaming) as d:
        got = eng.generate(prompt, sp(**params), "a")
    return got, d.d


def drive(eng, out):
    for ev in eng.step():
        if ev.token is not None:
            out.append(ev.token)


# -- oracle identity -----------------------------------------------------------

@pytest.mark.parametrize("params", [GREEDY, SAMPLED], ids=["greedy",
                                                            "sampled"])
def test_stream_matches_oracle_and_jax(jax_params, port_params, params):
    expect = jengine(jax_params, oracle=True).generate(
        PROMPT, JSamplingParams(**params), "a")
    jgot, jd = streamed("jax", jengine(jax_params), PROMPT, params)
    tgot, td = streamed("torch", tengine(port_params), PROMPT, params)
    assert jgot == expect
    assert tgot == expect
    assert td == jd
    # the run streamed: spills, prefetches, hits over lates
    assert td["pages_spilled"] > 0 and td["prefetch_issued"] > 0
    assert td["prefetch_hit"] > td["prefetch_late"]


def test_stream_int8_kv_quant_identity_and_scale_leaves(jax_params,
                                                        port_params):
    """int8 cold pages stream verbatim (int8 rows + f32 scale leaves in the
    window pool, dequantized at consume); the tokens match the int8
    oracle."""
    expect = jengine(jax_params, kv_quant="int8", oracle=True).generate(
        PROMPT, JSamplingParams(**GREEDY), "a")
    jgot, jd = streamed("jax", jengine(jax_params, kv_quant="int8"), PROMPT,
                        GREEDY)
    eng = tengine(port_params, kv_quant="int8")
    tgot, td = streamed("torch", eng, PROMPT, GREEDY)
    assert jgot == expect and tgot == expect
    assert td == jd
    pool = eng._streamer.pool
    assert pool._quant
    staged = pool.staged()
    assert staged, "window pool never staged a segment"
    for k, v, ks, vs, lens, nlen, table in staged:
        assert k.dtype == torch.int8 and v.dtype == torch.int8
        assert ks.dtype == torch.float32 and vs.dtype == torch.float32


# -- verify-on-fetch: rot -> quarantine -> recompute only the victim ----------

def _rot_run(side, eng, faults_mod, req_cls, sp_cls):
    stats = (jstreaming if side == "jax" else tstreaming).STREAM_STATS
    eng.add_request(req_cls("r", PROMPT, sp_cls(**GREEDY)))
    out = []
    while eng.has_work() and len(out) < 4:
        drive(eng, out)
    q0, r0 = stats.pages_quarantined, stats.pages_recomputed
    # exactly ONE tier read rots; every later read is clean
    faults_mod.REGISTRY.arm("offload.read_tier", faults_mod.FaultSchedule(
        0, [faults_mod.FaultSpec("corrupt", p=1.0, n=1)]))
    with Delta(jstreaming if side == "jax" else tstreaming) as d:
        while eng.has_work():
            drive(eng, out)
    return (out, stats.pages_quarantined - q0,
            stats.pages_recomputed - r0, d.d)


def test_stream_rot_quarantines_and_recomputes_victim_page(jax_params,
                                                          port_params):
    expect = jengine(jax_params, oracle=True).generate(
        PROMPT, JSamplingParams(**GREEDY), "a")
    jres = _rot_run("jax", jengine(jax_params), jfaults, JRequest,
                    JSamplingParams)
    tres = _rot_run("torch", tengine(port_params), tfaults, TRequest,
                    TSamplingParams)
    assert jres[0] == expect and tres[0] == expect
    assert tres[1:3] == (1, 1) and jres[1:3] == (1, 1)
    assert tres[3] == jres[3]


# -- preempt / resume / migration ---------------------------------------------

def _preempt_run(side, eng, req_cls, sp_cls, migrate: bool):
    eng.add_request(req_cls("r", PROMPT, sp_cls(**GREEDY)))
    out = []
    with Delta(jstreaming if side == "jax" else tstreaming) as d:
        while eng.has_work() and len(out) < 5:
            drive(eng, out)
        seq = eng.scheduler.stream_active[0]
        st = eng._streamer
        ss = st.record(seq)
        st.preempt(seq)
        assert not ss.resident, "preempt must release every device page"
        assert ss.n_kv == ss.sealed_pages * PAGE
        if migrate:
            record = json.loads(json.dumps(st.export_seq(seq)))
            assert record["output"] == out
            st._seqs.pop("r")
            ss = st.import_seq(seq, record)
            assert ss.n_kv == record["n_kv"] and ss.hashes == record["hashes"]
        else:
            st.resume_hot_prefix(ss)
            assert all(lg in ss.resident
                       for lg in range(min(2, ss.sealed_pages)))
        while eng.has_work():
            drive(eng, out)
    return out, d.d


@pytest.mark.parametrize("migrate", [False, True],
                         ids=["preempt_resume", "export_import"])
def test_stream_preempt_and_migration_identity(jax_params, port_params,
                                               migrate):
    """Preempting a partly streamed sequence spills its sealed pages and
    drops the unsealed tail; resuming replays the committed tokens without
    emitting them again (with the hot prefix onboarded back, or through an
    export / import record)."""
    expect = jengine(jax_params, oracle=True).generate(
        PROMPT, JSamplingParams(**GREEDY), "a")
    jout, jd = _preempt_run("jax", jengine(jax_params), JRequest,
                            JSamplingParams, migrate)
    tout, td = _preempt_run("torch", tengine(port_params), TRequest,
                            TSamplingParams, migrate)
    assert jout == expect and tout == expect
    assert td == jd
    if not migrate:
        assert td["pages_promoted"] > 0


# -- spill policy units --------------------------------------------------------

POLICY_CASES = [
    # (hot_pages, beta, ewma, logicals, pm, pl, expect)
    (0, 0.0, [1.0, 1.0], [0, 1], [0.0, 0.0], [3.0, 1.0], [0.75, 0.25]),
    (0, 0.5, [1.0], [0], [0.0], [2.0], [1.0]),
    (0, 0.5, [0.0], [0], [0.0], [2.0], [0.5]),
    (2, 0.8, [1.0, 1.0, 1.0, 1.0], [0, 1, 2, 3], [0.5, -3.0, 2.0, -70.0],
     [1.0, 4.0, 2.5, 9.0], None),
]


@pytest.mark.parametrize("case", POLICY_CASES)
def test_policy_observe_folds_flash_mass(case):
    """observe normalises the flash masses l * exp(m - M) and folds them
    with beta: the same EWMA as JAX's StreamPolicy on the same (pm, pl)."""
    hot, beta, ewma, lgs, pm, pl, expect = case
    want = list(ewma)
    jstreaming.StreamPolicy(hot, beta).observe(want, lgs, np.array(pm),
                                               np.array(pl))
    got = list(ewma)
    tstreaming.StreamPolicy(hot, beta).observe(got, lgs, np.array(pm),
                                               np.array(pl))
    assert got == want
    if expect is not None:
        np.testing.assert_allclose(got, expect)


def test_policy_victim_lowest_mass_outside_hot_prefix():
    ewma = [0.01, 0.02, 0.9, 0.1, 0.5]
    for mod in (jstreaming, tstreaming):
        pol = mod.StreamPolicy(hot_pages=2)
        # pages 0/1 are protected despite the lowest mass
        assert pol.victim(ewma, [0, 1, 2, 3, 4]) == 3
        # ties break toward the OLDEST logical page
        assert pol.victim([0.0, 0.0, 0.5, 0.5, 0.5], [2, 3, 4]) == 2
        # an all-hot candidate set still yields a victim
        assert pol.victim(ewma, [0, 1]) == 0
        assert pol.victim(ewma, []) is None


def test_policy_fresh_pages_protected_in_live_stream(jax_params,
                                                     port_params):
    """End to end: middle-of-context pages spill while the stream runs (the
    freshest start at mass 1.0); the spill counts match JAX's."""
    _, jd = streamed("jax", jengine(jax_params), PROMPT, GREEDY)
    _, td = streamed("torch", tengine(port_params), PROMPT, GREEDY)
    assert td["pages_spilled"] > 0
    assert td["pages_spilled"] == jd["pages_spilled"]


# -- admission rules -----------------------------------------------------------

def _admission(eng, req_cls, sp_cls):
    small = sp_cls(max_tokens=4, temperature=0.0, ignore_eos=True)
    eng.add_request(req_cls("small", [1, 2, 3, 4], small))
    routed = bool(eng.scheduler.stream_active)
    while eng.has_work():
        eng.step()
    errors = []
    for rid, kw in (("lp", dict(logprobs=1)),
                    ("rp", dict(repetition_penalty=1.2))):
        with pytest.raises(ValueError) as ei:
            eng.add_request(req_cls(rid, PROMPT, sp_cls(
                max_tokens=16, ignore_eos=True, **kw)))
        errors.append(str(ei.value))
    return routed, errors


def test_stream_admission_routing_and_rejections(jax_params, port_params):
    """A context within the resident budget never streams; plans the
    streamer cannot thread are refused at admission, with JAX's messages."""
    jr = _admission(jengine(jax_params), JRequest, JSamplingParams)
    tr = _admission(tengine(port_params), TRequest, TSamplingParams)
    assert tr == jr
    assert not tr[0]
    assert "logprobs" in tr[1][0] and "penalt" in tr[1][1]


REFUSALS = [
    ("host_pages", {}, dict(host_pages=0)),
    ("spec_decode", {}, dict(spec_decode="ngram")),
    ("moe_impl", dict(name="tiny-moe", num_experts=4,
                      num_experts_per_tok=2, moe_impl="dispatch"), {}),
    ("attn_softcap", dict(attn_softcap=50.0), {}),
    ("sliding_window", dict(sliding_window=8), {}),
]


@pytest.mark.parametrize("name,model_kw,engine_kw", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_stream_config_validation(name, model_kw, engine_kw):
    """The port refuses every streaming configuration the JAX engine
    refuses, with its message."""
    msgs = []
    for mcls, ecls, build in (
            (JModelConfig, JEngineConfig,
             lambda m, e: JNativeEngine(m, e, seed=0)),
            (TModelConfig, TEngineConfig,
             lambda m, e: TNativeEngine(m, e, device="cpu"))):
        m = mcls(dtype="float32", max_model_len=256, **model_kw)
        e = ecls(**dict(STREAM, **engine_kw))
        with pytest.raises(ValueError) as ei:
            build(m, e)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert name.split("_")[0] in msgs[1]


# -- the kernel-form partial ---------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_kernel_form_partial_matches_pages_partial(quant):
    """At one query token the ragged kernel's (acc, m, l) over a row of
    pages (its plain version on the CPU) is `_pages_partial`'s: over the
    resident pages with a partial tail page last, and over a staged
    segment laid out as a one-layer cache (int8 with its scales)."""
    g = torch.Generator().manual_seed(0)
    hkv, grp, ps, hd, npages, nl = 2, 4, 8, 32, 7, 3
    h = hkv * grp
    q = torch.randn((1, h, hd), generator=g)
    k = torch.randn((nl, hkv, npages + 1, ps, hd), generator=g)
    v = torch.randn((nl, hkv, npages + 1, ps, hd), generator=g)
    cache = {"k": k, "v": v}
    if quant:
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    # resident: pages 5, 2, 6 in logical order, the tail (page 6) holding 3
    table = torch.tensor([5, 2, 6, 0, 0], dtype=torch.int64)
    lens = torch.tensor([ps, ps, 3, 0, 0], dtype=torch.int32)
    layer = 1
    kp = cache["k"][layer].index_select(1, table)
    vp = cache["v"][layer].index_select(1, table)
    if quant:
        kp = dequantize_rows(kp, cache["k_scale"][layer].index_select(
            1, table), torch.float32)
        vp = dequantize_rows(vp, cache["v_scale"][layer].index_select(
            1, table), torch.float32)
    want = tstreaming._pages_partial(q, kp, vp, lens, hd ** -0.5, False)
    got = tstreaming._kernel_partial(
        q, cache["k"], cache["v"], layer, table[None].to(torch.int32),
        lens.sum()[None].to(torch.int32), cache.get("k_scale"),
        cache.get("v_scale"))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    # a staged segment of 3 pages in 4 slots: [Hkv, W, ps, hd]
    w, n = 4, 3
    seg_k = cache["k"][2][:, :w].contiguous()
    seg_v = cache["v"][2][:, :w].contiguous()
    seg_ks = cache["k_scale"][2][:, :w].contiguous() if quant else None
    seg_vs = cache["v_scale"][2][:, :w].contiguous() if quant else None
    slot_lens = torch.tensor([ps] * n + [0] * (w - n), dtype=torch.int32)
    staged = (seg_k, seg_v, seg_ks, seg_vs, slot_lens,
              torch.tensor([n * ps], dtype=torch.int32),
              torch.arange(w, dtype=torch.int32)[None])
    cfg = TModelConfig(dtype="float32", num_heads=h, num_kv_heads=hkv,
                       head_dim=hd)
    acc0 = torch.zeros((1, hkv, grp, hd))
    m0 = torch.full((1, hkv, grp), -1e30)
    l0 = torch.zeros((1, hkv, grp))
    want = tstreaming._stream_seg_merge(cfg, False, q, staged, acc0, m0, l0)
    got = tstreaming._stream_seg_merge(cfg, False, q, staged, acc0, m0, l0,
                                       kernel=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
