"""The port's speculative decoding (dynamo_tpu_torch/engine/spec.py, the
engine's verify) against the JAX package's, case for case with
tests/test_spec_decode.py.

On the `tiny` config in float32 on the CPU, with the JAX engine's weights
carried over by `params_from_jax` (the draft's too): every engine case
runs the same requests through the JAX spec engine and the port's, and
holds the port to the JAX engine's token streams AND its counters
`spec_steps`, `spec_proposed_tokens` and `spec_accepted_tokens`, and to the
port's plain greedy engine (speculative greedy output is the plain greedy
output). Left out: the two pp cases (A10). The multimodal span case runs
each engine on its own content salts (the port's are BLAKE2b, JAX's xxh3).
The draft decodes through the ragged kernel's plain version here
(models/llama.decode_path), the JAX draft through its gather path; the
identical-draft cases still accept every draft, as in JAX. The n-gram
proposer and the draft budget are held id for id to the JAX functions on
hypothesis-drawn sequences. The verify's attention on the ragged path
(`block_attention`: the prefix through the kernel's plain version, the
block causally) is held to the JAX `paged_attention` the JAX verify runs,
on f32 and int8 pages, within 1e-5.
"""
import asyncio
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import dynamo_tpu.engine.config as jcfg_mod
import dynamo_tpu.engine.spec as jspec
import dynamo_tpu_torch.engine.config as tcfg_mod
import dynamo_tpu_torch.engine.spec as tspec
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

# tests/test_spec_decode.py's model and geometry (the JAX programs are
# shared with that file through the persistent compilation cache)
JCFG = JModelConfig(dtype="float32", max_model_len=512)
TCFG = TModelConfig(dtype="float32", max_model_len=512)
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
COUNTERS = ("spec_steps", "spec_proposed_tokens", "spec_accepted_tokens")


def _tcfg(jcfg):
    return TModelConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


def _jax_engine(jcfg=JCFG, eos=None, **kw):
    return JNativeEngine(jcfg, JEngineConfig(**dict(ENGINE_KW, **kw)),
                         seed=0, eos_token_ids=eos)


def _port_engine(jeng, jcfg=JCFG, eos=None, **kw):
    """The port engine on the JAX engine's weights (its draft's too)."""
    tcfg = _tcfg(jcfg)
    draft = None
    if jeng._draft is not None:
        dcfg = _tcfg(jeng._draft.cfg)
        draft = params_from_jax(jax.device_get(jeng._draft.params), dcfg)
    return TNativeEngine(tcfg, TEngineConfig(**dict(ENGINE_KW, **kw)),
                         params=params_from_jax(jax.device_get(jeng.params),
                                                tcfg),
                         eos_token_ids=eos, draft_params=draft,
                         device="cpu")


def _drive(eng, request_cls, params_cls, reqs):
    """{request id: tokens} of requests (rid, prompt, sampling kwargs) all
    submitted at once and stepped to the end."""
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


def _counters(eng) -> tuple:
    return tuple(getattr(eng, c) for c in COUNTERS)


def _run_both(reqs, jcfg=JCFG, eos=None, setup=None, **kw):
    """(streams, counters, port engine) after the same requests ran through
    the JAX spec engine and the port's, both streams and counters held
    equal; `setup(jeng, teng)` runs on both before the traffic."""
    jeng = _jax_engine(jcfg, eos=eos, **kw)
    teng = _port_engine(jeng, jcfg, eos=eos, **kw)
    if setup is not None:
        setup(jeng, teng)
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    got = _drive(teng, TRequest, TSamplingParams, reqs)
    assert got == want
    assert _counters(teng) == _counters(jeng)
    m = teng.metrics()
    assert (m.spec_steps, m.spec_proposed_tokens, m.spec_accepted_tokens) \
        == _counters(teng)
    return got, _counters(teng), teng


@pytest.fixture(scope="module")
def plain_port():
    """The port's plain engine on the JAX engine's weights: its greedy
    streams are what every speculative stream must equal."""
    jeng = _jax_engine()
    params = params_from_jax(jax.device_get(jeng.params), TCFG)

    def run(reqs, cfg=TCFG, eos=None, **kw):
        eng = TNativeEngine(cfg, TEngineConfig(**dict(ENGINE_KW, **kw)),
                            params=params, eos_token_ids=eos, device="cpu")
        return _drive(eng, TRequest, TSamplingParams, reqs)
    return run


def _oracle(monkeypatch, prompt_len: int, seq: list) -> None:
    """Both packages' ngram_propose replaced by a draft source fed `seq`,
    the true continuation (the JAX tests' oracle)."""
    def oracle(tokens, k, min_ngram=2, max_ngram=4, max_scan=4096,
               vocab_size=None):
        done = len(tokens) - prompt_len
        return seq[done:done + k]
    monkeypatch.setattr(jspec, "ngram_propose", oracle)
    monkeypatch.setattr(tspec, "ngram_propose", oracle)


def _wrong(monkeypatch) -> None:
    def wrong(tokens, k, min_ngram=2, max_ngram=4, max_scan=4096,
              vocab_size=None):
        return [(tokens[-1] + 1) % 100] * k
    monkeypatch.setattr(jspec, "ngram_propose", wrong)
    monkeypatch.setattr(tspec, "ngram_propose", wrong)


def repetitive_prompt():
    phrase = [11, 12, 13, 14, 15, 16]
    return phrase * 4 + [20, 21] + phrase * 2


# -- the proposer ---------------------------------------------------------------

@pytest.mark.parametrize("toks,kw", [
    ([1, 2, 3, 4, 9, 9, 1, 2, 3], dict(k=3)),
    ([1, 2, 3, 4, 9, 9, 1, 2, 3], dict(k=2)),
])
def test_ngram_propose_finds_continuation(toks, kw):
    assert tspec.ngram_propose(toks, **kw) == jspec.ngram_propose(toks, **kw)
    assert tspec.ngram_propose(toks, k=3) == [4, 9, 9]


def test_ngram_propose_prefers_most_recent_match():
    toks = [1, 2, 5, 7, 1, 2, 6, 8, 1, 2]
    assert tspec.ngram_propose(toks, k=1, max_ngram=2) == [6] == \
        jspec.ngram_propose(toks, k=1, max_ngram=2)


def test_ngram_propose_overlapping_run():
    for toks in ([7, 7, 7, 7], [7, 7, 7, 7, 7]):
        assert tspec.ngram_propose(toks, k=2, min_ngram=2) == [7, 7] == \
            jspec.ngram_propose(toks, k=2, min_ngram=2)


def test_ngram_propose_no_match_or_short():
    for toks, k in (([1, 2, 3, 4, 5], 4), ([1, 2], 4), ([1, 2, 3], 0)):
        assert tspec.ngram_propose(toks, k=k) == [] == \
            jspec.ngram_propose(toks, k=k)


def test_ngram_propose_truncates_at_salt_ids():
    salt = 0x12345678
    toks = [11, 12, 13, 14, salt, salt + 1, 21, 22, 11, 12, 13, 14]
    toks2 = [11, 12, 13, 14, 77, salt, 21, 11, 12, 13, 14]
    for t, vocab in ((toks, 256), (toks, None), (toks2, 256)):
        assert tspec.ngram_propose(t, k=3, vocab_size=vocab) == \
            jspec.ngram_propose(t, k=3, vocab_size=vocab)
    assert tspec.ngram_propose(toks2, k=3, vocab_size=256) == [77]
    assert tspec.truncate_to_vocab([1, 300, 2], 256) == [1]


@settings(max_examples=300, deadline=None)
@given(toks=st.lists(st.integers(0, 5), min_size=0, max_size=60),
       k=st.integers(0, 6), lo=st.integers(1, 4), span=st.integers(0, 3),
       max_scan=st.integers(2, 64),
       vocab=st.one_of(st.none(), st.integers(1, 6)))
def test_ngram_propose_and_draft_cap_match_jax(toks, k, lo, span, max_scan,
                                               vocab):
    kw = dict(min_ngram=lo, max_ngram=lo + span, max_scan=max_scan,
              vocab_size=vocab)
    assert tspec.ngram_propose(toks, k, **kw) == \
        jspec.ngram_propose(toks, k, **kw)
    seq = types.SimpleNamespace(total_len=len(toks) + 1,
                                pages=[0] * (len(toks) // 8 + 1))
    for max_pos in (-1, len(toks), len(toks) + k, 10 ** 6):
        assert tspec.draft_cap(seq, max_pos, 8, k) == \
            jspec.draft_cap(seq, max_pos, 8, k)


# -- exactness vs plain greedy ---------------------------------------------------

@pytest.mark.parametrize("prompt", [
    repetitive_prompt(),
    list(range(10, 40)),
    [5, 6, 5, 6, 5, 6, 5, 6],
], ids=["repetitive", "no-repeat", "short-period"])
def test_spec_exact_vs_plain(prompt, plain_port):
    reqs = [("spec", prompt, dict(max_tokens=12, temperature=0.0))]
    got, _, _ = _run_both(reqs, spec_decode="ngram", spec_k=4)
    assert got == plain_port(reqs)


def test_spec_exact_concurrent_batch(plain_port):
    prompts = [repetitive_prompt(), list(range(40, 60)), [3, 4, 5] * 6]
    reqs = [(f"r{i}", pr, dict(max_tokens=7, temperature=0.0))
            for i, pr in enumerate(prompts)]
    got, _, _ = _run_both(reqs, spec_decode="ngram", spec_k=4)
    solo = {}
    for r in reqs:
        solo.update(plain_port([r]))
    assert got == solo


def test_spec_exact_min_tokens_and_stops(monkeypatch, plain_port):
    """Hidden stops and the min-tokens eos ban through the VERIFY commit
    path, with the oracle draft fed each leg's plain stream."""
    prompt = repetitive_prompt()
    probe = plain_port([("p", prompt, dict(max_tokens=10,
                                            temperature=0.0))])["p"]
    seq: list = []
    _oracle(monkeypatch, len(prompt), seq)
    stop = dict(max_tokens=10, temperature=0.0,
                stop_token_ids=(probe[len(probe) // 2],))
    seq[:] = plain_port([("a", prompt, stop)])["a"]
    got, counts, _ = _run_both([("b", prompt, stop)], spec_decode="ngram",
                               spec_k=4)
    assert got["b"] == seq and counts[0] > 0
    eos = {probe[2]}
    ban = dict(max_tokens=10, temperature=0.0, min_tokens=5)
    seq[:] = plain_port([("a", prompt, ban)], eos=eos)["a"]
    assert len(seq) >= 5
    got, counts, _ = _run_both([("b", prompt, ban)], eos=eos,
                               spec_decode="ngram", spec_k=4)
    assert got["b"] == seq and counts[0] > 0


@pytest.mark.parametrize("mt", [1, 2, 3])
def test_spec_max_tokens_edges(mt, plain_port):
    reqs = [("b", repetitive_prompt(), dict(max_tokens=mt,
                                            temperature=0.0))]
    got, _, _ = _run_both(reqs, spec_decode="ngram", spec_k=4)
    assert got == plain_port(reqs) and len(got["b"]) == mt


# -- acceptance -------------------------------------------------------------------

def test_spec_oracle_draft_accepts_fully(monkeypatch, plain_port):
    prompt = list(range(10, 30))
    reqs = [("spec", prompt, dict(max_tokens=12, temperature=0.0))]
    plain = plain_port(reqs)["spec"]
    _oracle(monkeypatch, len(prompt), plain)
    got, counts, teng = _run_both(reqs, spec_decode="ngram", spec_k=4)
    assert got["spec"] == plain
    assert counts[1] == counts[2] > 0 and counts[0] <= 4


def test_spec_wrong_drafts_all_rejected(monkeypatch, plain_port):
    reqs = [("spec", list(range(10, 30)), dict(max_tokens=6,
                                               temperature=0.0))]
    _wrong(monkeypatch)
    got, counts, _ = _run_both(reqs, spec_decode="ngram", spec_k=4)
    assert got == plain_port(reqs)
    assert counts[1] > 0 and counts[2] == 0


# -- fallbacks ----------------------------------------------------------------------

def test_spec_sampled_plan_falls_back_to_window(plain_port):
    reqs = [("b", repetitive_prompt(), dict(max_tokens=8, temperature=0.8,
                                            top_k=20, seed=7))]
    got, counts, _ = _run_both(reqs, spec_decode="ngram", spec_k=4)
    assert got == plain_port(reqs)
    assert counts == (0, 0, 0)


def test_spec_gate_returns_to_window_on_rejection(monkeypatch, plain_port):
    """Rejected drafts collapse the acceptance EMA and the gate hands the
    batch back to the window: the same verify count and EMA as JAX; then
    the probe cadence and the bound precheck call for call."""
    reqs = [("spec", list(range(10, 30)), dict(max_tokens=24,
                                               temperature=0.0))]
    _wrong(monkeypatch)
    got, counts, teng = _run_both(reqs, decode_steps=8, spec_decode="ngram",
                                  spec_k=4, spec_probe_every=1000)
    assert got == plain_port(reqs, decode_steps=8)
    assert 1 <= counts[0] <= 9 and teng._spec_acc_ema < 0.35
    plan8 = types.SimpleNamespace(seqs=[object()], n_window=8)
    for method, ema in (("_spec_worthwhile", 0.0), ("_spec_bound_ok", 0.0)):
        jeng = _jax_engine(decode_steps=8, spec_decode="ngram", spec_k=4,
                           spec_probe_every=3)
        teng = _port_engine(jeng, decode_steps=8, spec_decode="ngram",
                            spec_k=4, spec_probe_every=3)
        answers = []
        for eng in (jeng, teng):
            eng._spec_acc_ema = ema
            call = getattr(eng, method)
            args = (plan8, 4) if method == "_spec_worthwhile" else (plan8,)
            answers.append([call(*args) for _ in range(4)]
                           + [eng._spec_gate_skips])
        assert answers[0] == answers[1]
        assert answers[1][:3] == [False, False, True]
    teng._spec_acc_ema, teng._spec_gate_skips = 1.0, 0
    assert teng._spec_bound_ok(plan8) and teng._spec_gate_skips == 0


def test_spec_empty_probe_resets_cadence(monkeypatch):
    monkeypatch.setattr(jspec, "ngram_propose", lambda *a, **k: [])
    monkeypatch.setattr(tspec, "ngram_propose", lambda *a, **k: [])

    def setup(jeng, teng):
        for eng in (jeng, teng):
            eng._spec_acc_ema = 0.0
            eng._spec_gate_skips = 4

    reqs = [("r", list(range(10, 30)), dict(max_tokens=12,
                                            temperature=0.0))]
    _, counts, teng = _run_both(reqs, setup=setup, decode_steps=8,
                                spec_decode="ngram", spec_k=4,
                                spec_probe_every=4)
    assert counts[0] == 0 and teng._spec_gate_skips < 4


def test_spec_gate_prices_follow_the_device():
    """The gate's prices (spec.gate_costs): off the card the JAX dispatch
    model at its default ratio, so the CPU engine decides as the JAX
    engine does; on the card one graph replay each, a verify priced at the
    measured VERIFY_STEPS window steps. The n-gram lengths are the JAX
    defaults."""
    jdef = JEngineConfig()
    assert (tspec.NGRAM_MIN, tspec.NGRAM_MAX) == (jdef.spec_min_ngram,
                                                  jdef.spec_max_ngram)
    r = jdef.spec_dispatch_ratio
    for nw in (1, 2, 4, 8):
        assert tspec.gate_costs(nw, "cpu") == (nw + r, 1 + r)
        assert tspec.gate_costs(nw, "cuda") == (nw, tspec.VERIFY_STEPS)
    assert 1 < tspec.VERIFY_STEPS < 1 + r
    jeng = _jax_engine(decode_steps=8, spec_decode="ngram", spec_k=4)
    teng = _port_engine(jeng, decode_steps=8, spec_decode="ngram", spec_k=4)
    plan8 = types.SimpleNamespace(seqs=[object(), None], n_window=8)
    assert teng._spec_gate_terms(plan8) == (1, 8, 8 + r, 1 + r)
    # one accepted draft expected a verify: JAX's prices refuse it
    # ((1 + 1) * (8 + 2) <= 8 * 3), the card's pass it ((1 + 1) * 8 > 8 x
    # VERIFY_STEPS); only the prices change with the device
    for eng in (jeng, teng):
        eng._spec_acc_ema = 0.25
    assert not jeng._spec_worthwhile(plan8, 4)
    assert not teng._spec_worthwhile(plan8, 4)
    teng.device = torch.device("cuda")
    assert teng._spec_gate_terms(plan8) == (1, 8, 8.0, tspec.VERIFY_STEPS)
    assert teng._spec_worthwhile(plan8, 4)


def test_spec_config_validation():
    for kw, match in ((dict(spec_decode="eagle"), "spec_decode"),
                      (dict(spec_decode="ngram", spec_k=0), "spec_k")):
        with pytest.raises(ValueError, match=match):
            _jax_engine(**kw)
        with pytest.raises(ValueError, match=match):
            TNativeEngine(TCFG, TEngineConfig(**dict(ENGINE_KW, **kw)),
                          device="cpu")
    # the JAX refusal of sp (ring-attention prefill) has no counterpart:
    # the port's EngineConfig has no sequence parallelism to refuse
    assert not hasattr(TEngineConfig(), "sp")


# -- draft-model mode -------------------------------------------------------------

@pytest.fixture
def f32_draft():
    """A registry entry equal to the test config in both packages (the
    registry 'tiny' is bf16; an identical draft needs identical
    arithmetic)."""
    jcfg_mod._CONFIGS["tiny-f32-test"] = JCFG
    tcfg_mod._CONFIGS["tiny-f32-test"] = TCFG
    yield "tiny-f32-test"
    jcfg_mod._CONFIGS.pop("tiny-f32-test", None)
    tcfg_mod._CONFIGS.pop("tiny-f32-test", None)


def test_spec_draft_same_model_accepts_fully(f32_draft, plain_port):
    reqs = [("spec", list(range(10, 30)), dict(max_tokens=16,
                                               temperature=0.0))]
    got, counts, teng = _run_both(reqs, spec_decode="draft",
                                  spec_draft_model=f32_draft, spec_k=4)
    assert got == plain_port(reqs)
    assert counts[0] > 0 and counts[1] == counts[2] > 0
    assert teng._draft.path == "ragged"


def test_spec_draft_divergent_model_still_exact(f32_draft, plain_port):
    from dynamo_tpu.models import llama as jllama

    def setup(jeng, teng):
        jeng._draft.params = jax.device_put(jllama.init_params(
            jax.random.PRNGKey(123), cfg=jeng._draft.cfg))
        teng._draft.params = params_from_jax(
            jax.device_get(jeng._draft.params), TCFG)

    reqs = [("spec", repetitive_prompt(), dict(max_tokens=20,
                                               temperature=0.0))]
    got, counts, _ = _run_both(reqs, setup=setup, decode_steps=8,
                               spec_decode="draft",
                               spec_draft_model=f32_draft, spec_k=4,
                               spec_probe_every=2)
    assert got == plain_port(reqs, decode_steps=8)
    assert counts[0] > 0 and counts[2] < counts[1]


def test_spec_draft_concurrent_batch_exact(f32_draft, plain_port):
    prompts = [list(range(3, 19)), list(range(40, 56)), list(range(7, 23))]
    reqs = [(f"r{i}", pr, dict(max_tokens=9, temperature=0.0))
            for i, pr in enumerate(prompts)]
    got, counts, _ = _run_both(reqs, spec_decode="draft",
                               spec_draft_model=f32_draft, spec_k=4)
    solo = {}
    for r in reqs:
        solo.update(plain_port([r]))
    assert got == solo
    assert counts[1] == counts[2] > 0


def test_spec_draft_pos_pruned_on_finish(f32_draft):
    """Requests finishing inside a verify step, and one aborted mid-stream,
    leave no draft coverage behind."""
    reqs = [("r1", list(range(10, 26)), dict(max_tokens=6,
                                             temperature=0.0)),
            ("r2", list(range(30, 46)), dict(max_tokens=6,
                                             temperature=0.0))]
    _, counts, teng = _run_both(reqs, spec_decode="draft",
                                spec_draft_model=f32_draft, spec_k=4)
    assert counts[0] > 0 and teng._draft.pos == {}
    teng.add_request(TRequest("r3", list(range(50, 66)),
                              TSamplingParams(max_tokens=30,
                                              temperature=0.0)))
    while not teng._draft.pos:
        teng.step()
    teng.abort("r3")
    assert teng._draft.pos == {}


def test_spec_draft_config_validation():
    small = "tiny-smallvocab"
    jcfg_mod._CONFIGS[small] = dataclasses.replace(
        jcfg_mod._CONFIGS["tiny"], vocab_size=64)
    tcfg_mod._CONFIGS[small] = dataclasses.replace(
        tcfg_mod._CONFIGS["tiny"], vocab_size=64)
    try:
        for kw, match in ((dict(spec_decode="draft"), "spec_draft_model"),
                          (dict(spec_decode="draft",
                                spec_draft_model=small), "vocab")):
            with pytest.raises(ValueError, match=match):
                _jax_engine(**kw)
            with pytest.raises(ValueError, match=match):
                TNativeEngine(TCFG, TEngineConfig(**dict(ENGINE_KW, **kw)),
                              device="cpu")
    finally:
        jcfg_mod._CONFIGS.pop(small, None)
        tcfg_mod._CONFIGS.pop(small, None)


def test_spec_draft_disagg_decode_side(f32_draft, plain_port):
    """A draft-speculating DECODE engine behind the port's disaggregation
    (PR 8's workers): the remotely prefilled prompt never went through the
    draft, so the first spec step's catch-up replays it. Tokens equal the
    aggregated engine's and the JAX disaggregated run's, counters equal
    the JAX decode engine's, and every draft is accepted."""
    from dynamo_tpu.disagg import (
        DisaggDecodeWorker as JDecodeWorker,
        DisaggregatedRouter as JRouter,
        LocalTransferBackend as JTransfer, PrefillQueue as JQueue,
        PrefillWorker as JPrefillWorker,
    )
    from dynamo_tpu.llm.worker import NativeEngineWorker as JWorker
    from dynamo_tpu.protocols.common import (
        PreprocessedRequest as JPre, StopConditions as JStop,
    )
    from dynamo_tpu.runtime.engine import Context as JContext
    from dynamo_tpu.runtime.transports.memory import MemoryPlane as JPlane
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.transfer import LocalTransferBackend
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    prompt = list(range(100, 120))
    kw = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
    expect = plain_port([("r1", prompt, kw)])["r1"]
    spec_kw = dict(spec_decode="draft", spec_draft_model=f32_draft,
                   spec_k=4)
    jdec = _jax_engine(**spec_kw)
    tdec = _port_engine(jdec, **spec_kw)
    jpre = _jax_engine()
    tpre = _port_engine(jpre)

    async def side(port: bool):
        plane = MemoryPlane() if port else JPlane()
        queue = (PrefillQueue if port else JQueue)(plane.messaging, "ns",
                                                   "tiny")
        router = (DisaggregatedRouter if port else JRouter)(
            max_local_prefill_length=4, max_prefill_queue_size=4,
            model="tiny")
        transfer = LocalTransferBackend() if port else JTransfer()
        decode = (DisaggDecodeWorker if port else JDecodeWorker)(
            tdec if port else jdec, plane.messaging, router, queue,
            worker_id="dec-0", prefill_timeout_s=30.0)
        transfer.register("dec-0", decode)
        prefill = (PrefillWorker if port else JPrefillWorker)(
            (NativeEngineWorker if port else JWorker)(
                tpre if port else jpre), queue, transfer, plane.messaging)
        await decode.start()
        await prefill.start()
        toks = []
        try:
            if port:
                req = PreprocessedRequest(
                    request_id="r1", token_ids=prompt,
                    stop=StopConditions(max_tokens=6, ignore_eos=True))
                async for f in decode.generate(req, Context("r1")):
                    toks.extend(f.token_ids)
            else:
                req = JPre(request_id="r1", token_ids=prompt,
                           stop=JStop(max_tokens=6, ignore_eos=True))
                async for f in decode.generate(
                        req.model_dump(exclude_none=True), JContext("r1")):
                    toks.extend(f.get("token_ids", ()))
        finally:
            await prefill.stop()
            await decode.stop()
        return toks, decode.remote_prefills

    got = asyncio.run(asyncio.wait_for(side(True), 120))
    want = asyncio.run(asyncio.wait_for(side(False), 120))
    assert got == want == (expect, 1)
    assert _counters(tdec) == _counters(jdec)
    assert tdec.spec_steps > 0
    assert tdec.spec_accepted_tokens == tdec.spec_proposed_tokens > 0


def test_spec_composes_with_int8_target(f32_draft):
    """int8 weights (the JAX engine's quantized tree, carried over
    verbatim) with an f32 draft: the port's streams and counters equal the
    JAX engine's, and the plain int8 engine's streams."""
    qj = dataclasses.replace(JCFG, quant="int8")
    reqs = [("spec", repetitive_prompt(), dict(max_tokens=10,
                                               temperature=0.0))]
    got, counts, _ = _run_both(reqs, jcfg=qj, spec_decode="draft",
                               spec_draft_model=f32_draft, spec_k=4)
    jplain = _jax_engine(qj)
    tplain = _port_engine(jplain, qj)
    assert got == _drive(tplain, TRequest, TSamplingParams, reqs)
    assert counts[0] > 0


def test_spec_composes_with_gemma2_class_attention(monkeypatch):
    """Soft-caps, alternating sliding windows and post-norms through the
    verify block (the port's gather paths), with oracle drafts."""
    g2 = dataclasses.replace(
        JCFG, attn_softcap=30.0, final_softcap=20.0, sliding_window=16,
        sliding_pattern="alternate", post_norms=True, norm_plus_one=True)
    prompt = repetitive_prompt() * 2
    kw = dict(max_prefill_chunk=64, prefill_buckets=(8, 16, 32, 64))
    reqs = [("spec", prompt, dict(max_tokens=8, temperature=0.0))]
    jplain = _jax_engine(g2, **kw)
    plain = _drive(_port_engine(jplain, g2, **kw), TRequest,
                   TSamplingParams, reqs)
    _oracle(monkeypatch, len(prompt), plain["spec"])
    got, counts, teng = _run_both(reqs, jcfg=g2, spec_decode="ngram",
                                  spec_k=4, **kw)
    assert got == plain and counts[0] > 0
    assert teng.decode_path == "gather"


def test_spec_prefix_cache_hashes_unaffected():
    """Sealed-page prefix hits after a speculative run equal the plain
    run's, in both packages."""
    prompt = repetitive_prompt()
    reqs = [("rb", prompt, dict(max_tokens=9, temperature=0.0))]
    jeng = _jax_engine(spec_decode="ngram", spec_k=4)
    _drive(jeng, JRequest, JSamplingParams, reqs)
    _, _, teng = _run_both(reqs, spec_decode="ngram", spec_k=4)
    tplain = _port_engine(jeng)
    _drive(tplain, TRequest, TSamplingParams, reqs)
    assert teng.scheduler.peek_prefix(prompt) == \
        tplain.scheduler.peek_prefix(prompt) == \
        jeng.scheduler.peek_prefix(prompt) > 0


def test_worker_stats_carry_spec_counters(f32_draft):
    """The worker's $STATS (and the router's WorkerMetrics) carry the spec
    counters of a draft-model engine, its draft's proposal graphs and the
    host phases of the verify and the proposals; the counters equal the
    JAX engine's on the same stream."""
    from dynamo_tpu_torch.kv_router.scoring import WorkerMetrics
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    spec_kw = dict(spec_decode="draft", spec_draft_model=f32_draft,
                   spec_k=4)
    jeng = _jax_engine(**spec_kw)
    teng = _port_engine(jeng, **spec_kw)
    prompt = list(range(10, 30))
    want = _drive(jeng, JRequest, JSamplingParams,
                  [("r", prompt, dict(max_tokens=12, temperature=0.0,
                                      ignore_eos=True))])["r"]

    async def main():
        worker = await NativeEngineWorker(teng).start()
        try:
            req = PreprocessedRequest(
                request_id="r", token_ids=prompt,
                stop=StopConditions(max_tokens=12, ignore_eos=True))
            toks = []
            async for f in worker.generate(req, Context("r")):
                toks.extend(f.token_ids)
            return toks, worker.stats_handler()
        finally:
            await worker.stop()

    toks, stats = asyncio.run(asyncio.wait_for(main(), 120))
    assert toks == want
    got = tuple(stats[c] for c in COUNTERS)
    assert got == _counters(jeng) == _counters(teng)
    assert got[0] > 0 and got[1] == got[2] > 0
    m = WorkerMetrics.from_dict(stats)
    assert (m.spec_steps, m.spec_proposed_tokens,
            m.spec_accepted_tokens) == got
    draft = stats["draft"]
    assert (draft["model"], draft["path"], draft["layers"], draft["k"]) == \
        (TCFG.name, "ragged", TCFG.num_layers, 4)
    assert sum(draft["catchup_buckets"].values()) > 0
    assert stats["phases"]["verify"]["count"] == got[0]
    assert stats["phases"]["propose"]["count"] == got[0]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_block_attention_matches_paged_attention(quant):
    """A verify block's attention (ops/paged_attention.block_attention)
    against the JAX paged_attention over the same cache with the block's
    rows written, on f32 and int8 pages: rows with a long, an empty and a
    mid-page prefix, GQA 2, slots past each row's block holding NaN (or
    NaN scales); within 1e-5."""
    from dynamo_tpu.ops import attention as jatt
    from dynamo_tpu_torch.ops.kv_quant import dequantize_rows, quantize_rows
    from dynamo_tpu_torch.ops.paged_attention import block_attention
    rng = np.random.default_rng(5)
    nl, hkv, h, hd, p, ps, pb, s, t = 2, 2, 4, 32, 16, 8, 3, 3, 5
    layer = 1
    pt = rng.permutation(p)[:s * pb].reshape(s, pb).astype(np.int32)
    prefix = np.array([13, 0, 7], np.int32)
    q = rng.normal(size=(s, t, h, hd)).astype(np.float32)
    kb = rng.normal(size=(s, t, hkv, hd)).astype(np.float32)
    vb = rng.normal(size=(s, t, hkv, hd)).astype(np.float32)
    vals = {n: rng.normal(size=(nl, hkv, p, ps, hd)).astype(np.float32)
            for n in ("k", "v")}
    cache = {}
    if quant:
        for n in ("k", "v"):
            qv, sc = quantize_rows(torch.from_numpy(vals[n]))
            cache[n], cache[f"{n}_scale"] = qv.numpy(), sc.numpy()
        blocks = []
        for x in (kb, vb):
            qv, sc = quantize_rows(torch.from_numpy(x))
            blocks.append((qv.numpy(), sc.numpy()))
    else:
        cache = {n: vals[n].copy() for n in ("k", "v")}
        blocks = [(kb, None), (vb, None)]
    # the block's rows at prefix + j, NaN in every later slot of the pages
    for i in range(s):
        for j in range(pb * ps):
            page, slot = pt[i, j // ps], j % ps
            for n, (rows, scales) in zip(("k", "v"), blocks):
                if prefix[i] <= j < prefix[i] + t:
                    cache[n][layer, :, page, slot] = rows[i, j - prefix[i]]
                    if quant:
                        cache[f"{n}_scale"][layer, :, page, slot] = \
                            scales[i, j - prefix[i]]
                elif j >= prefix[i] + t:
                    if quant:
                        cache[f"{n}_scale"][layer, :, page, slot] = np.nan
                    else:
                        cache[n][layer, :, page, slot] = np.nan
    qpos = prefix[:, None] + np.arange(t, dtype=np.int32)[None]
    want = jatt.paged_attention(
        jnp.asarray(q), jnp.asarray(cache["k"][layer]),
        jnp.asarray(cache["v"][layer]), jnp.asarray(pt),
        jnp.asarray(prefix + t), jnp.asarray(qpos),
        k_scale=jnp.asarray(cache["k_scale"][layer]) if quant else None,
        v_scale=jnp.asarray(cache["v_scale"][layer]) if quant else None)
    tb = [torch.from_numpy(x) for x in (kb, vb)]
    if quant:
        tb = [dequantize_rows(torch.from_numpy(r), torch.from_numpy(sc),
                              torch.float32) for r, sc in blocks]
    tc = {n: torch.from_numpy(np.ascontiguousarray(a))
          for n, a in cache.items()}
    got = block_attention(torch.from_numpy(q), tb[0], tb[1], tc["k"],
                          tc["v"], layer, torch.from_numpy(pt),
                          torch.from_numpy(prefix), tc.get("k_scale"),
                          tc.get("v_scale"))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_spec_on_int8_kv_pages(monkeypatch, plain_port):
    """Speculation on int8 KV pages: the verify block's rows quantized as
    the cache stores them, the prefix read with its scales; with oracle
    drafts, streams and counters equal to the JAX engine's, and the
    stream to the plain int8 engine's."""
    kv_quant = "int8"
    prompt = repetitive_prompt()
    reqs = [("spec", prompt, dict(max_tokens=12, temperature=0.0))]
    seq = plain_port(reqs, kv_quant=kv_quant)["spec"]
    _oracle(monkeypatch, len(prompt), seq)
    got, counts, _ = _run_both(reqs, spec_decode="ngram", spec_k=4,
                               kv_quant=kv_quant)
    assert counts[0] > 0 and counts[2] > 0
    assert got["spec"] == seq


def test_spec_draft_from_hf_dir(tmp_path, plain_port):
    """A draft model from an HF directory (models/loader.py on both sides):
    the same draft config and weights as the JAX engine loads, and the
    port's streams equal to the JAX engine's and the plain engine's."""
    import transformers as tf
    torch.manual_seed(0)
    model = tf.LlamaForCausalLM(tf.LlamaConfig(
        vocab_size=TCFG.vocab_size, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rope_theta=10000.0,
        tie_word_embeddings=False)).eval()
    path = str(tmp_path / "draft")
    model.save_pretrained(path, safe_serialization=True)
    spec_kw = dict(spec_decode="draft", spec_draft_model=path, spec_k=4)
    jeng = _jax_engine(**spec_kw)
    teng = TNativeEngine(TCFG, TEngineConfig(**dict(ENGINE_KW, **spec_kw)),
                         params=params_from_jax(jax.device_get(jeng.params),
                                                TCFG), device="cpu")
    dj, dt = jeng._draft, teng._draft
    assert (dt.cfg.hidden_size, dt.cfg.num_layers, dt.cfg.dtype) == \
        (dj.cfg.hidden_size, dj.cfg.num_layers, dj.cfg.dtype)
    jw = jax.device_get(dj.params["layers"]["wq"])
    assert np.array_equal(dt.params["layers"]["wq"].float().numpy(),
                          np.asarray(jw, dtype=np.float32))
    reqs = [("spec", list(range(10, 30)), dict(max_tokens=12,
                                               temperature=0.0))]
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    got = _drive(teng, TRequest, TSamplingParams, reqs)
    assert got == want == plain_port(reqs)
    assert teng.spec_steps > 0
    assert _counters(teng) == _counters(jeng)


def test_spec_exact_when_draft_crosses_mm_span(monkeypatch):
    """tests/test_spec_decode.py's case: a multimodal request whose
    proposals cross the image span (two correct tokens, then the
    sequence's own salt ids) speculates token-identically to plain greedy
    in both packages: the salts are cut from the proposals
    (truncate_to_vocab), never fed to the verify. Streams and spec
    counters equal JAX's."""
    from dynamo_tpu.engine.config import VisionConfig as JVisionConfig
    from dynamo_tpu_torch.engine.config import VisionConfig

    vision = dict(image_size=28, patch_size=14, hidden_size=32,
                  intermediate_size=64, num_layers=2, num_heads=2)
    jcfg = JModelConfig(dtype="float32", max_model_len=256,
                        vision=JVisionConfig(**vision))
    tcfg = dataclasses.replace(_tcfg(dataclasses.replace(jcfg, vision=None)),
                               vision=VisionConfig(**vision))
    n_patch = 4
    prompt = [5, 6, 7, 8] + [0] * n_patch + [9, 10, 11, 12]
    kw = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    ekw = dict(ENGINE_KW, max_slots=2, max_model_len=256)
    img = np.random.RandomState(3).rand(28, 28, 3).astype(np.float32)
    jtree = None

    def make(port: bool, **extra):
        nonlocal jtree
        cfg = dict(ekw, **extra)
        if not port:
            eng = JNativeEngine(jcfg, JEngineConfig(**cfg), seed=0)
            jtree = jax.device_get(eng.params)
            return eng
        return TNativeEngine(tcfg, TEngineConfig(**cfg),
                             params=params_from_jax(jtree, tcfg),
                             device="cpu")

    def gen(eng, port: bool, rid):
        req, sp = (TRequest, TSamplingParams) if port else (
            JRequest, JSamplingParams)
        eng.add_request(req(rid, prompt, sp(**kw),
                            mm_spans=[(4, eng.encode_image(img))]))
        seq = next(s for s in eng.scheduler.waiting if s.request_id == rid)
        salts = list(seq.prompt[4:4 + n_patch])
        out = []
        while eng.has_work():
            for ev in eng.step():
                if ev.token is not None:
                    out.append(ev.token)
        return out, salts

    runs = {}
    for port in (False, True):
        plain, salts = gen(make(port), port, "plain")
        assert any(not 0 <= x < jcfg.vocab_size for x in salts), \
            "admission must salt the span with out-of-vocab ids"
        mod = tspec if port else jspec

        def crossing(tokens, k, min_ngram=2, max_ngram=4, max_scan=4096,
                     vocab_size=None, plain=plain, salts=salts, mod=mod):
            done = len(tokens) - len(prompt)
            cont = plain[done:done + 2] + salts
            return mod.truncate_to_vocab(cont, vocab_size)[:k]
        monkeypatch.setattr(mod, "ngram_propose", crossing)
        eng = make(port, spec_decode="ngram", spec_k=4)
        spec, _ = gen(eng, port, "spec")
        assert spec == plain
        assert eng.spec_accepted_tokens > 0, \
            "truncated drafts must still exercise the verify path"
        runs[port] = (plain, _counters(eng))
    assert runs[True] == runs[False]
