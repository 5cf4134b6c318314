"""The port's mixture-of-experts serving path against the JAX package's, on
the same numpy-seeded inputs and bridged weights (`tiny-moe`: 4 experts,
top 2, f32 unless named).

- `ops/moe.moe_dispatch_mlp` against `dynamo_tpu/ops/moe.moe_dispatch_mlp`
  at capacity factors 2.0, 4.0 and 0.25 (which drops), with and without a
  validity mask: outputs within rtol = atol = 1e-5 (f32 on both sides;
  only the matmuls' summation order differs) and equal (dropped, routed).
- `models/llama._moe_mlp` (the dense oracle) against the JAX one (1e-5),
  and the dispatch against it when nothing drops.
- Ties in the router's logits go to the lower expert index, as
  `jax.lax.top_k` breaks them.
- The grouped W8A16 product's plain version against `wmat` per expert:
  exact zeros for the inactive experts; `active` counts the pairs kept
  after the mask, so a padding row activates no expert.
- `init_params` with quant="int8" equals `quantize_params` of the
  unquantized draw, scales [L, E, 1, F] as the JAX package's; the weight
  bridge carries the router and refuses a tree whose experts do not match.
- Engines: token-identical streams against the JAX `NativeEngine` (its
  gather decode window, decode_kernel="off"; with int8 KV pages at one step
  per window, as tests/test_torch_kv_quant.py explains): f32 and int8
  weights, greedy and seeded-sampled; int8 KV pages and moe_impl="dense",
  greedy. `moe_routed_tokens` / `moe_dropped_tokens` equal the JAX
  engine's after the same requests (a prompt longer than one bucket and a
  second one sharing its prefix, a slot dying mid-window, a mixed step),
  and change only when a committed program's outputs are read.
- `run.py` serves `tiny-moe` on the CPU.

The CUDA kernel (csrc/w8a16_moe_gemm.cu) is held against the plain version
on the card by chip_smoke.py phase 14.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
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
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import moe as jmoe
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, get_model_config,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import moe as tmoe
from dynamo_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

TCFG = dataclasses.replace(get_model_config("tiny-moe"), dtype="float32",
                           max_model_len=512)
JCFG = JModelConfig(name="tiny-moe", num_experts=4, num_experts_per_tok=2,
                    intermediate_size=256, dtype="float32",
                    max_model_len=512, decode_kernel="off")
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
EOS = {2}
TOL = dict(rtol=1e-5, atol=1e-5)
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch(tree):
    """A numpy layer dict -> torch (quantized leaves as {"q", "s"})."""
    return {k: ({p: _t(v[p]) for p in ("q", "s")} if jquant.is_quantized(v)
                else _t(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def layer0():
    """Layer 0 of a tiny-moe JAX init, as numpy."""
    params = jllama.init_params(jax.random.PRNGKey(1), JCFG)
    return jax.device_get(jax.tree.map(lambda a: a[0], params["layers"]))


def _x(seed, b=2, t=12):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, JCFG.hidden_size)).astype(np.float32)


# -- the dispatch ---------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("factor", [2.0, 4.0, 0.25])
def test_dispatch_matches_jax(layer0, factor, masked):
    x = _x(3)
    valid = None
    if masked:
        valid = np.random.default_rng(4).random(x.shape[:2]) > 0.3
        valid[0, :3] = False
    want, (jd, jr) = jmoe.moe_dispatch_mlp(
        jnp.asarray(x), layer0, JCFG, capacity_factor=factor,
        return_dropped=True,
        valid=None if valid is None else jnp.asarray(valid))
    got, (td, tr) = tmoe.moe_dispatch_mlp(
        _t(x), _to_torch(layer0), TCFG, capacity_factor=factor,
        return_dropped=True, valid=None if valid is None else _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (float(td), float(tr)) == (float(jd), float(jr))
    if factor == 0.25:
        assert float(td) > 0, "capacity 0.25 must drop"
    if masked:
        assert float(tr) == 2 * valid.sum()


def test_moe_mlp_matches_jax_and_dispatch_without_drops(layer0):
    """The dense oracle against the JAX one; the dispatch at capacity
    factor E (room for any routing) against it (JAX
    tests/test_model.py:131-148)."""
    x = _x(6, t=24)
    want = jllama._moe_mlp(jnp.asarray(x), layer0, JCFG)
    lp = {k: _t(v)[None] for k, v in layer0.items()}      # one layer
    dense = tllama._moe_mlp(_t(x), lp, 0, TCFG)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **TOL)
    disp, (dropped, _) = tmoe.moe_dispatch_mlp(
        _t(x), _to_torch(layer0), TCFG, capacity_factor=4.0,
        return_dropped=True)
    assert float(dropped) == 0
    np.testing.assert_allclose(disp.numpy(), dense.numpy(), **TOL)


def test_top_k_breaks_ties_toward_the_lower_index(layer0):
    logits = np.array([[[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0],
                        [0.0, -1.0, 0.0, 5.0], [7.0, 1.0, 1.0, 7.0]]],
                      np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 2)
    tv, ti = tmoe.top_k(_t(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a router with two identical columns: every token ties between them
    lp = dict(layer0)
    router = np.array(lp["router"])
    router[:, 3] = router[:, 1]
    lp["router"] = router
    x = _x(8)
    want, (jd, jr) = jmoe.moe_dispatch_mlp(
        jnp.asarray(x), lp, JCFG, capacity_factor=2.0, return_dropped=True)
    got, (td, tr) = tmoe.moe_dispatch_mlp(
        _t(x), _to_torch(lp), TCFG, capacity_factor=2.0,
        return_dropped=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (float(td), float(tr)) == (float(jd), float(jr))
    # expert 3 ties with expert 1 on every token: it is chosen only after 1
    pairs = tmoe.route(_t(x), _t(router), 4, 2, 2.0)["idx"].view(-1, 2)
    assert all(p.tolist() == [1, 3] for p in pairs if 3 in p.tolist())
    assert any(3 in p.tolist() for p in pairs)


# -- the grouped product's plain version ------------------------------------------

def test_grouped_plain_matches_wmat_per_expert():
    rng = np.random.default_rng(11)
    w = rng.standard_normal((4, 64, 48)).astype(np.float32) * 0.1
    qw = tquant.quantize_int8(_t(w))
    assert tuple(qw["s"].shape) == (4, 1, 48)
    x = _t(rng.standard_normal((4, 8, 64)).astype(np.float32))
    active = torch.tensor([3, 0, 1, 0], dtype=torch.int32)
    before = tquant.MOE_LAUNCHES
    got = tquant.grouped_w8a16(x, qw["q"], qw["s"], active)
    assert tquant.MOE_LAUNCHES == before     # a CPU tensor: the plain version
    for e in range(4):
        if active[e] == 0:
            assert torch.equal(got[e], torch.zeros_like(got[e]))
        else:
            want = x[e] @ tquant.wmat({"q": qw["q"][e], "s": qw["s"][e]},
                                      torch.float32)
            torch.testing.assert_close(got[e], want, rtol=0, atol=0)
    # grouped_linear: a quantized weight takes the grouped product, a plain
    # one a batched matmul
    torch.testing.assert_close(tquant.grouped_linear(x, qw, active), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(tquant.grouped_linear(x, _t(w), active),
                               torch.matmul(x, _t(w)), rtol=0, atol=0)


def test_active_counts_kept_pairs_after_the_mask(layer0):
    """active[e] is the pairs kept for expert e after `valid`: padding rows
    (however they would route) activate nothing, and the plain grouped
    product gives those experts exact zeros."""
    x = _x(12, b=4, t=1)                  # a decode step: 4 slots
    valid = np.array([[True], [False], [False], [False]])
    r = tmoe.route(_t(x), _t(layer0["router"]), 4, 2, 2.0, _t(valid))
    assert r["cap"] == 1
    chosen = set(r["idx"][0].tolist())
    assert int(r["active"].sum()) == 2 and len(chosen) == 2
    assert [int(a) for a in r["active"]] == [int(e in chosen)
                                             for e in range(4)]
    r_all = tmoe.route(_t(x), _t(layer0["router"]), 4, 2, 2.0)
    assert int(r_all["active"].sum()) == 8 and float(r_all["dropped"]) == 0
    # the whole layer with int8 experts: inactive experts' rows are zeros
    qlp = _to_torch(layer0)
    for k in EXPERT_KEYS:
        qlp[k] = tquant.quantize_int8(qlp[k])
    xin, _ = tmoe.dispatch(_t(x), r, 4, 2)
    y = tquant.grouped_linear(xin, qlp["w_gate"], r["active"])
    for e in range(4):
        if e not in chosen:
            assert torch.equal(y[e], torch.zeros_like(y[e]))


# -- parameters -----------------------------------------------------------------

def test_init_params_int8_equals_quantized_init():
    plain = tllama.init_params(TCFG, "cpu", seed=5)
    assert tuple(plain["layers"]["w_gate"].shape) == (2, 4, 128, 256)
    assert tuple(plain["layers"]["router"].shape) == (2, 128, 4)
    want = tquant.quantize_params(plain)
    got = tllama.init_params(dataclasses.replace(TCFG, quant="int8"), "cpu",
                             seed=5)
    for k in EXPERT_KEYS + ("wq", "wo"):
        for part in ("q", "s"):
            torch.testing.assert_close(got["layers"][k][part],
                                       want["layers"][k][part], rtol=0,
                                       atol=0)
    assert tuple(got["layers"]["w_gate"]["s"].shape) == (2, 4, 1, 256)
    assert tuple(got["layers"]["w_down"]["s"].shape) == (2, 4, 1, 128)
    assert not tquant.is_quantized(got["layers"]["router"])
    torch.testing.assert_close(got["layers"]["router"],
                               plain["layers"]["router"], rtol=0, atol=0)


def test_quantized_expert_stacks_match_jax():
    """Scales [L, E, 1, F] as the JAX package's (tests/test_quant.py:
    110-125), bit-identical."""
    params = jax.device_get(jllama.init_params(jax.random.PRNGKey(2), JCFG))
    jq = jquant.quantize_params(params, JCFG)
    w = params["layers"]["w_up"]
    got = tquant.quantize_int8(_t(w))
    want = jq["layers"]["w_up"]
    assert tuple(got["s"].shape) == tuple(np.shape(want["s"])) \
        == (2, 4, 1, 256)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def test_params_from_jax_carries_the_router_and_refuses_mismatch():
    params = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), JCFG))
    tp = tllama.params_from_jax(params, TCFG)
    np.testing.assert_array_equal(tp["layers"]["router"].numpy(),
                                  np.asarray(params["layers"]["router"]))
    assert tp["layers"]["router"].dtype == torch.float32
    bf = tllama.params_from_jax(params, dataclasses.replace(
        TCFG, dtype="bfloat16"))
    assert bf["layers"]["router"].dtype == torch.bfloat16
    dense_cfg = dataclasses.replace(TCFG, num_experts=0)
    with pytest.raises(ValueError, match="router"):
        tllama.params_from_jax(params, dense_cfg)
    with pytest.raises(ValueError, match="experts"):
        tllama.params_from_jax(params, dataclasses.replace(
            TCFG, num_experts=8))
    dense = jax.device_get(jllama.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(JCFG, num_experts=0)))
    with pytest.raises(ValueError, match="missing"):
        tllama.params_from_jax(dense, TCFG)


# -- engines --------------------------------------------------------------------

def _drive(eng, request_cls, params_cls, reqs):
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


class Pair:
    """A JAX engine and a port engine on the same weights, driven with the
    same requests in the same order."""

    def __init__(self, jcfg, tcfg, **kw):
        cfg = dict(ENGINE_KW, **kw)
        self.j = JNativeEngine(jcfg, JEngineConfig(**cfg), eos_token_ids=EOS,
                               seed=0)
        self.t = TNativeEngine(
            tcfg, TEngineConfig(**cfg), eos_token_ids=EOS, device="cpu",
            params=tllama.params_from_jax(jax.device_get(self.j.params),
                                          tcfg))

    def counts(self):
        return {n: (e.moe_routed_tokens, e.moe_dropped_tokens)
                for n, e in (("jax", self.j), ("port", self.t))}

    def identical(self, reqs):
        before = self.counts()
        want = _drive(self.j, JRequest, JSamplingParams, reqs)
        got = _drive(self.t, TRequest, TSamplingParams, reqs)
        assert got == want
        assert sum(len(t) for t in got.values()) > len(reqs)
        after = self.counts()
        d = {n: (after[n][0] - before[n][0], after[n][1] - before[n][1])
             for n in after}
        assert d["port"] == d["jax"] and d["port"][0] > 0
        return got, d["port"]


def _reqs(sampled: bool, seed: int = 9, lens=(9, 40, 17, 70)):
    rng = np.random.default_rng(seed)
    return [(f"m{seed}-{i}", rng.integers(3, 250, n).tolist(),
             dict(max_tokens=9, temperature=0.8 if sampled else 0.0,
                  top_k=20, seed=60 + i))
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def f32_pair():
    return Pair(JCFG, TCFG)


@pytest.fixture(scope="module")
def int8_pair():
    return Pair(dataclasses.replace(JCFG, quant="int8"),
                dataclasses.replace(TCFG, quant="int8"))


def test_f32_greedy_identical(f32_pair):
    f32_pair.identical(_reqs(False))
    assert f32_pair.t.metrics().mixed_steps > 0


def test_f32_seeded_sampled_identical(f32_pair):
    f32_pair.identical(_reqs(True, seed=10))


def test_int8_weights_greedy_identical(int8_pair):
    assert tquant.is_quantized(int8_pair.t.params["layers"]["w_gate"])
    assert tuple(int8_pair.t.params["layers"]["w_gate"]["s"].shape) \
        == (2, 4, 1, 256)
    int8_pair.identical(_reqs(False, seed=11))


def test_int8_weights_seeded_sampled_identical(int8_pair):
    int8_pair.identical(_reqs(True, seed=12))


def test_int8_kv_pages_greedy_identical():
    pair = Pair(dataclasses.replace(JCFG, kv_quant="int8"),
                dataclasses.replace(TCFG, kv_quant="int8"), decode_steps=1)
    assert pair.t.cache["k"].dtype == torch.int8
    pair.identical(_reqs(False, seed=13, lens=(9, 40)))


def test_dense_moe_impl_greedy_identical():
    pair = Pair(dataclasses.replace(JCFG, moe_impl="dense"),
                dataclasses.replace(TCFG, moe_impl="dense"))
    reqs = _reqs(False, seed=14, lens=(9, 40))
    want = _drive(pair.j, JRequest, JSamplingParams, reqs)
    assert _drive(pair.t, TRequest, TSamplingParams, reqs) == want
    # the dense oracle has no dispatch: neither engine counts
    counts = pair.counts()
    assert counts["port"] == counts["jax"] == (0.0, 0.0)


def test_counts_over_buckets_and_a_shared_prefix(f32_pair):
    """A prompt longer than one bucket (chunked over 3 prefill steps) and a
    second request sharing its first 48 tokens (6 pages: prefix hits, so
    only its tail is prefilled and routed)."""
    rng = np.random.default_rng(15)
    long = rng.integers(3, 250, 75).tolist()
    other = long[:48] + rng.integers(3, 250, 20).tolist()
    greedy = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
    _, (routed, dropped) = f32_pair.identical(
        [("long", long, greedy)])
    hits0 = f32_pair.t.metrics().gpu_prefix_cache_hits
    _, (routed2, _) = f32_pair.identical([("share", other, greedy)])
    hits = f32_pair.t.metrics().gpu_prefix_cache_hits - hits0
    assert hits == 6
    # 2 choices x 2 layers a routed token: the 75-token prompt and 5-6
    # decode rows (the last token's row is written when a window feeds
    # it); the second prompt's 48 cached tokens are not recomputed
    assert 4 * (75 + 5) <= routed <= 4 * (75 + 6) and dropped == 0
    assert 4 * (68 - 48 + 5) <= routed2 <= 4 * (68 - 48 + 6)


def test_slot_dying_mid_window_counts_as_jax(f32_pair):
    """Slots that end mid-window on a hidden stop id stop routing from the
    next step on (the window's `writable` mask): the routed counts equal
    the JAX engine's."""
    base = _reqs(False, seed=16, lens=(12, 20, 30))
    first = _drive(TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW),
                                 device="cpu", params=f32_pair.t.params),
                   TRequest, TSamplingParams,
                   [(rid, p, dict(kw, max_tokens=16, ignore_eos=True))
                    for rid, p, kw in base])
    reqs = []
    for rid, p, kw in base:
        toks = first[rid]
        # the third generated token stops the stream: mid-window
        reqs.append((rid + "-stop", p, dict(kw, max_tokens=16,
                                            stop_token_ids=[toks[2]])))
    got, _ = f32_pair.identical(reqs)
    assert all(len(t) < 16 for t in got.values())


def test_mixed_step_counts_as_jax(f32_pair):
    """A request decoding while another one's prompt prefills: decode rows
    and a prefill chunk share mixed steps, routed counts equal JAX's."""
    m0 = f32_pair.t.metrics().mixed_steps
    reqs = _reqs(False, seed=17, lens=(10, 60, 90))
    f32_pair.identical(reqs)
    assert f32_pair.t.metrics().mixed_steps > m0


def test_only_committed_programs_count(f32_pair):
    """A window program run without a commit (as a graph's warm-up runs
    it, on copies of the staged inputs) leaves the counters unchanged;
    the committed window adds its outputs' counts."""
    eng = f32_pair.t
    eng.add_request(TRequest("warm", list(range(20, 41)),
                             TSamplingParams(max_tokens=12, temperature=0.0,
                                             ignore_eos=True)))
    while eng.scheduler.waiting:
        eng.step()
    plan = eng.scheduler.schedule()
    samp = eng._sampling_arrays(plan.seqs)
    staged = eng._stage_window(plan, samp, None, False, True)
    before = (eng.moe_routed_tokens, eng.moe_dropped_tokens)
    idle = {k: v.clone() for k, v in staged["bufs"].items()}
    outs = eng._window_program(staged)(idle)
    assert float(outs[4][1]) > 0          # the program did route
    assert (eng.moe_routed_tokens, eng.moe_dropped_tokens) == before
    outs = eng._dispatch_staged(staged)
    eng._fetch_and_commit(plan, eng._copy_outs_async(outs))
    assert eng.moe_routed_tokens == before[0] + float(outs[4][1])
    while eng.has_work():
        eng.step()


def test_run_serves_tiny_moe_on_cpu(monkeypatch, capsys):
    """`run.py in=text out=native tiny-moe --device cpu` answers one
    prompt; the card names the registry's MoE geometry."""
    import builtins

    from dynamo_tpu_torch.run import amain, build_card
    cfg = build_card("tiny-moe").model_config()
    assert cfg.is_moe and cfg.num_experts == 4
    assert build_card("mixtral-8x7b").model_config().num_experts == 8
    lines = iter(["hello experts", ""])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(lines))
    asyncio.run(amain(["in=text", "out=native", "tiny-moe", "--device",
                       "cpu", "--max-tokens", "5"]))
    out = capsys.readouterr().out
    assert "model=tiny-moe" in out
    assert len(out.strip().splitlines()) >= 2
