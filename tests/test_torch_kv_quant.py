"""The port's int8 KV pages (dynamo_tpu_torch, kv_quant="int8") against the
JAX package's, on the same numpy-seeded inputs.

- The codec (ops/kv_quant.py) is BIT-identical: the per-row max runs in f32
  and both round half to even.
- The quantized write and the gather path's dequantize, the ragged decode
  kernel's int8 mode (its plain version here; the CUDA kernel is held
  against that on the card by chip_smoke.py) against the Pallas kernel in
  interpret mode, the model's forward and decode step, and the engine's
  token streams.
- The port's parity gate (dynamo_tpu_torch/bench.run_kv_quant_parity)
  against the JAX package's on the same weights.

Tolerances: the f32 flash state (acc, m, l) and model logits as in the
other port tests (1e-5 and 1e-4: f32 on both sides, sums in other orders;
the int8 acc sums up to ~32 rows of values up to 127 * 0.05, so its
tolerance is relative). Token streams are identical. The JAX engines run
their gather decode (decode_kernel="off") with decode_steps=1: that window
keeps the rows it writes in full precision until the window's end and only
then quantizes them, while its kernel window (which the port's decode
window mirrors) quantizes every step; at one step per window the two are
the same function. One two-step window is held against the JAX kernel
window (its Pallas kernel in interpret mode), which quantizes every step
as the port does. Seeded sampling on int8 is compared in alternating
steps only: the JAX package's own mixed-vs-alternating seeded int8 test
fails (ROADMAP.md §C).
"""
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
from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops import kv_quant as jkq
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops import kv_quant as tkq
from dynamo_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

TOL_F32 = 1e-5
TOL_LOGITS = 1e-4
JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off",
                    kv_quant="int8")
TCFG = TModelConfig(dtype="float32", max_model_len=512, kv_quant="int8")
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512, decode_steps=1)
EOS = {2}


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the codec ----------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_quantize_rows_bit_identical(bf16):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 64)) * 3).astype(np.float32)
    x[1, 2] = 0.0                                   # an all-zero row
    x[2, 5, :] = 0.5                                # ties at the max
    jx, tx = jnp.asarray(x), _t(x)
    if bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = jkq.quantize_rows(jx)
    tq, ts = tkq.quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the zero row quantizes to 0 with the floor scale, and comes back 0
    assert not tq[1, 2].any() and float(ts[1, 2]) == np.float32(1e-12)
    back = tkq.dequantize_rows(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jkq.dequantize_rows(jq, js, jnp.float32)))
    assert not back[1, 2].any()


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_dequant_matches(bf16):
    rng = np.random.default_rng(2)
    cache = rng.integers(-127, 128, (2, 6, 4, 32), dtype=np.int8)
    scale = rng.uniform(0.01, 0.05, (2, 6, 4)).astype(np.float32)
    pt = np.array([[3, 1], [0, 5]], np.int32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    want = jkq.gather_dequant(jnp.asarray(cache), jnp.asarray(scale),
                              jnp.asarray(pt), jdt)
    got = tkq.gather_dequant(_t(cache), _t(scale), _t(pt), tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_page_bytes_modes_and_keys():
    for args in [(32, 8, 64, 128, 2), (16, 8, 64, 64, 2), (2, 2, 8, 32, 4)]:
        for quant in (False, True):
            assert tkq.page_bytes(*args, quant) == jkq.page_bytes(*args,
                                                                  quant)
    assert tkq.cache_keys(True) == jkq.cache_keys(True)
    assert tkq.cache_keys(False) == jkq.cache_keys(False)
    assert tkq.validate_mode("int8") == "int8"
    for bad in ("int4", "fp8"):
        with pytest.raises(ValueError):
            tkq.validate_mode(bad)
    with pytest.raises(ValueError):
        TNativeEngine(TModelConfig(dtype="float32"),
                      TEngineConfig(kv_quant="fp8"), device="cpu")


# -- the gather path ----------------------------------------------------------

def test_write_kv_pages_quant_matches():
    """Quantized scatter: the same int8 bytes and scales at the same slots;
    dropped rows (index < 0) land in the scratch page, values and scales
    alike, and nowhere else."""
    rng = np.random.default_rng(3)
    hkv, p, ps, hd = 2, 5, 4, 32
    k_new = rng.standard_normal((2, 3, hkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((2, 3, hkv, hd)).astype(np.float32)
    widx = np.array([[1, 6, -1], [13, -1, 2]], np.int32)
    jk = jnp.zeros((hkv, p, ps, hd), jnp.int8)
    js = jnp.zeros((hkv, p, ps), jnp.float32)
    want = jattn.write_kv_pages_quant(jk, jk, js, js, jnp.asarray(k_new),
                                      jnp.asarray(v_new), jnp.asarray(widx))
    tk, tv = (torch.zeros((hkv, p + 1, ps, hd), dtype=torch.int8)
              for _ in range(2))
    tks, tvs = (torch.zeros((hkv, p + 1, ps)) for _ in range(2))
    tattn.write_kv_pages_quant(tk, tv, tks, tvs, _t(k_new), _t(v_new),
                               _t(widx))
    for got, w in zip((tk, tv, tks, tvs), want):
        np.testing.assert_array_equal(got[:, :p].numpy(), np.asarray(w))
    # the two dropped rows: scratch-page slots 2 and 4 % ps = 0
    for t in (tk, tv):
        assert t[:, p, [0, 2]].any() and not t[:, p, [1, 3]].any()
    for t in (tks, tvs):
        assert (t[:, p, [0, 2]] > 0).all() and not t[:, p, [1, 3]].any()


@pytest.mark.parametrize("bf16", [False, True])
def test_paged_attention_with_scales_matches(bf16):
    """Prefill/mixed attention over an int8 cache: dequantized to q's
    dtype right after the gather, then the same masked softmax."""
    rng = np.random.default_rng(4)
    b, tq, h, hkv, p, ps, hd = 2, 5, 4, 2, 8, 4, 32
    q = rng.standard_normal((b, tq, h, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (hkv, p, ps, hd), dtype=np.int8)
    vc = rng.integers(-127, 128, (hkv, p, ps, hd), dtype=np.int8)
    ks = rng.uniform(0.01, 0.05, (hkv, p, ps)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (hkv, p, ps)).astype(np.float32)
    pt = np.array([[1, 4, 6], [2, 0, 7]], np.int32)
    kv_lens = np.array([11, 7], np.int32)
    pos = np.array([[6, 7, 8, 9, 10], [2, 3, 4, 5, 6]], np.int32)
    jq, tq_ = jnp.asarray(q), _t(q)
    if bf16:
        jq, tq_ = jq.astype(jnp.bfloat16), tq_.to(torch.bfloat16)
    want = jattn.paged_attention(
        jq, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pt),
        jnp.asarray(kv_lens), jnp.asarray(pos), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = tattn.paged_attention(tq_, _t(kc), _t(vc), _t(pt), _t(kv_lens),
                                _t(pos), _t(ks), _t(vs))
    tol = 1e-2 if bf16 else TOL_F32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# -- the ragged kernel's int8 mode ---------------------------------------------

def _int8_geometry(hd, seed, stale_scale=0.03):
    """Ragged rows over a shared page pool with an empty row, int8 pages
    and per-row scales; every slot at or past a row's length holds garbage
    values and `stale_scale`."""
    rng = np.random.default_rng(seed)
    s, h, hkv, p, ps, pb, nl = 4, 8, 4, 20, 8, 4, 2
    if hd == 128:
        h, hkv = 4, 2  # keep interpret-mode runtime down at the wide head
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (nl, hkv, p, ps, hd), dtype=np.int8)
    v = rng.integers(-127, 128, (nl, hkv, p, ps, hd), dtype=np.int8)
    ks = rng.uniform(0.01, 0.05, (nl, hkv, p, ps)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (nl, hkv, p, ps)).astype(np.float32)
    k_new = rng.standard_normal((s, hkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((s, hkv, hd)).astype(np.float32)
    pt = (np.arange(s * pb).reshape(s, pb) + 1).astype(np.int32)
    lens = np.array([5, 0, 17, 32], np.int32)
    for i in range(s):
        for t in range(lens[i], pb * ps):
            ks[:, :, pt[i, t // ps], t % ps] = stale_scale
            vs[:, :, pt[i, t // ps], t % ps] = stale_scale
    return q, k, v, ks, vs, k_new, v_new, pt, lens


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32,
                               atol=TOL_F32 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_int8_prefix_mode_matches_pallas(hd):
    q, k, v, ks, vs, k_new, v_new, pt, lens = _int8_geometry(hd, seed=hd)
    layer = 1
    jacc, jm, jl = jpa.decode_paged_attention_prefix(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([layer], jnp.int32), jnp.asarray(pt), jnp.asarray(lens),
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tacc, tm, tl = tpa.decode_paged_attention_prefix(
        _t(q), _t(k), _t(v), layer, _t(pt), _t(lens), _t(ks), _t(vs))
    for got, want in ((tacc, jacc), (tm, jm), (tl, jl)):
        _close(got, want)
    # the empty row walks one masked page, as the TPU kernel's
    assert bool((tm[1] == tpa.NEG_INF).all())
    assert bool((tl[1] == k.shape[3]).all()) and not tacc[1].any()
    jout = jpa.combine_self_attention(jnp.asarray(q), jnp.asarray(k_new),
                                      jnp.asarray(v_new), jacc, jm, jl)
    tout = tpa.combine_self_attention(_t(q), _t(k_new), _t(v_new), tacc, tm,
                                      tl)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL_F32,
                               atol=TOL_F32)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_int8_inclusive_mode_matches_pallas(hd):
    q, k, v, ks, vs, _, _, pt, lens = _int8_geometry(hd, seed=50 + hd)
    want = jpa.decode_paged_attention(
        jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
        jnp.asarray(pt), jnp.asarray(lens), interpret=True,
        k_scale=jnp.asarray(ks[0]), v_scale=jnp.asarray(vs[0]))
    got = tpa.decode_paged_attention(_t(q), _t(k[0]), _t(v[0]), _t(pt),
                                     _t(lens), _t(ks[0]), _t(vs[0]))
    ok = lens > 0           # kv_len 0 rows are padding (output ignored)
    np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok],
                               rtol=TOL_F32, atol=TOL_F32)


def test_int8_stale_scales_are_selected_to_zero():
    """Scales past a row's length may be stale: NaN or inf there changes
    nothing (the TPU kernel would carry p = 0 times inf into its sum)."""
    args = _int8_geometry(64, seed=9)
    q, k, v, ks, vs, _, _, pt, lens = args
    clean = tpa.ragged_decode_attention(_t(q), _t(k), _t(v), 1, _t(pt),
                                        _t(lens), _t(ks), _t(vs))
    ks2, vs2 = ks.copy(), vs.copy()
    ks2[ks == 0.03] = np.nan
    vs2[vs == 0.03] = np.inf
    dirty = tpa.ragged_decode_attention(_t(q), _t(k), _t(v), 1, _t(pt),
                                        _t(lens), _t(ks2), _t(vs2))
    for a, b in zip(clean, dirty):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["missing_v", "scale_shape", "scale_dtype",
                                 "scale_contiguous", "bf16_cache_scales",
                                 "int8_without_scales", "q_int8"])
def test_int8_kernel_argument_checks(bad):
    """The CUDA wrapper's checks on an int8 cache and its scales: mismatched
    shapes and dtypes raise before any launch."""
    s, h, hkv, hd = 2, 8, 2, 64
    q = torch.zeros((s, h, hd), dtype=torch.bfloat16)
    k = torch.zeros((2, hkv, 4, 8, hd), dtype=torch.int8)
    ks = torch.zeros((2, hkv, 4, 8))
    vs = torch.zeros((2, hkv, 4, 8))
    pt = torch.zeros((s, 2), dtype=torch.int32)
    lens = torch.zeros((s,), dtype=torch.int32)
    if bad == "missing_v":
        vs = None
    elif bad == "scale_shape":
        ks = torch.zeros((2, hkv, 4, 7))
    elif bad == "scale_dtype":
        ks = ks.half()
    elif bad == "scale_contiguous":
        ks = torch.zeros((2, hkv, 8, 4)).transpose(2, 3)
    elif bad == "bf16_cache_scales":
        k = k.to(torch.bfloat16)
    elif bad == "int8_without_scales":
        ks = vs = None
    elif bad == "q_int8":
        q = q.to(torch.int8)
    with pytest.raises((ValueError, TypeError)):
        tpa._check_kernel_args(q, k, k, 0, pt, lens, ks, vs)
    # the accepted forms: an f32 or a bf16 q over an int8 cache
    for qdt in (torch.float32, torch.bfloat16):
        tpa._check_kernel_args(
            torch.zeros((s, h, hd), dtype=qdt),
            torch.zeros((2, hkv, 4, 8, hd), dtype=torch.int8),
            torch.zeros((2, hkv, 4, 8, hd), dtype=torch.int8), 0, pt, lens,
            torch.zeros((2, hkv, 4, 8)), torch.zeros((2, hkv, 4, 8)))


# -- the model ----------------------------------------------------------------

P, PS = 16, 8


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tllama.params_from_jax(jax.device_get(jp), TCFG, "cpu")


def test_init_cache_layout():
    c = tllama.init_cache(TCFG, 5, 8, "cpu")
    assert set(c) == set(tkq.cache_keys(True))
    assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == torch.float32
    assert tuple(c["k"].shape) == (2, 2, 5, 8, 32)
    assert tuple(c["k_scale"].shape) == (2, 2, 5, 8)
    assert not any(t.any() for t in c.values())


def test_int8_forward_and_decode_match(params):
    """A prefill chunk, then the deferred-write decode step: logits, the
    int8 pages and scales the prefill wrote, and the decode step's new rows
    (the port's prefix kernel view with the whole scale stacks against the
    JAX Pallas kernel in interpret mode)."""
    jp, tp = params
    prompt = np.random.default_rng(5).integers(3, 250, 19).astype(np.int32)
    pages = [3, 8, 9]
    t = len(prompt)
    widx = np.array([[pages[i // PS] * PS + i % PS for i in range(t)]],
                    np.int32)
    meta = dict(positions=np.arange(t, dtype=np.int32)[None],
                page_table=np.array([pages], np.int32),
                kv_lens=np.array([t], np.int32), write_idx=widx)
    jcache = jllama.init_cache(JCFG, P, PS)
    tcache = tllama.init_cache(TCFG, P + 1, PS, "cpu")
    jlog, jcache = jllama.forward(
        jp, JCFG, jnp.asarray(prompt[None]), jcache,
        jllama.AttnMetadata(**{k: jnp.asarray(v) for k, v in meta.items()}))
    tlog, tcache = tllama.forward(
        tp, TCFG, _t(prompt[None]), tcache,
        tllama.AttnMetadata(**{k: _t(v) for k, v in meta.items()}))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tcache[key][:, :, :P].numpy(),
                                   np.asarray(jcache[key]), rtol=1e-5)
    for key in ("k", "v"):   # rounding may differ by one step at a tie
        diff = np.abs(tcache[key][:, :, :P].numpy().astype(np.int32)
                      - np.asarray(jcache[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    tok = np.array([int(tlog[0, -1].argmax()), 0], np.int32)
    pt = np.array([pages, [0, 0, 0]], np.int32)
    prefix = np.array([t, 0], np.int32)
    jcfg = dataclasses.replace(JCFG, decode_kernel="interpret")
    jl, jk, jv = jllama.decode_forward(
        jp, jcfg, jnp.asarray(tok), jcache, jnp.asarray(pt),
        jnp.asarray(prefix), jnp.asarray(prefix))
    tl, tk, tv = tllama.decode_forward(
        tp, TCFG, _t(tok), tcache, _t(pt), _t(prefix), _t(prefix))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL_LOGITS,
                               atol=TOL_LOGITS)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_F32, atol=TOL_F32)


# -- the engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def _drive(eng, request_cls, params_cls, reqs):
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


def _identical(jax_params, reqs, jcfg=JCFG, **kw):
    cfg = dict(ENGINE_KW, **kw)
    # the quantization mode rides the deployment knob on the port side
    jeng = JNativeEngine(jcfg, JEngineConfig(**cfg), eos_token_ids=EOS,
                         seed=0)
    teng = TNativeEngine(dataclasses.replace(TCFG, kv_quant=""),
                         TEngineConfig(kv_quant="int8", **cfg),
                         eos_token_ids=EOS, device="cpu",
                         params=tllama.params_from_jax(jax_params, TCFG))
    assert teng.kv_quant == "int8" and teng.cache["k"].dtype == torch.int8
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    got = _drive(teng, TRequest, TSamplingParams, reqs)
    assert got == want
    assert sum(len(t) for t in got.values()) > len(reqs)
    return teng


def _reqs(sampled: bool):
    rng = np.random.default_rng(6)
    return [(f"q{i}", rng.integers(3, 250, n).tolist(),
             dict(max_tokens=9, temperature=0.8 if sampled else 0.0,
                  top_k=20, seed=40 + i))
            for i, n in enumerate((9, 40, 17, 70))]


def test_int8_engine_greedy_alternating_identical(jax_params):
    teng = _identical(jax_params, _reqs(False), mixed_token_budget=0)
    assert teng.metrics().mixed_steps == 0


def test_int8_engine_greedy_mixed_identical(jax_params):
    teng = _identical(jax_params, _reqs(False))
    assert teng.metrics().mixed_steps > 0


def test_int8_engine_seeded_sampled_alternating_identical(jax_params):
    _identical(jax_params, _reqs(True), mixed_token_budget=0)


def test_int8_pallas_interpret_window_identical(jax_params):
    """A two-step decode window against the JAX engine's kernel window (its
    Pallas kernel in interpret mode), which quantizes every step's rows as
    the port's window does."""
    jcfg = dataclasses.replace(JCFG, decode_kernel="interpret")
    _identical(jax_params, [("k", range(30, 47), dict(max_tokens=5))],
               jcfg=jcfg, decode_steps=2)


def test_int8_engine_metrics(jax_params):
    teng = TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), device="cpu",
                         params=tllama.params_from_jax(jax_params, TCFG))
    jeng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    tm, jm = teng.metrics(), jeng.metrics()
    assert (tm.kv_page_bytes, tm.kv_quant_bits) == (jm.kv_page_bytes,
                                                    jm.kv_quant_bits)
    assert tm.kv_quant_bits == 8
    plain = TNativeEngine(dataclasses.replace(TCFG, kv_quant=""),
                          TEngineConfig(**ENGINE_KW), device="cpu")
    assert plain.metrics().kv_quant_bits == 0
    assert plain.metrics().kv_page_bytes > tm.kv_page_bytes


# -- the parity gate ----------------------------------------------------------

def test_parity_gate_matches_the_jax_gate(jax_params):
    """The port's run_kv_quant_parity passes and reaches the JAX gate's
    verdict on the same weights: same thresholds, same decision points, the
    same matches, drift within 1e-3."""
    import bench as jbench
    from dynamo_tpu_torch import bench as tbench
    assert (tbench.KVQ_MATCH_MIN, tbench.KVQ_DRIFT_RTOL,
            tbench.KVQ_DRIFT_ATOL) == (jbench.KVQ_MATCH_MIN,
                                       jbench.KVQ_DRIFT_RTOL,
                                       jbench.KVQ_DRIFT_ATOL)
    kw = dict(page_size=16, num_pages=64, max_slots=2, max_prefill_chunk=32,
              prefill_buckets=(8, 16, 32), max_model_len=512, decode_steps=4)
    base = dataclasses.replace(JCFG, kv_quant="")
    want = jbench.run_kv_quant_parity(base, engine_kwargs=kw, n_tokens=24,
                                      n_prompts=2, logf=lambda *a: None)
    got = tbench.run_kv_quant_parity(
        dataclasses.replace(TCFG, kv_quant=""), engine_kwargs=kw,
        n_tokens=24, n_prompts=2, logf=lambda *a: None, device="cpu",
        params=tllama.params_from_jax(jax_params, TCFG))
    assert got["pass"] and want["pass"]
    for key in ("greedy_match_rate", "raw_match_rate", "decisive_positions",
                "n_tokens", "per_prompt"):
        assert got[key] == want[key], key
    for key in ("max_logit_drift", "drift_bound"):
        assert abs(got[key] - want[key]) < 1e-3, key


def test_run_kv_quant_int8_on_cpu(tmp_path, capsys):
    """`python -m dynamo_tpu_torch.run in=batch:FILE out=native tiny
    --kv-quant int8 --device cpu`."""
    import asyncio
    import json
    from dynamo_tpu_torch.run import amain
    path = tmp_path / "prompts.jsonl"
    path.write_text(json.dumps({"prompt": "int8 pages"}) + "\n")
    asyncio.run(amain([f"in=batch:{path}", "out=native", "tiny",
                       "--device", "cpu", "--max-tokens", "5",
                       "--kv-quant", "int8"]))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["completion_tokens"] == 5


# -- the kernel's split-KV schedule, int8 ---------------------------------------

def _int8_split_geometry(hd, seed):
    """Seven rows of six disjoint int8 pages (ps 8), lens 0, 1, on the page
    and split boundaries of 1- and 3-page splits and one past them, and the
    full table; garbage int8 values in every slot at or past a row's length
    and a finite stale scale there."""
    rng = np.random.default_rng(seed)
    s, h, hkv, ps, pb, nl = 7, 8, 4, 8, 6, 2
    if hd == 128:
        h, hkv = 4, 2  # keep interpret-mode runtime down at the wide head
    p = s * pb + 1
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (nl, hkv, p, ps, hd), dtype=np.int8)
    v = rng.integers(-127, 128, (nl, hkv, p, ps, hd), dtype=np.int8)
    ks = rng.uniform(0.01, 0.05, (nl, hkv, p, ps)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (nl, hkv, p, ps)).astype(np.float32)
    pt = (rng.permutation(s * pb) + 1).reshape(s, pb).astype(np.int32)
    lens = np.array([0, 1, 8, 9, 24, 25, 48], np.int32)
    stale = np.zeros(ks.shape, bool)
    for i in range(s):
        for t in range(lens[i], pb * ps):
            stale[:, :, pt[i, t // ps], t % ps] = True
    ks[stale] = 0.03
    vs[stale] = 0.03
    return q, k, v, ks, vs, pt, lens, stale


@pytest.mark.parametrize("pps", [1, 3])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bf16_q", [False, True])
def test_int8_split_merge_matches(hd, bf16_q, pps):
    """The int8 split rules merged back equal the unsplit plain version with
    NaN / inf stale scales, and (f32 q) the Pallas kernel in interpret mode
    with finite ones; the empty row keeps m = -1e30, l = ps, acc = 0."""
    q, k, v, ks, vs, pt, lens, stale = _int8_split_geometry(
        hd, seed=300 + hd + pps)
    layer, ps = 1, k.shape[3]
    tq = _t(q).to(torch.bfloat16) if bf16_q else _t(q)
    ks_bad, vs_bad = ks.copy(), vs.copy()
    ks_bad[stale] = np.nan
    vs_bad[stale] = np.inf
    args = (tq, _t(k), _t(v), layer, _t(pt), _t(lens))
    got = tpa._merge_splits_plain(*tpa._ragged_split_plain(
        *args, pps, _t(ks_bad), _t(vs_bad)))
    unsplit = tpa._ragged_plain(*args, _t(ks_bad), _t(vs_bad))
    for a, b in zip(got, unsplit):
        assert torch.isfinite(a).all()
        _close(a, b.numpy())
    assert bool((got[1][0] == tpa.NEG_INF).all())
    assert bool((got[2][0] == ps).all()) and not got[0][0].any()
    if not bf16_q:
        want = jpa.decode_paged_attention_prefix(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray([layer], jnp.int32), jnp.asarray(pt),
            jnp.asarray(lens), interpret=True, k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs))
        for a, b in zip(got, want):
            _close(a, b)
