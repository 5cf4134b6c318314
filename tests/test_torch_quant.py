"""The port's weight-only int8 (dynamo_tpu_torch/ops/quant.py,
ModelConfig.quant="int8") against the JAX package's, on the same
numpy-seeded inputs and bridged weights.

- `quantize_int8` is BIT-identical: the same q bytes and the same s bits
  (f32 max / 127 on both sides, round half to even).
- `wmat` is the same dequantize; `linear`'s plain version (the CPU route)
  equals the JAX `x @ wmat(w)` within 1e-6 in f32 (sums in another order).
- A quantized JAX tree crosses `params_from_jax` exactly.
- The int8-weight engine's streams are TOKEN-IDENTICAL to the JAX
  int8-weight engine's on `tiny` in f32: greedy and seeded-sampled, and
  greedy with int8 KV pages too (seeded sampling on int8 KV pages is the
  reference failure test_int8_seeded_sampled_identity, ROADMAP.md §C, so it
  is not used as ground truth).
- The kernel route's host rules (the split over K, rows a pass, the M at
  which linear picks the kernel) and its refusal to run a CUDA tensor
  anywhere but on the card. The CUDA kernel itself is held against the
  plain version on the card by chip_smoke.py.
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
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

JCFG = JModelConfig(dtype="float32", max_model_len=512, decode_kernel="off",
                    quant="int8")
TCFG = TModelConfig(dtype="float32", max_model_len=512, quant="int8")
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
EOS = {2}


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the scheme -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 96), (3, 48, 40), (2, 128, 1024)])
def test_quantize_int8_bit_identical(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0                      # an all-zero channel: s = 1e-12
    w[..., 7] *= 1e3
    want = jquant.quantize_int8(jnp.asarray(w))
    got = tquant.quantize_int8(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["s"].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy().view(np.int32),
                                  np.asarray(want["s"]).view(np.int32))


def test_quantize_int8_halfway_rounds_to_even():
    """w / s landing exactly on k + 0.5 rounds to the even neighbour on
    both sides (jnp.round and torch.round)."""
    w = np.array([[127.0], [2.5], [-3.5], [0.5], [-0.5]], np.float32)
    want = np.asarray(jquant.quantize_int8(jnp.asarray(w))["q"])
    got = tquant.quantize_int8(torch.from_numpy(w))["q"].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1:, 0], [2, -4, 0, 0])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wmat_matches(dt):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 64, 48)).astype(np.float32)
    jq = jquant.quantize_int8(jnp.asarray(w))
    tq = {"q": _t(jq["q"]), "s": _t(jq["s"])}
    want = np.asarray(jquant.wmat(jq, getattr(jnp, dt)).astype(jnp.float32))
    got = tquant.wmat(tq, getattr(torch, dt)).float().numpy()
    np.testing.assert_array_equal(got, want)
    plain = torch.randn(3, 4)
    assert tquant.wmat(plain, torch.bfloat16) is plain


@pytest.mark.parametrize("m", [1, 3, 8, 40])
def test_linear_plain_matches_jax(m):
    rng = np.random.default_rng(m)
    w = rng.standard_normal((96, 160)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, m, 96)).astype(np.float32)
    jq = jquant.quantize_int8(jnp.asarray(w))
    want = np.asarray(jnp.einsum("btd,df->btf", jnp.asarray(x),
                                 jquant.wmat(jq, jnp.float32)))
    before = tquant.KERNEL_LAUNCHES, tquant.DEQUANT_LAUNCHES
    got = tquant.linear(torch.from_numpy(x),
                        {"q": _t(jq["q"]), "s": _t(jq["s"])}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (tquant.KERNEL_LAUNCHES, tquant.DEQUANT_LAUNCHES) == before
    # a plain weight is one matmul
    pw = torch.from_numpy(w)
    torch.testing.assert_close(tquant.linear(torch.from_numpy(x), pw),
                               torch.from_numpy(x) @ pw, rtol=0, atol=0)


def test_quantize_params_keys_and_validation():
    cfg = TModelConfig(dtype="float32")
    params = tllama.init_params(cfg, "cpu", seed=0)
    qp = tquant.quantize_params(params)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert tquant.is_quantized(qp["layers"][k])
    assert tquant.is_quantized(qp["lm_head"])
    assert qp["layers"]["attn_norm"] is params["layers"]["attn_norm"]
    assert qp["embed"] is params["embed"]
    with pytest.raises(ValueError, match="quant mode"):
        tquant.validate_mode("int4")


def test_init_params_int8_equals_quantized_init():
    """init_params with quant="int8" draws the same weights as the
    unquantized init and quantizes them slice by slice: the same tree as
    quantize_params of the unquantized one."""
    cfg = TModelConfig(dtype="float32")
    plain = tllama.init_params(cfg, "cpu", seed=3)
    want = tquant.quantize_params(plain)
    got = tllama.init_params(dataclasses.replace(cfg, quant="int8"), "cpu",
                             seed=3)
    for k in ("wq", "w_down"):
        for part in ("q", "s"):
            torch.testing.assert_close(got["layers"][k][part],
                                       want["layers"][k][part], rtol=0,
                                       atol=0)
    torch.testing.assert_close(got["lm_head"]["q"], want["lm_head"]["q"],
                               rtol=0, atol=0)


# -- the bridge and the engine --------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def test_quantized_tree_crosses_exactly(jax_params):
    assert jquant.is_quantized(jax_params["layers"]["wq"])
    tp = tllama.params_from_jax(jax_params, TCFG)
    for k in tquant.QUANT_KEYS:
        for part, dt in (("q", torch.int8), ("s", torch.float32)):
            got = tp["layers"][k][part]
            assert got.dtype == dt
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax_params["layers"][k][part]))
    np.testing.assert_array_equal(tp["lm_head"]["q"].numpy(),
                                  np.asarray(jax_params["lm_head"]["q"]))
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  np.asarray(jax_params["embed"]))


def _drive(eng, request_cls, params_cls, reqs):
    for rid, prompt, kw in reqs:
        eng.add_request(request_cls(rid, list(prompt), params_cls(**kw)))
    out = {rid: [] for rid, _, _ in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


def _identical(jax_params, reqs, jcfg=JCFG, tcfg=TCFG, **kw):
    cfg = dict(ENGINE_KW, **kw)
    jeng = JNativeEngine(jcfg, JEngineConfig(**cfg), eos_token_ids=EOS,
                         seed=0)
    teng = TNativeEngine(tcfg, TEngineConfig(**cfg), eos_token_ids=EOS,
                         device="cpu",
                         params=tllama.params_from_jax(jax_params, tcfg))
    assert teng.quant == "int8"
    want = _drive(jeng, JRequest, JSamplingParams, reqs)
    got = _drive(teng, TRequest, TSamplingParams, reqs)
    assert got == want
    assert sum(len(t) for t in got.values()) > len(reqs)
    return teng


def _reqs(sampled: bool):
    rng = np.random.default_rng(9)
    return [(f"w{i}", rng.integers(3, 250, n).tolist(),
             dict(max_tokens=9, temperature=0.8 if sampled else 0.0,
                  top_k=20, seed=60 + i))
            for i, n in enumerate((9, 40, 17, 70))]


def test_int8_weight_engine_greedy_identical(jax_params):
    teng = _identical(jax_params, _reqs(False))
    assert teng.metrics().mixed_steps > 0


def test_int8_weight_engine_seeded_sampled_identical(jax_params):
    _identical(jax_params, _reqs(True))


def test_int8_weight_and_kv_engine_greedy_identical(jax_params):
    """int8 weights and int8 KV pages together, greedy (the JAX engine's
    gather decode at one step per window, as tests/test_torch_kv_quant.py
    explains)."""
    teng = _identical(
        jax_params, _reqs(False),
        jcfg=dataclasses.replace(JCFG, kv_quant="int8"),
        tcfg=dataclasses.replace(TCFG, kv_quant="int8"), decode_steps=1)
    assert teng.cache["k"].dtype == torch.int8


def test_engine_quantizes_an_unquantized_tree_and_reports_bytes():
    """An unquantized tree handed to an int8 engine is quantized where it
    lives; weight_bytes counts the tree's device bytes. The quantized
    projections take < 0.27x their f32 bytes (the JAX check,
    tests/test_quant.py:69-81); on `tiny` the whole tree takes ~0.33x,
    because the embedding stays f32."""
    ecfg = TEngineConfig(**ENGINE_KW)
    fcfg = dataclasses.replace(TCFG, quant="")
    params = tllama.init_params(fcfg, "cpu", seed=0)
    fp = TNativeEngine(fcfg, ecfg, params=params, device="cpu")
    q8 = TNativeEngine(TCFG, ecfg, params=params, device="cpu")
    assert tquant.is_quantized(q8.params["layers"]["wq"])
    assert not tquant.is_quantized(fp.params["layers"]["wq"])

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    mq, mf = q8.metrics(), fp.metrics()
    assert (mq.weight_quant_bits, mf.weight_quant_bits) == (8, 0)
    assert mq.weight_bytes == nbytes(q8.params)
    assert mf.weight_bytes == nbytes(params)
    assert mq.weight_bytes < 0.34 * mf.weight_bytes
    for k in tquant.QUANT_KEYS:
        assert nbytes(q8.params["layers"][k]) < \
            0.27 * nbytes(params["layers"][k])
    with pytest.raises(ValueError, match="quant mode"):
        TNativeEngine(dataclasses.replace(TCFG, quant="fp8"), ecfg,
                      device="cpu")


def test_run_quant_int8_on_cpu(tmp_path, capsys):
    import asyncio
    import json
    from dynamo_tpu_torch.run import amain
    path = tmp_path / "p.jsonl"
    path.write_text(json.dumps({"prompt": "int8 weights"}) + "\n")
    asyncio.run(amain([f"in=batch:{path}", "out=native", "tiny", "--device",
                       "cpu", "--max-tokens", "5", "--quant", "int8"]))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["completion_tokens"] == 5


# -- the kernel route's host rules ----------------------------------------------

@pytest.mark.parametrize("m,k,n", [
    (8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336), (8, 14336, 4096),
    (8, 4096, 128256), (1, 4096, 1024), (16, 4096, 4096), (512, 4096, 14336),
    (3, 1000, 333), (5, 64, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_config_covers_k(m, k, n, dtype):
    """Every split holds work and the splits cover K exactly once (the C
    entry point refuses a grid with an empty split); the tensor-core
    kernel's splits fit one cluster and hold at least 4 chunks each."""
    splits, per = tquant.gemm_config(m, k, n, 132, dtype)
    if dtype == torch.bfloat16:
        assert splits <= tquant._MMA_MAX_SPLITS
        chunk = tquant._MMA_CHUNK_K
        if splits > 1:
            assert per >= tquant._MMA_MIN_CHUNKS
    else:
        chunk = tquant._F32_CHUNK_K
    chunks = -(-k // chunk)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < chunks <= splits * per
    assert (splits - 1) * per * chunk < k
    if n >= 128256:
        assert splits == 1     # lm_head fills the card without a split


def test_rows_per_pass_and_route():
    assert [tquant.rows_per_pass(m) for m in (1, 2, 3, 4, 5, 8, 9, 512)] \
        == [1, 2, 4, 4, 8, 8, 8, 8]
    assert tquant.rows_per_pass(3, torch.bfloat16) == 8
    # the decode step's slots take the kernel; prefill buckets start at 16
    assert tquant.GEMV_MAX_M >= TEngineConfig().max_slots
    assert tquant.GEMV_MAX_M < min(TEngineConfig().prefill_buckets)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A CUDA x launches a kernel or raises; without a card it raises, and
    nothing is counted as launched."""
    rng = np.random.default_rng(0)
    w = tquant.quantize_int8(torch.from_numpy(
        rng.standard_normal((64, 32)).astype(np.float32)))
    before = tquant.KERNEL_LAUNCHES, tquant.DEQUANT_LAUNCHES
    for m in (2, 40):          # the kernel route and the dequantize route
        fake = torch.zeros((m, 64))
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(
            lambda t, f=fake: t is f))
        with pytest.raises((RuntimeError, AssertionError)):
            tquant.linear(fake, w)
    assert (tquant.KERNEL_LAUNCHES, tquant.DEQUANT_LAUNCHES) == before
    # a CPU x against a CUDA weight is refused too
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(
        lambda t: t is w["q"]))
    with pytest.raises(ValueError, match="CUDA"):
        tquant.linear(torch.zeros((2, 64)), w)


@pytest.mark.parametrize("bad", ["q_dtype", "s_len", "x_width", "x_dtype",
                                 "contiguous"])
def test_kernel_argument_checks(bad):
    x = torch.zeros((4, 64))
    q = torch.zeros((64, 32), dtype=torch.int8)
    s = torch.ones((1, 32))
    if bad == "q_dtype":
        q = q.float()
    elif bad == "s_len":
        s = torch.ones((1, 31))
    elif bad == "x_width":
        x = torch.zeros((4, 63))
    elif bad == "x_dtype":
        x = x.half()
    elif bad == "contiguous":
        x = torch.zeros((64, 4)).T
    with pytest.raises((ValueError, TypeError)):
        tquant._check_args(x, q, s)
    tquant._check_args(torch.zeros((4, 64)),
                       torch.zeros((64, 32), dtype=torch.int8),
                       torch.ones((1, 32)))
