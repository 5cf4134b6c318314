"""The port's sampler (dynamo_tpu_torch/engine/sampler.py) against the JAX
package's (dynamo_tpu/engine/sampler.py) on the same numpy-seeded logits.

The PRNG is held bit for bit: `make_keys` and the uniform bits under
`jax.random.categorical` are integer and bit operations, so any difference
is a fault. Sampled tokens are held token for token: the Gumbel noise goes
through `log` on both sides (XLA's and torch's CPU `log` may differ in the
last bit), which could only flip a draw at an exact near-tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampler as jsamp
from dynamo_tpu_torch.engine import sampler as tsamp

torch.set_num_threads(1)

B, V = 8, 256


def _logits(seed: int, b: int = B, v: int = V) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, v)) * 3.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seeds", [
    [0, 1, 2, 7, 1234, 99991, 2**31 - 1, 123456789],
    list(range(1000, 1008)),
])
def test_make_keys_bit_identical(seeds):
    seeds = np.asarray(seeds, np.int32)
    for counter in (0, 1, 5, 63, 4096, 2**31 - 1):
        counters = np.full(seeds.shape, counter, np.int32)
        want = np.asarray(jax.random.key_data(
            jsamp.make_keys(jnp.asarray(seeds), jnp.asarray(counters))))
        got = tsamp.make_keys(_t(seeds), _t(counters)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_uniform_bits_bit_identical():
    keys = jsamp.make_keys(jnp.arange(4, dtype=jnp.int32),
                           jnp.arange(4, dtype=jnp.int32) * 3)
    tiny = float(np.finfo(np.float32).tiny)
    want = np.stack([np.asarray(jax.random.uniform(
        k, (V,), jnp.float32, minval=tiny, maxval=1.0)) for k in keys])
    got = tsamp._uniform01(_t(np.asarray(jax.random.key_data(keys),
                                         np.int64)), V).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_categorical_token_identical():
    logits = _logits(3)
    keys = jsamp.make_keys(jnp.arange(B, dtype=jnp.int32) * 11,
                           jnp.arange(B, dtype=jnp.int32))
    want = np.asarray(jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(logits)))
    got = tsamp.categorical(
        _t(np.asarray(jax.random.key_data(keys), np.int64)),
        _t(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def _params(seed: int):
    rng = np.random.default_rng(seed)
    temp = rng.uniform(0.3, 1.5, B).astype(np.float32)
    temp[0] = 0.0                                     # one greedy row
    top_k = rng.integers(0, 40, B).astype(np.int32)
    top_p = rng.uniform(0.5, 1.0, B).astype(np.float32)
    top_p[1] = 1.0
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    counters = rng.integers(0, 50, B).astype(np.int32)
    return temp, top_k, top_p, seeds, counters


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_token_identical(seed):
    logits = _logits(seed)
    temp, top_k, top_p, seeds, counters = _params(seed)
    jkeys = jsamp.make_keys(jnp.asarray(seeds), jnp.asarray(counters))
    want = np.asarray(jsamp.sample(jnp.asarray(logits), jnp.asarray(temp),
                                   jnp.asarray(top_k), jnp.asarray(top_p),
                                   jkeys))
    got = tsamp.sample(_t(logits), _t(temp), _t(top_k), _t(top_p),
                       tsamp.make_keys(_t(seeds), _t(counters))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_fused_token_identical(seed):
    logits = _logits(10 + seed)
    temp, top_k, _, seeds, counters = _params(10 + seed)
    jkeys = jsamp.make_keys(jnp.asarray(seeds), jnp.asarray(counters))
    want = np.asarray(jsamp.sample_fused(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k), jkeys))
    got = tsamp.sample_fused(_t(logits), _t(temp), _t(top_k),
                             tsamp.make_keys(_t(seeds), _t(counters)))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the fused tail draws what the full tail draws at top_p = 1
    full = tsamp.sample(_t(logits), _t(temp), _t(top_k),
                        torch.ones(B), tsamp.make_keys(_t(seeds),
                                                       _t(counters)))
    np.testing.assert_array_equal(got.numpy(), full.numpy())


@pytest.mark.parametrize("mode", ["greedy", "fused", "full", "penalty",
                                  "min_tokens", "logprobs"])
def test_sample_logits_token_identical(mode):
    """The shared step tail: greedy, top-k, top-p, repetition penalty, the
    min-tokens eos ban and logprobs (logprobs within 1e-5: log_softmax
    sums in another order)."""
    logits = _logits(20)
    temp, top_k, top_p, seeds, counters = _params(20)
    min_toks = np.zeros(B, np.int32)
    eos = (2,)
    kw_j, kw_t = {}, {}
    if mode == "greedy":
        temp = np.zeros(B, np.float32)
        kw_j = kw_t = dict(greedy=True)
    elif mode == "fused":
        top_p = np.ones(B, np.float32)
        kw_j = kw_t = dict(fused=True)
    elif mode == "penalty":
        hist = np.random.default_rng(5).integers(0, V + 1, (B, 16)).astype(
            np.int32)                                  # V = padding
        pen = np.linspace(1.0, 2.0, B).astype(np.float32)
        kw_j = dict(seen=jsamp.seen_token_mask(jnp.asarray(hist), V),
                    rep_penalty=jnp.asarray(pen))
        kw_t = dict(seen=tsamp.seen_token_mask(_t(hist), V),
                    rep_penalty=_t(pen))
        np.testing.assert_array_equal(np.asarray(kw_j["seen"]),
                                      kw_t["seen"].numpy())
    elif mode == "min_tokens":
        logits[:, 2] = 50.0                            # eos would win
        min_toks = np.full(B, 100, np.int32)
    elif mode == "logprobs":
        kw_j = kw_t = dict(with_lp=True)
    jout = jsamp.sample_logits(
        jnp.asarray(logits), eos, jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(seeds), jnp.asarray(counters),
        jnp.asarray(min_toks), **kw_j)
    tout = tsamp.sample_logits(
        _t(logits), eos, _t(temp), _t(top_k), _t(top_p), _t(seeds),
        _t(counters), _t(min_toks), **kw_t)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    if mode == "min_tokens":
        assert not (tout[0].numpy() == 2).any()
    if mode == "logprobs":
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert tout[1] is None and jout[1] is None


def test_repetition_penalty_matches():
    logits = _logits(30)
    seen = np.random.default_rng(1).random((B, V)) < 0.2
    pen = np.linspace(0.5, 2.0, B).astype(np.float32)
    want = np.asarray(jsamp.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(pen)))
    got = tsamp.apply_repetition_penalty(_t(logits), _t(seen), _t(pen))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


class _Seq:
    def __init__(self, rid, prompt, output, epoch=1):
        self.request_id, self.prompt, self.output = rid, prompt, output
        self.epoch = epoch

    @property
    def total_len(self):
        return len(self.prompt) + len(self.output)


def test_host_staging_caches_match():
    """SamplingArrayCache / RepPenaltyCache are host code copied verbatim:
    same arrays for the same slot set, including the incremental update."""
    from dynamo_tpu.engine.scheduler import SamplingParams as JSP
    from dynamo_tpu_torch.engine.scheduler import SamplingParams as TSP
    reqs = [_Seq("a", [5, 6, 7], [9]), None, _Seq("b", [1, 2], [])]
    kw = {"a": dict(temperature=0.7, top_k=5, seed=3, min_tokens=2,
                    repetition_penalty=1.2),
          "b": dict(top_p=0.9, seed=2**40 + 5)}
    jc, tc = jsamp.SamplingArrayCache(), tsamp.SamplingArrayCache()
    jr, tr = jsamp.RepPenaltyCache(), tsamp.RepPenaltyCache()
    for _ in range(2):
        for a, b in zip(jc.arrays(reqs, lambda r: JSP(**kw[r])),
                        tc.arrays(reqs, lambda r: TSP(**kw[r]))):
            np.testing.assert_array_equal(a, b)
        ja = jr.arrays(reqs, lambda r: JSP(**kw[r]), V, lambda n: 8)
        ta = tr.arrays(reqs, lambda r: TSP(**kw[r]), V, lambda n: 8)
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(a, b)
        reqs[0].output.append(11)
    assert jc.all_greedy == tc.all_greedy is False
    assert jc.fused_eligible == tc.fused_eligible is False
