"""The port's Llama model (dynamo_tpu_torch/models/llama.py) against the JAX
package's (dynamo_tpu/models/llama.py) on the `tiny` config in float32,
with the JAX weights carried over by `params_from_jax`.

Tolerances: logits within 1e-4 and written cache rows within 1e-5. Both
sides compute in f32; XLA and torch sum the projections in different
orders, and those differences pass through two layers before the lm head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

JCFG = JModelConfig(dtype="float32", max_model_len=512)
TCFG = TModelConfig(dtype="float32", max_model_len=512)
P, PS = 16, 8       # pages the JAX cache holds; the port's holds P + 1
TOL_LOGITS = 1e-4
TOL_CACHE = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tllama.params_from_jax(jax.device_get(jp), TCFG, "cpu")


def test_weight_bridge(params):
    jp, tp = params
    flat_j = {"embed": jp["embed"], "final_norm": jp["final_norm"],
              "lm_head": jp["lm_head"],
              **{f"layers.{k}": v for k, v in jp["layers"].items()}}
    flat_t = {"embed": tp["embed"], "final_norm": tp["final_norm"],
              "lm_head": tp["lm_head"],
              **{f"layers.{k}": v for k, v in tp["layers"].items()}}
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        assert tuple(flat_t[k].shape) == flat_j[k].shape, k
        assert flat_t[k].dtype == torch.float32
        np.testing.assert_array_equal(flat_t[k].numpy(),
                                      np.asarray(flat_j[k]))


def test_init_params_shapes_and_dtype():
    """Random init on the target device in the model dtype, in the JAX
    layout; norms start at one."""
    cfg = dataclasses.replace(TCFG, dtype="bfloat16")
    tp = tllama.init_params(cfg, "cpu", seed=3)
    jshapes = jax.eval_shape(lambda k: jllama.init_params(k, JCFG),
                             jax.random.PRNGKey(0))
    assert tp["embed"].shape == jshapes["embed"].shape
    for k, v in tp["layers"].items():
        assert tuple(v.shape) == jshapes["layers"][k].shape, k
        assert v.dtype == torch.bfloat16
    assert bool((tp["layers"]["attn_norm"] == 1).all())
    again = tllama.init_params(cfg, "cpu", seed=3)
    assert torch.equal(tp["layers"]["wq"], again["layers"]["wq"])


def _meta(rows, tb, pb):
    """Scheduler-style plan arrays for rows of (tokens, start, pages):
    padding columns repeat the last position and write nothing."""
    b = len(rows)
    tokens = np.zeros((b, tb), np.int32)
    positions = np.zeros((b, tb), np.int32)
    write_idx = np.full((b, tb), -1, np.int32)
    page_table = np.zeros((b, pb), np.int32)
    kv_lens = np.zeros((b,), np.int32)
    for i, (toks, start, pages) in enumerate(rows):
        n = len(toks)
        tokens[i, :n] = toks
        positions[i, :] = start + n - 1
        positions[i, :n] = np.arange(start, start + n)
        page_table[i, :len(pages)] = pages
        for t in range(n):
            pos = start + t
            write_idx[i, t] = pages[pos // PS] * PS + pos % PS
        kv_lens[i] = start + n
    return tokens, positions, page_table, kv_lens, write_idx


def _run_both(params, jcache, tcache, rows, tb, pb):
    jp, tp = params
    tokens, positions, page_table, kv_lens, write_idx = _meta(rows, tb, pb)
    jmeta = jllama.AttnMetadata(
        positions=jnp.asarray(positions), page_table=jnp.asarray(page_table),
        kv_lens=jnp.asarray(kv_lens), write_idx=jnp.asarray(write_idx))
    tmeta = tllama.AttnMetadata(
        positions=torch.from_numpy(positions),
        page_table=torch.from_numpy(page_table),
        kv_lens=torch.from_numpy(kv_lens),
        write_idx=torch.from_numpy(write_idx))
    jlog, jcache = jllama.forward(jp, JCFG, jnp.asarray(tokens), jcache,
                                  jmeta)
    tlog, tcache = tllama.forward(tp, TCFG, torch.from_numpy(tokens),
                                  tcache, tmeta)
    for i, (toks, _, _) in enumerate(rows):
        np.testing.assert_allclose(tlog[i, :len(toks)].numpy(),
                                   np.asarray(jlog)[i, :len(toks)],
                                   rtol=TOL_LOGITS, atol=TOL_LOGITS)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :, :P].numpy(),
                                   np.asarray(jcache[key]),
                                   rtol=TOL_CACHE, atol=TOL_CACHE)
    return jcache, tcache, tlog


def test_forward_prefill_then_mixed(params):
    """A prefill chunk for two rows, then a mixed step: one single-token
    decode row plus the second row's next chunk over its cached prefix;
    logits of every valid position and every written cache row."""
    rng = np.random.default_rng(0)
    a = rng.integers(3, 250, 12).tolist()
    b = rng.integers(3, 250, 13).tolist()
    jcache = jllama.init_cache(JCFG, P, PS)
    tcache = tllama.init_cache(TCFG, P + 1, PS, "cpu")
    rows = [(a, 0, [2, 5]), (b[:7], 0, [7])]
    jcache, tcache, tlog = _run_both(params, jcache, tcache, rows, 16, 3)
    nxt = int(tlog[0, len(a) - 1].argmax())
    rows = [([nxt], len(a), [2, 5]), (b[7:], 7, [7, 3]),
            ([], 0, [])]                                   # padding row
    _run_both(params, jcache, tcache, rows, 8, 3)


def test_forward_single_token_uses_inclusive_kernel_view(params):
    """Tq == 1 goes through the ragged kernel's inclusive view in the port
    (its plain version on CPU) and through the gather path in the JAX
    package; same logits."""
    jcache = jllama.init_cache(JCFG, P, PS)
    tcache = tllama.init_cache(TCFG, P + 1, PS, "cpu")
    prompt = list(range(20, 41))
    jcache, tcache, _ = _run_both(params, jcache, tcache,
                                  [(prompt[:-1], 0, [4, 1, 6])], 32, 3)
    _run_both(params, jcache, tcache,
              [([prompt[-1]], 20, [4, 1, 6]), ([], 0, [])], 1, 3)


def test_decode_forward_matches_pallas_interpret(params):
    """The deferred-write decode step: the port's prefix kernel view +
    combine_self_attention against JAX's decode_forward with the Pallas
    kernel in interpret mode; logits and the new kv rows. Row 1 is padding
    (empty prefix)."""
    jp, tp = params
    jcache = jllama.init_cache(JCFG, P, PS)
    tcache = tllama.init_cache(TCFG, P + 1, PS, "cpu")
    prompt = np.random.default_rng(1).integers(3, 250, 19).tolist()
    jcache, tcache, tlog = _run_both(params, jcache, tcache,
                                     [(prompt, 0, [3, 8, 9])], 32, 3)
    tok = np.array([int(tlog[0, -1].argmax()), 0], np.int32)
    pt = np.array([[3, 8, 9], [0, 0, 0]], np.int32)
    prefix = np.array([19, 0], np.int32)
    pos = np.array([19, 0], np.int32)
    jcfg = dataclasses.replace(JCFG, decode_kernel="interpret")
    jlog, jk, jv = jllama.decode_forward(
        jp, jcfg, jnp.asarray(tok), jcache, jnp.asarray(pt),
        jnp.asarray(prefix), jnp.asarray(pos))
    tlog, tk, tv = tllama.decode_forward(
        tp, TCFG, torch.from_numpy(tok), tcache, torch.from_numpy(pt),
        torch.from_numpy(prefix), torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)
    for got, want in ((tk, jk), (tv, jv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_CACHE, atol=TOL_CACHE)


def test_dropped_writes_land_in_the_scratch_page():
    """Rows with write index < 0 go to the cache's last page and nowhere
    else (the port's stand-in for JAX's mode="drop" scatter)."""
    from dynamo_tpu_torch.ops.attention import write_kv_pages
    hkv, p, hd = 2, 5, 4
    k = torch.zeros((hkv, p, PS, hd))
    v = torch.zeros((hkv, p, PS, hd))
    new = torch.ones((1, 3, hkv, hd))
    write_kv_pages(k, v, new, new, torch.tensor([[9, -1, -1]]))
    assert float(k[:, :p - 1].sum()) == hkv * hd        # slot 9 only
    assert float(k[:, 1, 1].sum()) == hkv * hd
    assert float(k[:, p - 1].sum()) == 2 * hkv * hd     # the two drops


@pytest.mark.parametrize("knob", [dict(attn_softcap=50.0),
                                  dict(sliding_window=64),
                                  dict(query_scale=0.1)])
def test_unservable_configs_are_refused(knob):
    """The Gemma-2 attention knobs, once refused, are served now: the
    decode resolves to the gather window with the knob named, and a
    ragged path asked for such a config is refused rather than served
    without the knob, as is an unknown decode_kernel."""
    cfg = dataclasses.replace(TCFG, **knob)
    tllama.init_params(cfg, "cpu")
    path, reason = tllama.decode_path(cfg)
    assert path == "gather" and next(iter(knob)) in reason
    assert tllama.decode_path(dataclasses.replace(cfg, decode_kernel="off")
                              ) == ("gather", "decode_kernel='off'")
    with pytest.raises(ValueError, match="cannot decode through the ragged"):
        tllama._resolved(cfg, "ragged")
    with pytest.raises(ValueError, match="unknown decode_kernel"):
        tllama.init_params(dataclasses.replace(cfg, decode_kernel="fast"),
                           "cpu")
