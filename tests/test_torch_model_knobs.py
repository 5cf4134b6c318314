"""The architecture knobs checkpoint families set (dynamo_tpu_torch/models/
llama.py) against the JAX model (dynamo_tpu/models/llama.py) in float32:
q/k/v bias (Qwen2), the Gemma deltas (embedding scale, (1 + w) norms,
tanh-GELU), the Gemma-2 post norms and final soft-cap without any
attention knob, tied embeddings, and the dense MoE oracle's activation.

The same seeded numpy weights go to both packages; norms and biases are
drawn away from their init values (ones, zeros) so that every branch
changes the output. `forward` (a prefill chunk, then a single-token step)
and `decode_forward` (JAX: the Pallas kernel in interpret mode) agree
within rtol = atol = 1e-5 on the logits and the new kv rows.
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
from dynamo_tpu_torch.engine.config import check_supported
from dynamo_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

TOL = 1e-5
P, PS = 8, 8
BASE = dict(dtype="float32", max_model_len=256, vocab_size=192,
            hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16)
KNOBS = {
    "bias": dict(attn_bias=True),
    "gemma": dict(embed_scale=64 ** 0.5, norm_plus_one=True,
                  mlp_act="gelu_tanh", tie_word_embeddings=True),
    "post_norms_softcap": dict(post_norms=True, final_softcap=3.0),
    "everything": dict(attn_bias=True, embed_scale=64 ** 0.5,
                       norm_plus_one=True, mlp_act="gelu_tanh",
                       post_norms=True, final_softcap=3.0),
    "moe_dense_gelu": dict(num_experts=4, num_experts_per_tok=2,
                           moe_impl="dense", mlp_act="gelu_tanh"),
}


def _configs(name):
    return (JModelConfig(**BASE, **KNOBS[name]),
            TModelConfig(**BASE, **KNOBS[name]))


def _params(jcfg, tcfg, seed=0):
    """JAX init, norms and biases redrawn from a seed: (JAX tree, port
    tree) holding the same values."""
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for key in layers:
        if key.endswith("norm"):
            layers[key] = rng.uniform(0.5, 1.5, layers[key].shape).astype(
                np.float32) - (1.0 if jcfg.norm_plus_one else 0.0)
        elif key.endswith("_b"):
            layers[key] = rng.normal(0, 0.5, layers[key].shape).astype(
                np.float32)
    tree = dict(tree, layers=layers,
                final_norm=rng.uniform(0.5, 1.5, tree["final_norm"].shape
                                       ).astype(np.float32))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    return jtree, tllama.params_from_jax(tree, tcfg, "cpu")


def _meta(tokens, start, pages):
    n = len(tokens)
    pos = np.arange(start, start + n, dtype=np.int32)[None]
    pt = np.asarray([pages], np.int32)
    widx = np.asarray([[pages[p // PS] * PS + p % PS for p in pos[0]]],
                      np.int32)
    lens = np.asarray([start + n], np.int32)
    return (jllama.AttnMetadata(jnp.asarray(pos), jnp.asarray(pt),
                                jnp.asarray(lens), jnp.asarray(widx)),
            tllama.AttnMetadata(torch.from_numpy(pos), torch.from_numpy(pt),
                                torch.from_numpy(lens),
                                torch.from_numpy(widx)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_forward_and_decode_match_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg)
    for key in ("post_attn_norm", "post_mlp_norm", "wq_b", "wk_b", "wv_b"):
        assert (key in tp["layers"]) == (key in jp["layers"]), key
    jcache = jllama.init_cache(jcfg, P, PS)
    tcache = tllama.init_cache(tcfg, P + 1, PS, "cpu")
    prompt = np.random.default_rng(1).integers(
        1, BASE["vocab_size"], 11).astype(np.int32)
    pages = [3, 5]
    jm, tm = _meta(prompt[:-1], 0, pages)
    jlog, jcache = jllama.forward(jp, jcfg, jnp.asarray(prompt[:-1])[None],
                                  jcache, jm)
    tlog, tcache = tllama.forward(tp, tcfg, torch.from_numpy(
        prompt[:-1].copy())[None], tcache, tm)
    _close(tlog[0], jlog[0])
    for key in ("k", "v"):
        _close(tcache[key][:, :, :P], jcache[key])
    # one token through forward (Tq == 1) ...
    jm, tm = _meta(prompt[-1:], len(prompt) - 1, pages)
    jl1, _ = jllama.forward(jp, jcfg, jnp.asarray(prompt[-1:])[None],
                            dict(jcache), jm)
    tl1, _ = tllama.forward(tp, tcfg, torch.from_numpy(
        prompt[-1:].copy())[None], {k: v.clone() for k, v in
                                    tcache.items()}, tm)
    _close(tl1[0], jl1[0])
    # ... and through the deferred-write decode step
    tok = np.asarray([prompt[-1], 0], np.int32)
    pt = np.asarray([pages, [0, 0]], np.int32)
    prefix = np.asarray([len(prompt) - 1, 0], np.int32)
    jout = jllama.decode_forward(
        jp, dataclasses.replace(jcfg, decode_kernel="interpret"),
        jnp.asarray(tok), jcache, jnp.asarray(pt), jnp.asarray(prefix),
        jnp.asarray(prefix))
    tout = tllama.decode_forward(
        tp, tcfg, torch.from_numpy(tok), tcache, torch.from_numpy(pt),
        torch.from_numpy(prefix), torch.from_numpy(prefix))
    for got, want in zip(tout, jout[:3]):
        _close(got, want)
    _close(tout[0][0], tl1[0, 0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 2048, 3072])
def test_embed_scale_rounds_to_the_activation_dtype(dtype, d):
    """sqrt(d) is rounded to x's dtype before the multiply, as JAX does:
    bit-equal outputs in bf16 and f32."""
    jcfg = JModelConfig(embed_scale=float(d) ** 0.5, dtype=dtype)
    tcfg = TModelConfig(embed_scale=float(d) ** 0.5, dtype=dtype)
    x = np.random.default_rng(d).normal(0, 1, (4, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(tllama.torch_dtype(tcfg))
    want = np.asarray(jllama.scale_embeds(jx, jcfg).astype(jnp.float32))
    got = tllama.scale_embeds(tx, tcfg).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_bf16_bit_equal(plus_one):
    """rms_norm(plus_one) rounds once, where JAX does: bit-equal in bf16."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, (3, 64)).astype(np.float32)
    w = rng.normal(0, 0.3, (64,)).astype(np.float32)
    jb, tb = jnp.bfloat16, torch.bfloat16
    want = np.asarray(jllama.rms_norm(jnp.asarray(x, jb), jnp.asarray(w, jb),
                                      1e-6, plus_one).astype(jnp.float32))
    got = tllama.rms_norm(torch.from_numpy(x).to(tb),
                          torch.from_numpy(w).to(tb), 1e-6,
                          plus_one).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_mlp_activation(act):
    """The gate activation in f32, cast back: within 1e-6 in f32 (XLA's
    tanh is its own polynomial, torch's another), and in bf16 at most one
    bf16 ulp apart where the f32 values round differently, or 1e-6 in the
    GELU's far negative tail, where XLA's tanh reaches -1 earlier."""
    x = np.random.default_rng(7).normal(0, 2, (3, 256)).astype(np.float32)
    jcfg, tcfg = JModelConfig(mlp_act=act), TModelConfig(mlp_act=act)
    want = np.asarray(jllama.mlp_activation(jnp.asarray(x), jcfg))
    got = tllama.mlp_activation(torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jllama.mlp_activation(
        jnp.asarray(x, jnp.bfloat16), jcfg).astype(jnp.float32))
    got = tllama.mlp_activation(torch.from_numpy(x).to(torch.bfloat16),
                                tcfg).float().numpy()
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7 + 1e-6
    assert (np.abs(got - want) <= ulp).all()


def test_init_params_new_leaves():
    """Post norms start at one and biases at zero, in the JAX layout."""
    jcfg, tcfg = _configs("everything")
    tp = tllama.init_params(dataclasses.replace(tcfg, dtype="bfloat16"),
                            "cpu")
    shapes = jax.eval_shape(lambda k: jllama.init_params(k, jcfg),
                            jax.random.PRNGKey(0))["layers"]
    for key in ("post_attn_norm", "post_mlp_norm", "wq_b", "wk_b", "wv_b"):
        assert tuple(tp["layers"][key].shape) == shapes[key].shape
    assert bool((tp["layers"]["post_mlp_norm"] == 1).all())
    assert bool((tp["layers"]["wk_b"] == 0).all())


@pytest.mark.parametrize("geometry,ok", [
    (dict(head_dim=128, num_heads=32, num_kv_heads=8), True),
    (dict(head_dim=256, num_heads=8, num_kv_heads=1), True),
    (dict(head_dim=96, num_heads=32, num_kv_heads=32), True),
    (dict(head_dim=64, num_heads=32, num_kv_heads=2), True),
    (dict(head_dim=256, num_heads=16, num_kv_heads=8), True),
    (dict(head_dim=128, num_heads=96, num_kv_heads=8), True),
    (dict(head_dim=80, num_heads=32, num_kv_heads=8), False),
    (dict(head_dim=64, num_heads=32, num_kv_heads=1), False),
])
def test_kernel_geometry_refused_on_cuda_only(geometry, ok):
    """No geometry is refused any more, on any device: the ragged kernel
    takes head dims 32, 64, 96, 128 and 256 and GQA groups up to 16; any
    other head dim or group resolves the decode to the gather window, with
    the limit named, on the CPU and the card alike."""
    cfg = TModelConfig(**geometry)
    check_supported(cfg, "cpu")
    check_supported(cfg, "cuda")
    path, reason = tllama.decode_path(cfg)
    if ok:
        assert (path, reason) == ("ragged", "decode_kernel='auto'")
    else:
        assert path == "gather"
        assert reason in (
            "head_dim 80: the ragged kernel takes head dims "
            "(32, 64, 96, 128, 256)",
            "GQA group 32: the ragged kernel takes groups of at most 16")


def test_dtype_refused_on_cuda_only():
    """A model dtype the CUDA kernels cannot take (float16, given by an
    explicit override) is refused by name for a CUDA engine; f32 and bf16
    pass, and the CPU serves float16 through the plain versions."""
    for dtype in ("float32", "bfloat16"):
        check_supported(TModelConfig(dtype=dtype), "cuda")
    check_supported(TModelConfig(dtype="float16"), "cpu")
    with pytest.raises(NotImplementedError,
                       match="dtype float16 .* take float32, bfloat16"):
        check_supported(TModelConfig(dtype="float16"), "cuda")


def test_moe_dispatch_with_gelu_refused():
    with pytest.raises(NotImplementedError, match="SiLU"):
        check_supported(TModelConfig(num_experts=4, mlp_act="gelu_tanh"))
