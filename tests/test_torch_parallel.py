"""The port's parallel/ modules and the Megatron shards against the JAX
package's: the mesh axes, `kv_shard_layout` over a grid (with the same
raises), the bootstrap's environment decisions, the PartitionSpecs of
`param_shardings`, every leaf of each rank's shard bit-equal to JAX's
`addressable_shards[r]` under `NamedSharding(make_mesh(tp=N), spec)` (llama
with untied and tied embeddings, a qwen2-style tree with q/k/v biases, a
gemma2-style tree with post-norms, at tp 2 and 4), the rank-invariant
init, and the refusals of a tp engine, named. Nothing here spawns a rank:
tests/test_torch_tp.py runs the engines.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.parallel import bootstrap as jboot
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import EngineRequest, SamplingParams
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.parallel import bootstrap as tboot
from dynamo_tpu_torch.parallel import comm as tcomm
from dynamo_tpu_torch.parallel import launch as tlaunch
from dynamo_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
            max_model_len=256, dtype="float32")
TREES = {
    "llama": BASE,
    "llama-tied": dict(BASE, tie_word_embeddings=True),
    "qwen2": dict(BASE, attn_bias=True),
    "gemma2": dict(BASE, post_norms=True, norm_plus_one=True,
                   mlp_act="gelu_tanh", embed_scale=8.0, final_softcap=30.0,
                   attn_softcap=50.0, sliding_window=64, query_scale=0.25,
                   tie_word_embeddings=True),
}


# -- mesh ----------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [
    dict(), dict(tp=2), dict(tp=4), dict(dp=2, tp=4), dict(pp=2, tp=2),
    dict(ep=2, sp=2, tp=2)])
def test_mesh_axes_match_jax(sizes):
    assert tmesh.AXES == jmesh.AXES
    t = tmesh.make_mesh(**sizes)
    assert t.shape == dict(jmesh.make_mesh(**sizes).shape)
    assert list(t.shape) == list(jmesh.AXES)
    assert t.size == jmesh.make_mesh(**sizes).size
    assert t.tp == sizes.get("tp", 1)


def test_mesh_refusals():
    with pytest.raises(ValueError, match="outside tp=2"):
        tmesh.make_mesh(tp=2, rank=2)
    with pytest.raises(ValueError, match="size >= 1"):
        tmesh.make_mesh(tp=0)
    with pytest.raises(ValueError, match="group holds 4 ranks"):
        tmesh.make_mesh(tp=2, comm=_FakeComm(4))
    assert tmesh.single_device_mesh().size == 1


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # the raise is part of the contract
        return (type(e).__name__, str(e))


KV_GRID = [(l, hkv, tp, pp, n) for l in (2, 4, 6) for hkv in (1, 2, 4, 8)
           for tp in (1, 2, 4) for pp in (1, 2, 3) for n in (0, 1, 2, 4, 3)]


@pytest.mark.parametrize("pp", [1, 2, 3])
def test_kv_shard_layout_matches_jax(pp):
    cases = [c for c in KV_GRID if c[3] == pp]
    for l, hkv, tp, pp_, n in cases:
        assert _outcome(tmesh.kv_shard_layout, l, hkv, tp, pp_, n) == \
            _outcome(jmesh.kv_shard_layout, l, hkv, tp, pp_, n), \
            (l, hkv, tp, pp_, n)
    # the grid holds plans and raises both
    kinds = {_outcome(tmesh.kv_shard_layout, *c)[0] for c in cases}
    assert kinds == {"ok", "ValueError"}


# -- bootstrap ------------------------------------------------------------------

@pytest.mark.parametrize("env,args", [
    ({}, ()),
    ({"DYN_COORD_ADDR": "127.0.0.1:1"}, ()),
    ({"DYN_COORD_ADDR": "127.0.0.1:1", "DYN_NUM_PROCESSES": "2"}, ()),
    ({"DYN_COORD_ADDR": "127.0.0.1:1", "DYN_PROCESS_ID": "0"}, ()),
    ({"DYN_COORD_ADDR": "127.0.0.1:1", "DYN_NUM_PROCESSES": "0",
      "DYN_PROCESS_ID": "0"}, ()),
    ({}, ("127.0.0.1:1", 2, -1)),
    ({}, ("127.0.0.1:1", -3, 1)),
])
def test_bootstrap_env_decisions_match_jax(monkeypatch, env, args):
    """The no-op and the refusals, before either package touches its
    runtime: the same outcome and message."""
    for key in ("DYN_COORD_ADDR", "DYN_NUM_PROCESSES", "DYN_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    got = _outcome(tboot.bootstrap_distributed, *args)
    assert got == _outcome(jboot.bootstrap_distributed, *args)
    assert got[0] in ("ok", "ValueError")


def test_backend_follows_the_device():
    assert tboot.default_backend("cuda:3") == "nccl"
    assert tboot.default_backend("cpu") == "gloo"


def test_rank_placement_refusals(monkeypatch):
    assert tlaunch.rank_devices(3, "cpu") == (["cpu"] * 3, "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tlaunch.rank_devices(2) == (["cuda:0", "cuda:1"], "nccl")
    with pytest.raises(ValueError, match="tp=4 needs 4 CUDA devices, 2 "
                                         "visible"):
        tlaunch.rank_devices(4)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one"):
        tlaunch.rank_devices(2, devices=["cuda:0", "cuda:0"])
    # gloo may share a card when asked, and never on its own
    assert tlaunch.rank_devices(4, backend="gloo",
                                devices=["cuda:0"] * 4)[1] == "gloo"
    with pytest.raises(ValueError, match="NCCL ranks run on CUDA"):
        tlaunch.rank_devices(2, "cpu", backend="nccl")


# -- the shards -----------------------------------------------------------------

@pytest.mark.parametrize("kind", list(TREES))
def test_param_specs_are_jax_param_shardings(kind):
    jspec = jllama.param_shardings(JModelConfig(**TREES[kind]))
    flat = jax.tree.leaves_with_path(jspec, is_leaf=lambda x: isinstance(
        x, P))
    tspec = tllama.param_specs(TModelConfig(**TREES[kind]))
    tflat = jax.tree.leaves_with_path(tspec, is_leaf=lambda x: isinstance(
        x, tuple))
    assert {jax.tree_util.keystr(k): tuple(v) for k, v in flat} == \
        {jax.tree_util.keystr(k): v for k, v in tflat}


@pytest.fixture(scope="module")
def jax_trees():
    return {kind: jax.device_get(jllama.init_params(
        jax.random.PRNGKey(3), JModelConfig(**fields)))
        for kind, fields in TREES.items()}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", list(TREES))
def test_rank_shards_bit_equal_jax_addressable_shards(jax_trees, kind, tp):
    """Every leaf of rank r's shard (params_from_jax with the mesh; and
    shard_params of the whole torch tree) is JAX's shard on device r."""
    fields = TREES[kind]
    jcfg, tcfg = JModelConfig(**fields), TModelConfig(**fields)
    tree = jax_trees[kind]
    mesh = jmesh.make_mesh(tp=tp)
    specs = jllama.param_shardings(jcfg)
    placed = jax.tree.map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        tree, specs, is_leaf=lambda x: isinstance(x, P))
    whole = tllama.params_from_jax(tree, tcfg, "cpu")
    for r in range(tp):
        got = tllama.params_from_jax(
            tree, tcfg, "cpu", mesh=tmesh.make_mesh(tp=tp, rank=r))
        cut = tllama.shard_params(whole, tcfg, r, tp)
        for path, leaf in jax.tree.leaves_with_path(placed):
            shards = sorted(leaf.addressable_shards,
                            key=lambda s: s.device.id)
            want = np.asarray(shards[r].data)
            node, node_cut = got, cut
            for key in path:
                node, node_cut = node[key.key], node_cut[key.key]
            assert node.shape == want.shape, (kind, tp, r, path)
            assert np.array_equal(node.numpy(), want), (kind, tp, r, path)
            assert np.array_equal(node_cut.numpy(), want), (kind, tp, r, path)


@pytest.mark.parametrize("tp", [2, 4])
def test_init_draws_do_not_depend_on_tp(tp):
    """Each rank's init_params is its cut of the tp-1 draw of the seed."""
    cfg = TModelConfig(**BASE)
    whole = tllama.init_params(cfg, "cpu", seed=5)
    for r in range(tp):
        got = tllama.init_params(cfg, "cpu", seed=5,
                                 mesh=tmesh.make_mesh(tp=tp, rank=r))
        want = tllama.shard_params(whole, cfg, r, tp)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert torch.equal(a, b)


def test_rank_config_and_kv_heads():
    cfg = TModelConfig(**BASE)
    rc = tllama.rank_config(cfg, 4)
    assert (rc.num_heads, rc.num_kv_heads, rc.intermediate_size,
            rc.vocab_size) == (2, 1, 32, 256)
    assert tllama.rank_config(cfg, 1) is cfg
    mqa = TModelConfig(**dict(BASE, num_kv_heads=2))
    # tp 4 over 2 kv heads: each rank holds the one its q heads read
    assert [tllama.kv_heads_of(mqa, r, 4) for r in range(4)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]
    assert tllama.rank_config(mqa, 4).num_kv_heads == 1


@pytest.mark.parametrize("fields,tp,err,named", [
    (dict(BASE, num_heads=6, num_kv_heads=2), 4, ValueError,
     "num_heads=6 is not divisible by tp=4"),
    (dict(BASE, num_heads=12, num_kv_heads=3), 2, ValueError,
     "neither divides nor is a multiple of num_kv_heads=3"),
    (dict(BASE, intermediate_size=100), 8, ValueError,
     "intermediate_size=100"),
    (dict(BASE, num_experts=4), 2, NotImplementedError, "an MoE model"),
    (dict(BASE, quant="int8"), 2, NotImplementedError, "int8 weights"),
])
def test_check_tp_refusals(fields, tp, err, named):
    with pytest.raises(err, match=named):
        tllama.check_tp(TModelConfig(**fields), tp)


def test_vocab_ranges_cover_the_vocab():
    for v, tp in ((256, 4), (250, 4), (128256, 4), (7, 3), (5, 4)):
        parts = [tcomm.vocab_range(v, r, tp) for r in range(tp)]
        assert parts[0][0] == 0 and parts[-1][1] == v
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    # JAX's even split where tp divides the vocab
    assert [tcomm.vocab_range(256, r, 4) for r in range(4)] == \
        [(0, 64), (64, 128), (128, 192), (192, 256)]


# -- the engine's refusals (no collective runs) ---------------------------------

class _FakeComm:
    """A group of `size` gloo ranks that is never asked for a collective."""

    def __init__(self, size, backend="gloo"):
        self.size, self.backend = size, backend


def _tp_engine(tp=2, fields=BASE, **knobs):
    kw = dict(page_size=8, num_pages=32, max_slots=2, max_prefill_chunk=32,
              prefill_buckets=(8, 16, 32), max_model_len=256)
    mesh = tmesh.make_mesh(tp=tp, comm=_FakeComm(tp))
    return TNativeEngine(TModelConfig(**fields),
                         TEngineConfig(**dict(kw, tp=tp, **knobs)),
                         device="cpu", mesh=mesh)


@pytest.mark.parametrize("fields,knobs,named", [
    (dict(BASE, num_experts=4), {}, "an MoE model"),
    (dict(BASE, quant="int8"), {}, "int8 weights"),
    (BASE, {"spec_decode": "ngram"}, "speculative decoding"),
    (BASE, {"host_pages": 8}, "the KV host / disk tiers"),
])
def test_engine_refuses_what_the_slice_leaves_out(fields, knobs, named):
    with pytest.raises(ValueError, match=f"{named}.*tensor-parallel engine "
                                         r"\(tp=2\)"):
        _tp_engine(fields=fields, **knobs)


@pytest.mark.parametrize("knobs,named", [
    (dict(host_pages=8, stream_pages=4), "single-device only"),
    (dict(stream_pages=4), "requires host_pages > 0")])
def test_engine_streaming_refusal_is_jax_message(knobs, named):
    with pytest.raises(ValueError) as jerr:
        JNativeEngine(JModelConfig(**BASE),
                      JEngineConfig(page_size=8, num_pages=32, max_slots=2,
                                    max_prefill_chunk=32,
                                    prefill_buckets=(8, 16, 32),
                                    max_model_len=256, **knobs),
                      mesh=jmesh.make_mesh(tp=2), seed=0)
    with pytest.raises(ValueError) as terr:
        _tp_engine(**knobs)
    assert str(terr.value) == str(jerr.value)
    assert named in str(terr.value)


def test_engine_refuses_other_axes_and_a_tp_mismatch():
    with pytest.raises(ValueError, match="EngineConfig.tp=2 needs the engine "
                                         "of a tensor-parallel group"):
        TNativeEngine(TModelConfig(**BASE), TEngineConfig(tp=2),
                      device="cpu")
    with pytest.raises(ValueError, match="mesh axis 'pp'=2"):
        TNativeEngine(TModelConfig(**BASE), TEngineConfig(tp=2),
                      device="cpu", mesh=tmesh.make_mesh(
                          tp=2, pp=2, comm=_FakeComm(2)))
    with pytest.raises(ValueError, match="engine tp=1 but the mesh's tp "
                                         "axis is 2"):
        TNativeEngine(TModelConfig(**BASE), TEngineConfig(),
                      device="cpu", mesh=tmesh.make_mesh(
                          tp=2, comm=_FakeComm(2)))


@pytest.mark.parametrize("call,named", [
    (lambda e: e.add_request(EngineRequest(
        "p", [1, 2, 3], SamplingParams(max_tokens=2), prefill_only=True)),
     "a disaggregated prefill"),
    (lambda e: e.allocate_remote(EngineRequest(
        "r", [1, 2, 3], SamplingParams(max_tokens=2))), "allocate_remote"),
    (lambda e: e.extract_pages([0]), "extract_pages"),
    (lambda e: e.inject_pages([0], None, None), "inject_pages"),
    (lambda e: e.attach_kv_pool(object(), "w0"), "the shared KV pool"),
])
def test_engine_refuses_the_disaggregated_transfer(call, named):
    eng = _tp_engine()
    with pytest.raises(ValueError, match=named):
        call(eng)


def test_engine_holds_its_rank_shard():
    eng = _tp_engine(tp=4)
    mc = eng.model_cfg
    assert (mc.num_heads, mc.num_kv_heads, mc.intermediate_size) == (2, 1, 32)
    assert eng.full_model_cfg.num_heads == 8
    assert tuple(eng.cache["k"].shape[:2]) == (2, 1)
    assert eng.window_graph_mode == "off (cpu)"
    assert eng.params["lm_head"].shape == (64, 64)
    with pytest.raises(ValueError, match="not rank 0's shard"):
        TNativeEngine(TModelConfig(**BASE), TEngineConfig(tp=2),
                      device="cpu", mesh=tmesh.make_mesh(
                          tp=2, comm=_FakeComm(2)),
                      params=tllama.init_params(TModelConfig(**BASE), "cpu"))


def test_engine_without_a_group_is_unchanged():
    eng = TNativeEngine(TModelConfig(**BASE), TEngineConfig(
        page_size=8, num_pages=32, max_slots=2, max_prefill_chunk=32,
        prefill_buckets=(8, 16, 32), max_model_len=256), device="cpu")
    m = eng.metrics()
    assert (m.tp, m.tp_rank, m.tp_backend, m.tp_ranks) == (1, 0, "", [])
    assert eng.tp_stats() == []
    assert dataclasses.replace(eng.model_cfg) == TModelConfig(**BASE)
