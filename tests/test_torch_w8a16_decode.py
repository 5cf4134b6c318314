"""The grouped W8A16 decode kernel's host side on the CPU
(dynamo_tpu_torch/ops/quant.py `linear_group`, `w8a16_group`,
`group_config`, `group_units`; the kernel is csrc/w8a16_gemm.cu
`w8a16_group`), against the JAX package where there is a counterpart.

- `linear_group`'s plain version (CPU tensors) equals the JAX `x @
  wmat(w)` einsum for each weight of a group (dynamo_tpu/ops/quant.py:70,
  dynamo_tpu/models/llama.py:387-389 and :322-325) within 1e-6 in f32 (sums
  in another order), and is bit-equal to the port's own `linear` in f32 and
  bf16.
- The routes, with every C entry point replaced by a recorder: a group at
  M <= GEMV_MAX_M with a bf16 x is ONE entry call carrying each weight's
  pointers, N and scales in order; an f32 x, or M past the switch point,
  makes today's calls a weight; plain weights make none.
- The grid: over the llama3-8b, llama3-1b, tiny, mixtral and odd groups
  at M = 1..16, every k row of every column of every weight is covered
  exactly once, the grid stays within one wave of resident blocks at 132
  SMs, the splits fit one portable cluster, and the C entry's own rules
  hold.
- The model's call sites: a decode step makes one `linear_group` call a
  group of products that share an input, 4 L + 1 products launches on a
  dense model and 2 L + 1 on an MoE one (the count chip_smoke.py's gates
  derive from the model's structure).
The kernel itself is held against its plain version on the card by
chip_smoke.py (phase 2d).
"""
import dataclasses
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.engine.config import ModelConfig, get_model_config
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

SRC = Path(tquant.__file__).resolve().parent.parent / "csrc" / "w8a16_gemm.cu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_group(k: int, ns, seed: int):
    """A group of JAX-quantized weights of one K from seeded numpy
    values, and the same leaves as port tensors."""
    rng = np.random.default_rng(seed)
    jws = [jquant.quantize_int8(jnp.asarray(
        rng.standard_normal((k, n)).astype(np.float32) * 0.1)) for n in ns]
    tws = [{"q": _t(w["q"]), "s": _t(w["s"])} for w in jws]
    return jws, tws


# -- (a) the plain version against JAX ------------------------------------------

@pytest.mark.parametrize("ns", [(48, 16, 16), (80, 80), (33,)])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 16, 40])
def test_linear_group_plain_matches_jax(ns, m):
    k = 96
    jws, tws = _jax_group(k, ns, seed=m + len(ns))
    x = np.random.default_rng(100 + m).standard_normal(
        (2, m, k)).astype(np.float32)
    got = tquant.linear_group(torch.from_numpy(x), tws)
    assert len(got) == len(ns)
    for jw, tw, y in zip(jws, tws, got):
        want = np.asarray(jnp.einsum("btd,de->bte", jnp.asarray(x),
                                     jquant.wmat(jw, jnp.float32)))
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
        assert torch.equal(y, tquant.linear(torch.from_numpy(x), tw))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for tw, yb in zip(tws, tquant.linear_group(xb, tws)):
        assert yb.dtype == torch.bfloat16
        assert torch.equal(yb, tquant.linear(xb, tw))


def test_linear_group_plain_weights_are_separate_matmuls():
    rng = np.random.default_rng(3)
    ws = [torch.from_numpy(rng.standard_normal((32, n)).astype(np.float32))
          for n in (16, 8, 8)]
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    for w, y in zip(ws, tquant.linear_group(x, ws)):
        assert torch.equal(y, x @ w)


# -- (b) the routes ---------------------------------------------------------------

class _Entry:
    """A recorder in place of one C entry point: its calls' arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def entries(monkeypatch):
    """Every C entry point replaced by a recorder, every tensor reporting
    itself as CUDA (the wrappers' shape logic runs on CPU tensors), and the
    CUDA runtime queries answered as on one card."""
    lib = types.SimpleNamespace(w8a16_gemm=_Entry(), w8a16_dequant=_Entry(),
                                w8a16_group=_Entry())
    large = types.SimpleNamespace(w8a16_large_m=_Entry())
    monkeypatch.setattr(tquant, "_lib", lambda: lib)
    monkeypatch.setattr(tquant, "_large_m_lib", lambda: large)
    monkeypatch.setattr(tquant, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    return types.SimpleNamespace(
        group=lib.w8a16_group.calls, gemm=lib.w8a16_gemm.calls,
        dequant=lib.w8a16_dequant.calls, large=large.w8a16_large_m.calls)


@pytest.mark.parametrize("m", [1, 8, tquant.GEMV_MAX_M])
@pytest.mark.parametrize("ns", [(48, 16, 16), (64, 64), (32,)])
def test_decode_group_is_one_entry_call(entries, m, ns):
    k = 64
    _, ws = _jax_group(k, ns, seed=m)
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    before = tquant.KERNEL_LAUNCHES
    ys = tquant.linear_group(x, ws)
    assert [tuple(y.shape) for y in ys] == [(m, n) for n in ns]
    assert all(y.dtype == torch.bfloat16 for y in ys)
    assert len(entries.group) == 1 and tquant.KERNEL_LAUNCHES == before + 1
    assert not entries.gemm and not entries.large and not entries.dequant
    call = entries.group[0]
    pad = tquant.GROUP_MAX_W - len(ns)
    assert call[0] == x.data_ptr()
    assert call[1:4] == tuple(w["q"].data_ptr() for w in ws) + (None,) * pad
    assert call[4:7] == tuple(w["s"].data_ptr() for w in ws) + (None,) * pad
    assert call[7:10] == tuple(y.data_ptr() for y in ys) + (None,) * pad
    assert call[10:13] == tuple(ns) + (0,) * pad
    splits, per, per_block, _ = tquant.group_config(k, ns, 132)
    assert call[13:19] == (len(ns), m, k, splits, per, per_block)


def test_decode_group_folds_leading_dimensions(entries):
    _, ws = _jax_group(64, (32, 16), seed=1)
    ys = tquant.linear_group(torch.zeros((2, 3, 64), dtype=torch.bfloat16),
                             ws)
    assert [tuple(y.shape) for y in ys] == [(2, 3, 32), (2, 3, 16)]
    assert entries.group[0][13:15] == (2, 6)


@pytest.mark.parametrize("m,dtype", [
    (3, torch.float32), (tquant.GEMV_MAX_M, torch.float32),
    (tquant.GEMV_MAX_M + 1, torch.bfloat16), (100, torch.bfloat16),
    (100, torch.float32)])
def test_other_rows_and_types_take_todays_calls_a_weight(entries, m, dtype):
    _, ws = _jax_group(64, (48, 16, 16), seed=m)
    ys = tquant.linear_group(torch.zeros((m, 64), dtype=dtype), ws)
    assert [tuple(y.shape) for y in ys] == [(m, 48), (m, 16), (m, 16)]
    assert not entries.group
    if m <= tquant.GEMV_MAX_M:      # the per-weight CUDA-core kernel
        assert len(entries.gemm) == 3
        assert [c[1] for c in entries.gemm] == [w["q"].data_ptr()
                                                for w in ws]
    elif dtype == torch.bfloat16:   # the tensor-core kernel a weight
        assert len(entries.large) == 3 and not entries.gemm
    else:                           # the dequantize route a weight
        assert len(entries.dequant) == 3 and not entries.large


def test_plain_weights_make_no_entry_call(entries):
    ws = [torch.zeros((64, n), dtype=torch.bfloat16) for n in (48, 16)]
    tquant.linear_group(torch.zeros((8, 64), dtype=torch.bfloat16), ws)
    assert not (entries.group or entries.gemm or entries.large
                or entries.dequant)


def test_single_weight_linear_is_a_group_of_one(entries):
    _, ws = _jax_group(64, (48,), seed=2)
    tquant.linear(torch.zeros((8, 64), dtype=torch.bfloat16), ws[0])
    assert len(entries.group) == 1 and entries.group[0][13] == 1


@pytest.mark.parametrize("bad", ["four", "f32", "rows", "k", "q_dtype",
                                 "s_len"])
def test_group_argument_checks(bad):
    k = 64
    x = torch.zeros((8, k), dtype=torch.bfloat16)
    qs = [torch.zeros((k, n), dtype=torch.int8) for n in (32, 16)]
    ss = [torch.ones((1, n)) for n in (32, 16)]
    tquant._check_group(x, qs, ss)          # the good case passes
    if bad == "four":
        qs, ss = qs * 2, ss * 2
    elif bad == "f32":
        x = x.float()
    elif bad == "rows":
        x = torch.zeros((17, k), dtype=torch.bfloat16)
    elif bad == "k":
        qs[1] = torch.zeros((k + 1, 16), dtype=torch.int8)
    elif bad == "q_dtype":
        qs[0] = qs[0].float()
    elif bad == "s_len":
        ss[1] = torch.ones((1, 15))
    with pytest.raises((TypeError, ValueError)):
        tquant._check_group(x, qs, ss)


def test_cuda_x_never_takes_the_plain_version(monkeypatch):
    """A CUDA x launches the kernel or raises; without a card it raises,
    and nothing is counted as launched."""
    _, ws = _jax_group(64, (48, 16, 16), seed=4)
    fake = torch.zeros((4, 64), dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(
        lambda t: t is fake))
    before = tquant.KERNEL_LAUNCHES
    with pytest.raises((RuntimeError, AssertionError, OSError)):
        tquant.linear_group(fake, ws)
    assert tquant.KERNEL_LAUNCHES == before


# -- (c) the grid ---------------------------------------------------------------

def _groups(cfg) -> list:
    """(K, [N]) of each group of a model's decode step: q | k | v, o, gate
    | up and down on a dense model (the experts run elsewhere on an MoE
    one), and the head."""
    d, hd = cfg.hidden_size, cfg.head_dim
    attn = [(d, [cfg.num_heads * hd, cfg.num_kv_heads * hd,
                 cfg.num_kv_heads * hd]), (cfg.num_heads * hd, [d])]
    mlp = [] if cfg.is_moe else [(d, [cfg.intermediate_size] * 2),
                                 (cfg.intermediate_size, [d])]
    return attn + mlp + [(d, [cfg.vocab_size])]


GROUPS = [g for name in ("llama3-8b", "llama3-1b", "tiny", "mixtral-8x7b")
          for g in _groups(get_model_config(name))]
GROUPS += [(1000, [333]), (4100, [1031]), (1000, [333, 1031, 128]),
           (4100, [16]), (64, [1])]


def _cuda_constants() -> dict:
    src = SRC.read_text()
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (kGrp\w+) = (\d+);", src)}


@pytest.mark.parametrize("k,ns", GROUPS)
def test_group_grid_covers_each_weight_once(k, ns):
    """Every k row of every column of every weight exactly once, in one
    wave of resident blocks (2 an SM at most of the 3 that fit), the
    splits within one portable cluster, and the C entry's own checks."""
    sms = 132
    splits, per, per_block, blocks = tquant.group_config(k, ns, sms)
    chunks = -(-k // tquant._GRP_CHUNK_K)
    assert 1 <= splits <= tquant._GRP_MAX_SPLITS <= 8
    assert (splits - 1) * per < chunks <= splits * per
    assert splits == 1 or (per_block == 1 and per >= tquant._GRP_MIN_CHUNKS)
    assert splits * blocks <= 2 * sms
    assert blocks <= 65535
    seen = {}
    for w, col, k_lo, k_hi in tquant.group_units(k, ns, splits, per,
                                                 per_block, blocks):
        assert 0 <= w < len(ns) and col % tquant._GRP_TILE_N == 0
        assert col < ns[w] and 0 <= k_lo < k_hi <= k
        seen.setdefault((w, col), []).append((k_lo, k_hi))
    for w, n in enumerate(ns):
        for col in range(0, n, tquant._GRP_TILE_N):
            spans = sorted(seen.pop((w, col)))
            assert spans[0][0] == 0 and spans[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert not seen


@pytest.mark.parametrize("m", range(1, 17))
def test_group_grid_is_the_same_at_every_decode_row_count(m, entries):
    """M picks the kernel's instantiation (8 or 16 rows a pass), never
    the grid: one entry call at every M of a decode step."""
    _, ws = _jax_group(4096, (1024, 256), seed=0)
    tquant.linear_group(torch.zeros((m, 4096), dtype=torch.bfloat16), ws)
    assert entries.group[-1][13:19] == (2, m, 4096) + tuple(
        tquant.group_config(4096, (1024, 256), 132)[:3])


def test_grid_constants_match_the_kernel():
    c = _cuda_constants()
    assert c["kGrpTileN"] == tquant._GRP_TILE_N == 128
    assert c["kGrpChunkK"] == tquant._GRP_CHUNK_K
    assert c["kGrpMaxW"] == tquant.GROUP_MAX_W
    assert c["kGrpMaxSplits"] == tquant._GRP_MAX_SPLITS
    assert c["kGrpStages"] == tquant._GRP_STAGES
    # a stage: the q box (64 k rows x 128 bytes) and the x box (16 rows x
    # 64 bf16), each 1024-byte aligned for TMA's 128-byte swizzle
    stage = c["kGrpChunkK"] * c["kGrpTileN"] + c["kGrpXRows"] * \
        c["kGrpChunkK"] * 2
    assert stage % 1024 == 0 and c["kGrpXRows"] == 16
    smem = c["kGrpStages"] * stage + c["kGrpConsumers"] * 32 * \
        c["kGrpPartStride"] * 4 + 2 * 8 * c["kGrpStages"] + 1024
    assert smem == tquant.GROUP_SMEM_BYTES
    # three blocks an SM (228 KB, 1 KB reserved a block), as the grid
    # assumes; 16 k rows a consumer warp (the MMA's k16)
    assert 3 * (smem + 1024) <= 233472
    assert c["kGrpConsumers"] * 16 == c["kGrpChunkK"]
    assert c["kGrpPartStride"] == 2 * 32 + 1


# -- (d) the model's call sites ---------------------------------------------------

def _decode_products(cfg: ModelConfig, monkeypatch) -> list:
    """The products one decode step of `cfg` (int8 weights, CPU) asks for:
    one entry a `linear_group` call (the weights' N), one a `linear`
    call outside a group."""
    calls = []
    real_group, real_linear = tquant.linear_group, tquant.linear
    depth = {"n": 0}

    def group(x, ws):
        calls.append(("group", [w["q"].shape[-1] for w in ws]))
        depth["n"] += 1
        try:
            return real_group(x, ws)
        finally:
            depth["n"] -= 1

    def linear(x, w):
        if depth["n"] == 0:
            calls.append(("linear", [w["q"].shape[-1]]))
        return real_linear(x, w)
    monkeypatch.setattr(tllama, "linear_group", group)
    monkeypatch.setattr(tllama, "linear", linear)
    monkeypatch.setattr(tquant, "linear", linear)
    params = tllama.init_params(cfg, "cpu", seed=0)
    cache = tllama.init_cache(cfg, 8, 8, "cpu")
    tok = torch.tensor([5, 7])
    pt = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    tllama.decode_forward(params, cfg, tok, cache, pt, pos, pos)
    return calls


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_decode_step_groups_products_that_share_x(name, monkeypatch):
    cfg = dataclasses.replace(get_model_config(name), dtype="float32",
                              quant="int8")
    calls = _decode_products(cfg, monkeypatch)
    d, hd = cfg.hidden_size, cfg.head_dim
    layer = [("group", [cfg.num_heads * hd, cfg.num_kv_heads * hd,
                        cfg.num_kv_heads * hd]), ("linear", [d])]
    if not cfg.is_moe:
        layer += [("group", [cfg.intermediate_size] * 2), ("linear", [d])]
    assert calls == layer * cfg.num_layers + [("linear", [cfg.vocab_size])]
    per_layer = 2 if cfg.is_moe else 4
    assert len(calls) == per_layer * cfg.num_layers + 1
