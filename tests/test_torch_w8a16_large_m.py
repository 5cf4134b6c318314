"""The tensor-core W8A16 kernel's host side (dynamo_tpu_torch/ops/quant.py
`large_m_gemm`, csrc/w8a16_large_m.cu): the route every bf16 int8-weight
product past the decode rows takes on the card, dense (`linear`) and over
a layer's experts (`grouped_linear`).

- Its plain version (the CPU route) against the JAX package on the same
  numpy-seeded inputs, at the route's M (9, 16, 100, 512 and an odd 37):
  dense against `x @ wmat(w)` (dynamo_tpu/ops/quant.py:70-77), grouped
  against the expert einsum `becd,edf->becf` over `wmat` (dynamo_tpu/ops/
  moe.py:77-82) with the inactive experts' rows empty, as the dispatch
  leaves them. f32: rtol = atol = 1e-5 (the same products summed in
  another order); bf16: both sides round the f32 sum to bf16 once, so
  max |diff| <= 1e-2 x max |y| (the chip check's W8A16 bf16 tolerance,
  chip_smoke.py w8a16_check). An inactive expert is exact zeros even when
  its rows hold data (the kernel's contract).
- The scheduler, from shapes only: every output tile and every k-block of
  it is covered exactly once by the persistent blocks' walk; the ring fits
  a Hopper block's 227 KB; the tiles meet wgmma's shapes; the Python
  constants are the CUDA source's.
- The routes, with the C entry points replaced by recorders (no card
  here): a bf16 CUDA x past the switch point makes one call of the new
  entry and never dequantizes; a grouped one makes one call for all the
  experts; an f32 x takes the dequantize route; a CPU x reaches no entry.
- The argument checks that refuse what the kernel cannot take.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (phases 2d and 14.1).
"""
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

SRC = (Path(tquant.__file__).resolve().parent.parent / "csrc"
       / "w8a16_large_m.cu")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _weights(rng, shape):
    w = (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)
    return w, jquant.quantize_int8(jnp.asarray(w))


def _close(got: torch.Tensor, want: np.ndarray, dt: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= 1e-2 * np.abs(want).max(), err


# -- the plain version against the JAX package --------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [9, 16, 37, 100, 512])
def test_dense_plain_matches_jax(m, dt):
    rng = np.random.default_rng(m)
    _, jw = _weights(rng, (64, 48))
    x = rng.standard_normal((m, 64)).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    want = (jnp.asarray(x).astype(jdt) @ jquant.wmat(jw, jdt)).astype(
        jnp.float32)
    q = torch.from_numpy(np.array(jw["q"]))
    s = torch.from_numpy(np.array(jw["s"]))
    got = tquant.large_m_gemm(torch.from_numpy(x).to(tdt), q, s)
    assert got.dtype == tdt and tuple(got.shape) == (m, 48)
    _close(got, want, dt)
    # linear's CPU route is the same function
    _close(tquant.linear(torch.from_numpy(x).to(tdt), {"q": q, "s": s}),
           want, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [9, 16, 37, 100, 512])
def test_grouped_plain_matches_jax_einsum(m, dt):
    rng = np.random.default_rng(100 + m)
    e, k, n = 4, 64, 32
    _, jw = _weights(rng, (e, k, n))
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    active = np.array([m, 0, 3, 0], np.int32)
    x_routed = x * (active > 0)[:, None, None]     # the dispatch's buffer
    tdt, jdt = DTYPES[dt]
    want = jnp.einsum("becd,edf->becf",
                      jnp.asarray(x_routed)[None].astype(jdt),
                      jquant.wmat(jw, jdt))[0].astype(jnp.float32)
    q = torch.from_numpy(np.array(jw["q"]))
    s = torch.from_numpy(np.array(jw["s"]))
    act = torch.from_numpy(active)
    got = tquant.large_m_gemm(torch.from_numpy(x_routed).to(tdt), q, s, act)
    _close(got, want, dt)
    # grouped_linear's CPU route is the same function; an inactive expert
    # is exact zeros even where its rows hold data
    _close(tquant.grouped_linear(torch.from_numpy(x_routed).to(tdt),
                                 {"q": q, "s": s}, act), want, dt)
    full = tquant.large_m_gemm(torch.from_numpy(x).to(tdt), q, s, act)
    for j in (1, 3):
        assert torch.equal(full[j], torch.zeros_like(full[j]))


def test_active_none_is_every_group():
    rng = np.random.default_rng(5)
    _, jw = _weights(rng, (3, 32, 16))
    q = torch.from_numpy(np.array(jw["q"]))
    s = torch.from_numpy(np.array(jw["s"]))
    x = torch.from_numpy(rng.standard_normal((3, 20, 32)).astype(np.float32))
    every = torch.ones((3,), dtype=torch.int32)
    assert torch.equal(tquant.large_m_gemm(x, q, s),
                       tquant.large_m_gemm(x, q, s, every))


# -- the scheduler, from shapes only ------------------------------------------

SHAPES = [  # (groups, M, K, N): llama3-8b's projections and head at the
    # route's M, mixtral's experts, the registry's tiny widths, ragged edges
    (1, 9, 4096, 1024), (1, 16, 4096, 4096), (1, 64, 4096, 14336),
    (1, 100, 14336, 4096), (1, 512, 4096, 1024), (1, 512, 4096, 14336),
    (1, 2048, 4096, 4096), (1, 33, 4096, 128256), (8, 256, 4096, 14336),
    (8, 2048, 14336, 4096), (8, 17, 4096, 14336), (4, 40, 64, 256),
    (1, 300, 136, 48), (1, 1, 8, 16)]


@pytest.mark.parametrize("g,m,k,n", SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_schedule_covers_every_tile_and_kblock_once(g, m, k, n, sms):
    tile_m, splits, per, grid = tquant.large_m_config(g, m, k, n, sms)
    assert tile_m == (128 if m <= 128 else 256)
    nk = -(-k // tquant._LM_TILE_K)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < nk <= splits * per   # no empty split
    if splits > 1:
        assert per >= tquant._LM_MIN_KBLOCKS
    units = tquant.large_m_units(g, m, k, n, tile_m, splits, per)
    assert 1 <= grid <= min(len(units), sms)
    # the persistent walk: block b takes units b, b + grid, ...
    walked = [u for b in range(grid) for u in units[b::grid]]
    assert sorted(walked) == sorted(units) and len(walked) == len(units)
    cover = {}
    for gg, mt, nt, kb0, kb1 in units:
        assert kb0 < kb1
        cover.setdefault((gg, mt, nt), []).extend(range(kb0, kb1))
    tm = -(-m // tile_m)
    tn = -(-n // tquant._LM_TILE_N)
    assert sorted(cover) == [(a, b, c) for a in range(g) for b in range(tm)
                             for c in range(tn)]
    for kbs in cover.values():
        assert sorted(kbs) == list(range(nk))
    # the row tile runs fastest: neighbours share a weight tile
    if tm > 1 and len(units) > 1:
        assert units[0][2] == units[1][2] and units[0][1] != units[1][1]


def test_splits_only_where_tiles_leave_sms_idle():
    # few tiles split K to fill the card; many tiles run one split each
    assert tquant.large_m_config(1, 9, 4096, 1024, 132)[1] > 1
    assert tquant.large_m_config(1, 512, 4096, 14336, 132)[1] == 1
    assert tquant.large_m_config(8, 256, 4096, 14336, 132)[1] == 1
    assert tquant.large_m_config(1, 16, 4096, 128256, 132)[1] == 1


def _cuda_constants() -> dict:
    text = SRC.read_text()
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("tile_m", [128, 256])
def test_ring_fits_a_block_and_matches_the_source(tile_m):
    """Each tiling's shared memory, summed from the source's own constants
    (the TMA ring of x and int8 q tiles, the two widened bf16 tiles, an
    mbarrier pair a stage, 1024 bytes of alignment slack), fits the
    232,448 bytes a Hopper block may use; the host's tile and column
    widths are the source's."""
    text = SRC.read_text()
    c = _cuda_constants()
    assert (c["kBN"], c["kBK"]) == (tquant._LM_TILE_N, tquant._LM_TILE_K)
    assert "static constexpr int kBM = 64 * SLABS * kConsumers;" in text
    assert "static constexpr int kStages = SLABS == 1 ? 7 : 4;" in text
    assert "static_assert(kSmemBytes <= 232448" in text
    slabs = tile_m // (64 * c["kConsumers"])
    assert slabs in (1, 2) and tquant.large_m_tile_m(tile_m) == tile_m
    stages = 7 if slabs == 1 else 4
    smem = (stages * (tile_m * c["kBK"] * 2 + c["kBK"] * c["kBN"])
            + c["kBBuffers"] * c["kBK"] * c["kBN"] * 2 + 8 * 2 * stages
            + 1024)
    assert smem <= 232448
    # the consumer warpgroups and the producer warp; one block an SM, whose
    # 65,536 registers leave each thread room for a consumer's
    # accumulators (wgmma needs them and its descriptors in registers at
    # once); each consumer warp widens one 8-row k group of a q tile
    threads = c["kConsumers"] * 128 + 32
    assert 4 * c["kConsumers"] == c["kBK"] // 8
    regs = 65536 // threads // 8 * 8
    assert regs >= slabs * tquant._LM_TILE_N // 2 + 26


def test_tiles_meet_wgmma_shapes():
    # wgmma: 64 rows an instruction (a slab of a consumer warpgroup), N a
    # multiple of 8 up to 256, K 16 a bf16 instruction; the x stage row is
    # the 128-byte swizzle span and the int8 q row one 128-byte TMA box row;
    # a tile's rows are one TMA box (at most 256)
    c = _cuda_constants()
    for m in (1, 128, 129, 4096):
        tile_m = tquant.large_m_tile_m(m)
        assert tile_m % (c["kConsumers"] * 64) == 0 and tile_m <= 256
    assert tquant._LM_TILE_N % 8 == 0 and tquant._LM_TILE_N <= 256
    assert tquant._LM_TILE_K % 16 == 0
    assert tquant._LM_TILE_K * 2 == 128          # bf16 x row: 128 bytes
    assert tquant._LM_TILE_N == 128              # int8 q: one 128-byte box
    assert "m64n%dk16" % tquant._LM_TILE_N in SRC.read_text()


# -- the routes ---------------------------------------------------------------

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
    moe = types.SimpleNamespace(w8a16_moe_gemm=_Entry())
    large = types.SimpleNamespace(w8a16_large_m=_Entry())
    monkeypatch.setattr(tquant, "_lib", lambda: lib)
    monkeypatch.setattr(tquant, "_moe_lib", lambda: moe)
    monkeypatch.setattr(tquant, "_large_m_lib", lambda: large)
    monkeypatch.setattr(tquant, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    return types.SimpleNamespace(
        gemm=lib.w8a16_gemm.calls, dequant=lib.w8a16_dequant.calls,
        group=lib.w8a16_group.calls, moe=moe.w8a16_moe_gemm.calls,
        large=large.w8a16_large_m.calls)


def _qw(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tquant.quantize_int8(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)))


@pytest.mark.parametrize("m", [tquant.GEMV_MAX_M + 1, 32, 100, 512])
def test_bf16_past_the_switch_point_takes_the_new_kernel_once(entries, m):
    w = _qw((64, 48))
    before = tquant.LARGE_M_LAUNCHES
    y = tquant.linear(torch.zeros((m, 64), dtype=torch.bfloat16), w)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, 48)
    assert len(entries.large) == 1 and not entries.dequant
    assert not entries.gemm and not entries.group and not entries.moe
    assert tquant.LARGE_M_LAUNCHES == before + 1
    call = entries.large[0]
    config = tquant.large_m_config(1, m, 64, 48, 132)
    assert call[3] is None                      # dense: every group active
    assert call[6:14] == (1, m, 64, 48) + config
    # leading dimensions fold into M
    tquant.linear(torch.zeros((2, m, 64), dtype=torch.bfloat16), w)
    assert entries.large[1][6:10] == (1, 2 * m, 64, 48)


def test_decode_rows_keep_the_decode_kernel(entries):
    w = _qw((64, 48))
    tquant.linear(torch.zeros((tquant.GEMV_MAX_M, 64),
                              dtype=torch.bfloat16), w)
    assert len(entries.group) == 1 and not entries.large
    assert not entries.dequant and not entries.gemm


def test_grouped_bf16_is_one_launch_for_every_expert(entries):
    w = _qw((4, 64, 48))
    active = torch.tensor([3, 0, 1, 0], dtype=torch.int32)
    m = tquant.GROUPED_MAX_M + 1
    y = tquant.grouped_linear(torch.zeros((4, m, 64), dtype=torch.bfloat16),
                              w, active)
    assert tuple(y.shape) == (4, m, 48) and y.dtype == torch.bfloat16
    assert len(entries.large) == 1 and not entries.dequant
    assert not entries.moe and not entries.gemm and not entries.group
    call = entries.large[0]
    assert call[3] == active.data_ptr()
    assert call[6:10] == (4, m, 64, 48)
    # at decode rows the grouped decode kernel stays
    tquant.grouped_linear(torch.zeros((4, tquant.GROUPED_MAX_M, 64),
                                      dtype=torch.bfloat16), w, active)
    assert len(entries.moe) == 1 and len(entries.large) == 1


def test_f32_past_the_switch_point_takes_the_dequantize_route(entries):
    w = _qw((64, 48))
    tquant.linear(torch.zeros((40, 64)), w)
    assert len(entries.dequant) == 1 and not entries.large
    wg = _qw((4, 64, 48))
    tquant.grouped_linear(torch.zeros((4, 40, 64)), wg,
                          torch.ones((4,), dtype=torch.int32))
    assert len(entries.dequant) == 1 + 4 and not entries.large


def test_cpu_x_reaches_no_entry(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached a C entry point")
    monkeypatch.setattr(tquant, "_lib", refuse)
    monkeypatch.setattr(tquant, "_moe_lib", refuse)
    monkeypatch.setattr(tquant, "_large_m_lib", refuse)
    before = (tquant.KERNEL_LAUNCHES, tquant.DEQUANT_LAUNCHES,
              tquant.MOE_LAUNCHES, tquant.LARGE_M_LAUNCHES)
    w = _qw((64, 48))
    wg = _qw((4, 64, 48))
    for dt in (torch.float32, torch.bfloat16):
        for m in (3, 40, 512):
            tquant.linear(torch.zeros((m, 64), dtype=dt), w)
            tquant.grouped_linear(torch.zeros((4, m, 64), dtype=dt), wg,
                                  torch.ones((4,), dtype=torch.int32))
        tquant.large_m_gemm(torch.zeros((40, 64), dtype=dt), w["q"], w["s"])
    assert (tquant.KERNEL_LAUNCHES, tquant.DEQUANT_LAUNCHES,
            tquant.MOE_LAUNCHES, tquant.LARGE_M_LAUNCHES) == before


def test_cpu_x_against_a_cuda_weight_is_refused(monkeypatch):
    w = _qw((64, 48))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(
        lambda t: t is w["q"]))
    with pytest.raises(ValueError, match="CUDA"):
        tquant.large_m_gemm(torch.zeros((20, 64)), w["q"], w["s"])


# -- the argument checks ------------------------------------------------------

@pytest.mark.parametrize("bad", [
    "n_mod_16", "k_mod_8", "x_dtype", "q_dtype", "x_contiguous",
    "q_contiguous", "s_len", "active_shape", "active_dtype", "x_width",
    "groups", "device", "empty_m"])
def test_argument_checks(bad):
    g, m, k, n = 2, 20, 64, 48
    x = torch.zeros((g, m, k), dtype=torch.bfloat16)
    q = torch.zeros((g, k, n), dtype=torch.int8)
    s = torch.ones((g, 1, n))
    active = torch.ones((g,), dtype=torch.int32)
    tquant._check_large_m(x, q, s, active)      # the good case passes
    tquant._check_large_m(x, q, s, None)
    if bad == "n_mod_16":
        q, s = torch.zeros((g, k, 40), dtype=torch.int8), torch.ones((g, 40))
    elif bad == "k_mod_8":
        q = torch.zeros((g, 60, n), dtype=torch.int8)
        x = torch.zeros((g, m, 60), dtype=torch.bfloat16)
    elif bad == "x_dtype":
        x = x.float()
    elif bad == "q_dtype":
        q = q.float()
    elif bad == "x_contiguous":
        x = torch.zeros((g, k, m), dtype=torch.bfloat16).transpose(1, 2)
    elif bad == "q_contiguous":
        q = torch.zeros((g, n, k), dtype=torch.int8).transpose(1, 2)
    elif bad == "s_len":
        s = torch.ones((g, 1, n - 1))
    elif bad == "active_shape":
        active = torch.ones((g + 1,), dtype=torch.int32)
    elif bad == "active_dtype":
        active = torch.ones((g,), dtype=torch.int64)
    elif bad == "x_width":
        x = torch.zeros((g, m, k - 8), dtype=torch.bfloat16)
    elif bad == "groups":
        x = torch.zeros((g + 1, m, k), dtype=torch.bfloat16)
    elif bad == "device":
        x = torch.zeros((g, m, k), dtype=torch.bfloat16, device="meta")
    elif bad == "empty_m":
        x = torch.zeros((g, 0, k), dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        tquant._check_large_m(x, q, s, active)


def test_misaligned_x_is_refused():
    buf = torch.zeros((20 * 64 + 1,), dtype=torch.bfloat16)
    x = buf[1:].view(1, 20, 64)                  # 2 bytes past the start
    with pytest.raises(ValueError, match="aligned"):
        tquant._check_large_m(x, torch.zeros((1, 64, 48), dtype=torch.int8),
                              torch.ones((1, 48)), None)
