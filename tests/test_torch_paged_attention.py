"""The port's ragged decode attention (dynamo_tpu_torch/ops/paged_attention.py)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy-seeded inputs.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
chip_smoke.py. Geometries follow tests/test_ragged_kernel.py:_geometry,
with recycled page tails poisoned with NaN and an empty (lens = 0) row.

Tolerances: the f32 flash state (acc, m, l) within 1e-5, since both sides
compute in f32 from the same inputs and differ only in summation order;
outputs cast to bf16 within 1e-2 (one bf16 step is 2**-8 of the value).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

TOL_F32 = 1e-5
TOL_BF16_OUT = 1e-2


def _geometry(hd, bf16, seed):
    """Ragged rows over a shared page pool, one empty row, and NaN in every
    page slot at or past its row's length."""
    rng = np.random.default_rng(seed)
    s, h, hkv, p, ps, pb, nl = 4, 8, 4, 20, 8, 4, 2
    if hd == 128:
        h, hkv = 4, 2  # keep interpret-mode runtime down at the wide head
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    k = rng.standard_normal((nl, hkv, p, ps, hd)).astype(np.float32)
    v = rng.standard_normal((nl, hkv, p, ps, hd)).astype(np.float32)
    k_new = rng.standard_normal((s, hkv, hd)).astype(np.float32)
    v_new = rng.standard_normal((s, hkv, hd)).astype(np.float32)
    pt = (np.arange(s * pb).reshape(s, pb) + 1).astype(np.int32)
    lens = np.array([5, 0, 17, 32], np.int32)
    for i in range(s):
        for t in range(lens[i], pb * ps):
            k[:, :, pt[i, t // ps], t % ps] = np.nan
            v[:, :, pt[i, t // ps], t % ps] = np.nan
    arrs = [q, k, v, k_new, v_new]
    if bf16:
        # round once through bf16 so both packages see the same values
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return (*arrs, pt, lens)


def _inputs(arrs, bf16):
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(np.array(a)).to(tdt) for a in arrs])


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_prefix_mode_matches_pallas(hd, bf16):
    q, k, v, k_new, v_new, pt, lens = _geometry(hd, bf16, seed=hd)
    (jq, jk, jv, jkn, jvn), (tq, tk, tv, tkn, tvn) = _inputs(
        [q, k, v, k_new, v_new], bf16)
    layer = 1
    jacc, jm, jl = jpa.decode_paged_attention_prefix(
        jq, jk, jv, jnp.asarray([layer], jnp.int32), jnp.asarray(pt),
        jnp.asarray(lens), interpret=True)
    tacc, tm, tl = tpa.decode_paged_attention_prefix(
        tq, tk, tv, layer, torch.from_numpy(pt), torch.from_numpy(lens))
    # every row, the empty one too: it walks one masked page, so it keeps
    # m = -1e30 with l = ps and acc = 0, as the TPU kernel's
    for got, want in ((tacc, jacc), (tm, jm), (tl, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_F32, atol=TOL_F32)
    assert bool((tm[1] == tpa.NEG_INF).all())
    assert bool((tl[1] == k.shape[3]).all()) and not tacc[1].any()
    # so the self-term fold returns exactly the new token's value row; all
    # rows through combine_self_attention
    jout = np.asarray(jpa.combine_self_attention(jq, jkn, jvn, jacc, jm, jl),
                      np.float32)
    tout = tpa.combine_self_attention(tq, tkn, tvn, tacc, tm, tl).float()
    tol = TOL_BF16_OUT if bf16 else TOL_F32
    np.testing.assert_allclose(tout.numpy(), jout, rtol=tol, atol=tol)
    g = q.shape[1] // k.shape[1]
    np.testing.assert_allclose(tout.numpy()[1],
                               np.repeat(v_new[1], g, axis=0),
                               rtol=tol, atol=tol)
    assert np.isfinite(tout.numpy()).all()


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_inclusive_mode_matches_pallas(hd, bf16):
    q, k, v, _, _, pt, lens = _geometry(hd, bf16, seed=100 + hd)
    (jq, jk, jv), (tq, tk, tv) = _inputs([q, k, v], bf16)
    want = np.asarray(jpa.decode_paged_attention(
        jq, jk[0], jv[0], jnp.asarray(pt), jnp.asarray(lens),
        interpret=True), np.float32)
    got = tpa.decode_paged_attention(tq, tk[0], tv[0], torch.from_numpy(pt),
                                     torch.from_numpy(lens)).float().numpy()
    assert got.dtype == np.float32 and got.shape == q.shape
    ok = lens > 0          # kv_len 0 rows are padding (output ignored)
    tol = TOL_BF16_OUT if bf16 else TOL_F32
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=tol)


def test_plain_version_is_the_cpu_path():
    """On CPU tensors the dispatcher is exactly the plain version and does
    not count a kernel launch."""
    q, k, v, _, _, pt, lens = _geometry(64, False, seed=7)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1,
            torch.from_numpy(pt), torch.from_numpy(lens))
    before = tpa.KERNEL_LAUNCHES
    for a, b in zip(tpa.ragged_decode_attention(*args),
                    tpa._ragged_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tpa.KERNEL_LAUNCHES == before


def test_cpu_query_with_cuda_tables_is_refused(monkeypatch):
    q, k, v, _, _, pt, lens = _geometry(64, False, seed=8)
    fake = torch.from_numpy(pt)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(
        lambda t: t is fake))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.ragged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0,
            fake, torch.from_numpy(lens))


@pytest.mark.parametrize("bad", ["dtype", "table_dtype", "head_dim",
                                 "group", "layer", "rows", "contiguous"])
def test_kernel_argument_checks(bad):
    """The CUDA wrapper's checks run before any launch; they raise on what
    the kernel does not take."""
    s, h, hkv, hd = 2, 8, 2, 64
    q = torch.zeros((s, h, hd))
    k = torch.zeros((2, hkv, 4, 8, hd))
    pt = torch.zeros((s, 2), dtype=torch.int32)
    lens = torch.zeros((s,), dtype=torch.int32)
    layer = 0
    if bad == "dtype":
        q = q.half()
    elif bad == "table_dtype":
        pt = pt.long()
    elif bad == "head_dim":
        q, k = torch.zeros((s, h, 48)), torch.zeros((2, hkv, 4, 8, 48))
    elif bad == "group":
        q = torch.zeros((s, 20 * hkv, hd))
    elif bad == "layer":
        layer = 2
    elif bad == "rows":
        lens = torch.zeros((s + 1,), dtype=torch.int32)
    elif bad == "contiguous":
        q = torch.zeros((s, hd, h)).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tpa._check_kernel_args(q, k, k, layer, pt, lens)
    tpa._check_kernel_args(torch.zeros((s, h, hd)), torch.zeros(
        (2, hkv, 4, 8, hd)), torch.zeros((2, hkv, 4, 8, hd)), 0,
        torch.zeros((s, 2), dtype=torch.int32),
        torch.zeros((s,), dtype=torch.int32))


def test_build_is_keyed_on_the_source():
    """Every kernel builds from csrc/ into build/dynamo_tpu_torch/, under a
    name that changes with the source or the flags."""
    assert build.sources() == ["legacy_decode_attention",
                               "ragged_decode_attention", "w8a16_gemm"]
    path = build.library_path("ragged_decode_attention")
    assert path.parent == build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "dynamo_tpu_torch")
    assert path == build.library_path("ragged_decode_attention")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


# -- the kernel's split-KV schedule --------------------------------------------

def _split_geometry(hd, bf16, seed):
    """Seven rows of six disjoint pages (ps 8): lens 0 and 1, on the page
    and split boundaries of 1- and 3-page splits and one past them, and the
    full table; NaN in every slot at or past a row's length."""
    rng = np.random.default_rng(seed)
    s, h, hkv, ps, pb, nl = 7, 8, 4, 8, 6, 2
    if hd == 128:
        h, hkv = 4, 2  # keep interpret-mode runtime down at the wide head
    p = s * pb + 1
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    k = rng.standard_normal((nl, hkv, p, ps, hd)).astype(np.float32)
    v = rng.standard_normal((nl, hkv, p, ps, hd)).astype(np.float32)
    pt = (rng.permutation(s * pb) + 1).reshape(s, pb).astype(np.int32)
    lens = np.array([0, 1, 8, 9, 24, 25, 48], np.int32)
    for i in range(s):
        for t in range(lens[i], pb * ps):
            k[:, :, pt[i, t // ps], t % ps] = np.nan
            v[:, :, pt[i, t // ps], t % ps] = np.nan
    arrs = [q, k, v]
    if bf16:
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return (*arrs, pt, lens)


@pytest.mark.parametrize("pps", [1, 3])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_split_merge_matches_unsplit_and_pallas(hd, bf16, pps):
    """The kernel's split rules (neutral state past the walked pages, the
    empty row's one masked page) merged back equal the unsplit plain version
    and the Pallas kernel in interpret mode, every row's f32 state."""
    q, k, v, pt, lens = _split_geometry(hd, bf16, seed=200 + hd + pps)
    (jq, jk, jv), (tq, tk, tv) = _inputs([q, k, v], bf16)
    layer, ps = 1, k.shape[3]
    tpt, tlens = torch.from_numpy(pt), torch.from_numpy(lens)
    parts = tpa._ragged_split_plain(tq, tk, tv, layer, tpt, tlens, pps)
    assert parts[0].shape[0] == -(-pt.shape[1] // pps)
    # splits past a row's walked pages hold the neutral state
    n_pages = np.maximum(-(-lens // ps), 1)
    for i in range(parts[0].shape[0]):
        idle = torch.from_numpy(i * pps >= n_pages)
        assert bool((parts[1][i][idle] == tpa.NEG_INF).all())
        assert not parts[2][i][idle].any() and not parts[0][i][idle].any()
    got = tpa._merge_splits_plain(*parts)
    unsplit = tpa._ragged_plain(tq, tk, tv, layer, tpt, tlens)
    jacc, jm, jl = jpa.decode_paged_attention_prefix(
        jq, jk, jv, jnp.asarray([layer], jnp.int32), jnp.asarray(pt),
        jnp.asarray(lens), interpret=True)
    for a, b, c in zip(got, unsplit, (jacc, jm, jl)):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL_F32,
                                   atol=TOL_F32)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=TOL_F32,
                                   atol=TOL_F32)
    # the empty row merges to exactly m = -1e30, l = ps, acc = 0
    assert bool((got[1][0] == tpa.NEG_INF).all())
    assert bool((got[2][0] == ps).all()) and not got[0][0].any()


@pytest.mark.parametrize("s,hkv,pb,sms", [
    (8, 8, 12, 132),     # the main path's decode batch
    (8, 8, 32, 132),     # the same at the full 2048-token context
    (1, 8, 64, 132),     # one row of 4096 tokens
    (32, 8, 8, 132), (512, 8, 32, 132), (1, 1, 1, 132), (3, 2, 7, 1),
    (4, 8, 5, 78),
])
def test_pages_per_split_covers_every_page(s, hkv, pb, sms):
    """The host's split count: from shapes alone, at least one page a
    split, every page of Pb in exactly one split, never an empty grid, and
    at least half the blocks it aims for."""
    pps = tpa._pages_per_split(s, hkv, pb, sms)
    splits = -(-pb // pps)
    assert 1 <= pps <= pb and splits >= 1
    assert (splits - 1) * pps < pb <= splits * pps
    want = min(pb, -(-tpa._BLOCKS_PER_SM * sms // (s * hkv)))
    assert 2 * splits >= want
    assert pps == tpa._pages_per_split(s, hkv, pb, sms)


def test_pages_per_split_at_the_main_path_shapes():
    assert tpa._pages_per_split(8, 8, 12, 132) == 2     # 6 splits
    assert tpa._pages_per_split(8, 8, 32, 132) == 4     # 8 splits
    assert tpa._pages_per_split(1, 8, 64, 132) == 1     # 64 splits
    assert tpa._pages_per_split(512, 8, 32, 132) == 32  # one split


def test_ring_fits_shared_memory():
    """Every supported geometry's split block fits the 227 KB a block may
    opt in to; the wrapper refuses a page table wider than that allows."""
    for qdt, cdt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.int8),
                     (torch.bfloat16, torch.int8)):
        for hd in (32, 64, 128):
            assert tpa._ring_smem_bytes(qdt, cdt, hd, 1024) <= tpa._SMEM_MAX
    # bf16 at hd 128: 3 stages of 64 rows of K and V, 272 bytes a row; 8
    # warps' probabilities and rescale factors; q's A fragments; 12 page ids
    assert tpa._ring_smem_bytes(torch.bfloat16, torch.bfloat16, 128, 12) \
        == 3 * 2 * 64 * 272 + 8 * 8 * 8 * 4 + 8 * 8 * 4 + 128 * 16 + 48
    q = torch.zeros((1, 8, 128))
    k = torch.zeros((1, 8, 2, 8, 128))
    wide = torch.zeros((1, 40000), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        tpa._check_kernel_args(q, k, k, 0, wide,
                               torch.zeros((1,), dtype=torch.int32))
