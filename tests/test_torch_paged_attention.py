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
                               "ragged_decode_attention"]
    path = build.library_path("ragged_decode_attention")
    assert path.parent == build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "dynamo_tpu_torch")
    assert path == build.library_path("ragged_decode_attention")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
