"""The port's legacy decode kernel (dynamo_tpu_torch/ops/paged_attention_
oracle.py) and its decode A/B (dynamo_tpu_torch/bench.run_decode_kernel_ab)
against the JAX package's, on the same numpy-seeded inputs.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is held against that plain version, and against the ragged kernel,
on the card by chip_smoke.py. The kernel's cluster schedule (block r of a
row's cluster walks pages r, r + C, ...; the cluster merges the blocks'
partials) is restated in PyTorch (_cluster_partials_plain,
_cluster_merge_plain) and held here against the plain version and the JAX
legacy kernel in interpret mode, with the host's shapes-only cluster size,
stage size and shared-memory budget.

The parity matrix is tests/test_ragged_kernel.py's (:41-83): head dims
32 / 64 (the JAX package's lane-packed kernel) and 128 (its direct kernel)
x f32 / bf16 / int8 caches. Tolerances: normalised f32 outputs within 1e-5
(f32 on both sides, sums in other orders), bf16 outputs within 1e-2 (one
bf16 step is 2**-8 of the value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampler as jsampler
from dynamo_tpu.ops.paged_attention_oracle import (
    decode_paged_attention_legacy as jlegacy,
)
from dynamo_tpu_torch import bench as tbench
from dynamo_tpu_torch.engine.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.ops import paged_attention_oracle as tleg

torch.set_num_threads(1)

TOL_F32 = 1e-5
TOL_BF16 = 1e-2
KINDS = ["f32", "bf16", "int8"]


def _geometry(hd, kind, seed):
    """tests/test_ragged_kernel.py:_geometry: ragged lengths over pages
    spread through the pool; int8 caches with per-row scales."""
    rng = np.random.default_rng(seed)
    s, h, hkv, p, ps, pb = 3, 8, 4, 16, 8, 4
    if hd == 128:
        h, hkv = 4, 2  # keep interpret-mode runtime down at the wide head
    q = rng.standard_normal((s, h, hd)).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-127, 128, (hkv, p, ps, hd), dtype=np.int8)
        v = rng.integers(-127, 128, (hkv, p, ps, hd), dtype=np.int8)
        ks = rng.uniform(0.01, 0.05, (hkv, p, ps)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (hkv, p, ps)).astype(np.float32)
    else:
        k = rng.standard_normal((hkv, p, ps, hd)).astype(np.float32)
        v = rng.standard_normal((hkv, p, ps, hd)).astype(np.float32)
        ks = vs = None
    pt = ((np.arange(s * pb).reshape(s, pb) * 7) % p).astype(np.int32)
    lens = np.array([5, 17, 32], np.int32)
    return q, k, v, ks, vs, pt, lens


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(arrs, kind):
    """(jax arrays, torch tensors); bf16 rounds q/k/v in both packages."""
    jx, tx = [], []
    for a in arrs:
        if a is None:
            jx.append(None)
            tx.append(None)
            continue
        j, t = jnp.asarray(a), _t(a)
        if kind == "bf16" and a.dtype == np.float32:
            j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        jx.append(j)
        tx.append(t)
    return jx, tx


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_legacy_matches_pallas_and_unified(hd, kind):
    """The plain legacy version == the JAX legacy kernels in interpret mode
    (packed at hd 32/64, direct at 128), and the port's unified inclusive
    view == the port's legacy kernel on the same inputs."""
    q, k, v, ks, vs, pt, lens = _geometry(hd, kind, seed=hd)
    (jq, jk, jv, jks, jvs, jpt, jlens), (tq, tk, tv, tks, tvs, tpt, tlens) = \
        _both([q, k, v, ks, vs, pt, lens], kind)
    kw = {} if ks is None else dict(k_scale=jks, v_scale=jvs)
    want = jlegacy(jq, jk, jv, jpt, jlens, interpret=True, **kw)
    got = tleg.decode_paged_attention_legacy(tq, tk, tv, tpt, tlens, tks,
                                             tvs)
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    tol = TOL_BF16 if kind == "bf16" else TOL_F32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    unified = tpa.decode_paged_attention(tq, tk, tv, tpt, tlens, tks, tvs)
    np.testing.assert_allclose(unified.float().numpy(),
                               got.float().numpy(), rtol=tol, atol=tol)


def test_tails_and_zero_lengths():
    """kv_lens 0 is clamped to 1; tokens past the length have K, V and
    their scales selected to zero, so NaN or inf there changes nothing."""
    q, k, v, ks, vs, pt, lens = _geometry(64, "int8", seed=3)
    lens = np.array([0, 17, 32], np.int32)
    t = _t
    clean = tleg.decode_paged_attention_legacy(t(q), t(k), t(v), t(pt),
                                               t(lens), t(ks), t(vs))
    one = tleg.decode_paged_attention_legacy(
        t(q), t(k), t(v), t(pt), t(np.array([1, 17, 32], np.int32)), t(ks),
        t(vs))
    torch.testing.assert_close(clean, one, rtol=0, atol=0)
    ks2, vs2 = ks.copy(), vs.copy()
    for i, n in enumerate([1, 17, 32]):
        for tok in range(n, 32):
            ks2[:, pt[i, tok // 8], tok % 8] = np.nan
            vs2[:, pt[i, tok // 8], tok % 8] = np.inf
    dirty = tleg.decode_paged_attention_legacy(
        t(q), t(k), t(v), t(pt), t(lens), t(ks2), t(vs2))
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(clean, dirty, rtol=0, atol=0)


def test_plain_version_is_the_cpu_path():
    q, k, v, _, _, pt, lens = _geometry(64, "f32", seed=7)
    args = [torch.from_numpy(a) for a in (q, k, v, pt, lens)]
    before = tleg.KERNEL_LAUNCHES
    torch.testing.assert_close(tleg.decode_paged_attention_legacy(*args),
                               tleg._legacy_plain(*args), rtol=0, atol=0)
    assert tleg.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "table_dtype", "head_dim",
                                 "group", "rows", "contiguous", "layout",
                                 "scale_shape", "scales_without_int8",
                                 "shared_memory", "page_size",
                                 "no_pages"])
def test_legacy_kernel_argument_checks(bad):
    """The CUDA wrapper's checks run before any launch; they raise on what
    the kernel does not take."""
    s, h, hkv, hd, ps = 2, 8, 2, 64, 8
    q = torch.zeros((s, h, hd))
    k = torch.zeros((hkv, 4, ps, hd))
    ks = vs = None
    pt = torch.zeros((s, 2), dtype=torch.int32)
    lens = torch.ones((s,), dtype=torch.int32)
    if bad == "dtype":
        q = q.half()
    elif bad == "table_dtype":
        lens = lens.long()
    elif bad == "head_dim":
        q, k = torch.zeros((s, h, 48)), torch.zeros((hkv, 4, ps, 48))
    elif bad == "group":
        q = torch.zeros((s, 20 * hkv, hd))
    elif bad == "rows":
        pt = torch.zeros((s + 1, 2), dtype=torch.int32)
    elif bad == "contiguous":
        q = torch.zeros((s, hd, h)).transpose(1, 2)
    elif bad == "layout":
        k = torch.zeros((1, hkv, 4, ps, hd))
    elif bad == "scale_shape":
        k = k.to(torch.int8)
        ks, vs = torch.zeros((hkv, 4, ps + 1)), torch.zeros((hkv, 4, ps))
    elif bad == "scales_without_int8":
        ks, vs = torch.zeros((hkv, 4, ps)), torch.zeros((hkv, 4, ps))
    elif bad == "shared_memory":
        # two f32 stages of 120 tokens (120 does not halve to a multiple of
        # 8) at hd 128, K and V: 240 KB
        q, k = torch.zeros((s, h, 128)), torch.zeros((hkv, 4, 120, 128))
    elif bad == "page_size":
        k = torch.zeros((hkv, 4, 12, hd))  # not a multiple of 8 tokens
    elif bad == "no_pages":
        pt = torch.zeros((s, 0), dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        tleg._check_kernel_args(q, k, k, pt, lens, ks, vs)
    pt = torch.zeros((s, 2), dtype=torch.int32)
    lens = torch.ones((s,), dtype=torch.int32)
    tleg._check_kernel_args(torch.zeros((s, h, hd)),
                            torch.zeros((hkv, 4, ps, hd)),
                            torch.zeros((hkv, 4, ps, hd)), pt, lens)
    # f32 pages of 128 tokens at hd 128 fit as 32-token stages
    tleg._check_kernel_args(torch.zeros((s, h, 128)),
                            torch.zeros((hkv, 4, 128, 128)),
                            torch.zeros((hkv, 4, 128, 128)), pt, lens)
    # an int8 cache at ps 128, hd 128 fits (64 KB of pages)
    tleg._check_kernel_args(
        torch.zeros((s, h, 128), dtype=torch.bfloat16),
        torch.zeros((hkv, 4, 128, 128), dtype=torch.int8),
        torch.zeros((hkv, 4, 128, 128), dtype=torch.int8), pt, lens,
        torch.zeros((hkv, 4, 128)), torch.zeros((hkv, 4, 128)))


def test_decode_kernel_ab_matches_the_jax_sampler():
    """The port's A/B at the tiny geometry: the inputs are the JAX phase's
    (default_rng(18)), the three arms sample identical tokens, and the
    legacy arm's tokens equal the JAX sampler on the JAX legacy kernel's
    output."""
    tcfg = TModelConfig(dtype="float32")
    kw = dict(page_size=16)
    res = tbench.run_decode_kernel_ab(tcfg, kw, rows=8, reps=1,
                                      logf=lambda *a: None, device="cpu")
    assert res["tokens_identical"] and res["interpret"]
    for key in ("rows", "heads", "kv_heads", "head_dim", "page_size",
                "legacy_step_ms", "unified_step_ms", "unified_fused_step_ms",
                "unified_legacy_step_ratio", "fused_unfused_step_ratio"):
        assert key in res
    a = tbench.decode_ab_inputs(tcfg, 8, kw["page_size"])
    s, h, hd = a["q"].shape
    attn = jlegacy(*(jnp.asarray(a[n]) for n in ("q", "k", "v", "pt",
                                                 "lens")), interpret=True)
    logits = attn.reshape(s, h * hd) @ jnp.asarray(a["w_head"])
    keys = jsampler.make_keys(jnp.arange(s, dtype=jnp.int32),
                              jnp.zeros((s,), jnp.int32))
    want = jsampler.sample(logits, jnp.asarray(a["temp"]),
                           jnp.asarray(a["top_k"]), jnp.asarray(a["top_p"]),
                           keys)
    assert res["tokens"]["legacy"] == np.asarray(jax.device_get(want)).tolist()
    # the same draws as the JAX phase: its first draw is q
    rng = np.random.default_rng(18)
    np.testing.assert_array_equal(
        a["q"], rng.standard_normal(a["q"].shape).astype(np.float32))


def test_build_knows_the_legacy_source():
    """The legacy source builds beside the ragged one (the list itself is
    checked in tests/test_torch_paged_attention.py)."""
    assert "legacy_decode_attention" in build.sources()
    assert build.library_path("legacy_decode_attention").name.startswith(
        "legacy_decode_attention-")


# -- the kernel's cluster schedule --------------------------------------------

PB_CASES = [1, 3, 4, 12, 32]
GQA = [1, 4, 8]


def _cluster_geometry(hd, kind, pb, g, seed, poison=True):
    """Five rows of pb disjoint pages (ps 8, 2 kv heads, GQA group g): lens
    0 (clamped to 1), 1, ps, ps + 1 and the full table (clamped to Pb*ps),
    so short rows leave whole blocks of the cluster past the length. With
    `poison`, every slot at or past a row's clamped length holds NaN (K, V)
    or, for int8, garbage values with NaN (k) / inf (v) scales."""
    rng = np.random.default_rng(seed)
    s, hkv, ps = 5, 2, 8
    p = s * pb + 1
    q = rng.standard_normal((s, hkv * g, hd)).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-127, 128, (hkv, p, ps, hd), dtype=np.int8)
        v = rng.integers(-127, 128, (hkv, p, ps, hd), dtype=np.int8)
        ks = rng.uniform(0.01, 0.05, (hkv, p, ps)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (hkv, p, ps)).astype(np.float32)
    else:
        k = rng.standard_normal((hkv, p, ps, hd)).astype(np.float32)
        v = rng.standard_normal((hkv, p, ps, hd)).astype(np.float32)
        ks = vs = None
    pt = (rng.permutation(s * pb) + 1).reshape(s, pb).astype(np.int32)
    lens = np.array([0, 1, ps, ps + 1, pb * ps], np.int32)
    if poison:
        for i in range(s):
            for t in range(max(int(lens[i]), 1), pb * ps):
                page, slot = pt[i, t // ps], t % ps
                if kind == "int8":
                    ks[:, page, slot], vs[:, page, slot] = np.nan, np.inf
                else:
                    k[:, page, slot] = v[:, page, slot] = np.nan
    return q, k, v, ks, vs, pt, lens


def _emulated(tq, tk, tv, tpt, tlens, tks, tvs):
    parts = tleg._cluster_partials_plain(tq, tk, tv, tpt, tlens, tks, tvs)
    return tleg._cluster_merge_plain(*parts, tq.dtype), parts


@pytest.mark.parametrize("pb", PB_CASES)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_cluster_schedule_matches_plain(kind, hd, pb):
    """The cluster's per-block partials merged as the cluster merges them
    equal the plain version (GQA 1, 4 and 8 across the Pb cases), with NaN
    and inf in every tail; blocks whose pages all lie past the length hold
    the neutral state m = -1e30, l = 0, acc = 0."""
    g = GQA[PB_CASES.index(pb) % 3]
    q, k, v, ks, vs, pt, lens = _cluster_geometry(hd, kind, pb, g,
                                                  seed=hd + pb)
    _, (tq, tk, tv, tks, tvs, tpt, tlens) = _both(
        [q, k, v, ks, vs, pt, lens], kind)
    got, (acc, m, l) = _emulated(tq, tk, tv, tpt, tlens, tks, tvs)
    want = tleg._legacy_plain(tq, tk, tv, tpt, torch.clamp(tlens, min=1),
                              tks, tvs)
    assert got.dtype == tq.dtype and torch.isfinite(got).all()
    tol = TOL_BF16 if kind == "bf16" else TOL_F32
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)
    c, ps = tleg._cluster_size(pb), k.shape[2]
    assert acc.shape[0] == c
    n_pages = -(-np.clip(lens, 1, pb * ps) // ps)
    for r in range(c):
        idle = torch.from_numpy(r >= n_pages)
        assert bool((m[r][idle] == tleg.NEG_INF).all())
        assert not l[r][idle].any() and not acc[r][idle].any()
        assert torch.isfinite(acc[r]).all() and torch.isfinite(l[r]).all()


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_cluster_schedule_matches_pallas(kind, hd):
    """The emulated cluster schedule == the JAX legacy kernel in interpret
    mode (packed at hd 32/64, direct at 128) at Pb 12 (clusters of 8, so
    the short rows' clusters have idle blocks), on clean tails (the TPU
    kernels multiply a stale scale by p = 0) and lens of at least 1."""
    q, k, v, ks, vs, pt, lens = _cluster_geometry(hd, kind, 12, 4,
                                                  seed=50 + hd, poison=False)
    lens = np.maximum(lens, 1)
    (jq, jk, jv, jks, jvs, jpt, jlens), (tq, tk, tv, tks, tvs, tpt, tlens) = \
        _both([q, k, v, ks, vs, pt, lens], kind)
    kw = {} if ks is None else dict(k_scale=jks, v_scale=jvs)
    want = jlegacy(jq, jk, jv, jpt, jlens, interpret=True, **kw)
    got, _ = _emulated(tq, tk, tv, tpt, tlens, tks, tvs)
    tol = TOL_BF16 if kind == "bf16" else TOL_F32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("pb,c", [(1, 1), (3, 3), (4, 4), (8, 8), (12, 8),
                                  (32, 8), (64, 8)])
def test_cluster_size_from_shapes(pb, c):
    """One block a page up to the portable cluster of 8; every page of a
    row belongs to exactly one block (pages r, r + C, ...)."""
    assert tleg._cluster_size(pb) == c
    owned = sorted(p for r in range(c) for p in range(r, pb, c))
    assert owned == list(range(pb))


@pytest.mark.parametrize("ps,hd,esz,ct", [
    (64, 128, 4, 32),    # f32 at hd 128: half-page stages of 32 KB
    (128, 128, 4, 32),
    (64, 128, 2, 64),    # bf16: whole pages of 32 KB
    (64, 128, 1, 64),    # int8: whole pages of 16 KB
    (64, 64, 4, 64),
    (8, 128, 4, 8),      # a small page is one stage
    (120, 128, 4, 120),  # 60 is no multiple of 16 tokens: no halving
])
def test_stage_tokens(ps, hd, esz, ct):
    assert tleg._stage_tokens(ps, hd, esz) == ct
    assert ps % ct == 0 and ct % 8 == 0


def test_shared_memory_budget():
    """_smem_bytes is the .cu's Layout: 128 bytes of barriers, the ring
    (two stages, at least the 4 warps' f32 states), the partials gathered
    from the cluster, the warps' probabilities, rescale factors and (m, l),
    the page ids. f32 pages at hd 128 fit 3 blocks an SM."""
    # f32, hd 128, ps 64, Pb 4: two 32-token stages of K and V; the
    # gathered acc: 8 x 128 / 128 + 7 chunks of 128 f32, (m, l) 8 x 8 each
    ring = 2 * 2 * 32 * 128 * 4
    gather = (8 + 7) * 128 * 4 + 2 * 8 * 8 * 4
    want = (128 + ring + gather + 4 * 8 * 8 * 4 + 4 * 8 * 4 + 2 * 4 * 8 * 4
            + 16)
    assert tleg._smem_bytes(4, 128, 64, 4) == want == 75280
    assert 3 * (want + 1024) <= 233472   # 228 KB an SM, 1 KB each reserved
    # int8 stages carry their scale rows; a small ring still holds the
    # warps' states (4 x 8 x 128 f32)
    assert tleg._smem_bytes(1, 128, 8, 1) == (
        128 + 4 * 8 * 128 * 4 + gather + 1024 + 128 + 256 + 16)
    # page ids: ceil(Pb / 8) ints, in 16-byte units
    assert tleg._smem_bytes(4, 64, 64, 40) - tleg._smem_bytes(4, 64, 64, 8) \
        == 32 - 16
    for esz in (4, 2, 1):
        for hd in (32, 64, 128):
            for ps in (8, 16, 64, 128):
                assert tleg._smem_bytes(esz, hd, ps, 64) <= tleg._SMEM_MAX
