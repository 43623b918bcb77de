"""The port's paged attention (plain version and two-tier composition)
against the reference on the same numpy inputs, on the CPU.

The reference side runs the Pallas kernel in interpret mode and its
jnp oracles; the port side runs `repro_torch.kernels.ref` and
`repro_torch.kernels.ops`. Tolerance: atol 1e-5 in float32 (the two
frameworks sum in different orders).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ATOL = 1e-5

PAGED_SHAPES = [
    # (B, KH, G, HD, P, T, N) — the shapes of tests/test_kernels.py
    (1, 1, 1, 64, 4, 16, 4),
    (2, 4, 2, 128, 8, 16, 6),
    (2, 2, 8, 128, 16, 16, 16),
    (1, 8, 1, 64, 8, 16, 8),
    (3, 2, 5, 128, 8, 16, 5),
]


def _rand_paged(rng, B, KH, G, HD, P, T, N):
    q = rng.standard_normal((B, KH, G, HD)).astype(np.float32)
    kp = rng.standard_normal((B, P, T, KH, HD)).astype(np.float32)
    vp = rng.standard_normal((B, P, T, KH, HD)).astype(np.float32)
    pl = rng.integers(-1, P, (B, N)).astype(np.int32)
    pv = rng.integers(0, T + 1, (B, N)).astype(np.int32)
    return q, kp, vp, pl, pv


def _cases():
    """name -> numpy inputs (q, k_pool, v_pool, page_list, page_valid)."""
    cases = {}
    for shape in PAGED_SHAPES:
        rng = np.random.default_rng(sum(shape))
        cases[f"holes{shape}"] = _rand_paged(rng, *shape)
    rng = np.random.default_rng(0)
    q, kp, vp, _, _ = _rand_paged(rng, 2, 2, 2, 64, 4, 16, 4)
    cases["all_holes"] = (q, kp, vp, np.full((2, 4), -1, np.int32),
                          np.zeros((2, 4), np.int32))
    rng = np.random.default_rng(5)
    B, KH, G, HD, P, T = 2, 2, 2, 32, 8, 16
    q, kp, vp, _, _ = _rand_paged(rng, B, KH, G, HD, P, T, P)
    perm = np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32)
    valid = rng.integers(1, T + 1, (B, P)).astype(np.int32)
    perm[0, 3] = -1                                   # one hole
    cases["permuted"] = (q, kp, vp, perm, valid)
    return cases


CASES = _cases()


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_paged():
    """The Pallas kernel (interpret mode) on every case, computed once."""
    out = {}
    for name, (q, kp, vp, pl, pv) in CASES.items():
        res = paged_attention(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(pl),
                              jnp.asarray(pv), interpret=True)
        out[name] = [np.asarray(x) for x in res]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_attention_ref_matches_pallas_kernel(jax_paged, name):
    got = tref.paged_attention_ref(*_t(*CASES[name]))
    for g, w, what in zip(got, jax_paged[name], ("out", "m", "l", "lse")):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=1e-5,
                                   err_msg=what)


def test_all_holes_are_empty(jax_paged):
    out, m, l, lse = tref.paged_attention_ref(*_t(*CASES["all_holes"]))
    assert bool((l == 0).all()) and bool((out == 0).all())
    assert bool((m == tref.NEG_INF).all()) and bool((lse == tref.NEG_INF).all())


def _identity_lists(valid):
    P = valid.shape[1]
    return np.where(valid > 0, np.arange(P, dtype=np.int32)[None],
                    np.int32(-1)).astype(np.int32)


def test_pool_attention_matches_reference():
    rng = np.random.default_rng(1)
    B, KH, G, HD, P, T = 2, 4, 2, 64, 8, 16
    q, kp, vp, _, _ = _rand_paged(rng, B, KH, G, HD, P, T, P)
    valid = rng.integers(0, T + 1, (B, P)).astype(np.int32)
    want = jref.pool_attention_ref(*[jnp.asarray(a)
                                     for a in (q, kp, vp, valid)])
    got = tref.pool_attention_ref(*_t(q, kp, vp, valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # and the paged form over the identity layout is the same function
    paged = tref.paged_attention_ref(*_t(q, kp, vp, _identity_lists(valid),
                                         valid))
    np.testing.assert_allclose(paged[0].numpy(), got[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(paged[3].numpy(), got[3].numpy(), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiered_attention_matches_reference(seed):
    """Two tiers with identity-or-hole lists (what `tier_lists` gives):
    merged output and per-page importance, against the reference's
    CPU path."""
    rng = np.random.default_rng(seed)
    B, KH, G, HD, T, Ph, Pe = 2, 2, 2, 16, 16, 4, 6
    q = rng.standard_normal((B, KH, G, HD)).astype(np.float32)
    pools = [rng.standard_normal((B, P, T, KH, HD)).astype(np.float32)
             for P in (Ph, Ph, Pe, Pe)]
    hv = rng.integers(0, T + 1, (B, Ph)).astype(np.int32)
    ev = rng.integers(0, T + 1, (B, Pe)).astype(np.int32)
    ev[1] = 0                                   # lane 1: host tier empty
    args = [q, *pools, _identity_lists(hv), hv, _identity_lists(ev), ev]
    w_out, w_imp = jops.tiered_paged_attention(
        *[jnp.asarray(a) for a in args], use_pallas=False)
    g_out, g_imp = tops.tiered_paged_attention(*_t(*args))
    np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), atol=ATOL)
    np.testing.assert_allclose(g_imp.numpy(), np.asarray(w_imp), atol=ATOL)


@pytest.mark.parametrize("seed", [3, 11, 2024])
def test_two_tier_merge_equals_single_pool(seed):
    rng = np.random.default_rng(seed)
    B, KH, G, HD, T, P = 1, 2, 2, 32, 8, 6
    q = rng.standard_normal((B, KH, G, HD)).astype(np.float32)
    kp = rng.standard_normal((B, P, T, KH, HD)).astype(np.float32)
    vp = rng.standard_normal((B, P, T, KH, HD)).astype(np.float32)
    valid = rng.integers(1, T + 1, (B, P)).astype(np.int32)
    tq, tk, tv, tvalid = _t(q, kp, vp, valid)
    o_all = tref.pool_attention_ref(tq, tk, tv, tvalid)[0]
    cut = 2
    oa = tref.pool_attention_ref(tq, tk[:, :cut], tv[:, :cut],
                                 tvalid[:, :cut])
    ob = tref.pool_attention_ref(tq, tk[:, cut:], tv[:, cut:],
                                 tvalid[:, cut:])
    merged, lse = tref.merge_partials([oa[:3], ob[:3]])
    np.testing.assert_allclose(merged.numpy(), o_all.numpy(), atol=ATOL)
    jq, jk, jv, jvalid = [jnp.asarray(a) for a in (q, kp, vp, valid)]
    ja = jref.pool_attention_ref(jq, jk[:, :cut], jv[:, :cut],
                                 jvalid[:, :cut])
    jb = jref.pool_attention_ref(jq, jk[:, cut:], jv[:, cut:],
                                 jvalid[:, cut:])
    j_merged, j_lse = jref.merge_partials([ja[:3], jb[:3]])
    np.testing.assert_allclose(merged.numpy(), np.asarray(j_merged),
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL)


def test_merge_associativity():
    rng = np.random.default_rng(7)
    B, KH, G, HD, T, P = 1, 1, 1, 16, 16, 9
    q, kp, vp = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, KH, G, HD), (B, P, T, KH, HD),
                           (B, P, T, KH, HD))]
    valid = torch.full((B, P), T, dtype=torch.int32)
    parts = [tref.pool_attention_ref(q, kp[:, i:i + 3], vp[:, i:i + 3],
                                     valid[:, i:i + 3])[:3]
             for i in (0, 3, 6)]
    m1, _ = tref.merge_partials(parts)
    o6 = tref.pool_attention_ref(q, kp[:, :6], vp[:, :6], valid[:, :6])
    m2, _ = tref.merge_partials([o6[:3], parts[2]])
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=ATOL)
    jparts = [jref.pool_attention_ref(
        *[jnp.asarray(a.numpy()) for a in (q, kp[:, i:i + 3],
                                           vp[:, i:i + 3],
                                           valid[:, i:i + 3])])[:3]
        for i in (0, 3, 6)]
    j1, _ = jref.merge_partials(jparts)
    np.testing.assert_allclose(m1.numpy(), np.asarray(j1), atol=ATOL)


def test_tier_attention_takes_the_plain_version_on_cpu(monkeypatch):
    """A CPU tensor goes to the plain version, never the kernel wrapper."""
    from repro_torch.kernels import paged_attention as pa
    calls = []

    def no_kernel(*a, **k):
        raise AssertionError("the kernel wrapper was called for CPU tensors")

    monkeypatch.setattr(tops, "paged_attention", no_kernel)
    before = pa.COUNTS["paged_attention"]
    q, kp, vp, pl, pv = _t(*CASES["permuted"])
    got = tops.tier_attention(q, kp, vp, pl, pv)
    calls.append(got)
    want = tref.paged_attention_ref(q, kp, vp, pl, pv)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert pa.COUNTS["paged_attention"] == before


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.paged_attention import paged_attention as kern
    with pytest.raises(ValueError, match="CUDA"):
        kern(*_t(*CASES["permuted"]))


def test_choose_splits_fills_the_card():
    from repro_torch.kernels.paged_attention import choose_splits
    for n in (1, 5, 64, 208):
        splits, per = choose_splits(8, 8, n, 132)
        assert 1 <= splits <= n and splits * per >= n
        assert (splits - 1) * per < n               # no empty split
    assert choose_splits(8, 8, 64, 132)[0] * 64 >= 2 * 132
