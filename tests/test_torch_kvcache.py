"""The port's paged-cache primitives against the reference on the same
numpy inputs: integer state must match exactly and page data bitwise
(every op here copies values, it computes none)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kvcache import migrate as jmig  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kvcache import migrate as tmig  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

L, B, KH, HD, T = 2, 3, 2, 8, 4
PH, PE = 4, 6


def _geos():
    j = jpaged.CacheGeometry(num_layers=L, batch=B, page_tokens=T,
                             hbm_pages=PH, host_pages=PE, kv_heads=KH,
                             head_dim=HD, dtype=jnp.float32)
    t = tpaged.CacheGeometry(num_layers=L, batch=B, page_tokens=T,
                             hbm_pages=PH, host_pages=PE, kv_heads=KH,
                             head_dim=HD, dtype=torch.float32)
    return j, t


def _jnp(cache):
    return {f.name: np.asarray(getattr(cache, f.name))
            for f in dataclasses.fields(cache)}


def _assert_same(jax_cache, torch_cache):
    want = _jnp(jax_cache)
    got = bridge.cache_to_numpy(torch_cache)
    assert set(want) == set(got)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _prefilled(S, seed=0):
    """A reference and a port cache, both prefilled from the same K/V."""
    jgeo, tgeo = _geos()
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, S, KH, HD)).astype(np.float32)
    v = rng.standard_normal((L, B, S, KH, HD)).astype(np.float32)
    jc = jpaged.prefill_cache(jgeo, jnp.asarray(k), jnp.asarray(v), S - 1)
    tc = tpaged.prefill_cache(tgeo, torch.from_numpy(k), torch.from_numpy(v),
                              S - 1)
    return jc, tc


def test_geometry_matches():
    for ctx, frac in ((512, 0.25), (4096, 0.25), (128, 0.5)):
        j = jpaged.CacheGeometry.for_context(
            num_layers=24, batch=8, context=ctx, kv_heads=8, head_dim=128,
            hbm_fraction=frac)
        t = tpaged.CacheGeometry.for_context(
            num_layers=24, batch=8, context=ctx, kv_heads=8, head_dim=128,
            hbm_fraction=frac)
        assert (j.hbm_pages, j.host_pages, j.max_tokens, j.page_bytes()) \
            == (t.hbm_pages, t.host_pages, t.max_tokens, t.page_bytes())


@pytest.mark.parametrize("S", [5, 16, 27, 40])
def test_prefill_cache(S):
    """Static placement HBM first; S = 27 and 40 spill into the host."""
    jc, tc = _prefilled(S)
    _assert_same(jc, tc)
    for layer in (None, 1):
        for a, b in zip(jc.tier_lists(layer), tc.tier_lists(layer)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _pools(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, P, T, KH, HD)).astype(np.float32)
            for P in (PH, PH, PE, PE)]


def test_write_token_layer():
    """One token per lane: an HBM slot, a host slot, the last host slot."""
    pools = _pools(1)
    rng = np.random.default_rng(2)
    slot = np.array([1, PH + 2, PH + PE - 1], np.int32)
    offset = np.array([0, 3, 2], np.int32)
    k_new = rng.standard_normal((B, KH, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, KH, HD)).astype(np.float32)
    want = jpaged.write_token_layer(*[jnp.asarray(a) for a in pools],
                                    jnp.asarray(slot), jnp.asarray(offset),
                                    jnp.asarray(k_new), jnp.asarray(v_new))
    got = [torch.from_numpy(a.copy()) for a in pools]
    tpaged.write_token_layer(*got, torch.from_numpy(slot),
                             torch.from_numpy(offset),
                             torch.from_numpy(k_new), torch.from_numpy(v_new))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_write_token_layer_leaves_inactive_lanes():
    pools = _pools(3)
    slot = np.array([0, PH + 1, 2], np.int32)
    offset = np.array([1, 1, 1], np.int32)
    new = np.ones((B, KH, HD), np.float32)
    got = [torch.from_numpy(a.copy()) for a in pools]
    tpaged.write_token_layer(*got, torch.from_numpy(slot),
                             torch.from_numpy(offset), torch.from_numpy(new),
                             torch.from_numpy(new),
                             active=torch.tensor([True, False, False]))
    assert bool((got[0][0, 0, 1] == 1).all())
    for g, p in zip(got, pools):
        np.testing.assert_array_equal(g[1:].numpy(), p[1:])


def test_write_tokens_layer():
    """A slice that straddles the tier boundary, with invalid rows."""
    pools = _pools(4)
    C = 9
    rng = np.random.default_rng(5)
    start = np.array([PH * T - 4, 0, 2 * T + 1], np.int32)
    n_valid = np.array([9, 3, 0], np.int32)
    pos = start[:, None] + np.arange(C, dtype=np.int32)[None]
    valid = np.arange(C)[None] < n_valid[:, None]
    page, offset = pos // T, pos % T
    k_new = rng.standard_normal((B, C, KH, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, C, KH, HD)).astype(np.float32)
    want = jpaged.write_tokens_layer(
        *[jnp.asarray(a) for a in pools], jnp.asarray(page),
        jnp.asarray(offset), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(valid))
    got = [torch.from_numpy(a.copy()) for a in pools]
    tpaged.write_tokens_layer(*got, torch.from_numpy(page),
                              torch.from_numpy(offset),
                              torch.from_numpy(k_new),
                              torch.from_numpy(v_new),
                              torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_allocate_prompt_pages():
    jc, tc = _prefilled(9)
    C = 12
    start = np.array([9, 0, 3 * T], np.int32)
    n_new = np.array([12, 0, 7], np.int32)
    pos = start[:, None] + np.arange(C, dtype=np.int32)[None]
    valid = np.arange(C)[None] < n_new[:, None]
    want = jpaged.allocate_prompt_pages(jc, jnp.asarray(pos),
                                        jnp.asarray(valid),
                                        jnp.asarray(n_new))
    got = tpaged.allocate_prompt_pages(tc, torch.from_numpy(pos),
                                       torch.from_numpy(valid),
                                       torch.from_numpy(n_new))
    _assert_same(want, got)


def _plans():
    """(promotes, demotes) rows: a swap whose demotion lands in the host
    slot its promotion vacates, a fill of a free HBM slot, a demotion on
    another layer, and (by capacity) sentinel rows."""
    promotes = [(0, 0, 1, 2, 5), (1, 2, 0, 3, 4), (0, 1, 2, 1, 6)]
    demotes = [(0, 0, 2, 1, 2), (1, 1, 0, 5, 0)]
    return promotes, demotes


def test_apply_migrations_with_swaps_and_sentinels():
    jc, tc = _prefilled(36)      # 9 pages: 4 in HBM, 5 on the host
    # free one HBM slot in lane 2 / layer 1 so the fill row lands
    ho = np.asarray(jc.hbm_owner).copy()
    ho[1, 2, 3] = -1
    jc = dataclasses.replace(jc, hbm_owner=jnp.asarray(ho))
    tc = dataclasses.replace(tc, hbm_owner=torch.from_numpy(ho.copy()))
    promotes, demotes = _plans()
    cap = 8
    jplan = jmig.MigrationPlan.build(cap, promotes, demotes)
    tplan = tmig.MigrationPlan.build(cap, promotes, demotes, device="cpu")
    # the staged copies are the same pages, read before any scatter
    for g, w in zip(tmig.stage_plan(tc, tplan), jmig.stage_plan(jc, jplan)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jmig.apply_migrations(jc, jplan)
    got = tmig.apply_migrations(tc, tplan)
    _assert_same(want, got)
    assert [int(x) for x in tplan.row_counts()] == [3, 2]


def test_empty_plan_is_identity():
    jc, tc = _prefilled(30)
    before = bridge.cache_to_numpy(tc)
    got = tmig.apply_migrations(tc, tmig.MigrationPlan.empty(6, "cpu"))
    for name, arr in bridge.cache_to_numpy(got).items():
        np.testing.assert_array_equal(arr, before[name], err_msg=name)
    _assert_same(jmig.apply_migrations(jc, jmig.MigrationPlan.empty(6)), got)


def test_bridge_roundtrip_keeps_bf16_exact():
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    t = bridge.to_torch(np.asarray(a), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(t),
                                  np.asarray(a, np.float32))
