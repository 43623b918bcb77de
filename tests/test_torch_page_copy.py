"""The row copy's interface — several (dst, src) pairs in one call, a
side that splits two pools on one index dim (the reference's slot
space), a per-row `keep` mask, out-of-range rows dropped — in its plain
version (`ref.page_copy_ref`, what `ops.copy_rows` runs on CPU
tensors), held against the reference's scatters and gathers on the
same seeded numpy pools: the token writes of `repro.kvcache.paged`,
`repro.kvcache.migrate`'s stage + commit, and the tier concatenation
of the reference's prefill chunk. Then the port's call sites, each one
row copy now, against the compositions they replaced (one copy per
pool and tier, masks built beside them). Every comparison is exact:
rows are copied, never computed.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kvcache import migrate as jmig  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import page_copy as pc  # noqa: E402
from repro_torch.kernels.page_copy import Split  # noqa: E402
from repro_torch.kvcache import migrate as tmig  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

L, B, PH, PE, T, KH, HD = 2, 4, 3, 5, 4, 2, 8


def pools(rng, lead=(B,)):
    """k_hbm, v_hbm, k_host, v_host as numpy f32 [*lead, P, T, KH, HD]."""
    return [rng.standard_normal(lead + (p, T, KH, HD)).astype(np.float32)
            for p in (PH, PH, PE, PE)]


def t(a):
    return torch.from_numpy(np.array(a))


def i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


# --------------------------------------------------------------------------
# the plain version against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_token_write_matches_reference(seed):
    """K and V of one decode token per lane into both tiers by one call
    with a split side (slot < PH: HBM, else host at slot - PH; past
    both: dropped) equal the reference's `write_token_layer`."""
    rng = np.random.default_rng(seed)
    p = pools(rng)
    slot = rng.integers(0, PH + PE + 2, B).astype(np.int32)
    slot[0], slot[1] = PH - 1, PH            # both sides of the split
    off = rng.integers(0, T, B).astype(np.int32)
    k_new, v_new = (rng.standard_normal((B, KH, HD)).astype(np.float32)
                    for _ in range(2))
    want = jpaged.write_token_layer(*map(jnp.asarray, p), jnp.asarray(slot),
                                    jnp.asarray(off), jnp.asarray(k_new),
                                    jnp.asarray(v_new))
    got = [t(a) for a in p]
    at = (None, i32(slot), i32(off))
    ref.page_copy_ref((Split(got[0], got[2], 1), at, t(k_new), (None,)),
                      (Split(got[1], got[3], 1), at, t(v_new), (None,)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_prefill_write_with_keep_matches_reference(seed):
    """A prefill slice's tokens (rows dropped by `keep` = valid) equal
    the reference's `write_tokens_layer`."""
    rng = np.random.default_rng(seed)
    p = pools(rng)
    C = 6
    slot = rng.integers(0, PH + PE, (B, C)).astype(np.int32)
    off = rng.integers(0, T, (B, C)).astype(np.int32)
    valid = rng.random((B, C)) < 0.7
    # one row per (lane, slot, offset): later duplicates marked invalid
    seen = set()
    for b in range(B):
        for c in range(C):
            key = (b, slot[b, c], off[b, c])
            valid[b, c] &= key not in seen
            seen.add(key)
    k_new, v_new = (rng.standard_normal((B, C, KH, HD)).astype(np.float32)
                    for _ in range(2))
    want = jpaged.write_tokens_layer(
        *map(jnp.asarray, p), jnp.asarray(slot), jnp.asarray(off),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(valid))
    got = [t(a) for a in p]
    at = (i32(np.repeat(np.arange(B), C)), i32(slot.reshape(-1)),
          i32(off.reshape(-1)))
    keep = torch.as_tensor(valid.reshape(-1))
    ref.page_copy_ref(
        (Split(got[0], got[2], 1), at, t(k_new.reshape(-1, KH, HD)),
         (None,)),
        (Split(got[1], got[3], 1), at, t(v_new.reshape(-1, KH, HD)),
         (None,)), keep=keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _plan_rows():
    """Swaps whose demotion lands in the host slot its promotion vacates,
    a fill, and sentinel / out-of-range rows."""
    promotes = [(0, 1, 2, 1, 6), (1, 0, 4, 0, 9), (1, 3, 0, 2, 4),
                (0, 2, PE + 1, 0, 3)]                 # src out of range
    demotes = [(0, 1, 1, 2, 3), (1, 0, 0, 4, 0), (1, 2, 2, PE, 1)]
    return promotes, demotes


@pytest.mark.parametrize("seed", [0, 1])
def test_four_pair_stage_and_commit_match_reference(seed):
    """A migration plan's gather (four pairs: K and V of the demoted HBM
    pages and the promoted host pages) and its scatter (four pairs back
    into the other tier), each one call, equal the reference's
    `stage_plan` and the pools `commit_staged` leaves."""
    rng = np.random.default_rng(seed)
    p = pools(rng, (L, B))
    promotes, demotes = _plan_rows()
    M = 6
    jgeo = jpaged.CacheGeometry(num_layers=L, batch=B, page_tokens=T,
                                hbm_pages=PH, host_pages=PE, kv_heads=KH,
                                head_dim=HD, dtype=jnp.float32)
    jc = jpaged.init_cache(jgeo)
    jc = dataclasses.replace(jc, **dict(zip(
        ("k_hbm", "v_hbm", "k_host", "v_host"), map(jnp.asarray, p))))
    jplan = jmig.MigrationPlan.build(M, promotes, demotes)
    staged = jmig.stage_plan(jc, jplan)
    done = jmig.commit_staged(jc, jplan, staged)
    tp = tmig.MigrationPlan.build(M, promotes, demotes, device="cpu")
    cols = {f: getattr(tp, f) for f in tmig._FIELDS}

    def clamp(i, hi):
        return i.clamp(0, hi - 1).to(torch.int32)
    d = (clamp(cols["dem_layer"], L), cols["dem_batch"].clamp_min(0),
         clamp(cols["dem_src"], PH))
    pr = (clamp(cols["pro_layer"], L), cols["pro_batch"].clamp_min(0),
          clamp(cols["pro_src"], PE))
    got = [t(a) for a in p]
    out = [torch.empty((M, T, KH, HD)) for _ in range(4)]
    ref.page_copy_ref(*[(o, (None,), pool, at) for o, pool, at in zip(
        out, got, (d, d, pr, pr))])
    for g, w in zip(out, staged):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d_at = (cols["dem_layer"], cols["dem_batch"].clamp_min(0),
            cols["dem_dst"])
    p_at = (cols["pro_layer"], cols["pro_batch"].clamp_min(0),
            cols["pro_dst"])
    ref.page_copy_ref((got[2], d_at, out[0], (None,)),
                      (got[3], d_at, out[1], (None,)),
                      (got[0], p_at, out[2], (None,)),
                      (got[1], p_at, out[3], (None,)))
    for g, name in zip(got, ("k_hbm", "v_hbm", "k_host", "v_host")):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(done, name)))


@pytest.mark.parametrize("seen", [(PH, PE), (2, 3), (PH, 0), (1, PE)])
def test_split_gather_is_the_reference_tier_concatenation(seen):
    """The prefill chunk's gather of lanes' slots through a side split at
    n_h equals the reference's `jnp.concatenate([kh, ke], axis=1)`
    (transformer.py's prefill chunk), cut to the slots it reads."""
    rng = np.random.default_rng(sum(seen))
    p = pools(rng)
    n_h, n_e = seen
    lanes = np.array([2, 0, 3], np.int32)
    keys = np.asarray(jnp.concatenate([jnp.asarray(p[0]),
                                       jnp.asarray(p[2])], axis=1))
    vals = np.asarray(jnp.concatenate([jnp.asarray(p[1]),
                                       jnp.asarray(p[3])], axis=1))
    cols = list(range(n_h)) + list(range(PH, PH + n_e))
    n, R = n_h + n_e, len(lanes)
    got = [torch.empty((R * n, T, KH, HD)) for _ in range(2)]
    at = (i32(np.repeat(lanes, n)), i32(np.tile(np.arange(n), R)))
    src = [t(a) for a in p]
    ref.page_copy_ref((got[0], (None,), Split(src[0], src[2], 1, n_h), at),
                      (got[1], (None,), Split(src[1], src[3], 1, n_h), at))
    for g, w in zip(got, (keys, vals)):
        np.testing.assert_array_equal(
            g.reshape(R, n, T, KH, HD).numpy(), w[lanes][:, cols])


def test_four_pairs_keep_and_drops_against_a_row_loop():
    """Four pairs with their own index lists (a tensor side, split sides
    with the split at a's size and below it), `keep`, and rows out of
    range on either side (negative, past a pool, past both pools of a
    split): exactly a loop over the rows."""
    rng = np.random.default_rng(7)
    M = 9
    a = rng.standard_normal((3, 5, 16)).astype(np.float32)
    b = rng.standard_normal((3, 4, 16)).astype(np.float32)
    flat = rng.standard_normal((M, 16)).astype(np.float32)
    lane = rng.integers(-1, 4, M).astype(np.int32)          # -1 and 3 drop
    slot = rng.integers(-1, 11, M).astype(np.int32)         # 9, 10 drop
    keep = rng.random(M) < 0.8
    want = {k: v.copy() for k, v in
            (("a", a), ("b", b), ("g0", np.zeros((M, 16), np.float32)),
             ("g1", np.zeros((M, 16), np.float32)))}
    for r in range(M):
        if not keep[r] or not 0 <= lane[r] < 3:
            continue
        s = slot[r]
        if 0 <= s < 5:                   # the scatter's split at 5
            want["a"][lane[r], s] = flat[r]
        elif 5 <= s < 9:
            want["b"][lane[r], s - 5] = flat[r]
        if 0 <= s < 2:                   # the gather's split at 2
            want["g0"][r] = a[lane[r], s]
        elif 2 <= s < 6:
            want["g0"][r] = b[lane[r], s - 2]
        if 0 <= s < 4:                   # a plain side: b alone
            want["g1"][r] = b[lane[r], s]
    ga, gb, g0, g1 = t(a), t(b), torch.zeros((M, 16)), torch.zeros((M, 16))
    src_a, src_b = ga.clone(), gb.clone()    # gathers read the inputs
    at = (i32(lane), i32(slot))
    scratch = torch.zeros((M, 16))
    ops.copy_rows((g0, (None,), Split(src_a, src_b, 1, 2), at),
                  (Split(ga, gb, 1), at, t(flat), (None,)),
                  (g1, (None,), src_b, at),
                  (scratch, (None,), t(flat), (None,)),
                  keep=torch.as_tensor(keep))
    for g, name in ((ga, "a"), (gb, "b"), (g0, "g0"), (g1, "g1")):
        np.testing.assert_array_equal(g.numpy(), want[name], err_msg=name)
    np.testing.assert_array_equal(
        scratch.numpy(), np.where(keep[:, None], flat, 0.0))


def test_one_row_and_no_rows():
    """A one-row call copies its row; a zero-row call changes nothing."""
    pool = torch.arange(3 * 4 * 8, dtype=torch.float32).reshape(3, 4, 8)
    row = torch.full((1, 8), -1.0)
    ops.copy_rows((pool, (i32([2]), i32([1])), row, (None,)))
    assert torch.equal(pool[2, 1], row[0])
    before = pool.clone()
    ops.copy_rows((pool, (i32([]), i32([])), row[:0], (None,)))
    assert torch.equal(pool, before)


# --------------------------------------------------------------------------
# the port's call sites against the compositions they replaced
# --------------------------------------------------------------------------

_PLAIN = ref.page_copy_ref      # not the `counted` fixture's wrapper


def _copy(dst, dst_index, src, src_index):
    _PLAIN((dst, dst_index, src, src_index))


def _before_write_token_layer(kh, vh, ke, ve, slot, offset, k_new, v_new,
                              active=None):
    """The token write as it was: per tier a mask, one copy per pool."""
    hbm_pages, host_pages = kh.shape[1], ke.shape[1]
    keep = torch.ones_like(slot, dtype=torch.bool) if active is None \
        else active
    in_hbm = keep & (slot >= 0) & (slot < hbm_pages)
    in_host = keep & (slot >= hbm_pages) & (slot < hbm_pages + host_pages)
    off = offset.to(torch.int32)
    for tier, sel, base in (((kh, vh), in_hbm, 0),
                            ((ke, ve), in_host, hbm_pages)):
        at = (None, torch.where(sel, slot - base, -1).to(torch.int32), off)
        for pool, val in zip(tier, (k_new, v_new)):
            _copy(pool, at, val, (None,))


def _before_write_tokens_layer(kh, vh, ke, ve, slot, offset, k_new, v_new,
                               valid, lanes):
    hbm_pages, host_pages = kh.shape[1], ke.shape[1]
    lane = lanes.to(torch.int32).repeat_interleave(slot.shape[1])
    off = offset.to(torch.int32).reshape(-1)
    in_hbm = valid & (slot >= 0) & (slot < hbm_pages)
    in_host = valid & (slot >= hbm_pages) & (slot < hbm_pages + host_pages)
    for tier, sel, base in (((kh, vh), in_hbm, 0),
                            ((ke, ve), in_host, hbm_pages)):
        at = (lane, torch.where(sel, slot - base, -1).to(torch.int32)
              .reshape(-1), off)
        for pool, val in zip(tier, (k_new, v_new)):
            _copy(pool, at, val.reshape(-1, *val.shape[2:]), (None,))


def _before_read_token_layer(kh, vh, ke, ve, slot, offset):
    k = torch.zeros((slot.shape[0],) + kh.shape[3:])
    v = torch.zeros_like(k)
    for tier, base, n in (((kh, vh), 0, kh.shape[1]),
                          ((ke, ve), kh.shape[1], ke.shape[1])):
        sel = (slot >= base) & (slot < base + n)
        at = (None, torch.where(sel, slot - base, -1).to(torch.int32),
              offset.to(torch.int32))
        for out, pool in zip((k, v), tier):
            _copy(out, (None,), pool, at)
    return k, v


def _before_lane_pages(pool, lanes, n):
    R = lanes.shape[0]
    out = torch.empty((R, n) + pool.shape[2:])
    if n:
        _copy(out.view(R * n, *pool.shape[2:]), (None,), pool,
              (lanes.to(torch.int32).repeat_interleave(n),
               torch.arange(n, dtype=torch.int32).repeat(R)))
    return out


@pytest.fixture
def counted(monkeypatch):
    """The plain version's calls (what launches on the card)."""
    calls = []
    real = ref.page_copy_ref

    def count(*pairs, keep=None):
        calls.append(len(pairs))
        return real(*pairs, keep=keep)
    monkeypatch.setattr(ref, "page_copy_ref", count)
    return calls


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
def test_token_write_and_read_equal_before(counted, masked):
    rng = np.random.default_rng(3)
    p = [t(a) for a in pools(rng)]
    slot = i32([0, PH - 1, PH, PH + PE - 1])
    off = i32(rng.integers(0, T, B))
    k_new, v_new = (t(rng.standard_normal((B, KH, HD)).astype(np.float32))
                    for _ in range(2))
    active = torch.tensor([True, False, True, True]) if masked else None
    want = [a.clone() for a in p]
    _before_write_token_layer(*want, slot, off, k_new, v_new, active)
    old = _before_read_token_layer(*[a.clone() for a in p], slot, off)
    got_old = tpaged.read_token_layer(*p, slot, off)
    tpaged.write_token_layer(*p, slot, off, k_new, v_new, active=active)
    for g, w in zip(p, want):
        assert torch.equal(g, w)
    for g, w in zip(got_old, old):
        assert torch.equal(g, w)
    assert counted == [2, 2]                 # one call each, K and V


def test_prefill_write_and_gather_equal_before(counted):
    rng = np.random.default_rng(4)
    p = [t(a) for a in pools(rng)]
    lanes = torch.tensor([3, 1])
    C = 5
    start = torch.tensor([2, 7])
    pos, page, off, valid = transformer.chunk_coords(
        T, C, start, torch.tensor([5, 3]))
    k_new, v_new = (t(rng.standard_normal((2, C, KH, HD)).astype(
        np.float32)) for _ in range(2))
    want = [a.clone() for a in p]
    _before_write_tokens_layer(*want, page, off, k_new, v_new, valid, lanes)
    tpaged.write_tokens_layer(*p, page, off, k_new, v_new, valid,
                              lanes=lanes)
    for g, w in zip(p, want):
        assert torch.equal(g, w)
    for seen in ((PH, PE), (2, 0), (PH, 2)):
        keys, vals = transformer.lane_pages(p, lanes, seen)
        for got, hbm, host in ((keys, p[0], p[2]), (vals, p[1], p[3])):
            old = torch.cat([_before_lane_pages(hbm, lanes, seen[0]),
                             _before_lane_pages(host, lanes, seen[1])], 1)
            assert torch.equal(got, old)
    assert counted == [2] * 4


def test_stage_and_scatter_equal_before(counted):
    from repro_torch.kvcache.paged import CacheGeometry, init_cache
    rng = np.random.default_rng(5)
    geo = CacheGeometry(num_layers=L, batch=B, page_tokens=T,
                        hbm_pages=PH, host_pages=PE, kv_heads=KH,
                        head_dim=HD, dtype=torch.float32)
    cache = init_cache(geo, device="cpu")
    for name, a in zip(("k_hbm", "v_hbm", "k_host", "v_host"),
                       pools(rng, (L, B))):
        getattr(cache, name).copy_(t(a))
    promotes, demotes = _plan_rows()
    plan = tmig.MigrationPlan.build(6, promotes, demotes, device="cpu")
    # before: one gather per pool (clamped rows), one scatter per pool
    d = (plan.dem_layer.clamp(0, L - 1), plan.dem_batch.clamp_min(0),
         plan.dem_src.clamp(0, PH - 1))
    pr = (plan.pro_layer.clamp(0, L - 1), plan.pro_batch.clamp_min(0),
          plan.pro_src.clamp(0, PE - 1))
    old = []
    for pool, at in ((cache.k_hbm, d), (cache.v_hbm, d),
                     (cache.k_host, pr), (cache.v_host, pr)):
        out = torch.empty((6, T, KH, HD))
        _copy(out, (None,), pool, tuple(i.to(torch.int32) for i in at))
        old.append(out)
    want = {n: getattr(cache, n).clone()
            for n in ("k_hbm", "v_hbm", "k_host", "v_host")}
    d_at = (plan.dem_layer, plan.dem_batch.clamp_min(0), plan.dem_dst)
    p_at = (plan.pro_layer, plan.pro_batch.clamp_min(0), plan.pro_dst)
    for name, at, src in (("k_host", d_at, old[0]), ("v_host", d_at, old[1]),
                          ("k_hbm", p_at, old[2]), ("v_hbm", p_at, old[3])):
        _copy(want[name], at, src, (None,))
    counted.clear()
    staged = tmig.stage_plan(cache, plan)
    for g, w in zip(staged, old):
        assert torch.equal(g, w)
    tmig.scatter_staged(cache, plan, staged)
    for name, w in want.items():
        assert torch.equal(getattr(cache, name), w), name
    assert counted == [4, 4]


def test_moe_decode_puts_back_with_three_copies_a_layer(counted):
    """The moe decode of a smoke config (every lane writes, inactive
    lanes' rows put back): three row copies a layer — read, write,
    put back — where it took twelve."""
    from repro_torch import configs
    from repro_torch.kvcache.paged import init_cache
    from repro_torch.models.model import Model
    cfg = configs.get_smoke("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    geo = model.cache_geometry(2, 64, 0.5)
    cache = init_cache(geo, device="cpu")
    tok = torch.tensor([3, 5], dtype=torch.int32)
    slot = torch.zeros((geo.num_layers, 2), dtype=torch.int32)
    counted.clear()
    model.decode_step(params, cache, tok, write_slot=slot,
                      active=torch.tensor([True, False]))
    assert counted == [2] * (3 * geo.num_layers)


# --------------------------------------------------------------------------
# the wrapper's refusals and the launcher's descriptor (no card here)
# --------------------------------------------------------------------------

def test_descriptor_matches_the_launchers_struct():
    """`_DESC` packs csrc/page_copy.cu's `Desc` (1304 bytes, its
    static_assert): four pairs of two sides, each two pools of 9
    values and 8 more, then keep, pair and row counts, row bytes."""
    assert pc._DESC.size == 1304
    assert len(pc._NO_SIDE) == 26
    assert pc.MAX_PAIRS == 4
    src = (build.CSRC / "page_copy.cu").read_text()
    assert "sizeof(Desc) == 1304" in src
    assert "constexpr int kMaxPairs = 4;" in src


def test_wrapper_refuses_cpu_indices_and_too_many_pairs():
    pool = torch.zeros((2, 4, 16))
    row = torch.zeros((1, 16))
    pair = (pool, (i32([0]), i32([1])), row, (None,))
    with pytest.raises(ValueError, match="ref.page_copy_ref"):
        pc.page_copy(pair)
    with pytest.raises(ValueError, match="1..4 pairs"):
        pc.page_copy(*[pair] * 5)
    with pytest.raises(ValueError, match="at least one index"):
        pc.page_copy((pool, (None, None), pool, (None, None)))
