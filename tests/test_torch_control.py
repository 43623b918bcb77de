"""The port's control plane against the reference on the same cache
state: write slots, Quest masks, migration plans, lane merge and lane
release must be equal exactly, ties in importance included."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import control as jctl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serving import control as tctl  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

PLAN_FIELDS = ("pro_layer", "pro_batch", "pro_src", "pro_dst",
               "pro_logical", "dem_layer", "dem_batch", "dem_src",
               "dem_dst", "dem_logical")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jconfigs.get_smoke("internlm2-1.8b"),
                               dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("internlm2-1.8b"),
                               dtype=torch.float32, param_dtype=torch.float32)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(1))
    return jm, jp, TModel(tcfg), bridge.params_from_jax(
        jax.device_get(jp), tcfg, device="cpu")


def _state(jm, jp, lengths, seed, levels=4):
    """A reference cache with 3 lanes prefilled to `lengths` (lane 2 is
    then released: an empty lane), importance drawn from a few discrete
    levels so ties abound. Returns (jax cache, numpy fields)."""
    geo = jm.cache_geometry(3, 512)
    rng = np.random.default_rng(seed)
    S = max(lengths)
    toks = rng.integers(0, 256, (3, S)).astype(np.int32)
    _, cache = jm.prefill(jp, jnp.asarray(toks), geo)
    # per-lane lengths and a released lane 2
    length = np.asarray(lengths, np.int32)
    cache = dataclasses.replace(cache, length=jnp.asarray(length))
    cache = jctl.release_lanes(cache, jnp.asarray([False, False, True]))
    imp = rng.integers(0, levels, cache.importance.shape) / levels
    alive = np.asarray(cache.page_table) >= 0
    cache = dataclasses.replace(
        cache, importance=jnp.asarray(np.where(alive, imp, 0.0),
                                      jnp.float32))
    fields = {f.name: np.asarray(getattr(cache, f.name))
              for f in dataclasses.fields(cache)}
    return cache, fields


@pytest.fixture(scope="module")
def state(models):
    jm, jp, _, _ = models
    return _state(jm, jp, [300, 290, 0], seed=0)


def _port(fields):
    return bridge.cache_from_numpy(fields, device="cpu")


def test_choose_write_slot(state, models):
    jm, jp, _, _ = models
    jc, fields = state
    np.testing.assert_array_equal(
        tctl.choose_write_slot(_port(fields)).numpy(),
        np.asarray(jctl.choose_write_slot(jc)))
    # a lane whose HBM is full and whose host is full too (last slot)
    ho = fields["host_owner"].copy()
    ho[:, 0] = np.arange(ho.shape[-1])
    full = dict(fields, host_owner=ho)
    jfull = dataclasses.replace(jc, host_owner=jnp.asarray(ho))
    np.testing.assert_array_equal(
        tctl.choose_write_slot(_port(full)).numpy(),
        np.asarray(jctl.choose_write_slot(jfull)))


@pytest.mark.parametrize("sparsity", [0.25, 0.5, 0.9])
def test_quest_page_mask_with_ties(state, sparsity):
    jc, fields = state
    np.testing.assert_array_equal(
        tctl.quest_page_mask(_port(fields), sparsity).numpy(),
        np.asarray(jctl.quest_page_mask(jc, sparsity)))


@pytest.mark.parametrize("thresh,active", [
    (0.0, None), (0.3, None), (0.0, [True, False, True])])
def test_plan_migrations_with_ties(state, thresh, active):
    jc, fields = state
    budget = 3
    jact = None if active is None else jnp.asarray(active)
    tact = None if active is None else torch.tensor(active)
    jplan, jn_pro, jn_dem = jctl.plan_migrations(
        jc, budget=budget, promote_thresh=thresh, active=jact)
    tplan, tn_pro, tn_dem = tctl.plan_migrations(
        _port(fields), budget=budget, promote_thresh=thresh, active=tact)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    assert (int(tn_pro), int(tn_dem)) == (int(jn_pro), int(jn_dem))
    assert int(tn_pro) > 0


def test_lane_merge_after_a_masked_decode_step(models, state):
    """The port's decode step writes only active lanes' pools and
    `lane_merge` merges only the small tensors; the result equals the
    reference's decode step + whole-cache `where` merge."""
    jm, jp, tm, tp = models
    jc, fields = state
    active = np.array([True, False, False])
    token = np.array([5, 6, 7], np.int32)
    jslot = jctl.choose_write_slot(jc)
    _, jnew = jm.decode_step(jp, jc, jnp.asarray(token), write_slot=jslot,
                             use_pallas=False)
    jm_ = jctl.lane_merge(jc, jnew, jnp.asarray(active))
    tc = _port(fields)
    tslot = tctl.choose_write_slot(tc)
    _, tnew = tm.decode_step(tp, tc, torch.from_numpy(token),
                             write_slot=tslot,
                             active=torch.from_numpy(active))
    tm_ = tctl.lane_merge(tc, tnew, torch.from_numpy(active))
    got = bridge.cache_to_numpy(tm_)
    for name, want in ((f.name, np.asarray(getattr(jm_, f.name)))
                       for f in dataclasses.fields(jm_)):
        if name in ("k_hbm", "v_hbm", "k_host", "v_host"):
            # inactive lanes bitwise; the active lane's new token within
            # float tolerance (computed by each side)
            np.testing.assert_array_equal(got[name][:, 1:], want[:, 1:],
                                          err_msg=name)
            np.testing.assert_allclose(got[name], want, atol=1e-5)
        elif name == "importance":
            np.testing.assert_array_equal(got[name][:, 1:], want[:, 1:])
            np.testing.assert_allclose(got[name], want, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_release_lanes_tiers_and_occupancy(state):
    jc, fields = state
    lanes = np.array([True, False, False])
    want = jctl.release_lanes(jc, jnp.asarray(lanes))
    got = tctl.release_lanes(_port(fields), torch.from_numpy(lanes))
    got_np = bridge.cache_to_numpy(got)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(got_np[f.name],
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(tctl.page_tiers(_port(fields)).numpy(),
                                  np.asarray(jctl.page_tiers(jc)))
    np.testing.assert_array_equal(tctl.occupancy(_port(fields)).numpy(),
                                  np.asarray(jctl.occupancy(jc)))


def test_lane_modes_and_budgets(state):
    active = np.array([True, True, False, True])
    pre = np.array([5, 9, 0, 0], np.int32)
    plen = np.array([9, 9, 0, 4], np.int32)
    want = jctl.lane_modes(*[jnp.asarray(a) for a in (active, pre, plen)])
    got = tctl.lane_modes(*[torch.from_numpy(a) for a in (active, pre, plen)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    from repro.kvcache.paged import CacheGeometry
    geo = CacheGeometry.for_context(num_layers=24, batch=8, context=4096,
                                    kv_heads=8, head_dim=128)
    for frac in (0.01, 0.1, 0.5):
        assert tctl.migration_budget(geo, frac) == \
            jctl.migration_budget(geo, frac)
        assert tctl.plan_capacity(geo, frac) == jctl.plan_capacity(geo, frac)
