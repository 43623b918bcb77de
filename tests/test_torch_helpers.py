"""The reference's last public helpers, ported: parameter counts of
every config, the schema's counts and bytes, the paged cache's
`append_token` / `page_of_token`, `insert_lane`, `migration_bytes` and
the latency model's totals — each against the reference on the same
inputs: exact for integers and byte counts, 1e-12 for floats."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import latency_model as jlat  # noqa: E402
from repro.core.tiers import GH200 as JGH200  # noqa: E402
from repro.kvcache import migrate as jmig  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import control as jctl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import latency_model as tlat  # noqa: E402
from repro_torch.core.tiers import GH200 as TGH200  # noqa: E402
from repro_torch.core.tiers import SPECS  # noqa: E402
from repro_torch.kvcache import migrate as tmig  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serving import control as tctl  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

#: the 10 architectures plus the paper's own llama31-8b
ARCHS = jconfigs.all_arch_names() + ["llama31-8b"]

# a small cache: 2 layers, 3 lanes, 3 HBM + 4 host slots of 4 tokens
L, B, T, PH, PE, KH, HD = 2, 3, 4, 3, 4, 2, 8
MAXP = PH + PE


def test_arch_list_covers_eleven_configs():
    assert len(ARCHS) == 11 and len(set(ARCHS)) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    if tc.moe is None:
        assert tc.active_param_count() == tc.param_count()
    else:
        assert tc.active_param_count() < tc.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_counts_and_bytes_equal_the_reference(arch):
    js, ts = JModel(jconfigs.get(arch)).schema(), \
        TModel(tconfigs.get(arch)).schema()
    assert tparams.count_params(ts) == jparams.count_params(js)
    for nbytes in (2, 4):
        assert tparams.param_bytes(ts, nbytes) == \
            jparams.param_bytes(js, nbytes)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "whisper-tiny", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_smoke_params_hold_the_counted_elements(arch):
    model = TModel(tconfigs.get_smoke(arch))
    params = model.init(0, device="cpu")
    leaves = list(_leaves(params))
    assert sum(p.numel() for p in leaves) == \
        tparams.count_params(model.schema())
    abstract = list(_leaves(tparams.abstract_params(model.schema(),
                                                    torch.float32)))
    assert [a.shape for a in abstract] == [p.shape for p in leaves]
    assert all(a.device.type == "meta" and a.dtype == torch.float32
               for a in abstract)


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_abstract_cache_has_init_caches_shapes():
    geo = tpaged.CacheGeometry(L, B, T, PH, PE, KH, HD, torch.float32)
    want = tpaged.init_cache(geo, device="cpu")
    got = tpaged.abstract_cache(geo)
    jgot = jpaged.abstract_cache(jpaged.CacheGeometry(
        L, B, T, PH, PE, KH, HD, jnp.float32))
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
        assert tuple(getattr(jgot, f.name).shape) == tuple(w.shape)


def test_page_of_token_equals_the_reference():
    tok = np.arange(0, 200, 7, dtype=np.int32)
    got = tpaged.page_of_token(torch.as_tensor(tok), 16)
    want = jpaged.page_of_token(jnp.asarray(tok), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tpaged.page_of_token(37, 16) == jpaged.page_of_token(37, 16)


def _cache_numpy(rng, batch=B):
    """Random pools and tables of a smoke cache (values only matter for
    equality)."""
    pool_h = (L, batch, PH, T, KH, HD)
    pool_e = (L, batch, PE, T, KH, HD)
    return {
        "k_hbm": rng.standard_normal(pool_h).astype(np.float32),
        "v_hbm": rng.standard_normal(pool_h).astype(np.float32),
        "k_host": rng.standard_normal(pool_e).astype(np.float32),
        "v_host": rng.standard_normal(pool_e).astype(np.float32),
        "page_table": rng.integers(-1, MAXP, (L, batch, MAXP)).astype(
            np.int32),
        "hbm_owner": rng.integers(-1, MAXP, (L, batch, PH)).astype(np.int32),
        "host_owner": rng.integers(-1, MAXP, (L, batch, PE)).astype(
            np.int32),
        "length": rng.integers(0, MAXP * T, (batch,)).astype(np.int32),
        "importance": rng.random((L, batch, MAXP)).astype(np.float32),
    }


def _jcache(arrays):
    return jpaged.PagedKVCache(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()})


def _assert_cache(got, want):
    got = bridge.cache_to_numpy(got)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(w), err_msg=name)


def test_append_token_equals_the_reference():
    """Slots in both tiers, and sentinel rows past both pools (the
    reference's dropped scatter), which must leave the pools alone."""
    rng = np.random.default_rng(0)
    arrays = _cache_numpy(rng)
    k_new = rng.standard_normal((L, B, KH, HD)).astype(np.float32)
    v_new = rng.standard_normal((L, B, KH, HD)).astype(np.float32)
    # layer 0: HBM, host, HBM; layer 1: host, sentinel, last host slot
    slot = np.array([[0, PH + 1, 2], [PH, MAXP, MAXP - 1]], np.int32)
    offset = np.array([1, 3, 0], np.int32)
    want = jpaged.append_token(_jcache(arrays), jnp.asarray(k_new),
                               jnp.asarray(v_new), jnp.asarray(slot),
                               jnp.asarray(offset))
    got = tpaged.append_token(bridge.cache_from_numpy(arrays, device="cpu"),
                              torch.as_tensor(k_new), torch.as_tensor(v_new),
                              torch.as_tensor(slot), torch.as_tensor(offset))
    _assert_cache(got, {f.name: getattr(want, f.name)
                        for f in dataclasses.fields(want)})
    # the sentinel row wrote nothing: lane 1 of layer 1 unchanged
    np.testing.assert_array_equal(got.k_hbm[1, 1].numpy(),
                                  arrays["k_hbm"][1, 1])
    np.testing.assert_array_equal(got.k_host[1, 1].numpy(),
                                  arrays["k_host"][1, 1])


@pytest.mark.parametrize("lane", [0, 2])
def test_insert_lane_equals_the_reference(lane):
    rng = np.random.default_rng(lane + 1)
    arrays = _cache_numpy(rng)
    lane_arrays = _cache_numpy(rng, batch=1)
    want = jctl.insert_lane(_jcache(arrays), _jcache(lane_arrays),
                            jnp.int32(lane))
    got = tctl.insert_lane(bridge.cache_from_numpy(arrays, device="cpu"),
                           bridge.cache_from_numpy(lane_arrays, device="cpu"),
                           torch.tensor(lane, dtype=torch.int32))
    _assert_cache(got, {f.name: getattr(want, f.name)
                        for f in dataclasses.fields(want)})


def test_migration_bytes_equals_the_reference():
    rng = np.random.default_rng(3)
    M = 9
    cols = rng.integers(0, 3, (10, M)).astype(np.int32)
    cols[0, [1, 4]] = -1                # two sentinel promote rows
    cols[5, [1, 2, 4, 7]] = -1          # four sentinel demote rows
    jplan = jmig.MigrationPlan(*[jnp.asarray(c) for c in cols])
    tplan = tmig.MigrationPlan(*[torch.as_tensor(c) for c in cols])
    page_bytes = 2 * T * KH * HD * 2
    got = tmig.migration_bytes(tplan, page_bytes)
    want = jmig.migration_bytes(jplan, page_bytes)
    assert [int(g) for g in got] == [int(w) for w in want] == \
        [7 * page_bytes, 5 * page_bytes]


def _traffic(mod, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return mod.StepTraffic(**{f: rng.random(n) * 1e8 for f in (
        "h_read", "e_read", "h_write", "e_write", "m_in", "m_out")})


def test_latency_totals_equal_the_reference():
    assert set(SPECS) == {"gh200", "h100"}
    assert dataclasses.asdict(TGH200.with_kv_budget(8e9)) == \
        dataclasses.asdict(JGH200.with_kv_budget(8e9))
    jt, tt = _traffic(jlat), _traffic(tlat)
    got = tlat.total_latency(tt, TGH200)
    want = jlat.total_latency(jt, JGH200)
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert tlat.tokens_per_second(tt, TGH200, 64) == pytest.approx(
        jlat.tokens_per_second(jt, JGH200, 64), rel=1e-12, abs=0)
    zero = tlat.StepTraffic(*([np.zeros(3)] * 6))
    assert tlat.tokens_per_second(zero, TGH200, 3) == float("inf")


def test_kv_workload_equals_the_reference():
    args = dict(bytes_per_token_layer=jlat.gqa_kv_bytes_per_token_layer(
        8, 128), weight_bytes_per_layer_step=123456, num_layers=32,
        prompt_len=30000, decode_len=1000)
    assert tlat.gqa_kv_bytes_per_token_layer(8, 128) == \
        jlat.gqa_kv_bytes_per_token_layer(8, 128)
    assert tlat.gqa_kv_bytes_per_token_layer(4, 64, 4) == \
        jlat.gqa_kv_bytes_per_token_layer(4, 64, 4)
    got, want = tlat.KVWorkload(**args), jlat.KVWorkload(**args)
    assert got.kv_bytes_total() == want.kv_bytes_total()
    with pytest.raises(AttributeError, match="page size"):
        got.page_bytes
