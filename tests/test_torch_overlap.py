"""Overlap mode of the port (`EngineConfig.overlap_migrations`,
`measured_payback`) against the reference on the CPU.

The internlm2-1.8b smoke config in float32 with the same weights
(carried by the bridge), both sides priced on the port's H100 spec. The
reference's overlap serve runs on the CPU only with the pinned-host
placement switched off on the engine instance
(`eng._host_memory_kind = None`): jax lists a `pinned_host` memory kind
on the CPU, and its attention then mixes memory spaces. Greedy tokens,
terminal statuses and every per-step (h_read, e_read, m_in, m_out) must
be equal exactly:

  * on a stream that never spills (every policy), and on one under HBM
    pressure (`importance`, `quest`) where pages are committed, both
    with more requests than slots, so lanes are reused and
    `mask_plan_lanes` drops rows of rebound lanes;
  * through the row-copy routes the card takes for pinned host pools
    (on CPU tensors `ops.copy_rows` runs its plain version).

Units against the reference: `revalidate_plan`, `mask_plan_lanes`,
`protect_read_residents` and every policy's plan-ahead plan.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.tiers import MemorySystemSpec as JSpec  # noqa: E402
from repro.kvcache.migrate import MigrationPlan as JPlan  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import control as jctl  # noqa: E402
from repro.serving import policies as jpol  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.tiers import H100  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.kvcache.migrate import MigrationPlan  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serving import control as tctl  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import policies as tpol  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

POLICIES = ("static", "importance", "recency", "cost_aware", "quest")
PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(MigrationPlan))
JAX_H100 = JSpec(**dataclasses.asdict(H100))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jconfigs.get_smoke("internlm2-1.8b"),
                               dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("internlm2-1.8b"),
                               dtype=torch.float32, param_dtype=torch.float32)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = bridge.params_from_jax(jax.device_get(jp), tcfg,
                                device="cpu")
    return jm, jp, TModel(tcfg), tp


# --------------------------------------------------------------------------- #
# the streams (the reference's tests/test_async_migration.py settings)
# --------------------------------------------------------------------------- #

def no_spill(policy):
    """`_serve_cfg` + `_stream`: 4 short requests through 2 slots, every
    page in HBM."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (16 + 8 * (i % 3),)) for i in range(4)]
    kw = dict(max_context=128, hbm_fraction=0.25, policy=policy,
              attention_sparsity=0.5 if policy == "quest" else 0.0,
              promote_thresh=0.005, telemetry_stride=4, prefill_chunk=16)
    return kw, prompts, 5


def pressure(policy):
    """`test_pipeline_commits_under_pressure`: 3 requests of 272/288
    tokens through 2 slots, 16 HBM pages per lane, sparse reads."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (272 + 16 * (i % 2),)) for i in range(3)]
    kw = dict(max_context=512, hbm_fraction=0.25, policy=policy,
              attention_sparsity=0.5, promote_thresh=1e-4,
              telemetry_stride=8, prefill_chunk=16)
    return kw, prompts, 8


STREAMS = [("no_spill", p) for p in POLICIES] + \
    [("pressure", "importance"), ("pressure", "quest")]


def outcome(eng, rep):
    return {
        "outputs": {r.rid: list(r.output) for r in rep.completed},
        "statuses": rep.statuses,
        "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats],
    }


@pytest.fixture(scope="module")
def reference(models):
    jm, jp, _, _ = models
    runs = {}

    def get(stream, policy):
        if (stream, policy) not in runs:
            kw, prompts, budget = globals()[stream](policy)
            eng = JEngine(jm, jp, JConfig(spec=JAX_H100,
                                          overlap_migrations=True, **kw))
            eng._host_memory_kind = None
            rep = eng.serve([JRequest(rid=i, prompt=p, max_new_tokens=budget)
                             for i, p in enumerate(prompts)], num_slots=2,
                            seed=0)
            runs[stream, policy] = outcome(eng, rep)
        return runs[stream, policy]
    return get


def port_run(models, stream, policy, **extra):
    _, _, tm, tp = models
    kw, prompts, budget = globals()[stream](policy)
    eng = ServingEngine(tm, tp, EngineConfig(spec=H100,
                                             overlap_migrations=True,
                                             **kw, **extra), device="cpu")
    rep = eng.serve([Request(rid=i, prompt=p, max_new_tokens=budget)
                     for i, p in enumerate(prompts)], num_slots=2, seed=0)
    return eng, rep


@pytest.mark.parametrize("stream,policy", STREAMS)
def test_overlap_serve_matches_reference(models, reference, stream, policy):
    eng, rep = port_run(models, stream, policy)
    got = outcome(eng, rep)
    want = reference(stream, policy)
    assert got["statuses"] == want["statuses"]
    assert got["outputs"] == want["outputs"]
    assert got["bytes"] == want["bytes"]
    assert set(got["statuses"].values()) == {"ok"}
    # on the CPU the overlap cache's host pools are plain CPU tensors
    assert not eng.state.k_host.is_pinned()
    assert eng.state.k_host.device == eng.state.k_hbm.device
    migrated = sum(b[2] + b[3] for b in got["bytes"])
    if stream == "pressure":
        assert migrated > 0
        assert sum(b[1] for b in got["bytes"]) > 0          # host reads
    if policy == "static":
        assert migrated == 0


def test_lane_reuse_drops_rows_of_rebound_lanes(models, monkeypatch):
    """More requests than slots: at the boundary where a lane is rebound,
    the staged plan is masked with that lane marked stale."""
    seen = []
    real = tctl.mask_plan_lanes

    def spy(plan, stale):
        seen.append(stale.clone())
        return real(plan, stale)
    monkeypatch.setattr(tctl, "mask_plan_lanes", spy)
    port_run(models, "pressure", "importance")
    assert seen[0].all()                    # both lanes bound at start
    assert any(s.any() for s in seen[1:])   # a lane rebound later


@pytest.mark.parametrize("policy", ["importance", "quest"])
def test_pinned_routes_match_reference(models, reference, monkeypatch,
                                       policy):
    """The routes the card takes for pinned host pools — token writes,
    the prefill plane's bounded read, staging and commit, all through
    `ops.copy_rows` — on CPU tensors (its plain version): the same
    stream as the reference, the copies really ran, and every index
    they were given is what the card's kernel accepts (a contiguous
    int32 [rows] tensor, a contiguous bool [rows] keep mask, at most
    four pairs)."""
    calls = []
    real = ref.page_copy_ref

    def counted(*pairs, keep=None):
        given = [i for p in pairs for i in (*p[1], *p[3]) if i is not None]
        rows = given[0].shape[0]
        for i in given:
            assert i.dtype == torch.int32 and i.dim() == 1
            assert i.shape[0] == rows and i.is_contiguous()
        if keep is not None:
            assert keep.dtype == torch.bool and keep.dim() == 1
            assert keep.shape[0] == rows and keep.is_contiguous()
        assert 1 <= len(pairs) <= 4
        calls.append(1)
        return real(*pairs, keep=keep)
    monkeypatch.setattr(ref, "page_copy_ref", counted)
    eng, rep = port_run(models, "pressure", policy)
    assert outcome(eng, rep) == reference("pressure", policy)
    assert len(calls) > 0


def test_step_run_generate_stay_inline(models):
    """`generate` with overlap_migrations on runs inline, as in the
    reference (serve only); its tokens equal an inline engine's."""
    _, _, tm, tp = models
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, 256, (2, 40)), dtype=torch.int32)
    toks = []
    for overlap in (False, True):
        eng = ServingEngine(tm, tp, EngineConfig(
            max_context=128, overlap_migrations=overlap), device="cpu")
        logits = eng.start(prompt)
        toks.append(eng.generate(logits.argmax(-1).to(torch.int32), 4))
    assert torch.equal(toks[0], toks[1])


# --------------------------------------------------------------------------- #
# hazard masking and plan-ahead, units against the reference
# --------------------------------------------------------------------------- #

L_, B_, PH, PE = 2, 2, 4, 6


def owners(ho, eo):
    """A port cache and a reference cache with these owner maps."""
    geo = paged.CacheGeometry(num_layers=L_, batch=B_, page_tokens=4,
                              hbm_pages=PH, host_pages=PE, kv_heads=2,
                              head_dim=8, dtype=torch.float32)
    cache = paged.init_cache(geo, device="cpu")
    cache.hbm_owner = torch.as_tensor(ho)
    cache.host_owner = torch.as_tensor(eo)
    jcache = bridge.cache_to_numpy(cache)
    from repro.kvcache.paged import PagedKVCache as JCache
    return cache, JCache(**{k: jnp.asarray(v) for k, v in jcache.items()})


def plans(rows):
    """(port plan, reference plan) of the same ten columns."""
    cols = np.asarray(rows, np.int32)
    return (MigrationPlan(*[torch.as_tensor(c) for c in cols]),
            JPlan(*[jnp.asarray(c) for c in cols]))


def assert_same_plan(tplan, jplan):
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)


def test_revalidate_masks_exactly_the_hazards():
    """The reference's hazard cases: a valid swap, a valid fill, a stale
    source, and a fill whose destination the interim step occupied."""
    ho = np.full((L_, B_, PH), -1, np.int32)
    eo = np.full((L_, B_, PE), -1, np.int32)
    eo[0, 0, 2] = 5
    ho[0, 0, 1] = 7
    eo[1, 1, 3] = 4
    eo[0, 1, 1] = 9
    eo[1, 0, 0] = 2
    ho[1, 0, 2] = 6
    tc, jc = owners(ho, eo)
    tp, jp = plans([[0, 1, 0, 1, -1], [0, 1, 1, 0, -1], [2, 3, 1, 0, -1],
                    [1, 0, 3, 2, -1], [5, 4, 8, 2, -1], [0, -1, 0, -1, -1],
                    [0, -1, 1, -1, -1], [1, -1, 3, -1, -1],
                    [2, -1, 1, -1, -1], [7, -1, 3, -1, -1]])
    got = tctl.revalidate_plan(tp, tc)
    assert_same_plan(got, jctl.revalidate_plan(jp, jc))
    assert (got.pro_layer >= 0).tolist() == [True, True, False, False,
                                             False]
    assert (got.dem_layer >= 0).tolist() == [True, False, False, False,
                                             False]


def test_revalidate_masks_a_swap_whose_victim_moved():
    ho = np.full((L_, B_, PH), -1, np.int32)
    eo = np.full((L_, B_, PE), -1, np.int32)
    eo[0, 0, 2] = 5
    ho[0, 0, 1] = 3                      # the plan expects 7 there
    tc, jc = owners(ho, eo)
    tp = MigrationPlan.build(4, [(0, 0, 2, 1, 5)], [(0, 0, 1, 2, 7)],
                             device="cpu")
    jp = JPlan.build(4, [(0, 0, 2, 1, 5)], [(0, 0, 1, 2, 7)])
    got = tctl.revalidate_plan(tp, tc)
    assert_same_plan(got, jctl.revalidate_plan(jp, jc))
    assert not (got.pro_layer >= 0).any()
    assert not (got.dem_layer >= 0).any()


@pytest.mark.parametrize("seed", range(4))
def test_revalidate_on_random_caches(seed):
    rng = np.random.default_rng(seed)
    ho = rng.integers(-1, PH + PE, (L_, B_, PH)).astype(np.int32)
    eo = rng.integers(-1, PH + PE, (L_, B_, PE)).astype(np.int32)
    tc, jc = owners(ho, eo)
    M = 8
    cols = [rng.integers(-1, L_, M), rng.integers(-1, B_, M),
            rng.integers(-1, PE, M), rng.integers(-1, PH, M),
            rng.integers(-1, PH + PE, M), rng.integers(-1, L_, M),
            rng.integers(-1, B_, M), rng.integers(-1, PH, M),
            rng.integers(-1, PE, M), rng.integers(-1, PH + PE, M)]
    tp, jp = plans(cols)
    assert_same_plan(tctl.revalidate_plan(tp, tc),
                     jctl.revalidate_plan(jp, jc))


def test_mask_plan_lanes_drops_stale_lane_rows():
    tp, jp = plans([[0, 0, 1, -1], [0, 1, 1, -1], [1, 2, 3, -1],
                    [0, 1, 2, -1], [4, 5, 6, -1], [0, 0, -1, -1],
                    [0, 1, -1, -1], [0, 1, -1, -1], [1, 2, -1, -1],
                    [7, 8, -1, -1]])
    stale = [False, True]
    got = tctl.mask_plan_lanes(tp, torch.tensor(stale))
    assert_same_plan(got, jctl.mask_plan_lanes(jp, jnp.asarray(stale)))
    assert (got.pro_layer >= 0).tolist() == [True, False, False, False]
    assert (got.dem_layer >= 0).tolist() == [True, False, False, False]


@pytest.fixture(scope="module")
def cache_state(models):
    """A reference cache of 2 lanes prefilled past HBM (lane 1 shorter),
    importance from a few levels (ties), and its port copy."""
    jm, jp, _, _ = models
    geo = jm.cache_geometry(2, 512)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (2, 300)).astype(np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(toks), geo)
    jc = dataclasses.replace(jc, length=jnp.asarray([300, 270], jnp.int32))
    alive = np.asarray(jc.page_table) >= 0
    imp = rng.integers(0, 4, alive.shape) / 4.0
    jc = dataclasses.replace(jc, importance=jnp.asarray(
        np.where(alive, imp, 0.0), jnp.float32))
    fields = {f.name: np.asarray(getattr(jc, f.name))
              for f in dataclasses.fields(jc)}
    return geo, jc, bridge.cache_from_numpy(fields, device="cpu")


def test_protect_read_residents(cache_state):
    _, jc, tc = cache_state
    mask = np.array(jctl.quest_page_mask(jc, 0.5))
    score = np.random.default_rng(1).random(
        tc.hbm_owner.shape).astype(np.float32)
    got = tpol.protect_read_residents(tc, torch.as_tensor(score),
                                      torch.as_tensor(mask))
    want = jpol.protect_read_residents(jc, jnp.asarray(score),
                                       jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isinf(got.numpy()).any()
    assert tpol.protect_read_residents(tc, torch.as_tensor(score),
                                       None) is not None


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("overlap,sparsity", [(False, 0.5), (True, 0.0),
                                              (True, 0.5)])
def test_plan_ahead_is_on_only_with_overlap_and_sparsity(policy, overlap,
                                                         sparsity):
    kw = dict(policy=policy, overlap_migrations=overlap,
              attention_sparsity=sparsity)
    got = tpol.make_policy(policy, cfg=EngineConfig(**kw), geo=None)
    want = jpol.make_policy(policy, cfg=JConfig(**kw), geo=None)
    assert got.plan_ahead == want.plan_ahead == (overlap and sparsity > 0)


@pytest.mark.parametrize("policy", POLICIES)
def test_plan_ahead_plans_match_reference(cache_state, policy):
    """Every policy in plan-ahead mode, on the same cache and read set:
    the same plan rows, counts and state as the reference's."""
    geo, jc, tc = cache_state
    kw = dict(policy=policy, overlap_migrations=True, attention_sparsity=0.5,
              promote_thresh=1e-4, spec=H100)
    tp = tpol.make_policy(policy, cfg=EngineConfig(**kw), geo=geo)
    jkw = dict(kw, spec=JAX_H100)
    jp = jpol.make_policy(policy, cfg=JConfig(**jkw), geo=geo)
    assert tp.plan_ahead and jp.plan_ahead
    read = np.array(jctl.quest_page_mask(jc, 0.5))
    jstate = jp.init_state(geo)
    tstate = tp.init_state(geo)
    budget = tctl.migration_budget(geo, 0.1)
    for _ in range(2):                   # twice: state carried across
        jplan, jstate, (jn_pro, jn_dem) = jp.plan(
            jc, jstate, None, budget, read_mask=jnp.asarray(read))
        tplan, tstate, (tn_pro, tn_dem) = tp.plan(
            tc, tstate, None, budget, read_mask=torch.as_tensor(read))
        assert_same_plan(tplan, jplan)
        assert (int(tn_pro), int(tn_dem)) == (int(jn_pro), int(jn_dem))
    if policy in ("importance", "recency", "cost_aware"):
        # protection changed something: the unprotected plan differs
        # or the read set's residents were never victims anyway
        ho = tc.hbm_owner.numpy()
        in_read = np.take_along_axis(read, np.maximum(ho, 0), -1) & (ho >= 0)
        victims = tplan.dem_src.numpy()
        lay, bat = tplan.dem_layer.numpy(), tplan.dem_batch.numpy()
        live = lay >= 0
        assert not in_read[lay[live], bat[live], victims[live]].any()


# --------------------------------------------------------------------------- #
# measured payback
# --------------------------------------------------------------------------- #

def test_payback_event_carries_the_reference_keys(models):
    """measured_payback on the CPU: one `payback_measured` event at step
    0 with the reference's keys, and the stream still completes ok."""
    jm, jp, _, _ = models
    kw, prompts, budget = no_spill("cost_aware")
    jeng = JEngine(jm, jp, JConfig(spec=JAX_H100, overlap_migrations=True,
                                   measured_payback=True, **kw))
    jeng._host_memory_kind = None
    jrep = jeng.serve([JRequest(rid=i, prompt=p, max_new_tokens=budget)
                       for i, p in enumerate(prompts)], num_slots=2)
    eng, rep = port_run(models, "no_spill", "cost_aware",
                        measured_payback=True)
    got = [e for e in rep.events if e["kind"] == "payback_measured"]
    want = [e for e in jrep.events if e["kind"] == "payback_measured"]
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for key in ("step", "rows", "bytes", "modeled_link_bw"):
        assert got[0][key] == want[0][key]
    assert set(rep.statuses.values()) == {"ok"}


def test_measured_link_spec_inverts_as_the_reference():
    """The inversion: the move costs 1/link_bw + 1/hbm_bw a byte; a
    non-positive difference, or one under the HBM floor, gives None."""
    moved = 1 << 20
    t_link = moved / 32e9 + moved / H100.hbm_bw
    spec, detail = tengine.measured_link_spec(H100, t_link, moved, rows=8)
    assert spec.link_bw == pytest.approx(32e9, rel=1e-9)
    assert spec.name == "h100+measured"
    assert detail == {"rows": 8, "bytes": moved, "delta_s": t_link,
                      "modeled_link_bw": H100.link_bw,
                      "measured_link_bw": spec.link_bw}
    for delta in (0.0, -1e-3, 0.5 * moved / H100.hbm_bw):
        spec, detail = tengine.measured_link_spec(H100, delta, moved, 8)
        assert spec is None and detail["measured_link_bw"] is None


def test_payback_probe_times_the_swap_over_the_empty_plan(models,
                                                          monkeypatch):
    """The probe commits the swap plan and the all-sentinel plan over
    one cache (the pages every commit stages for its sentinel rows are
    in both); the swap pairs each promote with a demote back to its
    host slot, and a direction left out is all sentinels."""
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, EngineConfig(spec=H100), device="cpu")
    geo = tm.cache_geometry(2, 128)
    seen = []
    real = tengine.apply_migrations

    def spy(cache, plan, *shard):
        seen.append((int((plan.pro_layer >= 0).sum()), id(cache)))
        return real(cache, plan, *shard)
    monkeypatch.setattr(tengine, "apply_migrations", spy)
    _, detail = eng._measure_migration_spec(geo, iters=2)
    cap = tctl.plan_capacity(geo, eng.cfg.migration_budget_frac)
    assert sorted({n for n, _ in seen}) == [0, cap]
    assert len({c for _, c in seen}) == 1 and len(seen) == 2 * (1 + 2)
    assert detail["rows"] == cap
    assert detail["bytes"] == 2 * cap * geo.page_bytes()
    plan = tengine.swap_plan(geo, cap, "cpu")
    assert torch.equal(plan.dem_dst, plan.pro_src)
    assert torch.equal(plan.dem_src, plan.pro_dst)
    slots = np.arange(cap) % 3 + 1
    alone = tengine.swap_plan(geo, cap, "cpu", slots, demotes=False)
    assert alone.pro_src.tolist() == slots.tolist()
    assert (alone.dem_layer == -1).all() and (alone.dem_dst == -1).all()


@pytest.mark.parametrize("measured", [False, True])
def test_payback_recalibrates_cost_aware(models, monkeypatch, measured):
    """A measurement recalibrates cost_aware's thresholds from the
    measured spec; None leaves them modeled. Pricing stays on cfg.spec."""
    spec = dataclasses.replace(H100, name="h100+measured", link_bw=8e9)
    detail = {"rows": 4, "bytes": 1, "delta_s": 1.0,
              "modeled_link_bw": H100.link_bw,
              "measured_link_bw": 8e9 if measured else None}
    monkeypatch.setattr(ServingEngine, "_measure_migration_spec",
                        lambda self, geo: (spec if measured else None,
                                           detail))
    eng, rep = port_run(models, "no_spill", "cost_aware",
                        measured_payback=True)
    want = eng._policy.recalibrate(None, spec if measured else H100)
    for key, value in want.items():
        assert torch.equal(eng._pstate[key], value), key
    assert rep.events[0] == {"kind": "payback_measured", "step": 0,
                             **detail}
    assert eng.cfg.spec is H100


# --------------------------------------------------------------------------- #
# the pinned host tier on the CPU
# --------------------------------------------------------------------------- #

def test_host_pinned_cache_on_the_cpu_is_a_plain_cache():
    geo = paged.CacheGeometry(num_layers=2, batch=2, page_tokens=4,
                              hbm_pages=4, host_pages=6, kv_heads=2,
                              head_dim=8)
    a = paged.init_cache(geo, "cpu", host_pinned=True)
    b = paged.init_cache(geo, "cpu")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.device.type == "cpu" and not x.is_pinned()
        assert torch.equal(x, y), f.name


def test_paged_kernel_refuses_a_pageable_host_pool():
    """Before any CUDA call: a host pool that is not pinned raises, and
    is never copied to the card."""
    q = torch.zeros((2, 2, 2, 16))
    pool = torch.zeros((2, 4, 16, 2, 16))
    lists = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="pageable"):
        pa.paged_attention(q, pool, pool, lists, lists)


def test_copy_rows_plain_version_drops_out_of_range_rows():
    """`ops.copy_rows` on CPU tensors: rows with a -1 or out-of-range
    index on either side are skipped, the rest copied (gather, then the
    token scatter of a decode step)."""
    rng = np.random.default_rng(0)
    pool = torch.as_tensor(rng.standard_normal((2, 3, 5, 4, 8)),
                           dtype=torch.float32)
    lay = torch.tensor([0, 1, -1, 2, 1], dtype=torch.int32)
    lane = torch.tensor([2, 0, 1, 0, 1], dtype=torch.int32)
    slot = torch.tensor([4, 0, 3, 1, 5], dtype=torch.int32)
    out = torch.zeros((5, 4, 8))
    ops.copy_rows((out, (None,), pool, (lay, lane, slot)))
    for r in range(5):
        ok = 0 <= lay[r] < 2 and 0 <= slot[r] < 5
        want = pool[lay[r], lane[r], slot[r]] if ok else torch.zeros(4, 8)
        assert torch.equal(out[r], want), r
    tok = torch.ones((3, 4, 8))
    dst = pool[0].clone()
    ops.copy_rows((dst, (None, torch.tensor([1, -1, 4], dtype=torch.int32)),
                   tok, (None,)))
    want = pool[0].clone()
    want[0, 1] = 1.0
    want[2, 4] = 1.0
    assert torch.equal(dst, want)


def test_page_copy_layout_arguments_and_refusals():
    """The launcher's per-side layout (`page_copy._layout`, checked once
    per shape): bounds and byte strides of the indexed dims padded to
    four, the row's bytes; a row that is not contiguous, or strides
    that break 16-byte vectors, are refused."""
    from repro_torch.kernels import page_copy as pc
    pool = torch.zeros((2, 3, 5, 4, 2, 16), dtype=torch.bfloat16)
    args, row = pc._layout("dst", tuple(pool.shape), pool.stride(), 2, 3)
    assert args == [2, 3, 5, 1, 3 * 5 * 128 * 2, 5 * 128 * 2, 128 * 2, 0]
    assert row == 4 * 2 * 16 * 2
    args, row = pc._layout("src", (7, 2, 16), (32, 16, 1), 4, 1)
    assert args == [7, 1, 1, 1, 128, 0, 0, 0] and row == 128
    with pytest.raises(ValueError, match="contiguous"):
        pc._layout("dst", (3, 4, 16), (64, 1, 4), 2, 1)
    with pytest.raises(ValueError, match="16 bytes"):
        pc._layout("dst", (3, 4), (4, 1), 2, 1)
    with pytest.raises(ValueError, match="1..4"):
        pc._layout("dst", (3, 4), (4, 1), 2, 3)
