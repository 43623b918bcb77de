"""The port's fault plane (`serving.faults`) against the reference's, on
the CPU.

Units: the plane's schedules (`spec_at`, `commit_caps`, `pool_delta`,
`poison_steps`, `window_events`, `FaultPlane.random`) equal the
reference's for the same arguments and seeds; `throttle_plan` equals
the reference's on random plans at caps 0, partial and `NO_FAULT_CAP`;
`degraded_spec` equals the reference's. Serve: the reference's chaos
scenarios (`tests/test_chaos.py::TestChaosServe`, one fault kind at a
time, then the full plane, then seeded random planes) and a partial
commit under HBM pressure, inline and in overlap mode, on the
internlm2-1.8b smoke config in float32 with the same weights: greedy
tokens, statuses with error codes, events and every priced StepStats
row exactly equal (modeled latencies within 1e-12 relative).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.latency_model import degraded_spec as j_degraded  # noqa: E402
from repro.kvcache.migrate import MigrationPlan as JPlan  # noqa: E402
from repro.serving import faults as jf  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch.core.latency_model import degraded_spec  # noqa: E402
from repro_torch.core.tiers import GH200, H100  # noqa: E402
from repro_torch.kvcache.migrate import MigrationPlan  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tf  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402

from _torch_serve_ref import (  # noqa: E402
    JAX_H100, assert_same, engines, outcome, requests, smoke_pair,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(MigrationPlan))


def both(kind, **kw):
    """The same fault plane built by the reference and by the port."""
    def build(mod):
        return mod.FaultPlane(
            tier=tuple(mod.TierFault(**t) for t in kw.get("tier", ())),
            migration=tuple(mod.MigrationFault(**m)
                            for m in kw.get("migration", ())),
            pool=tuple(mod.PoolFault(**p) for p in kw.get("pool", ())),
            poison=tuple(mod.PoisonFault(**p)
                         for p in kw.get("poison", ())))
    return build(jf) if kind == "ref" else build(tf)


FULL = dict(tier=[dict(start=2, stop=10, link_scale=0.1, dram_scale=0.5)],
            migration=[dict(start=0, stop=24, commit_frac=0.0)],
            pool=[dict(step=4, delta=-2)],
            poison=[dict(rid=1, step=6)])
OVERLAPPING = dict(tier=[dict(start=0, stop=9, hbm_scale=0.5,
                              link_scale=0.25),
                         dict(start=5, stop=20, link_scale=0.5,
                              dram_scale=0.3)],
                   migration=[dict(start=3, stop=11, commit_frac=0.5),
                              dict(start=8, stop=30, commit_frac=0.0)],
                   pool=[dict(step=4, delta=-3), dict(step=6, delta=2)],
                   poison=[dict(rid=2, step=9), dict(rid=5, step=0)])


def spec_tuple(spec):
    return dataclasses.astuple(spec)


@pytest.mark.parametrize("kw", [FULL, OVERLAPPING], ids=["full", "overlap"])
def test_schedules_match_reference(kw):
    jplane, tplane = both("ref", **kw), both("port", **kw)
    base = dataclasses.asdict(H100)
    jbase = JAX_H100
    rids = np.array([1, -1, 2, 5], np.int32)
    for step in range(0, 40):
        assert spec_tuple(tplane.spec_at(step, H100)) == \
            spec_tuple(jplane.spec_at(step, jbase)), step
        assert tplane.scales_at(step) == jplane.scales_at(step)
    assert dataclasses.asdict(H100) == base
    for step0, stride in ((0, 4), (2, 4), (4, 8), (8, 16), (20, 16)):
        np.testing.assert_array_equal(
            tplane.commit_caps(step0, stride, 13),
            jplane.commit_caps(step0, stride, 13))
        assert tplane.pool_delta(step0, stride) == \
            jplane.pool_delta(step0, stride)
        np.testing.assert_array_equal(
            tplane.poison_steps(step0, stride, rids),
            jplane.poison_steps(step0, stride, rids))
        assert tplane.window_events(step0, stride) == \
            jplane.window_events(step0, stride)


@pytest.mark.parametrize("seed", range(6))
def test_random_plane_matches_reference(seed):
    kw = dict(steps=48, rids=[0, 1, 2, 3, 7])
    if seed % 2:
        kw.update(n_tier=3, n_migration=1, n_pool=2, n_poison=2,
                  max_shrink=5)
    got = dataclasses.asdict(tf.FaultPlane.random(seed, **kw))
    want = dataclasses.asdict(jf.FaultPlane.random(seed, **kw))
    assert got == want
    assert tf.FaultPlane.random(seed, **kw) == tf.FaultPlane.random(seed,
                                                                    **kw)


def random_plan(rng, capacity):
    """A plan with live promote rows scattered among sentinel rows and
    index-paired demote rows."""
    cols = {f: np.full((capacity,), -1, np.int32) for f in PLAN_FIELDS}
    live = rng.random(capacity) < 0.6
    for f in PLAN_FIELDS:
        cols[f][live] = rng.integers(0, 9, int(live.sum()))
    dem = live & (rng.random(capacity) < 0.7)
    for f in PLAN_FIELDS[5:]:
        cols[f][live & ~dem] = -1
    return cols


@pytest.mark.parametrize("cap", [0, 1, 3, 7, int(tf.NO_FAULT_CAP)])
def test_throttle_plan_matches_reference(cap):
    rng = np.random.default_rng(cap)
    for _ in range(4):
        cols = random_plan(rng, 16)
        want = jf.throttle_plan(JPlan(*[jnp.asarray(cols[f])
                                        for f in PLAN_FIELDS]),
                                jnp.int32(cap))
        got = tf.throttle_plan(MigrationPlan(*[torch.as_tensor(cols[f])
                                               for f in PLAN_FIELDS]), cap)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
            assert getattr(got, f).dtype == torch.int32
        # a 0-dim tensor cap gives the same plan as the host int
        again = tf.throttle_plan(MigrationPlan(*[torch.as_tensor(cols[f])
                                                 for f in PLAN_FIELDS]),
                                 torch.tensor(min(cap, 2**30)))
        for f in PLAN_FIELDS:
            assert torch.equal(getattr(again, f), getattr(got, f))


@pytest.mark.parametrize("spec", [H100, GH200], ids=["h100", "gh200"])
def test_degraded_spec_matches_reference(spec):
    jspec = type(JAX_H100)(**dataclasses.asdict(spec))
    for scales in ((1.0, 1.0, 1.0), (0.5, 0.1, 0.25), (1.0, 0.01, 1.0)):
        h, k, d = scales
        got = degraded_spec(spec, hbm_scale=h, link_scale=k, dram_scale=d)
        want = j_degraded(jspec, hbm_scale=h, link_scale=k, dram_scale=d)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.hbm_capacity == spec.hbm_capacity
        assert got.bw_ratio == want.bw_ratio
    with pytest.raises(ValueError):
        degraded_spec(spec, link_scale=0.0)


# --------------------------------------------------------------------------- #
# serve under fault planes, against the reference
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def models():
    return smoke_pair()


def chaos_cfg(policy="importance", **kw):
    """The reference's chaos-suite engine settings."""
    return dict(max_context=128, hbm_fraction=0.25, policy=policy,
                promote_thresh=0.005, telemetry_stride=4, prefill_chunk=16,
                **kw)


def chaos_prompts(vocab, n):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, (16 + 8 * (i % 2),)) for i in range(n)]


def pressure_prompts(vocab, n):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, (272 + 16 * (i % 2),)) for i in range(n)]


#: name -> (engine settings, prompts, n, budget, plane kwargs)
SCENARIOS = {
    "full": (chaos_cfg(), chaos_prompts, 4, 6, FULL),
    "poison": (chaos_cfg(), chaos_prompts, 5, 8,
               dict(poison=[dict(rid=0, step=2)])),
    "migration_drop": (chaos_cfg(), chaos_prompts, 4, 6,
                       dict(migration=[dict(start=0, stop=10_000,
                                            commit_frac=0.0)])),
    "tier": (chaos_cfg("cost_aware"), chaos_prompts, 4, 6,
             dict(tier=[dict(start=0, stop=10_000, hbm_scale=0.5,
                             link_scale=0.01)])),
    "commit_streak": (chaos_cfg(fallback_commit_faults=2), chaos_prompts,
                      4, 10, dict(migration=[dict(start=0, stop=10_000,
                                                  commit_frac=0.0)])),
    "pool_shrink": (chaos_cfg(), chaos_prompts, 6, 8,
                    dict(pool=[dict(step=4, delta=-14),
                               dict(step=24, delta=10)])),
    "partial_commit": (dict(max_context=512, hbm_fraction=0.25,
                            policy="importance", attention_sparsity=0.5,
                            promote_thresh=1e-4, telemetry_stride=8,
                            prefill_chunk=16),
                       pressure_prompts, 3, 8,
                       dict(migration=[dict(start=8, stop=40,
                                            commit_frac=0.05)],
                            tier=[dict(start=24, stop=34,
                                       link_scale=0.5)])),
}


def run_both(models, scenario, overlap, plane_kw=None, seed=None):
    cfg, make, n, budget, kw = SCENARIOS[scenario]
    jeng, teng = engines(models, overlap=overlap, **cfg)
    prompts = make(models[2].cfg.vocab, n)
    if seed is None:
        jplane, tplane = both("ref", **(plane_kw or kw)), \
            both("port", **(plane_kw or kw))
    else:
        rids = list(range(n))
        jplane = jf.FaultPlane.random(seed, steps=48, rids=rids)
        tplane = tf.FaultPlane.random(seed, steps=48, rids=rids)
    jrep = jeng.serve(requests(JRequest, prompts, budget), num_slots=2,
                      seed=0, faults=jplane)
    trep = teng.serve(requests(Request, prompts, budget), num_slots=2,
                      seed=0, faults=tplane)
    return outcome(teng, trep), outcome(jeng, jrep), trep


MODES = pytest.mark.parametrize("overlap", [False, True],
                                ids=["inline", "overlap"])


@MODES
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_chaos_serve_matches_reference(models, scenario, overlap,
                                       monkeypatch):
    dropped = []

    def spy(plan, cap, ahead=None):
        out = tf.throttle_plan(plan, cap, ahead)
        dropped.append(int((plan.pro_layer >= 0).sum()
                           - (out.pro_layer >= 0).sum()))
        return out
    monkeypatch.setattr(tengine, "throttle_plan", spy)
    got, want, rep = run_both(models, scenario, overlap)
    assert_same(got, want)
    kinds = {e["kind"] for e in rep.events}
    statuses = rep.statuses
    if scenario == "full":
        assert {"tier_degradation", "migration_fault", "pool_resize",
                "logit_poison"} <= kinds
        assert statuses[1] == "failed"
    if scenario == "poison":
        bad = next(r for r in rep.completed if r.rid == 0)
        assert bad.status == "failed"
        assert bad.error.code == "poisoned_logits"
        assert len(bad.output) < 8
    if scenario in ("migration_drop", "commit_streak"):
        assert sum(b[2] + b[3] for b in got["bytes"]) == 0
    if scenario == "tier":
        assert "payback_recalibration" in kinds
        fb = [e for e in rep.events if e["kind"] == "policy_fallback"]
        assert fb and fb[0]["reason"] == "tier_ratio"
    if scenario == "commit_streak":
        fb = [e for e in rep.events if e["kind"] == "policy_fallback"]
        assert fb and fb[0]["reason"] == "commit_faults"
    if scenario == "pool_shrink":
        assert any(s == "ok" for s in statuses.values())
    if scenario == "partial_commit":
        # pages moved, and the cap dropped some rows of a live plan
        assert sum(b[2] + b[3] for b in got["bytes"]) > 0
        assert max(dropped) > 0
    if scenario in ("poison", "pool_shrink"):
        # no cap: the throttle runs every decode step and drops nothing
        assert dropped and max(dropped) == 0


@MODES
def test_random_planes_match_reference(models, overlap):
    for seed in range(3):
        got, want, rep = run_both(models, "full", overlap, seed=seed)
        assert_same(got, want)
        assert len(rep.statuses) == 4


def test_clean_plane_is_the_clean_stream(models):
    """An empty plane changes nothing: the stream equals serve() with no
    plane, and no event is logged."""
    cfg, make, n, budget, _ = SCENARIOS["partial_commit"]
    _, teng = engines(models, **cfg)
    prompts = make(models[2].cfg.vocab, n)
    clean = outcome(teng, teng.serve(requests(Request, prompts, budget),
                                     num_slots=2))
    empty = outcome(teng, teng.serve(requests(Request, prompts, budget),
                                     num_slots=2, faults=tf.FaultPlane()))
    assert_same(empty, clean)
    assert empty["events"] == []
