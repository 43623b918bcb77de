"""Serve-stream trace capture and scoring of the port against the
reference, on the CPU (`EngineConfig.trace_telemetry` on `serve`,
`trace_bridge.collect_serve` / `attribute` / `score_serve` /
`goodput_curve`).

The internlm2-1.8b smoke config in float32 with the same weights, both
sides priced on the port's H100 spec:

  * every array of the `ServeTraceRecord` (read sets, read-time
    placements — pre-commit in overlap mode — emitted and first tokens,
    lane bindings, prompt lengths) equals the reference's exactly, on a
    contended stream with Quest sparsity, inline and overlap;
  * `attribute` stitches two requests that reuse one lane into
    disjoint, clean records, as the reference's
    `TestLaneReuseAttribution` pins, and equals the reference's;
  * `score_serve` and `goodput_curve` (modeled latency) on the port's
    record equal the reference's on its own within 1e-12, also on a
    faulted stream, and stamp the report the same way;
  * capture is pure observation: tokens and StepStats equal with it
    off.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.placement.base import UNALLOC  # noqa: E402
from repro.core.sa import SAConfig as JSAConfig  # noqa: E402
from repro.serving import faults as jf  # noqa: E402
from repro.serving import trace_bridge as jtb  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.slo import SLOPolicy as JSLO  # noqa: E402
from repro_torch.core.sa import SAConfig  # noqa: E402
from repro_torch.core.tiers import H100  # noqa: E402
from repro_torch.serving import faults as tf  # noqa: E402
from repro_torch.serving import trace_bridge as ttb  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from repro_torch.serving.slo import SLOPolicy  # noqa: E402

from _torch_serve_ref import (  # noqa: E402
    JAX_H100, engines, outcome, requests, smoke_pair,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

SA = dict(max_evaluations=8, iters_per_level=3, seed=0)
RECORD_ARRAYS = ("access", "tier", "emitted", "first", "rids", "prompt_len")
MODES = pytest.mark.parametrize("overlap", [False, True],
                                ids=["inline", "overlap"])


@pytest.fixture(scope="module")
def models():
    return smoke_pair()


def contended(vocab):
    """272/288-token prompts spill past the 16-page per-lane HBM pool
    (ctx 512), a short one reuses a lane; Quest sparsity concentrates
    reads so placement matters."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, vocab, (n,)) for n in (272, 288, 40, 280)]
    kw = dict(max_context=512, hbm_fraction=0.25, policy="importance",
              attention_sparsity=0.5, promote_thresh=1e-4,
              telemetry_stride=8, prefill_chunk=16, trace_telemetry=True)
    return kw, prompts, 8


def plane(mod):
    return mod.FaultPlane(
        tier=(mod.TierFault(start=8, stop=40, link_scale=0.25,
                            dram_scale=0.5),),
        migration=(mod.MigrationFault(start=16, stop=32,
                                      commit_frac=0.05),),
        poison=(mod.PoisonFault(rid=3, step=53),))


@pytest.fixture(scope="module")
def runs(models):
    """(overlap, faulted) -> (port engine, its report, reference engine,
    its report), each stream served once."""
    cache = {}

    def get(overlap, faulted=False):
        key = (overlap, faulted)
        if key not in cache:
            kw, prompts, budget = contended(models[2].cfg.vocab)
            jeng, teng = engines(models, overlap=overlap, **kw)
            jrep = jeng.serve(requests(JRequest, prompts, budget),
                              num_slots=2, seed=0,
                              faults=plane(jf) if faulted else None)
            trep = teng.serve(requests(Request, prompts, budget),
                              num_slots=2, seed=0,
                              faults=plane(tf) if faulted else None)
            cache[key] = (teng, trep, jeng, jrep)
        return cache[key]
    return get


@MODES
def test_serve_trace_record_matches_reference(runs, overlap):
    teng, trep, jeng, jrep = runs(overlap)
    got, want = ttb.collect_serve(teng), jtb.collect_serve(jeng)
    for name in RECORD_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    assert (got.page_tokens, got.page_bytes, got.hbm_pages) == \
        (want.page_tokens, want.page_bytes, want.hbm_pages)
    assert outcome(teng, trep)["outputs"] == outcome(jeng, jrep)["outputs"]
    # reads only on decode rows of their lane; some reads hit the host
    step_reads = got.access.any(axis=(1, 3))                  # [S, B]
    assert not np.any(step_reads & ~(got.emitted >= 0))
    assert (got.access & (got.tier == 1)).any()


@MODES
def test_attribution_matches_reference(runs, overlap):
    teng, _, jeng, _ = runs(overlap)
    got = ttb.attribute(ttb.collect_serve(teng))
    want = jtb.attribute(jtb.collect_serve(jeng))
    assert [a.rid for a in got] == [a.rid for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.lanes, b.lanes)
        for name in ("access", "tier", "moves"):
            np.testing.assert_array_equal(getattr(a.record, name),
                                          getattr(b.record, name))
        assert a.record.prompt_len == b.record.prompt_len


@MODES
def test_lane_reuse_gives_disjoint_clean_records(models, overlap):
    """Two requests through ONE slot: the lane is reused, the records
    must not cross-contaminate (the reference's
    `TestLaneReuseAttribution` on the port)."""
    rng = np.random.default_rng(5)
    vocab = models[2].cfg.vocab
    r0 = Request(rid=0, prompt=rng.integers(0, vocab, (48,)),
                 max_new_tokens=6)
    r1 = Request(rid=1, prompt=rng.integers(0, vocab, (16,)),
                 max_new_tokens=6)
    _, eng = engines(models, overlap=overlap, max_context=128,
                     hbm_fraction=0.25, policy="importance",
                     promote_thresh=0.005, telemetry_stride=4,
                     prefill_chunk=16, trace_telemetry=True)
    eng.serve([r0, r1], num_slots=1, seed=0)
    rec = ttb.collect_serve(eng)
    atts = {a.rid: a for a in ttb.attribute(rec)}
    assert set(atts) == {0, 1}
    assert np.all(atts[0].lanes == 0) and np.all(atts[1].lanes == 0)
    assert atts[0].rows.max() < atts[1].rows.min()
    for rid, req in ((0, r0), (1, r1)):
        a = atts[rid]
        assert a.record.prompt_len == req.prompt_len
        assert a.record.num_steps == req.max_new_tokens - 1
        for s in range(a.record.num_steps):
            want = -(-(req.prompt_len + 1 + s) // rec.page_tokens)
            exists = (a.record.tier[s] != UNALLOC).sum(axis=-1)
            np.testing.assert_array_equal(exists, np.full_like(exists, want))


def assert_scores_equal(got, want):
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key] == pytest.approx(val, rel=1e-12, abs=0.0), key


@MODES
@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
def test_score_serve_and_goodput_match_reference(runs, overlap, faulted):
    teng, trep, jeng, jrep = runs(overlap, faulted)
    slo = SLOPolicy.uniform(float("inf"), 2e-4)
    jslo = JSLO.uniform(float("inf"), 2e-4)
    got = ttb.goodput_curve(ttb.collect_serve(teng), H100, trep, slo,
                            sa_cfg=SAConfig(**SA))
    want = jtb.goodput_curve(jtb.collect_serve(jeng), JAX_H100, jrep, jslo,
                             sa_cfg=JSAConfig(**SA))
    assert_scores_equal(got["aggregate"], want["aggregate"])
    assert got["curve"] == want["curve"]
    assert set(trep.request_scores) == set(jrep.request_scores)
    for rid, sc in jrep.request_scores.items():
        assert_scores_equal(trep.request_scores[rid], sc)
    assert_scores_equal(trep.headroom, jrep.headroom)
    assert trep.goodput == jrep.goodput
    agg = got["aggregate"]
    assert 0.0 < agg["live_hit_fraction"] < 1.0
    assert 0.0 < agg["bound_fraction"] <= 1.0 + 1e-3
    if faulted:
        assert trep.headroom["fault_events"] == len(trep.events) > 0
        assert trep.statuses[3] == "failed"
    else:
        assert "fault_events" not in trep.headroom
    # the curve is monotone in the target scale
    fracs = [row["goodput"] for row in got["curve"]]
    assert fracs == sorted(fracs)


def test_capture_is_pure_observation(models, runs):
    teng, trep, _, _ = runs(False)
    kw, prompts, budget = contended(models[2].cfg.vocab)
    kw["trace_telemetry"] = False
    _, eng = engines(models, **kw)
    rep = eng.serve(requests(Request, prompts, budget), num_slots=2, seed=0)
    assert outcome(eng, rep) == outcome(teng, trep)
    assert eng._serve_trace_log == []
