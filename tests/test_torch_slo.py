"""The port's SLO plane (`serving.slo`, `serve(slo=...)`) against the
reference's, on the CPU.

Units: `should_shed` (its reason string included), `projected_ttft`,
`target_for` and `score_goodput` (wall and modeled latency, per tier,
with scaled targets) give the reference's answers on the same stamped
requests. Serve, on the internlm2-1.8b smoke config in float32 with the
same weights: shedding whose outcome cannot depend on the clock (a TTFT
target of 0 or infinity per tier) sheds the same requests as the
reference, with the same tokens, statuses and StepStats; the TTFT
decomposition `queue_wait + prefill + throttle == TTFT` holds within
2e-6 s (the float64 resolution of wall-clock stamps near 1.7e9 s is
2.4e-7 s, and the parts are sums of a few such stamps); no request is
both "timeout" and SLO-shed.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serving import slo as jslo  # noqa: E402
from repro.serving.engine import ServeReport as JReport  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import RequestError as JError  # noqa: E402
from repro_torch.serving import slo as tslo  # noqa: E402
from repro_torch.serving.engine import ServeReport  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    TERMINAL_STATUSES, Request, RequestError,
)

from _torch_serve_ref import (  # noqa: E402
    assert_same, engines, outcome, requests, smoke_pair,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

#: residual bound of the TTFT identity (see the module docstring)
IDENTITY_TOL = 2e-6
INF = float("inf")


def policies(targets, slack=1.0):
    """The same tiered policy built by the reference and by the port."""
    return (jslo.SLOPolicy({t: jslo.SLOTarget(*v) for t, v in
                            targets.items()}, shed_slack=slack),
            tslo.SLOPolicy({t: tslo.SLOTarget(*v) for t, v in
                            targets.items()}, shed_slack=slack))


TIERED = {"interactive": (1.0, 0.1), "batch": (30.0, 0.5),
          "default": (5.0, 0.2)}


@pytest.mark.parametrize("slack", [1.0, 2.0])
def test_should_shed_matches_reference(slack):
    jpol, tpol = policies(TIERED, slack)
    for tier in ("interactive", "batch", None, "other"):
        for plen in (1, 16, 300, 2731):
            kw = dict(rid=0, prompt=np.zeros(plen, np.int32),
                      max_new_tokens=4, tier=tier)
            jr, tr = JRequest(**kw), Request(**kw)
            jr.submitted_at = tr.submitted_at = 100.0
            assert tpol.target_for(tr) == tslo.SLOTarget(
                *dataclass_tuple(jpol.target_for(jr)))
            for now in (100.0, 100.5, 101.5, 140.0):
                for est in (None, 0.0, 0.004, 0.07):
                    for chunk in (16, 256):
                        args = (now, est, chunk)
                        assert tpol.projected_ttft(tr, *args) == \
                            jpol.projected_ttft(jr, *args)
                        assert tpol.should_shed(tr, *args) == \
                            jpol.should_shed(jr, *args)
    jnone, tnone = policies({"batch": (1.0, 0.1)})
    r = Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=1)
    assert tnone.target_for(r) is None
    assert tnone.should_shed(r, 1e12, 1.0, 16) is None


def dataclass_tuple(target):
    return (target.ttft_s, target.tpot_s)


def stamped(mod, rid, *, status="ok", ttft=0.5, tpot=0.05, n_out=4,
            tier=None):
    r = mod.Request(rid=rid, prompt_len=8, max_new_tokens=n_out, tier=tier)
    r.status = status
    r.submitted_at = 100.0
    if status == "ok":
        r.first_token_at = 100.0 + ttft
        r.finished_at = r.first_token_at + tpot * (n_out - 1)
        r.output = list(range(n_out))
    return r


class _Mod:
    def __init__(self, request, error, report):
        self.Request, self.RequestError, self.ServeReport = \
            request, error, report


REF = _Mod(JRequest, JError, JReport)
PORT = _Mod(Request, RequestError, ServeReport)


def report_of(mod):
    """Stamped requests of every kind: fast, slow TTFT, slow TPOT, one
    output only, a failed and a shed one, over three tiers."""
    done = [stamped(mod, 0, ttft=0.5, tier="interactive"),
            stamped(mod, 1, ttft=2.0, tier="interactive"),
            stamped(mod, 2, ttft=3.0, tpot=0.3, tier="batch"),
            stamped(mod, 3, ttft=0.2, n_out=1),
            stamped(mod, 4, status="failed", tier="batch")]
    shed = stamped(mod, 5, status="rejected", tier="interactive")
    shed.error = mod.RequestError("slo_shed", "projected over target")
    rep = mod.ServeReport.build(done, [shed])
    rep.request_scores.update({0: {"steps": 4.0, "live_total_s": 0.2},
                               1: {"steps": 4.0, "live_total_s": 0.8},
                               2: {"steps": 0.0, "live_total_s": 0.0}})
    return rep


@pytest.mark.parametrize("latency", ["wall", "modeled"])
def test_score_goodput_matches_reference(latency):
    jpol, tpol = policies(TIERED)
    jrep, trep = report_of(REF), report_of(PORT)
    for scale in (0.25, 0.5, 1.0, 2.0, 4.0, 8.0):
        want = jslo.score_goodput(jrep, jpol, scale=scale, latency=latency)
        got = tslo.score_goodput(trep, tpol, scale=scale, latency=latency)
        assert got == want
        assert trep.goodput == got
    assert tslo.score_goodput(trep, tslo.SLOPolicy.uniform(1.0, 0.1)) == \
        jslo.score_goodput(jrep, jslo.SLOPolicy.uniform(1.0, 0.1))
    np.testing.assert_array_equal(tslo.ttft_decomposition_residual(trep),
                                  jslo.ttft_decomposition_residual(jrep))


# --------------------------------------------------------------------------- #
# serve(slo=...) against the reference
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def models():
    return smoke_pair()


def slo_cfg(**kw):
    """The reference's SLO-suite engine settings."""
    return dict(max_context=128, hbm_fraction=0.25, policy="importance",
                promote_thresh=0.005, telemetry_stride=4, prefill_chunk=16,
                **kw)


def slo_prompts(vocab, n, plen=32):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, (plen,)) for _ in range(n)]


#: name -> (tiers of the requests, targets): targets of 0 or infinity,
#: so which requests shed cannot depend on the clock
SHED_CASES = {
    "uniform_zero": (None, {"default": (0.0, 10.0)}),
    "uniform_inf": (None, {"default": (INF, INF)}),
    "tiered": (["interactive", "interactive", "interactive", "batch",
                "interactive", "batch"],
               {"interactive": (0.0, 10.0), "batch": (INF, INF)}),
}


@pytest.mark.parametrize("case", list(SHED_CASES))
def test_tier_shedding_matches_reference(models, case):
    tiers, targets = SHED_CASES[case]
    n = len(tiers) if tiers else 4
    prompts = slo_prompts(models[2].cfg.vocab, n)
    jeng, teng = engines(models, **slo_cfg())
    jpol, tpol = policies(targets)

    def reqs(cls):
        out = requests(cls, prompts, 4)
        for r, tier in zip(out, tiers or [None] * n):
            r.tier = tier
        return out
    jrep = jeng.serve(reqs(JRequest), num_slots=2, seed=0, slo=jpol)
    trep = teng.serve(reqs(Request), num_slots=2, seed=0, slo=tpol)
    assert_same(outcome(teng, trep), outcome(jeng, jrep))
    statuses = trep.statuses
    shed = sorted(e["rid"] for e in trep.events if e["kind"] == "slo_shed")
    if case == "uniform_zero":
        assert statuses == {0: "ok", 1: "ok", 2: "rejected",
                            3: "rejected"}
        assert shed == [2, 3]
    elif case == "uniform_inf":
        assert set(statuses.values()) == {"ok"} and shed == []
    else:
        assert shed == [2, 4]
        assert [statuses[i] for i in (0, 1, 3, 5)] == ["ok"] * 4
    for r in trep.rejected:
        assert r.error.code == "slo_shed" and "target" in r.error.detail


@pytest.mark.parametrize("budget", [None, 8], ids=["unbudgeted", "budget8"])
def test_ttft_decomposition_identity(models, budget):
    _, teng = engines(models, **slo_cfg(prefill_budget=budget))
    rep = teng.serve(requests(Request, slo_prompts(models[2].cfg.vocab, 5),
                              6), num_slots=2, seed=0,
                     slo=tslo.SLOPolicy.uniform(INF, INF))
    assert set(rep.statuses.values()) == {"ok"}
    res = tslo.ttft_decomposition_residual(rep)
    assert res.size == 5
    assert res.max() <= IDENTITY_TOL, res
    assert all(r.prefill_s > 0 for r in rep.completed)
    if budget is not None:
        assert any(r.throttle_s > 0 for r in rep.completed)
    waits = [r.queue_wait_s for r in rep.completed]
    assert min(waits) >= 0 and max(waits) > min(waits)
    assert set(rep.ttft_parts) == {"queue_wait", "prefill", "throttle"}


def test_timeout_and_shed_mutually_exclusive(models):
    """A queued request with an expired deadline belongs to the reaper
    even under an impossible SLO: one terminal status ("timeout"), no
    slo_shed event for it; the reference agrees."""
    prompts = slo_prompts(models[2].cfg.vocab, 5)
    jeng, teng = engines(models, **slo_cfg())

    def reqs(cls):
        out = requests(cls, prompts, 4)
        out[3].deadline_s = 0.0
        return out
    jrep = jeng.serve(reqs(JRequest), num_slots=2, seed=0,
                      slo=jslo.SLOPolicy.uniform(0.0, 10.0))
    trep = teng.serve(reqs(Request), num_slots=2, seed=0,
                      slo=tslo.SLOPolicy.uniform(0.0, 10.0))
    assert_same(outcome(teng, trep), outcome(jeng, jrep))
    assert trep.statuses[3] == "timeout"
    victim = next(r for r in trep.completed + trep.rejected if r.rid == 3)
    assert victim.error.code == "deadline_exceeded"
    assert not [e for e in trep.events
                if e["kind"] == "slo_shed" and e["rid"] == 3]
    rids = [r.rid for r in trep.completed + trep.rejected]
    assert sorted(rids) == sorted(set(rids)) == list(range(5))
    assert all(s in TERMINAL_STATUSES for s in trep.statuses.values())
    assert not math.isnan(sum(r.queue_wait_s or 0.0 for r in trep.completed))
