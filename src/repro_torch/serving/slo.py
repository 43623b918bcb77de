"""SLO plane: per-tier latency targets, admission shedding, goodput (the
port of the reference's `serving/slo.py`, host Python only).

Serving is scored on GOODPUT — requests completed within their latency
SLOs — not raw throughput. Three pieces:

  * `SLOTarget` / `SLOPolicy`: per-TIER TTFT/TPOT targets
    (`Request.tier` names the tier).
  * SLO-aware admission: `SLOPolicy.should_shed` projects a QUEUED
    request's earliest achievable TTFT (wait so far + its prefill at the
    measured step cadence) and `ServingEngine.serve` sheds it as
    `rejected` (error code "slo_shed") when the projection already
    exceeds the target. Shedding runs after deadline/cancel reaping, so
    no request is both "timeout" and SLO-shed.
  * `score_goodput`: the fraction of submitted requests that finished
    "ok" within (scaled) targets, judged on the wall-clock stamps or on
    the paper's MODELED per-request decode latency
    (`trace_bridge.score_serve`'s `request_scores`).

`serve(..., slo=policy)` layers this on top of the `prefill_budget`
token bucket: the bucket shapes WHEN admitted prefill work runs, the
policy decides WHETHER queued work is still worth admitting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.serving.scheduler import Request

#: tier name used when a request's tier has no explicit target
DEFAULT_TIER = "default"


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One tier's latency contract (seconds)."""

    ttft_s: float                      # time to first token
    tpot_s: float                      # time per output token after it

    def scaled(self, scale: float) -> "SLOTarget":
        """Both targets multiplied by `scale` (2.0 = twice as loose)."""
        return SLOTarget(self.ttft_s * scale, self.tpot_s * scale)


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Per-tier SLO targets + the admission shedding rule.

    `targets` maps tier names to `SLOTarget`; a request whose tier is
    missing falls back to the `DEFAULT_TIER` entry, and to NO target
    (never shed, never scored) when that is absent too. `shed_slack`
    loosens the shed projection (2.0 = shed only when the projected
    TTFT is past twice the target) so estimation noise cannot shed
    borderline requests that would have made it.
    """

    targets: Mapping[str, SLOTarget] = dataclasses.field(
        default_factory=dict)
    shed_slack: float = 1.0

    def target_for(self, req: Request) -> Optional[SLOTarget]:
        """The request's tier target, falling back to `DEFAULT_TIER`
        and then to None (no contract)."""
        tier = req.tier if req.tier is not None else DEFAULT_TIER
        tgt = self.targets.get(tier)
        if tgt is None and tier != DEFAULT_TIER:
            tgt = self.targets.get(DEFAULT_TIER)
        return tgt

    def projected_ttft(self, req: Request, now: float,
                       est_step_s: Optional[float],
                       prefill_chunk: int) -> float:
        """Earliest achievable TTFT for a QUEUED request: the wait it
        has already eaten plus its prefill time at the measured serve
        cadence (unknown before the first chunk lands -> 0, so early
        boundaries shed only on wait already incurred)."""
        waited = now - req.submitted_at
        if est_step_s is None:
            return waited
        steps = math.ceil(req.prompt_len / max(1, prefill_chunk))
        return waited + steps * est_step_s

    def should_shed(self, req: Request, now: float,
                    est_step_s: Optional[float],
                    prefill_chunk: int) -> Optional[str]:
        """Return a human-readable reason to shed `req`, or None."""
        tgt = self.target_for(req)
        if tgt is None:
            return None
        proj = self.projected_ttft(req, now, est_step_s, prefill_chunk)
        bar = tgt.ttft_s * self.shed_slack
        if proj > bar:
            return (f"projected TTFT {proj:.4f}s exceeds "
                    f"{req.tier or DEFAULT_TIER} target "
                    f"{tgt.ttft_s:.4f}s (slack {self.shed_slack:g})")
        return None

    @staticmethod
    def uniform(ttft_s: float, tpot_s: float,
                shed_slack: float = 1.0) -> "SLOPolicy":
        """One target for every request, tiered or not."""
        return SLOPolicy({DEFAULT_TIER: SLOTarget(ttft_s, tpot_s)},
                         shed_slack=shed_slack)


def _wall_latencies(r: Request):
    """(ttft_s, tpot_s) from the request's wall-clock stamps; inf when
    a stamp is missing (never counts as within-SLO)."""
    if r.first_token_at is None:
        return float("inf"), float("inf")
    ttft = r.first_token_at - r.submitted_at
    if r.finished_at is None or len(r.output) <= 1:
        return ttft, 0.0
    return ttft, (r.finished_at - r.first_token_at) / (len(r.output) - 1)


def score_goodput(report, policy: SLOPolicy, *, scale: float = 1.0,
                  latency: str = "wall") -> Dict[str, object]:
    """Score a `ServeReport` against (scaled) SLO targets.

    A request is GOOD iff its terminal status is "ok" AND it met its
    tier's targets at `scale` (scale 2.0 = twice-as-loose SLOs —
    sweeping `scale` traces the goodput-under-SLO curve). Shed,
    rejected, failed, cancelled and timed-out requests all count
    against goodput: they were submitted and not served within SLO.

    latency="wall" judges both TTFT and TPOT from the wall stamps.
    latency="modeled" judges TPOT from the paper's per-request modeled
    seconds (`report.request_scores[rid]["live_total_s"] / steps`, the
    Eq. (1)-(5) price of the request's decode reads under the achieved
    placement — requires `trace_bridge.score_serve(..., report=...)`
    to have stamped the report) and leaves TTFT out of the verdict:
    prefill is not priced by the access model. The modeled view is how
    placement policies are compared at equal targets.

    Returns the goodput row (also stamped onto `report.goodput` when
    the attribute exists): request/token goodput fractions, good
    counts, and the per-tier split.
    """
    assert latency in ("wall", "modeled"), latency
    statuses = report.statuses
    total = len(statuses)
    good = 0
    good_tokens = 0
    per_tier: Dict[str, Dict[str, int]] = {}
    for r in report.completed:
        tier = r.tier if r.tier is not None else DEFAULT_TIER
        row = per_tier.setdefault(tier, {"good": 0, "total": 0})
        row["total"] += 1
        if r.status != "ok":
            continue
        tgt = policy.target_for(r)
        if tgt is None:
            met = True                 # no contract -> "ok" suffices
        else:
            tgt = tgt.scaled(scale)
            ttft, tpot = _wall_latencies(r)
            if latency == "modeled":
                sc = report.request_scores.get(r.rid)
                if sc is None or not sc.get("steps"):
                    met = False                 # unscored: never good
                else:
                    tpot = sc["live_total_s"] / sc["steps"]
                    met = tpot <= tgt.tpot_s
            else:
                met = ttft <= tgt.ttft_s and tpot <= tgt.tpot_s
        if met:
            good += 1
            good_tokens += len(r.output)
            row["good"] += 1
    for r in report.rejected:
        tier = r.tier if r.tier is not None else DEFAULT_TIER
        per_tier.setdefault(tier, {"good": 0, "total": 0})["total"] += 1
    out = {
        "scale": float(scale),
        "latency": latency,
        "goodput": good / total if total else 1.0,
        "good_requests": int(good),
        "total_requests": int(total),
        "good_tokens": int(good_tokens),
        "shed_requests": int(sum(
            1 for r in report.rejected
            if r.error is not None and r.error.code == "slo_shed")),
        "per_tier": {t: {"good": int(v["good"]),
                         "total": int(v["total"]),
                         "goodput": v["good"] / v["total"]
                         if v["total"] else 1.0}
                     for t, v in sorted(per_tier.items())},
    }
    if hasattr(report, "goodput"):
        report.goodput = dict(out)
    return out


def ttft_decomposition_residual(report) -> np.ndarray:
    """Per-request |queue_wait + prefill_s + throttle_s - TTFT| for
    every completed request with a first token — the regression
    surface for the attribution contract (exact up to float rounding
    of the chunk-stride stamps)."""
    res = []
    for r in report.completed:
        if r.first_token_at is None or r.admitted_at is None:
            continue
        ttft = r.first_token_at - r.submitted_at
        parts = r.queue_wait_s + r.prefill_s + r.throttle_s
        res.append(abs(parts - ttft))
    return np.asarray(res, np.float64)
