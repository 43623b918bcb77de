"""Beyond-paper *deployable* policy: cost-aware hysteresis (no foresight).

The port's copy of the reference's `core/placement/cost_aware.py` (numpy only).

The paper's SA bound assumes a-priori knowledge of future accesses. This
policy is the practical counterpart the paper calls for ("predictive
modeling ... online learning of token access patterns"): it keeps an
exponential moving average of each page's observed access rate and
promotes/demotes only when the *modeled benefit exceeds the modeled
migration cost* under the same Eq.(3)/(4) bandwidth constants — i.e. the
policy embeds the paper's latency model as its own decision criterion.

Hysteresis (promote_thresh > demote_thresh) plus a per-step migration
budget bounds M_i/M_o, which is exactly the failure mode that makes
ReactiveLRU collapse at low sparsity.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.placement.base import DRAM, HBM, UNALLOC, PlacementPolicy


def migration_economics(spec) -> tuple[float, float]:
    """(gain_per_read, move_cost) in seconds/byte under the Eq.(3)/(4)
    bandwidth constants of a `MemorySystemSpec`: what one resident byte
    saves per read, and what moving one byte across the link costs.
    Shared by this simulator policy and its live device counterpart
    (`repro_torch.serving.policies.CostAwarePolicy`)."""
    gain_per_read = 1.0 / spec.effective_dram_read_bw - 1.0 / spec.hbm_bw
    move_cost = 1.0 / spec.link_bw + 1.0 / spec.hbm_bw
    return gain_per_read, move_cost


def payback_threshold(spec, horizon_steps: float) -> float:
    """Minimum per-step access rate (or attention-mass share) at which
    promoting a page pays back its migration cost within
    `horizon_steps` steps: rate * gain_per_read * horizon > move_cost.
    Derived purely from the spec's HBM/link/DRAM bandwidth ratios, so a
    harsher link (TPU PCIe vs GH200 NVLink-C2C) raises the bar."""
    gain_per_read, move_cost = migration_economics(spec)
    return move_cost / (gain_per_read * horizon_steps)


def hysteresis_thresholds(spec, horizon_steps: float,
                          demote_ratio: float = 0.25
                          ) -> tuple[float, float]:
    """(promote, demote) payback thresholds for a spec: promote at the
    full payback bar, demote only when importance falls below
    `demote_ratio` of it (the hysteresis band that stops thrash).
    The serving `CostAwarePolicy` carries these as policy-state DATA so
    a tier-degradation fault can recalibrate them mid-stream without
    retracing the serve executable."""
    t_pro = payback_threshold(spec, horizon_steps)
    return t_pro, demote_ratio * t_pro


class CostAwareHysteresis(PlacementPolicy):
    name = "cost_aware"
    uses_foresight = False
    device_counterpart = "cost_aware"

    def __init__(self, ema: float = 0.15, promote_thresh: float = 0.5,
                 demote_thresh: float = 0.1,
                 migration_budget_frac: float = 0.05):
        self.ema = ema
        self.promote_thresh = promote_thresh
        self.demote_thresh = demote_thresh
        self.budget_frac = migration_budget_frac

    def reset(self, sim) -> None:
        self._rate = np.zeros(sim.trace.num_pages, dtype=np.float64)
        # benefit of an HBM-resident hot page per access (seconds/byte gap)
        self._gain_per_read, self._move_cost = migration_economics(sim.spec)

    def on_access(self, sim, step, accessed):
        hit = np.zeros(sim.trace.num_pages, dtype=np.float64)
        hit[accessed] = 1.0
        alive = sim.placement != UNALLOC
        self._rate[alive] = ((1 - self.ema) * self._rate[alive]
                             + self.ema * hit[alive])

        # Expected payback horizon: a page read at rate r gains
        # r * gain_per_read per step once resident; moving costs
        # move_cost once. Promote when payback < ~1/ema steps.
        horizon = 1.0 / self.ema
        worth = self._rate * self._gain_per_read * horizon > self._move_cost

        budget = max(1, int(self.budget_frac * sim.hbm_budget_pages))
        dram_pages = np.nonzero((sim.placement == DRAM) & worth
                                & (self._rate > self.promote_thresh))[0]
        order = np.argsort(-self._rate[dram_pages], kind="stable")
        promote = dram_pages[order][:budget]
        if len(promote) == 0:
            return promote, promote

        room = sim.hbm_budget_pages - sim.hbm_used
        need = max(0, len(promote) - room)
        if need:
            resident = np.nonzero(sim.placement == HBM)[0]
            cold = resident[self._rate[resident] < self.demote_thresh]
            order = np.argsort(self._rate[cold], kind="stable")
            demote = cold[order][:need]
            promote = promote[: room + len(demote)]
        else:
            demote = np.zeros(0, dtype=np.int64)
        return promote, demote
