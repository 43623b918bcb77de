"""Unlimited-HBM strategy (paper baseline #1): idealized, everything in HBM.

The port's copy of the reference's `core/placement/unlimited.py` (numpy only).

Implemented by placing all pages in HBM and never migrating; the
simulator is constructed with an infinite page budget for this policy
(see `repro_torch.core.experiment.run_strategy`).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.placement.base import HBM, PlacementPolicy


class UnlimitedHBM(PlacementPolicy):
    name = "unlimited"

    def reset(self, sim) -> None:
        # The experiment harness lifts the budget; assert it did.
        if sim.hbm_budget_pages < sim.trace.num_pages:
            sim.hbm_budget_pages = sim.trace.num_pages

    def place_new(self, sim, pages: np.ndarray) -> np.ndarray:
        return np.full(len(pages), HBM, dtype=np.int8)
