"""Reactive scheduling (paper baseline #3).

The port's copy of the reference's `core/placement/reactive.py` (numpy only).

"Upon accessing a KV cache entry absent from HBM, it is promoted to HBM.
If HBM is full, the least recently used (LRU) entry is evicted to
off-package DRAM."

Promotion happens *after* the access (the read itself is served from
DRAM), and both the promotion and the LRU eviction are charged as
migration traffic in the same step — which is why the paper observes
this policy drowning in migrations at low sparsity.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.placement.base import DRAM, HBM, PlacementPolicy


class ReactiveLRU(PlacementPolicy):
    name = "reactive"
    device_counterpart = "recency"

    def __init__(self, max_promotions_per_step: int | None = None):
        # Optional cap (beyond-paper knob); None reproduces the paper.
        self.max_promotions = max_promotions_per_step

    def on_access(self, sim, step, accessed):
        missed = accessed[sim.placement[accessed] == DRAM]
        if self.max_promotions is not None:
            missed = missed[: self.max_promotions]
        n = len(missed)
        if n == 0:
            return missed, missed
        # Evict LRU HBM pages to make room (never the ones just accessed).
        room = sim.hbm_budget_pages - sim.hbm_used
        need = max(0, n - room)
        if need:
            hbm_pages = np.nonzero(sim.placement == HBM)[0]
            candidates = np.setdiff1d(hbm_pages, accessed, assume_unique=True)
            order = np.argsort(sim.last_access[candidates], kind="stable")
            evict = candidates[order][:need]
        else:
            evict = np.zeros(0, dtype=np.int64)
        return missed, evict
