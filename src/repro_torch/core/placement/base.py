"""Placement-policy interface shared by the simulator and the serving engine.

The port's copy of the reference's `core/placement/base.py` (numpy only).

A policy sees the same state the serving engine's control plane sees:
which pages exist, where they live, and (for oracle policies) the trace.
It never touches byte accounting — the simulator charges traffic from the
(promote, demote) sets the policy returns, so every policy is scored under
the identical Eq.(1)-(5) cost model.

Tiers: HBM = 0, DRAM = 1, UNALLOC = -1.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.simulator import HeteroMemSimulator

HBM = 0
DRAM = 1
UNALLOC = -1

_EMPTY = np.zeros(0, dtype=np.int64)


class PlacementPolicy:
    """Base class. Subclasses override some of the four hooks.

    Hook order within a simulated step `s`:
      1. place_new(sim, pages)         — tier for pages born at `s`
      2. migrations(sim, s)            — proactive (pre-access) migrations
      3. <simulator charges reads for trace.access[s]>
      4. on_access(sim, s, accessed)   — reactive (post-access) migrations
    """

    name = "base"
    #: oracle policies read future trace rows; real-time policies must not.
    uses_foresight = False
    #: registry name of the jit-safe live mirror of this policy in
    #: `repro_torch.serving.policies` (None for oracles the live engine
    #: cannot run — they need foresight the device doesn't have).
    device_counterpart: str | None = None

    def reset(self, sim: "HeteroMemSimulator") -> None:
        pass

    def place_new(self, sim: "HeteroMemSimulator",
                  pages: np.ndarray) -> np.ndarray:
        """Default: new pages go to HBM while it has room, else DRAM."""
        free = sim.hbm_budget_pages - sim.hbm_used
        tiers = np.full(len(pages), DRAM, dtype=np.int8)
        tiers[: max(free, 0)] = HBM
        return tiers

    def migrations(self, sim: "HeteroMemSimulator",
                   step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (promote DRAM->HBM page ids, demote HBM->DRAM page ids)."""
        return _EMPTY, _EMPTY

    def on_access(self, sim: "HeteroMemSimulator", step: int,
                  accessed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Reactive migrations after the reads of `step` were charged."""
        return _EMPTY, _EMPTY


def empty_migration() -> Tuple[np.ndarray, np.ndarray]:
    return _EMPTY, _EMPTY
