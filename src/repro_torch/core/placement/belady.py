"""Beyond-paper oracle: Belady (furthest-next-use) eviction + one-step
prefetch.

The port's copy of the reference's `core/placement/belady.py` (numpy only).

Classical optimal demand paging adapted to the two-tier KV problem:
pages needed at the current step are promoted (like Quest), and the
victim is always the resident page whose *next* use is furthest in the
future (instead of LRU / lowest-window-frequency). This gives a second,
differently-shaped upper bound to compare the paper's SA bound against:
SA optimizes *bandwidth overlap* via (W, R); Belady optimizes *misses*.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.placement.base import DRAM, HBM, PlacementPolicy


class BeladyOracle(PlacementPolicy):
    name = "belady"
    uses_foresight = True

    def reset(self, sim) -> None:
        tr = sim.trace
        steps, pages = tr.access.shape
        # next_use[p] = first step >= current reading p (incrementally
        # maintained; INF when never read again).
        self._INF = steps + 1
        self._next_use = np.full(pages, self._INF, dtype=np.int64)
        # per-page sorted access steps + cursor
        self._access_steps = [np.nonzero(tr.access[:, p])[0]
                              for p in range(pages)]
        self._cursor = np.zeros(pages, dtype=np.int64)
        for p in range(pages):
            a = self._access_steps[p]
            self._next_use[p] = a[0] if len(a) else self._INF

    def _advance(self, sim, step: int) -> None:
        # pages whose recorded next use is in the past: move cursor
        stale = np.nonzero(self._next_use < step)[0]
        for p in stale:
            a = self._access_steps[p]
            c = self._cursor[p]
            while c < len(a) and a[c] < step:
                c += 1
            self._cursor[p] = c
            self._next_use[p] = a[c] if c < len(a) else self._INF

    def migrations(self, sim, step):
        self._advance(sim, step)
        tr = sim.trace
        want = np.nonzero(tr.access[step])[0]
        promote = want[sim.placement[want] == DRAM]
        if len(promote) == 0:
            return promote, promote
        room = sim.hbm_budget_pages - sim.hbm_used
        need = max(0, len(promote) - room)
        if need:
            resident = np.nonzero(sim.placement == HBM)[0]
            keep = np.zeros(tr.num_pages, dtype=bool)
            keep[want] = True
            cand = resident[~keep[resident]]
            order = np.argsort(-self._next_use[cand], kind="stable")
            demote = cand[order][:need]
            promote = promote[: room + len(demote)]
        else:
            demote = np.zeros(0, dtype=np.int64)
        return promote, demote
