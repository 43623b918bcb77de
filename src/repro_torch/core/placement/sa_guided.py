"""SA-guided scheduling (paper Section III-B) — the upper-bound policy.

The port's copy of the reference's `core/placement/sa_guided.py` (numpy only).

At each step the policy looks at the *a-priori known* access patterns of
the next `W` decoding steps, ranks KV pages by access frequency within
that window (the paper's priority queue), and promotes the top-`R`
portion of the pages that are qualified for migration (i.e. pages that
the frequency ranking wants resident but that currently sit in DRAM).
Capacity is maintained by demoting the coldest-by-future-frequency
resident pages.

(W, R) are the two knobs the simulated-annealing optimizer in
`repro_torch.core.sa` tunes; this module only executes a given (W, R).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.placement.base import DRAM, HBM, UNALLOC, PlacementPolicy


class SAGuided(PlacementPolicy):
    name = "sa"
    uses_foresight = True

    def __init__(self, window: int = 8, ratio: float = 0.5):
        assert window >= 1
        assert 0.0 <= ratio <= 1.0
        self.window = int(window)
        self.ratio = float(ratio)

    def reset(self, sim) -> None:
        tr = sim.trace
        w = min(self.window, tr.num_steps)
        # Running window sum of future accesses: freq[p] = number of steps
        # in [step, step+W) that read page p. Updated incrementally per
        # step (O(pages)) instead of a [steps, pages] cumulative table.
        self._freq = tr.access[:w].sum(axis=0).astype(np.int32)
        self._w = w

    def _advance(self, sim, step: int) -> None:
        # window slides from [step-1, ...) to [step, ...)
        tr = sim.trace
        if step == 0:
            return
        self._freq -= tr.access[step - 1]
        tail = step - 1 + self._w
        if tail < tr.num_steps:
            self._freq += tr.access[tail]

    def migrations(self, sim, step):
        self._advance(sim, step)
        freq = self._freq
        placement = sim.placement
        alive = placement != UNALLOC
        budget = sim.hbm_budget_pages

        # Ideal resident set: top-`budget` alive pages by future frequency
        # (only pages actually accessed in the window qualify).
        masked = np.where(alive & (freq > 0), freq, 0)
        hot = np.nonzero(masked > 0)[0]
        if len(hot) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        if len(hot) > budget:
            part = np.argpartition(masked[hot], -budget)[-budget:]
            ideal = hot[part]
        else:
            ideal = hot

        qualified = ideal[placement[ideal] == DRAM]
        if len(qualified) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        # Rank qualified pages by frequency (priority queue), promote the
        # top-R portion — R throttles migration overhead.
        order = np.argsort(-masked[qualified], kind="stable")
        k = int(math.ceil(self.ratio * len(qualified)))
        promote = qualified[order[:k]]

        room = budget - sim.hbm_used
        need = max(0, len(promote) - room)
        if need:
            resident = np.nonzero(placement == HBM)[0]
            cold_order = np.argsort(masked[resident], kind="stable")
            demote = resident[cold_order][:need]
            # Never swap a colder page in for a hotter one.
            if len(demote):
                keep = masked[promote] > masked[demote[
                    np.minimum(np.arange(len(promote)), len(demote) - 1)]]
                # promotions beyond available room must beat the evictee
                prom_final = np.concatenate(
                    [promote[:room], promote[room:][keep[room:]]])
                need = max(0, len(prom_final) - room)
                demote = demote[:need]
                promote = prom_final
        else:
            demote = np.zeros(0, dtype=np.int64)
        return promote, demote
