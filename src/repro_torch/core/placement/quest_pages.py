"""Page-granularity scheduling (paper baseline #4, Quest-like).

The port's copy of the reference's `core/placement/quest_pages.py` (numpy only).

"Emulates the Quest approach by managing KV cache at page granularity
(page size: 16). Entire pages are migrated with perfect foresight of
token importance, though this incurs overhead from including unimportant
tokens in the same page."

Foresight horizon is a single step (Quest selects pages per decoding
step); granularity overhead is modeled by `unit_group`: migration
decisions operate on groups of `unit_group` consecutive trace units, so
with a token-granular trace and unit_group=16 a single hot token drags
its 15 page-mates across the link. With a page-granular (16-token) trace
unit_group=1 is the faithful setting.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.placement.base import DRAM, HBM, PlacementPolicy


class QuestPages(PlacementPolicy):
    name = "quest"
    # one-step foresight: the live mirror promotes the pages the Quest
    # top-k mask selects, which the device does know ahead of the read
    uses_foresight = True
    device_counterpart = "quest"

    def __init__(self, unit_group: int = 1):
        self.unit_group = unit_group

    def migrations(self, sim, step):
        tr = sim.trace
        want = np.nonzero(tr.access[step])[0]          # needed this step
        g = self.unit_group
        if g > 1:
            # expand to whole groups
            groups = np.unique(want // g)
            want = (groups[:, None] * g + np.arange(g)).ravel()
            want = want[want < tr.num_pages]
            want = want[sim.placement[want] != -1]
        promote = want[sim.placement[want] == DRAM]
        if len(promote) == 0:
            return promote, promote
        # Make room by demoting resident pages that are NOT needed this
        # step, coldest (least-recently-used) first.
        room = sim.hbm_budget_pages - sim.hbm_used
        need = max(0, len(promote) - room)
        if need:
            hbm_pages = np.nonzero(sim.placement == HBM)[0]
            keep = np.zeros(sim.trace.num_pages, dtype=bool)
            keep[want] = True
            cand = hbm_pages[~keep[hbm_pages]]
            order = np.argsort(sim.last_access[cand], kind="stable")
            demote = cand[order][:need]
            # If we still lack room, drop the excess promotions (HBM is
            # simply too small for this step's working set).
            room_after = room + len(demote)
            promote = promote[:room_after]
        else:
            demote = np.zeros(0, dtype=np.int64)
        return promote, demote
