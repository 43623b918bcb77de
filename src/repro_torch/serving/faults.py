"""Deterministic fault-injection plane for the serve loop (the port of
the reference's `serving/faults.py`).

The paper's premise is that tier bandwidth is a runtime variable, so
the engine must keep serving — and keep its headroom accounting
honest — when the memory system misbehaves. A `FaultPlane` is a seeded,
static schedule of adverse events that `ServingEngine.serve` queries at
every chunk boundary (step indices are `ContinuousBatcher.step_idx`
units):

  TierFault       bandwidths scaled inside [start, stop): the per-step
                  Eq. (1)-(5) pricing (`latency_model.degraded_spec`)
                  and cost_aware's payback thresholds see the degraded
                  spec. A pricing input only: the port does not throttle
                  the real link, and tokens are unaffected.
  MigrationFault  per step inside [start, stop) only the first
                  `ceil(commit_frac * capacity)` live promote rows of a
                  plan (and their paired demotes) commit
                  (`throttle_plan`); in overlap mode the caps throttle
                  the commit of the staged plan after revalidation.
  PoolFault       the scheduler's page pool gains `delta` pages at
                  `step` (negative: a shrink wave).
  PoisonFault     from `step` on, request `rid`'s logits are NaN; the
                  engine's non-finite guard quarantines the lane and the
                  request ends "failed".

Everything here is host numpy and plain Python except `throttle_plan`,
a few tensor ops on the plan with no host sync. The same constructor
arguments (or `FaultPlane.random`'s seed) give the same schedule as the
reference, bit for bit.

The plane is global under a serving mesh: every rank draws the same
schedule from the same arguments, slices its lanes out of the
[stride, B] poison masks, and caps each step's commits by the rows'
ranks in the whole stream's plan (`throttle_plan(ahead=)`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.latency_model import degraded_spec
from repro_torch.core.tiers import MemorySystemSpec
from repro_torch.kvcache.migrate import MigrationPlan

#: commit cap meaning "no migration fault this step": larger than any
#: plan capacity, so `throttle_plan` would be the identity
NO_FAULT_CAP = np.int32(2**30)


@dataclasses.dataclass(frozen=True)
class TierFault:
    """Scale the memory system's bandwidths inside [start, stop)."""

    start: int
    stop: int
    hbm_scale: float = 1.0
    link_scale: float = 1.0
    dram_scale: float = 1.0

    def active(self, step: int) -> bool:
        """Whether this fault window covers `step`."""
        return self.start <= step < self.stop


@dataclasses.dataclass(frozen=True)
class MigrationFault:
    """Drop (commit_frac=0) or partially commit migration plans inside
    [start, stop): per step only the first `ceil(commit_frac *
    capacity)` live promote rows land."""

    start: int
    stop: int
    commit_frac: float = 0.0

    def active(self, step: int) -> bool:
        """Whether this fault window covers `step`."""
        return self.start <= step < self.stop


@dataclasses.dataclass(frozen=True)
class PoolFault:
    """Resize the scheduler's page pool by `delta` pages at `step`."""

    step: int
    delta: int


@dataclasses.dataclass(frozen=True)
class PoisonFault:
    """Overwrite request `rid`'s logits with NaN from `step` on."""

    rid: int
    step: int


@dataclasses.dataclass(frozen=True)
class FaultPlane:
    """A static, deterministic schedule of injected faults, passed to
    `ServingEngine.serve(..., faults=plane)`; pure data, reusable
    across serve calls."""

    tier: Tuple[TierFault, ...] = ()
    migration: Tuple[MigrationFault, ...] = ()
    pool: Tuple[PoolFault, ...] = ()
    poison: Tuple[PoisonFault, ...] = ()

    def scales_at(self, step: int) -> Tuple[float, float, float]:
        """(hbm, link, dram) bandwidth scales active at `step`;
        overlapping windows compose multiplicatively."""
        h = k = d = 1.0
        for f in self.tier:
            if f.active(step):
                h *= f.hbm_scale
                k *= f.link_scale
                d *= f.dram_scale
        return h, k, d

    def spec_at(self, step: int, base: MemorySystemSpec
                ) -> MemorySystemSpec:
        """The spec governing `step`: `base` with the active tier-fault
        scales applied (`base` itself when none is active)."""
        h, k, d = self.scales_at(step)
        if (h, k, d) == (1.0, 1.0, 1.0):
            return base
        return degraded_spec(base, hbm_scale=h, link_scale=k,
                             dram_scale=d)

    def commit_caps(self, step0: int, stride: int,
                    budget_rows: int) -> np.ndarray:
        """Per-step commit caps for the chunk starting at `step0`, int32
        [stride]: `NO_FAULT_CAP` on fault-free steps, else
        `ceil(commit_frac * budget_rows)` (0 = full drop); the smallest
        active window wins."""
        caps = np.full((stride,), NO_FAULT_CAP, np.int32)
        for f in self.migration:
            lo = max(f.start - step0, 0)
            hi = min(f.stop - step0, stride)
            if lo < hi:
                cap = int(np.ceil(f.commit_frac * budget_rows))
                caps[lo:hi] = np.minimum(caps[lo:hi], cap)
        return caps

    def pool_delta(self, step0: int, stride: int) -> int:
        """Net page-pool delta of the PoolFaults inside [step0, step0 +
        stride), applied at that chunk's boundary."""
        return sum(f.delta for f in self.pool
                   if step0 <= f.step < step0 + stride)

    def poison_steps(self, step0: int, stride: int,
                     rids: np.ndarray) -> np.ndarray:
        """Per-step lane poison mask, bool [stride, B]: lane b is
        poisoned at chunk step i when a PoisonFault names its bound rid
        and `fault.step <= step0 + i`. Free lanes (rid -1) never are."""
        mask = np.zeros((stride, len(rids)), bool)
        for f in self.poison:
            lanes = np.nonzero(rids == f.rid)[0]
            if lanes.size:
                lo = max(f.step - step0, 0)
                if lo < stride:
                    mask[lo:, lanes] = True
        return mask

    def window_events(self, step0: int, stride: int) -> list:
        """The schedule entries that activate inside [step0, step0 +
        stride), as `ServeReport.events` dicts."""
        lo, hi = step0, step0 + stride
        out = []
        for f in self.tier:
            if lo <= f.start < hi:
                out.append({"kind": "tier_degradation", "step": f.start,
                            "stop": f.stop, "hbm_scale": f.hbm_scale,
                            "link_scale": f.link_scale,
                            "dram_scale": f.dram_scale})
        for f in self.migration:
            if lo <= f.start < hi:
                out.append({"kind": "migration_fault", "step": f.start,
                            "stop": f.stop,
                            "commit_frac": f.commit_frac})
        for f in self.pool:
            if lo <= f.step < hi:
                out.append({"kind": "pool_resize", "step": f.step,
                            "delta": f.delta})
        for f in self.poison:
            if lo <= f.step < hi:
                out.append({"kind": "logit_poison", "step": f.step,
                            "rid": f.rid})
        return out

    @staticmethod
    def random(seed: int, *, steps: int, rids: Sequence[int] = (),
               n_tier: int = 2, n_migration: int = 2, n_pool: int = 1,
               n_poison: int = 1, max_shrink: int = 2) -> "FaultPlane":
        """A seeded random schedule over a `steps`-long stream (the
        reference's draw order, so the same seed gives the same plane)."""
        rng = np.random.default_rng(seed)

        def window():
            a = int(rng.integers(0, max(steps - 1, 1)))
            b = int(rng.integers(a + 1, steps + 1))
            return a, b

        tier = []
        for _ in range(n_tier):
            a, b = window()
            tier.append(TierFault(
                start=a, stop=b,
                link_scale=float(rng.uniform(0.1, 0.8)),
                dram_scale=float(rng.uniform(0.25, 1.0))))
        migration = []
        for _ in range(n_migration):
            a, b = window()
            migration.append(MigrationFault(
                start=a, stop=b,
                commit_frac=float(rng.choice([0.0, 0.5]))))
        pool = [PoolFault(step=int(rng.integers(0, max(steps, 1))),
                          delta=-int(rng.integers(1, max_shrink + 1)))
                for _ in range(n_pool)]
        poison = []
        if rids:
            picks = rng.choice(np.asarray(list(rids)),
                               size=min(n_poison, len(rids)),
                               replace=False)
            poison = [PoisonFault(rid=int(r),
                                  step=int(rng.integers(0, max(steps, 1))))
                      for r in picks]
        return FaultPlane(tier=tuple(tier), migration=tuple(migration),
                          pool=tuple(pool), poison=tuple(poison))


def throttle_plan(plan: MigrationPlan, cap, ahead=None) -> MigrationPlan:
    """Commit only the first `cap` live promote rows of a plan and their
    index-paired demote rows (`plan_by_score` pairs demote i with
    promote i, so a partial commit never orphans half a swap); the rest
    become -1 no-ops. `cap` is a host int or a 0-dim tensor; no host
    sync either way. At a cap of at least the plan's capacity it is the
    identity.

    A row is kept when its rank among the live rows of the whole
    stream's plan is at most `cap`. `ahead` (int32 [L, B'], the
    engine's): the plan holds the rows of B' of the stream's lanes
    (a meshed serve's rank; unmeshed, all of them), laid out
    [L, B', budget] as `plan_by_score` lays them, and `ahead[l, b]`
    counts the live rows the whole plan holds before block (l, b).
    Without it the plan is the whole plan, one block."""
    live = plan.pro_layer >= 0
    if ahead is None:
        ahead = torch.zeros((1,), dtype=torch.int32, device=live.device)
    blocks = live.to(torch.int32).view(*ahead.shape, -1)
    rank = (ahead[..., None] + torch.cumsum(blocks, -1)).reshape(-1)
    keep = (rank <= cap) & live
    return MigrationPlan(*[
        torch.where(keep, getattr(plan, f.name), -1).to(torch.int32)
        for f in dataclasses.fields(plan)])
