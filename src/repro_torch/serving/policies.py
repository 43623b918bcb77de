"""Pluggable placement policies — the policy plane of the serve loop
(the port of the reference's `serving/policies.py`, first slice).

Protocol (duck-typed):

  init_state(geo) -> state      policy state carried across steps
                                (empty tuple for stateless policies)
  plan(cache, state, active, budget, read_mask=None)
      -> (MigrationPlan, state, (n_promotes, n_demotes))
                                one planning step; the plan's capacity
                                is the geometry constant
                                `control.plan_capacity`.

Registered in this slice (EngineConfig.policy):

  static      never migrates — an empty plan, the paper's baseline #2.
  importance  the attention-mass-EMA hysteresis planner
              (`control.plan_migrations`).

The reference's `recency`, `cost_aware` and `quest` policies arrive
with the port's policy slice; asking for one raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.kvcache.migrate import MigrationPlan
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.serving import control

Counts = Tuple[torch.Tensor, torch.Tensor]
PlanResult = Tuple[MigrationPlan, Any, Counts]

#: reference policies not ported yet, and the slice that brings them
NOT_PORTED = {
    "recency": "the port's policy slice (ROADMAP.md, queue 1)",
    "cost_aware": "the port's policy slice (ROADMAP.md, queue 1)",
    "quest": "the port's policy slice (ROADMAP.md, queue 1)",
}


class DevicePolicy:
    """Base class for migration planners (see module doc)."""

    name = "base"

    def __init__(self, *, cfg, geo):
        del cfg, geo

    def init_state(self, geo) -> Any:
        """Fresh policy state for a stream over `geo`."""
        del geo
        return ()

    def plan(self, cache: PagedKVCache, state: Any, active, budget: int,
             read_mask=None) -> PlanResult:
        """One planning step -> (MigrationPlan, state, (n_pro, n_dem))."""
        raise NotImplementedError


def check_read_mask(cache: PagedKVCache, read_mask) -> None:
    """The engine's read set is per lane, shaped like the page table."""
    if read_mask is not None and read_mask.shape != cache.page_table.shape:
        raise ValueError(f"read_mask {tuple(read_mask.shape)} does not match "
                         f"the page table {tuple(cache.page_table.shape)}")


_REGISTRY: Dict[str, Callable[..., DevicePolicy]] = {}


def register(name: str):
    """Class decorator: make a DevicePolicy selectable by
    `EngineConfig.policy`."""
    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} registered twice")
        _REGISTRY[name] = factory
        return factory
    return deco


def policy_names() -> Tuple[str, ...]:
    """The registered policy names, sorted."""
    return tuple(sorted(_REGISTRY))


def make_policy(name: str, *, cfg, geo) -> DevicePolicy:
    """Build a registered policy for an engine config + cache geometry."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet; it arrives with "
            f"{NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown device policy {name!r}; registered policies: "
            f"{', '.join(policy_names())}")
    return _REGISTRY[name](cfg=cfg, geo=geo)


@register("static")
class StaticPolicy(DevicePolicy):
    """Never migrate (paper baseline #2): an all-sentinel plan."""

    name = "static"

    def plan(self, cache, state, active, budget,
             read_mask=None) -> PlanResult:
        """Plan nothing: an all-sentinel fixed-capacity plan."""
        check_read_mask(cache, read_mask)
        L, B, _ = cache.hbm_owner.shape
        dev = cache.hbm_owner.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return MigrationPlan.empty(L * B * budget, device=dev), state, \
            (zero, zero)


@register("importance")
class ImportancePolicy(DevicePolicy):
    """Attention-mass-EMA hysteresis (`control.plan_migrations`)."""

    name = "importance"

    def __init__(self, *, cfg, geo):
        super().__init__(cfg=cfg, geo=geo)
        self._thresh = cfg.promote_thresh

    def plan(self, cache, state, active, budget,
             read_mask=None) -> PlanResult:
        """Promote the hottest host pages by importance EMA."""
        check_read_mask(cache, read_mask)
        plan, n_pro, n_dem = control.plan_migrations(
            cache, budget=budget, promote_thresh=self._thresh,
            active=active)
        return plan, state, (n_pro, n_dem)
