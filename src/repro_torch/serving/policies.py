"""Pluggable placement policies — the policy plane of the decode step
(the port of the reference's `serving/policies.py`).

Protocol (duck-typed):

  init_state(geo) -> state      policy state carried across steps
                                (empty tuple for stateless policies; a
                                dict of tensors the engine moves to its
                                device)
  plan(cache, state, active, budget, read_mask=None)
      -> (MigrationPlan, state, (n_promotes, n_demotes))
                                one planning step; the plan's capacity
                                is the geometry constant
                                `control.plan_capacity`. `read_mask`
                                (bool [L, B, max_pages]) is the page set
                                this step's attention read.
  recalibrate(state, spec) -> state
                                spec-dependent state values re-derived
                                for another `MemorySystemSpec`.

Registered policies (EngineConfig.policy):

  static      never migrates — an empty plan, the paper's baseline #2.
  importance  the attention-mass-EMA hysteresis planner
              (`control.plan_migrations`).
  recency     LRU by last-access step (live mirror of the simulator's
              `reactive`): host pages read within `window` steps are
              promoted, the least-recently-read HBM residents make room.
  cost_aware  importance hysteresis with thresholds derived from the
              memory system's bandwidth ratios
              (`core/placement/cost_aware.hysteresis_thresholds`), carried
              as float32 0-dim tensors; warm residents are protected.
  quest       promotes exactly the pages the Quest top-k mask reads
              next; mask-resident HBM pages are never evicted.

Plan-ahead (`EngineConfig.overlap_migrations`): in the overlap serve
pipeline a plan built at step N commits at step N+1, so the policy
plans for the step after next and `read_mask` becomes a one-step-ahead
re-reference oracle. `importance`, `recency` and `cost_aware` then also
protect the read set's HBM residents from eviction
(`protect_read_residents`: score +inf), since evicting one would make
the commit race the very read it serves. `static` plans nothing either
way, and `quest` already ranks by the next step's mask. The oracle
needs a sparse read set: dense attention reads every alive page, so
protecting the read set would freeze placement; plan-ahead is on only
with `attention_sparsity > 0`.

Under a serving mesh a policy plans the rank's own lanes: its state is
built for the rank-local geometry (`launch.shardings.
policy_state_shardings`: [L, B, ...] leaves hold the rank's lanes,
0-dim leaves are whole), and every plan is per (layer, lane), so the
data ranks' plans together are the unsplit plan. The `model` ranks
plan from the same all-reduced importance and agree step by step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.placement.cost_aware import hysteresis_thresholds
from repro_torch.kvcache.migrate import MigrationPlan
from repro_torch.kvcache.paged import IMPORTANCE_EMA, PagedKVCache
from repro_torch.serving import control

Counts = Tuple[torch.Tensor, torch.Tensor]
PlanResult = Tuple[MigrationPlan, Any, Counts]

_NEG_INF = float("-inf")
_POS_INF = float("inf")


class DevicePolicy:
    """Base class for migration planners (see module doc)."""

    name = "base"

    def __init__(self, *, cfg, geo):
        #: one-step-ahead planning: protect the read set's HBM residents
        #: (overlap mode with a sparse read set only; see the module doc)
        self.plan_ahead = (
            bool(getattr(cfg, "overlap_migrations", False))
            and getattr(cfg, "attention_sparsity", 0.0) > 0.0)
        del geo

    def init_state(self, geo) -> Any:
        """Fresh policy state for a stream over `geo`."""
        del geo
        return ()

    def plan(self, cache: PagedKVCache, state: Any, active, budget: int,
             read_mask=None) -> PlanResult:
        """One planning step -> (MigrationPlan, state, (n_pro, n_dem))."""
        raise NotImplementedError

    def recalibrate(self, state: Any, spec) -> Any:
        """Re-derive spec-dependent state values for `spec` (values
        only, never shapes). Default: nothing depends on the spec."""
        del spec
        return state


def check_read_mask(cache: PagedKVCache, read_mask) -> None:
    """The engine's read set is per lane, shaped like the page table."""
    if read_mask is not None and read_mask.shape != cache.page_table.shape:
        raise ValueError(f"read_mask {tuple(read_mask.shape)} does not match "
                         f"the page table {tuple(cache.page_table.shape)}")


def protect_read_residents(cache: PagedKVCache, hbm_score: torch.Tensor,
                           read_mask) -> torch.Tensor:
    """Plan-ahead eviction guard: +inf the HBM score of every resident
    whose logical page is in `read_mask` (a +inf victim score means no
    candidate can displace the slot, `control.plan_by_score`'s
    protection convention). No-op when the mask is absent."""
    if read_mask is None:
        return hbm_score
    ho = cache.hbm_owner
    in_read = torch.gather(read_mask, -1, ho.clamp_min(0).long()) & (ho >= 0)
    return torch.where(in_read, _POS_INF, hbm_score)


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
        """Promote the hottest host pages by importance EMA; with
        plan-ahead the read set's residents are also protected."""
        check_read_mask(cache, read_mask)
        if not self.plan_ahead:
            plan, n_pro, n_dem = control.plan_migrations(
                cache, budget=budget, promote_thresh=self._thresh,
                active=active)
            return plan, state, (n_pro, n_dem)
        imp = cache.importance
        hbm_imp = protect_read_residents(
            cache, control.slot_scores(imp, cache.hbm_owner), read_mask)
        plan, n_pro, n_dem = control.plan_by_score(
            cache, control.slot_scores(imp, cache.host_owner), hbm_imp,
            budget=budget, promote_thresh=self._thresh, active=active)
        return plan, state, (n_pro, n_dem)


@register("recency")
class RecencyPolicy(DevicePolicy):
    """LRU by last-access step (live mirror of ReactiveLRU).

    A page is accessed when this step's read set (`read_mask`, the
    pages attention streamed) includes it. Host pages accessed within
    `window` steps are promotion candidates, most recently read first;
    victims are the least-recently-read HBM residents, and a candidate
    never displaces a page read at the same step (strict inequality).
    """

    name = "recency"
    window = 8

    def __init__(self, *, cfg, geo):
        super().__init__(cfg=cfg, geo=geo)
        self._sparsity = cfg.attention_sparsity

    def init_state(self, geo) -> Any:
        """Per-page last-access steps (-1 = never) + the step count."""
        shape = (geo.num_layers, geo.batch, geo.max_pages)
        return {"last": torch.full(shape, -1, dtype=torch.int32),
                "step": torch.zeros((), dtype=torch.int32)}

    def plan(self, cache, state, active, budget,
             read_mask=None) -> PlanResult:
        """Promote recently read host pages, evict LRU residents."""
        check_read_mask(cache, read_mask)
        alive = cache.page_table >= 0
        if read_mask is not None:
            read = read_mask & alive
        elif self._sparsity > 0:
            # standalone use outside the engine: the post-step mask
            read = control.quest_page_mask(cache, self._sparsity)
        else:
            read = alive
        step = state["step"] + 1
        # unallocated pages forget their step, so a request admitted
        # into a released lane never inherits the last one's history
        last = torch.where(read, step,
                           torch.where(alive, state["last"], -1))
        scores = last.float()
        host_score = control.slot_scores(scores, cache.host_owner)
        hbm_score = control.slot_scores(scores, cache.hbm_owner)
        if self.plan_ahead:
            # just-read residents are already the most recent; +inf
            # makes their protection unconditional under the lagged
            # commit
            hbm_score = protect_read_residents(cache, hbm_score, read)
        # clamped at 0 so never-read pages (step -1) do not qualify
        # while the stream is younger than the window
        thresh = (step - self.window).clamp_min(0).float()
        plan, n_pro, n_dem = control.plan_by_score(
            cache, host_score, hbm_score, budget=budget,
            promote_thresh=thresh, active=active)
        return plan, {"last": last, "step": step}, (n_pro, n_dem)


@register("cost_aware")
class CostAwarePolicy(DevicePolicy):
    """Bandwidth-ratio hysteresis (live mirror of CostAwareHysteresis).

    Promote threshold = `payback_threshold(spec, 1 / IMPORTANCE_EMA)`:
    the attention-mass share at which keeping a page in HBM over the
    EMA horizon repays one link crossing under the spec's Eq. (3)/(4)
    constants. Residents at or above `demote_ratio` of it are protected
    from eviction. The thresholds are float32 0-dim tensors in the
    state, as the reference's `jnp.float32` scalars, so every
    comparison against the f32 importance happens in float32.
    """

    name = "cost_aware"
    demote_ratio = 0.25

    def __init__(self, *, cfg, geo):
        super().__init__(cfg=cfg, geo=geo)
        self._base_spec = cfg.spec

    def init_state(self, geo) -> Any:
        """Payback thresholds for the engine's spec."""
        del geo
        return self.recalibrate(None, self._base_spec)

    def recalibrate(self, state: Any, spec) -> Any:
        """Thresholds re-derived for `spec` (same shapes, new values)."""
        del state
        t_pro, t_dem = hysteresis_thresholds(
            spec, 1.0 / IMPORTANCE_EMA, self.demote_ratio)
        return {"t_promote": torch.tensor(t_pro, dtype=torch.float32),
                "t_demote": torch.tensor(t_dem, dtype=torch.float32)}

    def plan(self, cache, state, active, budget,
             read_mask=None) -> PlanResult:
        """Promote pages whose attention mass repays the link cost."""
        check_read_mask(cache, read_mask)
        imp = cache.importance
        host_score = control.slot_scores(imp, cache.host_owner)
        hbm_imp = control.slot_scores(imp, cache.hbm_owner)
        # residents warmer than the demote threshold are not victims
        protected = (cache.hbm_owner >= 0) & (hbm_imp >= state["t_demote"])
        hbm_score = torch.where(protected, _POS_INF, hbm_imp)
        if self.plan_ahead:
            # the band protects warm residents; the oracle also the
            # about-to-be-read ones, warm or not
            hbm_score = protect_read_residents(cache, hbm_score, read_mask)
        plan, n_pro, n_dem = control.plan_by_score(
            cache, host_score, hbm_score, budget=budget,
            promote_thresh=state["t_promote"], active=active)
        return plan, state, (n_pro, n_dem)


@register("quest")
class QuestPolicy(DevicePolicy):
    """Promote exactly what the Quest top-k mask reads next (live
    mirror of QuestPages).

    The mask over the post-step cache is the page set the next step's
    attention streams: its host-resident members are promoted (hottest
    first when over budget), its HBM residents are protected, and the
    coldest residents outside it make room.
    """

    name = "quest"

    def __init__(self, *, cfg, geo):
        super().__init__(cfg=cfg, geo=geo)
        self._sparsity = cfg.attention_sparsity

    def plan(self, cache, state, active, budget,
             read_mask=None) -> PlanResult:
        """Prefetch the next step's Quest top-k read set into HBM."""
        check_read_mask(cache, read_mask)
        # not read_mask (this step's reads): the mask over the post-step
        # cache is what the NEXT attention will want
        mask = control.quest_page_mask(cache, self._sparsity)
        imp = cache.importance
        eo, ho = cache.host_owner, cache.hbm_owner
        in_mask_host = torch.gather(mask, -1, eo.clamp_min(0).long()) \
            & (eo >= 0)
        host_imp = control.slot_scores(imp, eo)
        # +1 keeps every member above the 0.0 threshold (importance is
        # nonnegative)
        host_score = torch.where(in_mask_host, 1.0 + host_imp, _NEG_INF)
        in_mask_hbm = torch.gather(mask, -1, ho.clamp_min(0).long()) \
            & (ho >= 0)
        hbm_imp = control.slot_scores(imp, ho)
        hbm_score = torch.where(in_mask_hbm, _POS_INF, hbm_imp)
        plan, n_pro, n_dem = control.plan_by_score(
            cache, host_score, hbm_score, budget=budget,
            promote_thresh=0.0, active=active)
        return plan, state, (n_pro, n_dem)
