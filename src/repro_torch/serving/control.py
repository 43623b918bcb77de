"""Decode control plane, vectorized over [L, B] (the port of the
reference's `serving/control.py`).

  * write slot: the token's logical page keeps its existing mapping;
    a fresh page takes the first free HBM slot, else the first free
    host slot, else the last host slot.
  * quest mask: keep the top-k pages by importance EMA, always keeping
    the sink page and the two most recent pages.
  * migrations: per (layer, batch), promote the `budget` hottest host
    pages above `promote_thresh`; free HBM slots are consumed first
    (in slot order), then the coldest HBM residents are swapped out.
  * overlap-mode hazards: a plan staged one step ahead is revalidated
    against the commit-time owner maps (`revalidate_plan`), and its rows
    of rebound lanes are dropped at chunk boundaries (`mask_plan_lanes`).

Tie order follows the reference exactly: `lax.top_k` puts the lower
index first among ties and `jnp.argsort` is stable, so both become
`torch.sort(..., stable=True)` and a slice (`torch.topk` promises no
order among ties); `jnp.argmax` over bool returns the first True, so
the mask is cast to int before `torch.argmax`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.page_copy import Split
from repro_torch.kvcache.migrate import MigrationPlan
from repro_torch.kvcache.paged import NO_SLOT, PagedKVCache


def choose_write_slot(cache: PagedKVCache) -> torch.Tensor:
    """Physical slot [L, B] (int32) receiving this step's token (the
    tiers' sizes read from the owner maps, which are whole where a
    rank's pools hold a block of the slots)."""
    T = cache.k_hbm.shape[3]
    hbm_pages = cache.hbm_owner.shape[2]
    host_pages = cache.host_owner.shape[2]
    max_pages = cache.page_table.shape[2]
    B = cache.length.shape[0]

    logical = (cache.length // T).clamp_max(max_pages - 1).long()   # [B]
    existing = cache.page_table[:, torch.arange(B, device=logical.device),
                                logical]                            # [L, B]
    free_h = cache.hbm_owner < 0
    has_h = free_h.any(-1)
    first_h = free_h.to(torch.int32).argmax(-1)
    free_e = cache.host_owner < 0
    has_e = free_e.any(-1)
    first_e = free_e.to(torch.int32).argmax(-1)

    spill = hbm_pages + torch.where(has_e, first_e, host_pages - 1)
    fresh = torch.where(has_h, first_h, spill)
    return torch.where(existing >= 0, existing, fresh).to(torch.int32)


def quest_page_mask(cache: PagedKVCache, sparsity: float) -> torch.Tensor:
    """Quest-style top-k page mask, bool [L, B, max_pages]."""
    alive = cache.page_table >= 0
    n_alive = alive.sum(-1)
    k = torch.round((1.0 - sparsity) * n_alive).to(torch.int32).clamp_min(1)
    imp = torch.where(alive, cache.importance, float("-inf"))
    order = torch.sort(-imp, dim=-1, stable=True).indices  # dead last
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(order.shape[-1],
                                          device=order.device)
                  .expand_as(order))
    topk = rank < k[..., None]
    idx = torch.arange(alive.shape[-1], device=alive.device)
    sink = idx == 0
    recent = idx >= (n_alive[..., None] - 2)
    return alive & (topk | sink | recent)


def migration_budget(geo, frac: float) -> int:
    """Per-(layer, batch) promote budget, a static int of the geometry."""
    return min(max(1, int(frac * geo.hbm_pages)),
               geo.hbm_pages, geo.host_pages)


def plan_capacity(geo, frac: float) -> int:
    """Fixed MigrationPlan capacity for a geometry."""
    return geo.num_layers * geo.batch * migration_budget(geo, frac)


def plan_by_score(cache: PagedKVCache, host_score: torch.Tensor,
                  hbm_score: torch.Tensor, *, budget: int,
                  promote_thresh, active: Optional[torch.Tensor] = None,
                  ) -> Tuple[MigrationPlan, torch.Tensor, torch.Tensor]:
    """Fixed-capacity promote/demote pairing by per-slot score.

    host_score [L, B, Pe]: candidate score per host slot (-inf =
    ineligible). hbm_score [L, B, Ph]: victim score per HBM slot (-inf =
    free, +inf = protected). The i-th best candidate displaces the
    i-th worst victim only if strictly higher-scoring. `active` (bool
    [B]) gates planning per lane. Returns (plan, n_promotes, n_demotes).
    """
    ho, eo = cache.hbm_owner, cache.host_owner
    L, B, Ph = ho.shape
    Pe = eo.shape[2]
    if not 1 <= budget <= min(Ph, Pe):
        raise ValueError(f"budget {budget} outside 1..{min(Ph, Pe)}")

    cand = torch.sort(host_score, dim=-1, descending=True, stable=True)
    cand_imp = cand.values[..., :budget]
    cand_slot = cand.indices[..., :budget]
    cand_logical = torch.gather(eo, -1, cand_slot)

    dst_slot = torch.sort(hbm_score, dim=-1, stable=True).indices[..., :budget]
    victim_imp = torch.gather(hbm_score, -1, dst_slot)
    victim_logical = torch.gather(ho, -1, dst_slot)

    promote = (cand_imp > promote_thresh) & (victim_imp < cand_imp)
    if active is not None:
        promote = promote & active[None, :, None]
    demote = promote & (victim_logical >= 0)

    dev = ho.device
    lidx = torch.arange(L, device=dev)[:, None, None].expand_as(promote)
    bidx = torch.arange(B, device=dev)[None, :, None].expand_as(promote)

    def rows(ok, *cols):
        return [torch.where(ok, c, -1).reshape(-1).to(torch.int32)
                for c in cols]

    plan = MigrationPlan(
        *rows(promote, lidx, bidx, cand_slot, dst_slot, cand_logical),
        *rows(demote, lidx, bidx, dst_slot, cand_slot, victim_logical),
    )
    return plan, promote.sum(), demote.sum()


def _mask_plan_rows(plan: MigrationPlan, keep: torch.Tensor) -> MigrationPlan:
    """Sentinel out every plan row where `keep` (bool [M]) is False —
    both halves with the same mask (`plan_by_score` pairs demote i with
    promote i, and a demote row is live only when its promote is), so a
    masked plan never orphans half a swap."""
    return MigrationPlan(*[torch.where(keep, getattr(plan, f.name), -1)
                           .to(torch.int32)
                           for f in dataclasses.fields(plan)])


def revalidate_plan(plan: MigrationPlan, cache: PagedKVCache
                    ) -> MigrationPlan:
    """Hazard-mask a STAGED plan against the commit-time owner maps.

    In overlap mode (`EngineConfig.overlap_migrations`) a plan built at
    step N commits at step N+1, so the steps in between — the next
    decode's fresh-page allocation, the prefill plane's page
    registration — may have changed the placement the plan assumed. A
    promote row survives only when the world still matches the plan:

      * its source host slot still holds the planned logical page
        (``host_owner[src] == logical`` — a release, re-admission or
        earlier promote of that page invalidates the row);
      * its destination is still what the plan paired it with: the
        planned victim for swap rows (``hbm_owner[dem_src] ==
        dem_logical``), a still-free slot for fill rows
        (``hbm_owner[dst] < 0`` — an allocation into the slot in the
        interim kills the row rather than letting the commit clobber a
        page the in-flight step just wrote).

    Demote rows are masked with the SAME row mask (index-paired swaps).
    The one hazard owner maps cannot express — a released lane re-bound
    to another request with the same deterministic static placement —
    is `mask_plan_lanes`'s, at chunk boundaries.
    """
    ho, eo = cache.hbm_owner, cache.host_owner
    Ph, Pe = ho.shape[2], eo.shape[2]

    def gather(owner, l, b, s, bound):
        # out-of-range indices clamp, as a JAX gather's do
        return owner[l.clamp(0, owner.shape[0] - 1).long(),
                     b.clamp(0, owner.shape[1] - 1).long(),
                     s.clamp(0, bound - 1).long()]

    live = plan.pro_layer >= 0
    src_ok = gather(eo, plan.pro_layer, plan.pro_batch, plan.pro_src,
                    Pe) == plan.pro_logical
    dst_owner = gather(ho, plan.pro_layer, plan.pro_batch, plan.pro_dst, Ph)
    victim_owner = gather(ho, plan.dem_layer, plan.dem_batch, plan.dem_src,
                          Ph)
    dst_ok = torch.where(plan.dem_layer >= 0,
                         victim_owner == plan.dem_logical, dst_owner < 0)
    return _mask_plan_rows(plan, live & src_ok & dst_ok)


def mask_plan_lanes(plan: MigrationPlan, stale: torch.Tensor
                    ) -> MigrationPlan:
    """Drop every staged row targeting a `stale` lane (bool [B]).

    The chunk-boundary half of overlap-mode hazard masking: a plan
    staged in the previous chunk may name a lane the host released or
    (re)admitted at the boundary. `revalidate_plan` cannot catch the
    reuse case — static placement is deterministic, so a re-admitted
    request can reproduce the exact (slot, logical) pairs of the
    evicted one with another request's pages — so the engine masks
    freshly (re)bound lanes out of the staged plan before the chunk
    runs."""
    lane = plan.pro_batch.clamp(0, stale.shape[0] - 1).long()
    return _mask_plan_rows(plan, (plan.pro_layer >= 0) & ~stale[lane])


def slot_scores(values: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """Gather per-logical-page `values` [L, B, max_pages] to per-slot
    scores [L, B, P] through an owner map; free slots score -inf."""
    gathered = torch.gather(values, -1, owner.clamp_min(0).long())
    return torch.where(owner >= 0, gathered, float("-inf"))


def plan_migrations(cache: PagedKVCache, *, budget: int,
                    promote_thresh: float,
                    active: Optional[torch.Tensor] = None,
                    ) -> Tuple[MigrationPlan, torch.Tensor, torch.Tensor]:
    """Importance-EMA hysteresis planner: `plan_by_score` over the
    attention-mass EMA."""
    imp = cache.importance
    return plan_by_score(cache, slot_scores(imp, cache.host_owner),
                         slot_scores(imp, cache.hbm_owner), budget=budget,
                         promote_thresh=promote_thresh, active=active)


def lane_modes(active: torch.Tensor, prefilled: torch.Tensor,
               prompt_len: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane (prefilling, decoding), disjoint bool [B]: a live lane
    prefills until its prompt is consumed, then decodes."""
    prefilling = active & (prefilled < prompt_len)
    return prefilling, active & ~prefilling


def lane_merge(old: PagedKVCache, new: PagedKVCache,
               active: torch.Tensor) -> PagedKVCache:
    """Keep `new` for active lanes, `old` for the rest (active bool [B]).

    Only the small tensors are merged: tables, length and importance.
    The pools are taken from `new` as they are — the decode step leaves
    inactive lanes' pool rows untouched (`write_token_layer(active=)`),
    so they already hold `old`'s data. Merging whole pools, as the
    reference's `where` does, would copy 3.4 GB per step at full width.
    """
    def m(o, n):
        shape = [1] * n.dim()
        shape[1] = active.shape[0]
        return torch.where(active.reshape(shape), n, o)

    return dataclasses.replace(
        new,
        page_table=m(old.page_table, new.page_table),
        hbm_owner=m(old.hbm_owner, new.hbm_owner),
        host_owner=m(old.host_owner, new.host_owner),
        length=torch.where(active, new.length, old.length),
        importance=m(old.importance, new.importance))


def release_lanes(cache: PagedKVCache, lanes: torch.Tensor) -> PagedKVCache:
    """Reclaim completed lanes (bool [B]): owner maps and page table
    cleared, length zeroed, importance reset. Pool data stays in place
    (unreachable once unmapped)."""
    def clr(arr, fill):
        shape = [1] * arr.dim()
        shape[1] = lanes.shape[0]
        return torch.where(lanes.reshape(shape), fill, arr).to(arr.dtype)

    return dataclasses.replace(
        cache,
        page_table=clr(cache.page_table, NO_SLOT),
        hbm_owner=clr(cache.hbm_owner, NO_SLOT),
        host_owner=clr(cache.host_owner, NO_SLOT),
        length=torch.where(lanes, 0, cache.length).to(torch.int32),
        importance=clr(cache.importance, 0.0))


def insert_lane(cache: PagedKVCache, lane_cache: PagedKVCache,
                lane: torch.Tensor) -> PagedKVCache:
    """Bind a prefilled batch-1 cache to lane `lane` (an int scalar
    tensor) of the batched cache: the lane's pool pages take
    `lane_cache`'s, in place, and its tables, length and importance
    theirs, in new tensors. The lane index stays data: on the card this
    is one row-copy launch (K and V, every layer, both tiers) and the
    table writes, with no host sync on `lane`."""
    L, B, P = cache.page_table.shape
    dev = cache.page_table.device
    i32 = dict(dtype=torch.int32, device=dev)
    lane = torch.as_tensor(lane, device=dev)
    layer = torch.arange(L, **i32).repeat_interleave(P)
    slot = torch.arange(P, **i32).repeat(L)
    dst = (layer, lane.to(torch.int32).reshape(1).expand(L * P).contiguous(),
           slot)
    src = (layer, torch.zeros(L * P, **i32), slot)
    ops.copy_rows(
        (Split(cache.k_hbm, cache.k_host, 2), dst,
         Split(lane_cache.k_hbm, lane_cache.k_host, 2), src),
        (Split(cache.v_hbm, cache.v_host, 2), dst,
         Split(lane_cache.v_hbm, lane_cache.v_host, 2), src))
    onehot = torch.arange(B, device=dev) == lane

    def ins(dst_t, src_t):
        shape = [1] * dst_t.dim()
        shape[1] = B
        return torch.where(onehot.reshape(shape), src_t, dst_t)

    return dataclasses.replace(
        cache,
        page_table=ins(cache.page_table, lane_cache.page_table),
        hbm_owner=ins(cache.hbm_owner, lane_cache.hbm_owner),
        host_owner=ins(cache.host_owner, lane_cache.host_owner),
        length=torch.where(onehot, lane_cache.length[0], cache.length),
        importance=ins(cache.importance, lane_cache.importance))


def page_tiers(cache: PagedKVCache) -> torch.Tensor:
    """Read-time placement codes, int8 [L, B, max_pages]: 0 = HBM,
    1 = host DRAM, -1 = unallocated."""
    slot = cache.page_table
    hbm_pages = cache.hbm_owner.shape[2]
    return torch.where(slot < 0, -1,
                       torch.where(slot < hbm_pages, 0, 1)).to(torch.int8)


def occupancy(cache: PagedKVCache) -> torch.Tensor:
    """[2] int32: resident page counts (HBM, host) summed over [L, B]."""
    return torch.stack([(cache.hbm_owner >= 0).sum(),
                        (cache.host_owner >= 0).sum()]).to(torch.int32)
