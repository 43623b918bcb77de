"""Page migration between the HBM and host tiers (the port of the
reference's `kvcache/migrate.py`).

A `MigrationPlan` is a fixed-capacity batch of moves, -1 rows being
no-ops. Execution is a two-phase commit: `stage_plan` gathers (copies)
every source page before `commit_staged` scatters any of them, which
is what makes a swap safe — a demotion whose destination is the host
slot a promotion vacates reads the promoted page first. Pools are
written in place, tables replaced (see `repro_torch.kvcache.paged`).

Every page moves through the row-copy kernel (`kernels.ops.copy_rows`;
its plain version on the CPU), rows indexed by the plan's own tensors:
one launch gathers a plan's four page lists, one scatters them.
The reference routes sentinel rows to out-of-bounds indices and drops
them; here the copy skips rows whose indices are out of range, and the
table rewrites send them to a spare element. On the card that is no host sync,
whether the host pools lie in HBM (inline mode) or in pinned host
memory (overlap mode), and `commit_async` runs the copies on a side
stream concurrently with the decode compute.

On a rank whose pools hold its block of each tier's slots (the `pages`
rule: a `PoolShard`, passed as `shard`), a plan row may move a page
between slots of two ranks. Each rank gathers the source rows it holds
into staging buffers filled with -0.0 elsewhere, the buffers are
summed over the ranks (`PoolShard.exchange`: plain PyTorch addition in
the collective, exact, since -0.0 is the identity of every sum and each
row comes from one rank), and each rank scatters the rows whose
destination it holds. Every row of the plan's capacity crosses the
exchange, its sentinel rows included. The tables are whole on every
rank and rewritten alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kvcache.paged import NO_SLOT, PagedKVCache, PoolShard

_FIELDS = ("pro_layer", "pro_batch", "pro_src", "pro_dst", "pro_logical",
           "dem_layer", "dem_batch", "dem_src", "dem_dst", "dem_logical")


@dataclasses.dataclass
class MigrationPlan:
    """Fixed-capacity migration batch. All tensors int32 [M]; -1 rows
    are no-ops.

    promote: host slot `src` -> hbm slot `dst` (page `logical`)
    demote:  hbm slot `src`  -> host slot `dst`
    Every entry also names the (layer, batch) coordinate.
    """
    pro_layer: torch.Tensor
    pro_batch: torch.Tensor
    pro_src: torch.Tensor      # host slot
    pro_dst: torch.Tensor      # hbm slot
    pro_logical: torch.Tensor
    dem_layer: torch.Tensor
    dem_batch: torch.Tensor
    dem_src: torch.Tensor      # hbm slot
    dem_dst: torch.Tensor      # host slot
    dem_logical: torch.Tensor

    @classmethod
    def empty(cls, capacity: int, device=None) -> "MigrationPlan":
        """An all-sentinel plan on `device` (default: the CUDA card)."""
        device = resolve_device(device)
        return cls(*[torch.full((capacity,), -1, dtype=torch.int32,
                                device=device) for _ in _FIELDS])

    @classmethod
    def build(cls, capacity: int, promotes, demotes,
              device=None) -> "MigrationPlan":
        """promotes/demotes: iterables of (layer, batch, src, dst,
        logical); the plan on `device` (default: the CUDA card)."""
        device = resolve_device(device)

        def pack(rows):
            arr = np.full((capacity, 5), -1, np.int32)
            rows = list(rows)[:capacity]
            if rows:
                arr[: len(rows)] = np.asarray(rows, np.int32)
            return [torch.as_tensor(arr[:, i].copy(), device=device)
                    for i in range(5)]
        return cls(*pack(promotes), *pack(demotes))

    @property
    def capacity(self) -> int:
        return self.pro_layer.shape[0]

    def row_counts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_promotes, n_demotes): the non-sentinel rows."""
        return ((self.pro_layer >= 0).sum(), (self.dem_layer >= 0).sum())


def stage_plan(cache: PagedKVCache, plan: MigrationPlan,
               shard: Optional[PoolShard] = None):
    """Phase 1: gather every source page from the input pools.

    Returns `(dem_k, dem_v, pro_k, pro_v)`, each [M, T, KH, HD] — copies,
    so later scatters cannot change them. Sentinel rows gather an
    arbitrary in-bounds page; `commit_staged` drops them. With `shard`
    (a rank's slots, the `pages` rule) every rank gathers the rows it
    holds and the exchange gives each rank every row (the module
    docstring).
    """
    L = cache.page_table.shape[0]
    hbm_pages = cache.hbm_owner.shape[2]
    host_pages = cache.host_owner.shape[2]
    dem_src = plan.dem_src.clamp(0, hbm_pages - 1)
    pro_src = plan.pro_src.clamp(0, host_pages - 1)
    if shard is not None:
        dem_src = shard.tier_local(dem_src, 0)
        pro_src = shard.tier_local(pro_src, 1)
    d = _rows_of(plan.dem_layer.clamp(0, L - 1), plan.dem_batch.clamp_min(0),
                 dem_src)
    p = _rows_of(plan.pro_layer.clamp(0, L - 1), plan.pro_batch.clamp_min(0),
                 pro_src)
    row = cache.k_hbm.shape[3:]
    like = dict(dtype=cache.k_hbm.dtype, device=plan.pro_layer.device)
    if shard is None:
        bufs = [torch.empty((plan.capacity,) + row, **like)
                for _ in range(4)]
    else:
        staged = torch.full((4, plan.capacity) + row, -0.0, **like)
        bufs = staged.unbind(0)
    ops.copy_rows(*[(buf, (None,), pool, at) for buf, pool, at in zip(
        bufs, (cache.k_hbm, cache.v_hbm, cache.k_host, cache.v_host),
        (d, d, p, p))])
    if shard is not None:
        bufs = shard.exchange(staged).unbind(0)
    return tuple(bufs)


def _rows_of(*idx):
    """(layer, lane, slot) row indices as the row copy takes them."""
    return tuple(i.to(torch.int32).contiguous() for i in idx)


def commit_staged(cache: PagedKVCache, plan: MigrationPlan,
                  staged, shard: Optional[PoolShard] = None
                  ) -> PagedKVCache:
    """Phase 2: scatter the staged pages and rewrite the maps.

    `staged` is `stage_plan`'s gather of the SAME plan. A row scatters
    only where the reference's would land in bounds (and, with `shard`,
    where the rank holds its destination). Owner clears land before
    owner sets, so swapped slots end up owned by the arriving page, not
    marked free.
    """
    scatter_staged(cache, plan, staged, shard)
    return commit_tables(cache, plan)


def _in(idx, bound):
    return (idx >= 0) & (idx < bound)


def _scatter(table: torch.Tensor, ok: torch.Tensor, at, values
             ) -> torch.Tensor:
    """`table` [L, B, P] with table[at] = values at the rows `ok` keeps,
    in fixed shapes: every row computes its flat target, and the rows
    `ok` drops write a spare element past the end instead (no boolean
    indexing, so no host sync)."""
    L, B, P = table.shape
    layer, lane, slot = (i.long() for i in at)
    flat = torch.cat([table.reshape(-1), table.new_zeros(1)])
    target = torch.where(ok, (layer * B + lane) * P + slot, L * B * P)
    values = values.to(table.dtype) if torch.is_tensor(values) else \
        torch.full(target.shape, values, dtype=table.dtype,
                   device=table.device)
    return flat.index_put((target,), values)[:-1].view(L, B, P)


def scatter_staged(cache: PagedKVCache, plan: MigrationPlan,
                   staged, shard: Optional[PoolShard] = None) -> None:
    """The data half of `commit_staged`: row r of the staged pages lands
    at (layer, batch, dst) where those are in range; the row copy skips
    the others (the batch index is clamped at 0 first, as the reference
    does). With `shard`: where the rank holds dst, at its local slot."""
    dem_k, dem_v, pro_k, pro_v = staged
    dem_dst, pro_dst = plan.dem_dst, plan.pro_dst
    if shard is not None:
        dem_dst = shard.tier_local(dem_dst, 1)
        pro_dst = shard.tier_local(pro_dst, 0)
    d_at = _rows_of(plan.dem_layer, plan.dem_batch.clamp_min(0), dem_dst)
    p_at = _rows_of(plan.pro_layer, plan.pro_batch.clamp_min(0), pro_dst)
    ops.copy_rows((cache.k_host, d_at, dem_k, (None,)),
                  (cache.v_host, d_at, dem_v, (None,)),
                  (cache.k_hbm, p_at, pro_k, (None,)),
                  (cache.v_hbm, p_at, pro_v, (None,)))


def commit_tables(cache: PagedKVCache, plan: MigrationPlan
                  ) -> PagedKVCache:
    """The table half of `commit_staged`: owner maps and page table
    rewritten for the plan's in-range rows, in fixed shapes (`_scatter`),
    so a CUDA graph can hold it."""
    L, B, max_pages = cache.page_table.shape
    hbm_pages = cache.hbm_owner.shape[2]
    host_pages = cache.host_owner.shape[2]
    d_b = plan.dem_batch.clamp_min(0)
    d_ok = _in(plan.dem_layer, L) & (d_b < B)
    p_b = plan.pro_batch.clamp_min(0)
    p_ok = _in(plan.pro_layer, L) & (p_b < B)

    # ---- owner maps: clear vacated slots FIRST, then record arrivals ---
    hbm_owner = _scatter(cache.hbm_owner,
                         d_ok & _in(plan.dem_src, hbm_pages),
                         (plan.dem_layer, d_b, plan.dem_src), NO_SLOT)
    hbm_owner = _scatter(hbm_owner, p_ok & _in(plan.pro_dst, hbm_pages),
                         (plan.pro_layer, p_b, plan.pro_dst),
                         plan.pro_logical)
    host_owner = _scatter(cache.host_owner,
                          p_ok & _in(plan.pro_src, host_pages),
                          (plan.pro_layer, p_b, plan.pro_src), NO_SLOT)
    host_owner = _scatter(host_owner, d_ok & _in(plan.dem_dst, host_pages),
                          (plan.dem_layer, d_b, plan.dem_dst),
                          plan.dem_logical)

    # ---- page table --------------------------------------------------------
    page_table = _scatter(cache.page_table,
                          d_ok & _in(plan.dem_logical, max_pages),
                          (plan.dem_layer, d_b, plan.dem_logical),
                          plan.dem_dst + hbm_pages)
    page_table = _scatter(page_table, p_ok & _in(plan.pro_logical, max_pages),
                          (plan.pro_layer, p_b, plan.pro_logical),
                          plan.pro_dst)

    return dataclasses.replace(cache, page_table=page_table,
                               hbm_owner=hbm_owner, host_owner=host_owner)


def apply_migrations(cache: PagedKVCache, plan: MigrationPlan,
                     shard: Optional[PoolShard] = None) -> PagedKVCache:
    """Execute a migration batch inline: stage, then commit (`shard`: a
    rank's slots under the `pages` rule)."""
    return commit_staged(cache, plan, stage_plan(cache, plan, shard), shard)


def commit_async(cache: PagedKVCache, plan: MigrationPlan,
                 stream: "torch.cuda.Stream",
                 shard: Optional[PoolShard] = None):
    """`apply_migrations` with the page copies on `stream` (a CUDA
    cache whose host pools are pinned): they start after everything
    the current stream has queued so far — this step's token writes and
    attention reads — and run concurrently with what it queues next;
    the tables are rewritten on the current stream at once. Returns
    (cache, event): work that touches the pools must wait on the event
    (`torch.cuda.Stream.wait_event`) first. With `shard` the exchange
    runs on `stream` too, at the same point of every rank's step."""
    main = torch.cuda.current_stream(plan.pro_layer.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        # the staging buffers belong to `stream`'s pool; the plan's
        # rows, made on the main stream, must outlive the copies
        staged = stage_plan(cache, plan, shard)
        scatter_staged(cache, plan, staged, shard)
    for name in _FIELDS:
        getattr(plan, name).record_stream(stream)
    done = torch.cuda.Event()
    done.record(stream)
    return commit_tables(cache, plan), done


def migration_bytes(plan: MigrationPlan, page_bytes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M_i, M_o) bytes for Eq. (3)/(4) telemetry: the plan's promote
    and demote rows, a page each, as tensors on the plan's device."""
    n_pro, n_dem = plan.row_counts()
    return n_pro * page_bytes, n_dem * page_bytes
