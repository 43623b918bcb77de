"""Two-tier paged KV cache (the port of the reference's
`kvcache/paged.py`).

Physical layout (per attention layer, per batch lane):

  k_hbm/v_hbm   [L, B, hbm_pages,  page_tokens, KH, HD]   "HBM tier"
  k_host/v_host [L, B, host_pages, page_tokens, KH, HD]   "DRAM tier"

Logical pages map to physical slots through one page table:

  page_table    [L, B, max_pages] int32 — physical slot of logical page p;
                slot < hbm_pages  -> HBM slot,
                slot >= hbm_pages -> host slot (slot - hbm_pages),
                NO_SLOT (=-1)     -> page not allocated yet.

Both pools live on the cache's device, except in overlap mode
(`init_cache(host_pinned=True)` on the card), where `k_host`/`v_host`
are pinned CPU tensors: the "DRAM tier" is then host DRAM behind the
card's link, as in the reference's `pinned_host` placement. The paged
attention kernel reads them in place over the link (it takes each pool
as a pointer plus strides). Every other touch of either tier's pools —
token writes, migration, the prefill plane's read — goes through the
row-copy kernel (`kernels.ops.copy_rows`), in both modes, with the row
indices on the card: PyTorch indexing cannot address a CPU tensor with
CUDA indices, and nothing copies a whole host pool to the card. On the
CPU (tests) `host_pinned` gives plain CPU pools and `copy_rows` its
plain version. The reference's `host_memory_kind()` probes JAX for a
pinned memory kind to place its host pools in; the port pins them
(`host_pinned`) and needs no probe, so it has no counterpart.

Under a serving mesh (`ServingEngine(..., mesh=)`) each rank holds its
block of the cache, as `launch.shardings.cache_shardings` lays it out:
under the `kv_heads` rule pools [L, B/data, P, T, KH/model, HD], under
the `pages` rule [L, B/data, P/model, T, KH, HD] (the rank's contiguous
block of each tier's slots, `PoolShard`), under `none` whole pools; and
in every rule the tables and owner maps of its B/data lanes whole on
every `model` rank (where the reference shards the owner maps with the
pools' pages: the port keeps them whole, so every decision over them
is computed alike on every model rank). A rank's cache is a cache of a
rank-local geometry (its lanes, the whole tier sizes, which the tables,
the plans and the budget read) built by `init_cache`, whose `shard`
names the rank's slots (a `PoolShard`). Every function that needs a
tier's size reads it from the owner maps, never from the pools. In
overlap mode each rank keeps its host tier where the unmeshed port
keeps it, in pinned host memory; the reference's GSPMD puts a meshed
cache in device memory (its `serve` drops the pinned kind under a
mesh), and the values are the same either way.

Mutation convention: unlike the reference's pure functions, pool
writes happen IN PLACE (a full-width cache is 3.4 GB and is never
copied), while the small tensors — page table, owner maps, length,
importance — are replaced by new tensors. A cache object taken before
a step therefore still holds the pre-step tables, which is what
`control.lane_merge` relies on. Scatters the reference routes to an
out-of-bounds sentinel and drops (`mode="drop"`) carry index -1 into
the pools, which the row copy skips, and write a spare element past
the end of the tables; nothing indexes a table with -1, which would
wrap, and nothing indexes one by a boolean mask, which would read the
mask back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.page_copy import Split

NO_SLOT = -1

#: EMA decay of the per-page attention-mass importance statistic
#: (`PagedKVCache.importance`), applied by the decode data plane every
#: step.
IMPORTANCE_EMA = 0.25


@dataclasses.dataclass(frozen=True)
class PoolShard:
    """A rank's block of the pools under the `pages` rule: the global
    slots [lo, hi) of each tier (`hbm`, `host`) whose pages it holds,
    every KV head of them (`launch.shardings.pool_slots`). `exchange`
    sums a tensor over the ranks that share the lanes (the `model`
    axis), in place: the migration's row exchange, which the rank's
    `TensorParallel.reduce` is (no part of equality or the hash)."""

    hbm: Tuple[int, int]
    host: Tuple[int, int]
    exchange: Optional[Callable[[torch.Tensor], torch.Tensor]] = \
        dataclasses.field(default=None, compare=False, repr=False)

    @property
    def counts(self) -> Tuple[int, int]:
        """The rank's (HBM, host) slot counts: its pools' slot dims."""
        return self.hbm[1] - self.hbm[0], self.host[1] - self.host[0]

    def local_slots(self, slot: torch.Tensor, hbm_pages: int
                    ) -> torch.Tensor:
        """Global slots (< `hbm_pages`: HBM, else host at slot -
        `hbm_pages`) as the rank's own slot space (its HBM slots, then
        its host slots from its HBM count on), int32; a slot on another
        rank, or none, is NO_SLOT, which every row copy skips."""
        h = self.tier_local(torch.where(slot < hbm_pages, slot, NO_SLOT), 0)
        e = self.tier_local(slot - hbm_pages, 1)
        return torch.where(h >= 0, h, torch.where(
            e >= 0, e + self.counts[0], NO_SLOT)).to(torch.int32)

    def tier_local(self, index: torch.Tensor, tier: int) -> torch.Tensor:
        """Slots of one tier (`tier` 0: HBM, 1: host) as the rank's
        slots of that tier's pool, int32; another rank's, NO_SLOT."""
        lo, hi = self.hbm if tier == 0 else self.host
        return torch.where((index >= lo) & (index < hi), index - lo,
                           NO_SLOT).to(torch.int32)

    def lists(self, hl, hv, el, ev):
        """The rank's part of `PagedKVCache.tier_lists`' whole lists (of
        one layer or all): its slots' columns, each listed slot as its
        place in the rank's pool."""
        out = []
        for (lst, val), (lo, hi) in (((hl, hv), self.hbm),
                                     ((el, ev), self.host)):
            lst = lst[..., lo:hi]
            out += [torch.where(lst >= 0, lst - lo, NO_SLOT)
                    .to(torch.int32), val[..., lo:hi].contiguous()]
        return tuple(out)

    def place(self, imp_h: torch.Tensor, imp_e: torch.Tensor,
              hbm_pages: int, host_pages: int) -> torch.Tensor:
        """The rank's pages' [..., n_h] and [..., n_e] values at their
        global places of a [..., hbm_pages + host_pages] vector of
        zeros: summed over the ranks (each slot on one rank), the
        whole vector, exactly."""
        out = imp_h.new_zeros(imp_h.shape[:-1] + (hbm_pages + host_pages,))
        out[..., self.hbm[0]:self.hbm[1]] = imp_h
        out[..., hbm_pages + self.host[0]:hbm_pages + self.host[1]] = imp_e
        return out


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    num_layers: int          # attention layers only
    batch: int
    page_tokens: int
    hbm_pages: int           # per layer per sequence
    host_pages: int
    kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def max_pages(self) -> int:
        return self.hbm_pages + self.host_pages

    @property
    def max_tokens(self) -> int:
        return self.max_pages * self.page_tokens

    def page_bytes(self) -> int:
        return (2 * self.page_tokens * self.kv_heads * self.head_dim
                * self.dtype.itemsize)

    @classmethod
    def for_context(cls, *, num_layers: int, batch: int, context: int,
                    kv_heads: int, head_dim: int, page_tokens: int = 16,
                    hbm_fraction: float = 0.25, pad_to: int = 16,
                    dtype=torch.bfloat16) -> "CacheGeometry":
        """Pool sizes padded to `pad_to` pages, as in the reference."""
        def rnd(x):
            return -(-max(x, 1) // pad_to) * pad_to
        pages = -(-context // page_tokens)
        hbm = rnd(int(round(pages * hbm_fraction)))
        host = rnd(pages - hbm + 1)
        return cls(num_layers=num_layers, batch=batch,
                   page_tokens=page_tokens, hbm_pages=hbm,
                   host_pages=host, kv_heads=kv_heads,
                   head_dim=head_dim, dtype=dtype)


@dataclasses.dataclass
class PagedKVCache:
    k_hbm: torch.Tensor       # [L, B, Ph, T, KH, HD]
    v_hbm: torch.Tensor
    k_host: torch.Tensor      # [L, B, Pe, T, KH, HD]
    v_host: torch.Tensor
    page_table: torch.Tensor  # [L, B, max_pages] int32 physical slot
    hbm_owner: torch.Tensor   # [L, B, Ph] int32 logical page at slot (-1 free)
    host_owner: torch.Tensor  # [L, B, Pe] int32
    length: torch.Tensor      # [B] int32 tokens currently cached
    importance: torch.Tensor  # [L, B, max_pages] f32 EMA of attention mass

    def tier_lists(self, layer=None, logical_page_mask=None):
        """Kernel operands: per-tier (page_list, page_valid).

        page_list[b, s] = s if slot s is occupied else -1; page_valid is
        the number of cached tokens inside the owning page. Returns
        tensors for one layer ([B, P]) or all ([L, B, P]).
        logical_page_mask (bool, page-table shaped): pages whose mask is
        False are excluded from attention this step (Quest-style
        bypassing; their data stays cached).
        """
        T = self.k_hbm.shape[3]

        def lists(owner, mask):
            idx = torch.arange(owner.shape[-1], dtype=torch.int32,
                               device=owner.device)
            occupied = owner >= 0
            if mask is not None:
                sel = torch.gather(mask, -1, owner.clamp_min(0).long())
                occupied = occupied & sel
            plist = torch.where(occupied, idx, NO_SLOT).to(torch.int32)
            valid = (self.length[:, None] - owner * T).clamp(0, T)
            valid = torch.where(occupied, valid, 0).to(torch.int32)
            return plist, valid

        ho = self.hbm_owner if layer is None else self.hbm_owner[layer]
        eo = self.host_owner if layer is None else self.host_owner[layer]
        hl, hv = lists(ho, logical_page_mask)
        el, ev = lists(eo, logical_page_mask)
        return hl, hv, el, ev


def init_cache(geo: CacheGeometry, device=None, host_pinned: bool = False,
               shard: Optional[PoolShard] = None) -> PagedKVCache:
    """A fresh all-free cache for `geo` on `device` (default: the CUDA
    card): pools of `shard`'s slots when it names a rank's (the `pages`
    rule; the tables always whole). With `host_pinned` and a CUDA
    `device`, the host pools are zeroed pinned CPU tensors (the
    overlap-mode placement); on the CPU they are plain CPU tensors
    either way."""
    device = resolve_device(device)
    L, B, T = geo.num_layers, geo.batch, geo.page_tokens
    kh, hd = geo.kv_heads, geo.head_dim
    n_h, n_e = shard.counts if shard is not None else (
        geo.hbm_pages, geo.host_pages)
    shape_h = (L, B, n_h, T, kh, hd)
    shape_e = (L, B, n_e, T, kh, hd)
    pool = dict(dtype=geo.dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    host = pool
    if host_pinned and device.type == "cuda":
        host = dict(dtype=geo.dtype, device="cpu", pin_memory=True)
    return PagedKVCache(
        k_hbm=torch.zeros(shape_h, **pool),
        v_hbm=torch.zeros(shape_h, **pool),
        k_host=torch.zeros(shape_e, **host),
        v_host=torch.zeros(shape_e, **host),
        page_table=torch.full((L, B, geo.max_pages), NO_SLOT, **i32),
        hbm_owner=torch.full((L, B, geo.hbm_pages), NO_SLOT, **i32),
        host_owner=torch.full((L, B, geo.host_pages), NO_SLOT, **i32),
        length=torch.zeros((B,), **i32),
        importance=torch.zeros((L, B, geo.max_pages), dtype=torch.float32,
                               device=device),
    )


def abstract_cache(geo: CacheGeometry) -> PagedKVCache:
    """`init_cache`'s shapes and dtypes as tensors on the meta device:
    nothing is allocated (the dry run's decode state)."""
    return init_cache(geo, torch.device("meta"))


def page_of_token(token_idx, page_tokens: int):
    """(logical page, offset within it) of a token position."""
    return token_idx // page_tokens, token_idx % page_tokens


def prefill_cache(geo: CacheGeometry, k: torch.Tensor, v: torch.Tensor,
                  length, shard: Optional[PoolShard] = None
                  ) -> PagedKVCache:
    """Populate a cache from prefill K/V (static placement: HBM first).

    k, v: [L, B, S, KH, HD] with RoPE already applied to k.
    length: int or [B] — prompt tokens actually valid (<= S). Logical
    page p maps to HBM slot p while p < hbm_pages, then host slot
    p - hbm_pages — the paper's Static Placement. With a rank's `shard`
    (the `pages` rule) its pools keep the pages that fall in its slots.
    """
    L, B, S = k.shape[0], k.shape[1], k.shape[2]
    T = geo.page_tokens
    n_pages = -(-S // T)
    if n_pages > geo.max_pages:
        raise ValueError(f"{n_pages} prompt pages exceed the cache's "
                         f"{geo.max_pages}")
    dev = k.device
    pad = n_pages * T - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kp = k.reshape(L, B, n_pages, T, geo.kv_heads, geo.head_dim)
    vp = v.reshape(L, B, n_pages, T, geo.kv_heads, geo.head_dim)

    cache = init_cache(geo, device=dev, shard=shard)
    n_h = min(n_pages, geo.hbm_pages)
    n_e = n_pages - n_h
    shard = shard or PoolShard((0, geo.hbm_pages), (0, geo.host_pages))
    for pools, first, n, (lo, hi) in (
            ((cache.k_hbm, cache.v_hbm), 0, n_h, shard.hbm),
            ((cache.k_host, cache.v_host), n_h, n_e, shard.host)):
        end = min(n, hi)
        if end > lo:
            for pool, src in zip(pools, (kp, vp)):
                pool[:, :, :end - lo] = src[:, :, first + lo:first + end] \
                    .to(geo.dtype)

    def ar(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    pages = ar(geo.max_pages)
    table = torch.where(pages < n_pages, pages, NO_SLOT).to(torch.int32)
    hslots = ar(geo.hbm_pages)
    hbm_owner = torch.where(hslots < n_h, hslots, NO_SLOT).to(torch.int32)
    eslots = ar(geo.host_pages)
    host_owner = torch.where(eslots < n_e, eslots + n_h,
                             NO_SLOT).to(torch.int32)
    cache.page_table = table.expand(L, B, -1).clone()
    cache.hbm_owner = hbm_owner.expand(L, B, -1).clone()
    cache.host_owner = host_owner.expand(L, B, -1).clone()
    cache.length = torch.as_tensor(length, dtype=torch.int32,
                                   device=dev).expand(B).clone()
    return cache


# ---------------------------------------------------------------------------
# cache mutation primitives (operate on ONE layer slice; pools in place)
# ---------------------------------------------------------------------------

def write_token_layer(k_hbm_l, v_hbm_l, k_host_l, v_host_l, slot, offset,
                      k_new, v_new, active=None):
    """Write one token's (k, v) per lane into physical page `slot` at
    `offset`, in place.

    Shapes: pools [B, P, T, KH, HD]; slot/offset [B] int32;
    k_new/v_new [B, KH, HD]. slot >= hbm_pages addresses the host pool.
    `active` (bool [B], optional) leaves the other lanes' pools
    untouched. Lane b's row goes to (b, slot, offset) of the pool its
    slot names, or nowhere: no host sync, no collisions, and one row
    copy for K and V in both tiers.
    """
    at = (None, slot.to(torch.int32).contiguous(),
          offset.to(torch.int32).contiguous())
    ops.copy_rows(
        (Split(k_hbm_l, k_host_l, 1), at,
         k_new.to(k_hbm_l.dtype).contiguous(), (None,)),
        (Split(v_hbm_l, v_host_l, 1), at,
         v_new.to(v_hbm_l.dtype).contiguous(), (None,)),
        keep=active)
    return k_hbm_l, v_hbm_l, k_host_l, v_host_l


def read_token_layer(k_hbm_l, v_hbm_l, k_host_l, v_host_l, slot, offset):
    """The (k, v) rows at (lane, `slot`, `offset`) of each lane, [B, KH,
    HD] each: what `write_token_layer` with the same slots would
    overwrite. A lane whose slot names neither pool reads zeros."""
    B = slot.shape[0]
    k = torch.zeros((B,) + k_hbm_l.shape[3:], dtype=k_hbm_l.dtype,
                    device=slot.device)
    v = torch.zeros_like(k)
    at = (None, slot.to(torch.int32).contiguous(),
          offset.to(torch.int32).contiguous())
    ops.copy_rows((k, (None,), Split(k_hbm_l, k_host_l, 1), at),
                  (v, (None,), Split(v_hbm_l, v_host_l, 1), at))
    return k, v


def write_tokens_layer(k_hbm_l, v_hbm_l, k_host_l, v_host_l, slot, offset,
                       k_new, v_new, valid, lanes=None):
    """Write a slice of tokens' (k, v) into physical pages (one layer),
    in place — the chunked-prefill form of `write_token_layer`.

    pools [B, P, T, KH, HD]; slot/offset/valid [R, C]; k_new/v_new
    [R, C, KH, HD]; `lanes` [R] names the pool lane of each row
    (default: row r is lane r). Rows with valid == False are dropped.
    One row per token: (lane, slot, offset) of the pool its slot names,
    or nowhere.
    """
    R, C = slot.shape
    if lanes is None:
        lanes = torch.arange(R, device=slot.device)
    at = (lanes.to(torch.int32).repeat_interleave(C),
          slot.to(torch.int32).reshape(-1).contiguous(),
          offset.to(torch.int32).reshape(-1).contiguous())

    def rows(val, pool):
        return val.to(pool.dtype).reshape(-1, *val.shape[2:]).contiguous()
    ops.copy_rows(
        (Split(k_hbm_l, k_host_l, 1), at, rows(k_new, k_hbm_l), (None,)),
        (Split(v_hbm_l, v_host_l, 1), at, rows(v_new, v_hbm_l), (None,)),
        keep=valid.reshape(-1).contiguous())
    return k_hbm_l, v_hbm_l, k_host_l, v_host_l


def allocate_prompt_pages(cache: PagedKVCache, pos: torch.Tensor,
                          valid: torch.Tensor, n_new: torch.Tensor
                          ) -> PagedKVCache:
    """Register the logical pages receiving a prompt slice and bump
    lane lengths (chunked prefill at an offset).

    pos/valid: [B, C] absolute token positions and their validity;
    n_new: [B] tokens consumed per lane. Placement is Static: logical
    page p -> HBM slot p while p < hbm_pages, else host slot
    p - hbm_pages, exactly what `prefill_cache` produces. Half-filled
    pages are registered at once.
    """
    T = cache.k_hbm.shape[3]
    hbm_pages = cache.hbm_owner.shape[2]
    host_pages = cache.host_owner.shape[2]
    max_pages = cache.page_table.shape[2]
    page = (pos // T).to(torch.int32)
    lane = torch.arange(pos.shape[0], device=pos.device)[:, None] \
        .expand_as(pos)

    def put(table, sel, col):
        # fixed shapes: the rows `sel` drops write a spare column
        P = table.shape[2]
        out = torch.cat([table, table.new_zeros(table.shape[:2] + (1,))],
                        dim=2)
        out[:, lane, torch.where(sel, col, P).long()] = page
        return out[..., :P].contiguous()

    in_table = valid & (page >= 0) & (page < max_pages)
    in_hbm = in_table & (page < hbm_pages)
    in_host = in_table & (page >= hbm_pages) & \
        (page - hbm_pages < host_pages)
    return dataclasses.replace(
        cache,
        page_table=put(cache.page_table, in_table, page),
        hbm_owner=put(cache.hbm_owner, in_hbm, page),
        host_owner=put(cache.host_owner, in_host, page - hbm_pages),
        length=cache.length + n_new.to(cache.length.dtype))


def append_token(cache: PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, write_slot: torch.Tensor,
                 write_offset: torch.Tensor) -> PagedKVCache:
    """Append one token's KV across all layers: the pools written in
    place, `length` replaced by length + 1.

    k_new/v_new: [L, B, KH, HD]; write_slot: [L, B] physical page slot
    chosen by the control plane; write_offset: [B] offset within page.
    Row (l, b) lands at (l, b, slot, offset) of the pool its slot names,
    or nowhere when the slot is past both pools (the reference's
    dropped scatter): on the card one row-copy launch for K and V of
    every layer and both tiers, with no host sync.
    """
    L, B = write_slot.shape
    dev = write_slot.device

    def flat(i):
        return i.to(torch.int32).reshape(-1).contiguous()
    at = (flat(torch.arange(L, device=dev)[:, None].expand(L, B)),
          flat(torch.arange(B, device=dev)[None, :].expand(L, B)),
          flat(write_slot),
          flat(write_offset[None, :].expand(L, B)))

    def rows(val, pool):
        return val.to(pool.dtype).reshape(L * B, *val.shape[2:]).contiguous()
    ops.copy_rows(
        (Split(cache.k_hbm, cache.k_host, 2), at, rows(k_new, cache.k_hbm),
         (None,)),
        (Split(cache.v_hbm, cache.v_host, 2), at, rows(v_new, cache.v_hbm),
         (None,)))
    return dataclasses.replace(cache, length=cache.length + 1)
