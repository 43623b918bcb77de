"""Logical-axis -> mesh-axis sharding rules (divisibility-aware; the
port of the reference's `launch/shardings.py`, rule for rule).

One rules engine covers every architecture. Per parameter, each mesh
axis claims at most one tensor dim, chosen by a priority list over the
logical axis names, skipping dims whose size is not divisible by the
mesh axis (the non-divisible cases, e.g. llama4's 40 heads or
granite-moe's 40 experts on a 16-way model axis, fall through to the
next-priority dim).

Modes:
  train — TP over `model` + FSDP over `data` (embed dim), batch over
          (`pod`, `data`);
  serve — TP over `model`, params replicated over `data`/`pod`, batch
          over `data` (and `pod` when multi-pod).

A rule returns a partition spec: a tuple with one entry per tensor dim,
None (whole), an axis name, or a tuple of axis names (the dim split
over their product; `()` is whole). The reference returns JAX's
`PartitionSpec`s wrapped in `NamedSharding`s; the port has neither, and
its meshed serve is explicit SPMD, so a spec says which block of a
tensor a rank holds (`local_shape`, `shard`). The rules read only a
mesh's axis names and sizes (`launch.mesh.axis_names`,
`mesh_axis_sizes`), so they work on an `AbstractMesh`, a
`DeviceMesh` or a jax mesh alike.

The serve loop's surface: `cache_shardings` (the two-tier paged pools),
`policy_state_shardings` (per-lane policy state) and `serve_shardings`
(the bundle of per-lane / per-step specs of the serve chunk).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import axis_names, mesh_axis_sizes
from repro_torch.tree import tree_map

#: one entry per dim: None, an axis name, or a tuple of axis names
Spec = Tuple[Any, ...]

# priority of logical names for the model (TP/EP) axis
_MODEL_PRIORITY = ("experts", "heads", "kv_heads", "mlp", "vocab",
                   "head_dim", "embed")
# priority for the data (FSDP) axis — train mode only
_FSDP_PRIORITY = ("embed", "vocab", "mlp")


def _pick_dim(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
              priority, mesh_size: int, taken: set) -> Optional[int]:
    for name in priority:
        for dim, ax in enumerate(axes):
            if ax == name and dim not in taken and \
                    shape[dim] % mesh_size == 0 and shape[dim] >= mesh_size:
                return dim
    return None


def param_pspec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                mesh, mode: str = "train") -> Spec:
    """The spec of one parameter from its logical axis names.

    The `model` axis claims the highest-priority divisible dim
    (`_MODEL_PRIORITY`); in train mode `data` then claims an FSDP dim
    from the remainder. Serve mode replicates over `data`/`pod`."""
    sizes = mesh_axis_sizes(mesh)
    spec = [None] * len(shape)
    taken: set = set()
    if sizes.get("model", 1) > 1:
        d = _pick_dim(axes, shape, _MODEL_PRIORITY, sizes["model"], taken)
        if d is not None:
            spec[d] = "model"
            taken.add(d)
    if mode == "train" and sizes.get("data", 1) > 1:
        d = _pick_dim(axes, shape, _FSDP_PRIORITY, sizes["data"], taken)
        if d is not None:
            spec[d] = "data"
            taken.add(d)
    return tuple(spec)


def param_shardings(schema_axes: Dict[str, Any], abstract: Dict[str, Any],
                    mesh, mode: str = "train") -> Dict[str, Any]:
    """The trees of (logical axes, tensors or anything with `.shape`) ->
    the tree of specs."""
    return {k: param_shardings(a, abstract[k], mesh, mode)
            if isinstance(a, dict)
            else param_pspec(a, tuple(abstract[k].shape), mesh, mode)
            for k, a in schema_axes.items()}


# ---------------------------------------------------------------------------
# Activation / batch / state shardings
# ---------------------------------------------------------------------------

def batch_axes(mesh, batch: Optional[int] = None) -> Tuple[str, ...]:
    """Batch mesh axes: the WIDEST suffix of (`pod`, `data`) whose size
    product divides `batch`.

    Degrades axis by axis rather than all-or-nothing: a batch that
    divides the `data` axis but not `pod` x `data` still shards over
    `data` alone; only a batch no axis divides drops to full
    replication (`()`). `batch=None` trusts the caller and returns
    every batch axis."""
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    if batch is None:
        return axes
    sizes = mesh_axis_sizes(mesh)
    for start in range(len(axes) + 1):
        cand = axes[start:]
        total = math.prod(sizes[a] for a in cand)
        if batch % total == 0 and batch >= total:
            return cand
    return ()


def tokens_sharding(mesh, batch: Optional[int] = None) -> Spec:
    """[B, S] token ids: batch-sharded rows, whole positions."""
    return (batch_axes(mesh, batch), None)


def logits_sharding(mesh, vocab: int, batch: Optional[int] = None) -> Spec:
    """[B, V] logits: batch rows + vocab over `model` when divisible."""
    v = "model" if vocab % mesh_axis_sizes(mesh).get("model", 1) == 0 \
        else None
    return (batch_axes(mesh, batch), v)


def _kv_shard_axis(geo, mesh) -> str:
    """Which pool dim carries the model axis: kv_heads when divisible
    (classic TP); otherwise pages (the LSE merge over pages is
    associative, so page-sharding is exact sequence-parallel attention);
    "none" when neither divides (the pools whole on every rank). The
    port's meshed serve runs all three (`pool_slots` gives a rank its
    slots)."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    if geo.kv_heads % m == 0:
        return "kv_heads"
    if geo.hbm_pages % m == 0 and geo.host_pages % m == 0:
        return "pages"
    return "none"


def pool_slots(geo, mesh, rank: int):
    """The global slots [lo, hi) of each tier whose pages the rank at
    index `rank` of the `model` axis holds: ((HBM lo, hi), (host lo,
    hi)), a contiguous 1/model of each under the `pages` rule (the block
    `shard` cuts on the pools' pages dim), the whole of each under the
    other rules."""
    whole = ((0, geo.hbm_pages), (0, geo.host_pages))
    if _kv_shard_axis(geo, mesh) != "pages":
        return whole
    m = mesh_axis_sizes(mesh)["model"]
    return tuple((rank * n // m, (rank + 1) * n // m) for _, n in whole)


def cache_shardings(geo, mesh):
    """Specs of a `PagedKVCache`'s fields.

    Pools [L, B, P, T, KH, HD]: batch over data(/pod); model axis on
    kv_heads or pages per `_kv_shard_axis`. Owner tables follow the
    pools' pages dim so tier_lists stays local (the reference's rule;
    the port's meshed serve holds the pools so, and keeps the owner
    maps whole on every model rank: `kvcache.paged`)."""
    from repro_torch.kvcache.paged import PagedKVCache
    b_ax = batch_axes(mesh, getattr(geo, "batch", None))
    ax = _kv_shard_axis(geo, mesh)
    kh = "model" if ax == "kv_heads" else None
    pg = "model" if ax == "pages" else None
    pool = (None, b_ax, pg, None, kh, None)
    owner = (None, b_ax, pg)
    table = (None, b_ax, None)
    return PagedKVCache(
        k_hbm=pool, v_hbm=pool, k_host=pool, v_host=pool,
        page_table=table, hbm_owner=owner, host_owner=owner,
        length=(b_ax,), importance=table)


def policy_state_shardings(state: Any, geo, mesh) -> Any:
    """Specs of a `DevicePolicy.init_state` tree.

    Policy state rides beside the cache, so its lanes co-shard with the
    cache's: leaves shaped like the page table ([L, B, ...], recency's
    last-access stamps) take the batch axes on dim 1, per-lane [B]
    vectors on dim 0, and everything else (cost_aware's 0-dim payback
    bars, recency's step count) is whole on every rank."""
    b_ax = batch_axes(mesh, geo.batch)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 2 and shape[0] == geo.num_layers \
                and shape[1] == geo.batch:
            return (None, b_ax) + (None,) * (len(shape) - 2)
        if len(shape) == 1 and shape[0] == geo.batch:
            return (b_ax,)
        return ()
    return tree_map(one, state)


def serve_shardings(geo, mesh) -> Dict[str, Any]:
    """The spec bundle of the serve chunk.

      cache      PagedKVCache of specs (`cache_shardings`)
      lane       per-lane [B] carries (token/active/remaining/...)
      lane_kv    per-lane 2-D rows ([B, 2] sampling keys, [B, S] prompts)
      step_lane  per-(step, lane) [stride, B] fault masks + emissions
      rep        whole on every rank (prefill credits, commit caps — the
                 fault plane is global, not per-shard)
      plan       the staged MigrationPlan (overlap mode): the
                 reference's is replicated; the port's rows name the
                 rank's own lanes (its plan covers them alone)

    Lane axes come from `batch_axes(mesh, geo.batch)`, so a lane count
    the data axis does not divide degrades to replication."""
    from repro_torch.kvcache.migrate import MigrationPlan
    b_ax = batch_axes(mesh, geo.batch)
    return {
        "cache": cache_shardings(geo, mesh),
        "lane": (b_ax,),
        "lane_kv": (b_ax, None),
        "step_lane": (None, b_ax),
        "rep": (),
        "plan": MigrationPlan(*([()] * 10)),
    }


def ssm_state_shardings(state: Any, mesh) -> Any:
    """Recurrent states: batch over data; the first trailing dim the
    model axis divides over model."""
    m = mesh_axis_sizes(mesh).get("model", 1)

    def one(leaf):
        # state leaves are [L, B, ...]
        b_ax = batch_axes(mesh, leaf.shape[1] if leaf.ndim > 1 else None)
        spec = [None, b_ax] + [None] * (leaf.ndim - 2)
        for dim in range(2, leaf.ndim):
            if leaf.shape[dim] % m == 0 and leaf.shape[dim] >= m:
                spec[dim] = "model"
                break
        return tuple(spec)
    return tree_map(one, state)


def replicated(mesh) -> Spec:
    """Whole on every rank."""
    del mesh
    return ()


def state_shardings_for(model, state_abs: Any, mesh) -> Any:
    """Specs matching `Model.init_decode_state` / prefill output."""
    from repro_torch.kvcache.paged import PagedKVCache
    if isinstance(state_abs, PagedKVCache):
        return cache_shardings(_geo_of(model, state_abs), mesh)
    if isinstance(state_abs, dict):
        out = {}
        for k, v in state_abs.items():
            if k == "kv":
                out[k] = cache_shardings(_geo_of(model, v), mesh)
            elif k == "enc":
                out[k] = (batch_axes(mesh, v.shape[0]), None, None)
            else:
                out[k] = ssm_state_shardings(v, mesh)
        return out
    return ssm_state_shardings(state_abs, mesh)


def _geo_of(model, cache_abs):
    """A geometry-like view of an abstract cache."""
    from types import SimpleNamespace
    del model
    L, B, Ph, T, KH, HD = cache_abs.k_hbm.shape
    return SimpleNamespace(kv_heads=KH, head_dim=HD, hbm_pages=Ph,
                           host_pages=cache_abs.k_host.shape[2], batch=B)


# ---------------------------------------------------------------------------
# One rank's block of a tensor
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes that split a tensor under `spec`, in dim order
    (`()`: whole on every rank). A meshed train step reads it to count
    each leaf's share of the global gradient norm once: a sum of squares
    over a block is summed over exactly these axes."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def data_dim(spec: Spec) -> Optional[int]:
    """The dim `spec` splits over `data` (None: whole on `data`): the dim
    on which a meshed train step gathers an FSDP leaf's blocks before
    using it, and reduce-scatters its gradient."""
    for d, entry in enumerate(spec):
        if "data" in _entry_axes(entry):
            return d
    return None


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a `shape` tensor under `spec`
    (a dim split over axes of total size n holds shape / n)."""
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def shard(tensor: torch.Tensor, spec: Spec, mesh,
          coord: Dict[str, int]) -> torch.Tensor:
    """The block of `tensor` that the rank at `coord` ({axis: index})
    holds under `spec`: along a dim split over axes (a1, a2, ...) the
    block index is coord[a1] * size[a2] * ... + coord[a2] * ... (the
    first axis major). Contiguous; `tensor` itself where nothing is
    split."""
    sizes = mesh_axis_sizes(mesh)
    out = tensor
    for d, entry in enumerate(spec):
        idx = 0
        n = 1
        for a in _entry_axes(entry):
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        if n > 1:
            step = tensor.shape[d] // n
            out = out.narrow(d, idx * step, step)
    return out.contiguous()
