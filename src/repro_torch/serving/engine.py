"""Serving engine over the two-tier paged KV cache (the port of the
reference's `serving/engine.py`, inline and overlap modes).

One decode step is: the control plane (write-slot choice, optional
Quest mask), `Model.decode_step` over the paged cache — whose attention
runs the hand-written paged-attention kernel once per tier per layer on
the card — then `control.lane_merge`, the placement policy's plan, and
`apply_migrations`. Each step emits a [4] int32 telemetry row
(resident HBM / host pages, promotes, demotes) that the host prices
with the paper's Eq. (1)-(5) under a `MemorySystemSpec`.

Drive modes:

  start/step/run/generate
                        single-stream: whole-prompt prefill (its
                        attention runs the hand-written flash-attention
                        kernel on the card; `extra` carries the vlm
                        family's patch and the encdec family's frame
                        embeddings), then one decode step per
                        call, a teacher-forced loop, or a greedy loop
                        (a hybrid model's steps carry its Mamba2 state
                        beside the cache of its attention sites; an
                        xlstm model, which has no cache to place, runs
                        `start` only and steps with
                        `Model.decode_step`, and `step`/`run`/
                        `generate` raise ValueError for it);
                        telemetry is read back once per
                        `telemetry_stride` steps. With
                        `EngineConfig.trace_telemetry` each step also
                        keeps lane 0's page read set and read-time
                        placement for `serving.trace_bridge`.
  serve(requests)       continuous batching over mixed prefill+decode
                        steps: decoding lanes emit one sampled token
                        while prefilling lanes consume a
                        `prefill_chunk`-token slice of their prompt,
                        written straight into their lane's pages. The
                        first output token is sampled at the step
                        prefill crosses prompt_len. Admission,
                        completion, deadlines and page reclaim happen at
                        boundaries every `telemetry_stride` steps.
                        The dense and moe families only, as in the
                        reference (vlm and encdec need prefill extras).

Overlap mode (`EngineConfig.overlap_migrations`, serve only, as in
the reference): the host pools live in pinned host memory on the card,
read in place by the paged kernel over the link, and each decode step
commits the plan staged one step earlier — revalidated against the
post-decode owner maps — then plans the next on the post-commit cache
with this step's read set as a one-step-ahead oracle. On the card the
commit's page copies run on a side stream, concurrent with the rest of
the step; the next step waits for them before it touches the pools.
`measured_payback` times the commit of a full swap plan on pinned host
pools at serve start and recalibrates `cost_aware` from the measured
link bandwidth.

Fused chunks (the reference's `lax.scan` executables): `run`,
`generate` and each boundary-to-boundary chunk of `serve` are one chunk
function of `telemetry_stride` steps that reads its inputs from tensors
at fixed addresses (the arena: cache pools and tables, policy state,
per-lane carries, the fault plane's per-step caps and poison rows),
makes no decision on a device value, writes its final state back into
the arena in place and returns its per-step rows, read back once per
chunk. On the card `serving.graphs.ChunkGraphs` captures it as one CUDA
graph per key and replays it (`ServingEngine.captures` counts the
captures, the reference's executable cache). A serve key is
(drive mode, policy, overlap, trace capture, sampling, EOS, prefill
budget, prefill plane); the prefill plane is (pages, steps): the pages
it reads — those that hold the positions of the prefilling lanes' real
tokens, or of every row of every lane for the moe family, whose routing
groups them all — rounded up to a power of two and capped at the lane's
`max_pages` (`prefill_buckets`), and the chunk's leading steps it runs
on — those the slowest prefilling lane needs, rounded up to a multiple
of a quarter of the stride (`step_buckets`), all of them under a
prefill budget — or (0, 0) when no lane prefills at the chunk's start,
which leaves the plane out of the chunk (`prefill_plane`). So a serve
holds at most `serve_graph_bound(geo, stride)` = 1 +
`len(step_buckets(stride))` (at most 4) x
`len(prefill_buckets(geo.max_pages))` graphs per (policy, overlap), 41
at phase 4's geometry, and a `run`/`generate` one per chunk length.
The reference's two `lax.cond` skips are masked planes here: both run
every step, and a 0-dim device flag makes a plane with no lane in it
an exact no-op — a decode plane with no decoding lane commits nothing
(its migration cap is 0), keeps the policy state and the staged plan,
and writes no pool row; a prefill lane of n_valid 0 writes nothing.
Both are also left out where the host knows them empty: the prefill
plane after its steps.
`step()` stays eager, as the reference's. `run`/`generate` capture
for every family they drive (those with a paged cache), `serve` for
both families it drives (dense and moe).

`serve(faults=FaultPlane(...))` folds a seeded fault schedule into the
stream at chunk boundaries (`serving.faults`): tier faults reprice the
telemetry and recalibrate cost_aware (in place, so a graph reads the
new thresholds), migration faults cap each step's committed rows (a
[stride] int32 row of the arena), pool faults resize the scheduler's
pool, poison faults (a [stride, B] bool row, all False without a
fault) NaN a lane's logits, which the non-finite guard quarantines; repeated
commit drops or a tier ratio past `fallback_tier_ratio` fall back to
static placement (every commit capped at 0). `serve(slo=SLOPolicy(...))`
sheds queued requests whose projected TTFT already misses their tier's
target (`serving.slo`). With `EngineConfig.trace_telemetry`, `serve`
keeps every lane's decode read set and read-time placement per step,
with the chunk's lane->request bindings, in `_serve_trace_log` for
`trace_bridge.collect_serve`; the per-step arrays stay on the device
until the chunk's one readback.

Serving across a device mesh (`ServingEngine(..., mesh=)`, the dense
and moe families' `serve()` and single-stream path, as in the
reference): a (`data`, `model`)
`DeviceMesh` of `torch.distributed` ranks (`launch.mesh`), one card
each (the CPU under gloo). The rank program is explicit SPMD: every
rank runs this host loop identically over all B lanes, and its device
work over its own block of them, with named collectives at fixed
points. The rules are the reference's (`launch.shardings`):

  * lanes over `data` when the axis divides them
    (`serve_shardings`' "lane"; else every rank holds every lane and
    the data-axis collectives are left out): the arena, the cache
    ([L, B/data, P, T, KH/model, HD] pools under the `kv_heads` rule,
    the other rules below; in overlap mode each rank's
    host tier is pinned host memory, where the reference's GSPMD puts
    device memory — the values are the same) and the policy state hold
    the rank's lanes, and its plans name them;
  * heads, KV heads (the `kv_heads` rule), MLP and vocabulary over
    `model`: the rank-local
    model (`ModelConfig.rank_local`, and a `transformer.TensorParallel`
    bound to the mesh's collectives) and the weight shards
    (`bridge.shard_params`, or `bridge.init_shards` to draw them
    without the whole model): the engine keeps no whole copy, so a rank
    holds about 1/model of the weights plus the leaves held whole;
    with the row-parallel sums, the embedding's and the importance's
    all-reduce and the logits' all-gather in `models.transformer`;
  * a moe model's padded experts over `model` (expert parallelism:
    `models.moe`), its router whole on every rank; with its lanes split
    over `data`, each moe layer all-gathers the router logits of every
    data rank's lanes, so a decode step routes all B lanes as one group
    and a prefill chunk all B x C slots, as the unsplit stream does;
  * inside a chunk, over `data`: the decode plane's "any lane decoding"
    flag, the prefill budget's token demand and, for the fault plane's
    commit cap, each (layer, lane) block's live rows (so the cap counts
    rows in the unsplit plan's order, `throttle_plan(ahead=)`);
  * at the chunk's one readback, over `data`: the per-step rows, the
    trace and the lane carries all-gathered, the telemetry's page
    counts summed (every model rank counts the whole tables' pages,
    which the whole geometry prices once);
  * the single-stream path (`start`, `step`, `run`, `generate`) binds
    the rank's lanes and pools as `serve` does: `start` prefills the
    rank's lanes of the prompts with the rank-local model, and every
    entry point takes the rank's lanes of its input tokens and returns
    whole outputs on every rank (logits over the whole vocabulary,
    gathered over `model` inside the model and over `data` here; a
    greedy step's argmax over the whole vocabulary), with the stats
    made global as a serve chunk's (inside the captured chunk);
  * host decisions read from a clock or a per-rank measurement (open-
    loop arrivals, deadlines and cancellation, SLO sheds, the measured
    payback) are the mesh's first rank's, broadcast (`_agree`), so the
    ranks never diverge and a collective never waits on a rank that
    went elsewhere.

A `model` axis that does not divide the KV heads takes the
reference's other KV pool rules (`launch.shardings._kv_shard_axis`):
every rank holds every KV head (`wk`/`wv` whole) and the query heads'
block where the axis divides them (`TensorParallel.heads`; q is
gathered over `model` before the attention, whose output the rank cuts
back to its heads). Under `pages` (the axis divides both tiers' slots)
its pools hold a contiguous 1/model of each tier's slots
(`launch.shardings.pool_slots`, `kvcache.paged.PoolShard`): the token
is written by the rank that holds its slot, each rank's paged kernel
reads its slots, the ranks' partials merge exactly, and a migration row
between two ranks' slots crosses an exchange over `model`
(`kvcache.migrate`). Under `none` the pools are whole on every rank.
The tables, owner maps, plans and policy state are whole on every model
rank in every rule, so every decision is computed alike on each and
equals the unmeshed one (the reference shards the owner maps with the
pools).

The captured chunks hold their collectives, for both families, meshed
serve and single stream alike.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.bridge import shard_params
from repro_torch.core.latency_model import StepTraffic, step_latency
from repro_torch.core.tiers import H100, MemorySystemSpec
from repro_torch.kernels import ops
from repro_torch.kvcache.migrate import (
    MigrationPlan, apply_migrations, commit_async,
)
from repro_torch.kvcache.paged import (
    NO_SLOT, PagedKVCache, PoolShard, init_cache,
)
from repro_torch.launch.mesh import (
    AXES, all_gather, all_reduce_sum, axis_names, mesh_axis_sizes,
    mesh_coordinate,
)
from repro_torch.launch.shardings import batch_axes
from repro_torch.models.model import Model
from repro_torch.models.transformer import TensorParallel
from repro_torch.serving import control
from repro_torch.serving.faults import FaultPlane, throttle_plan
from repro_torch.serving.graphs import ChunkGraphs
from repro_torch.serving.policies import make_policy, policy_names
from repro_torch.serving.sampling import (
    SamplingConfig, lane_key, make_sampler,
)
from repro_torch.serving.scheduler import (
    ContinuousBatcher, Request, RequestError,
)
from repro_torch.serving.slo import SLOPolicy
from repro_torch.tree import tree_leaves, tree_map


def prefill_buckets(max_pages: int) -> tuple:
    """The page counts a serve chunk's prefill plane may read: powers of
    two below `max_pages`, then `max_pages`."""
    out, b = [], 1
    while b < max_pages:
        out.append(b)
        b *= 2
    return tuple(out) + (max_pages,)


def step_buckets(stride: int) -> tuple:
    """The step counts a serve chunk's prefill plane may run: multiples
    of a quarter of `stride` (rounded up) below it, then `stride`."""
    q = -(-stride // 4)
    return tuple(range(q, stride, q)) + (stride,)


def prefill_plane(view, stride: int, chunk: int, page_tokens: int,
                  max_pages: int, budgeted: bool, all_lanes: bool = False):
    """(pages, steps) of the prefill plane of a serve chunk that starts
    at `view`: (0, 0) when no lane is prefilling (none can start inside
    the chunk); else the plane runs on the chunk's first `steps` steps —
    the steps the slowest prefilling lane needs at `chunk` tokens a step,
    rounded up to a step bucket, or all `stride` under a prefill budget,
    which may delay any of them — over the smallest page bucket that
    holds every row the plane's values depend on. After the steps a lane
    needs it has no prompt left, so the plane is a no-op for it.

    Those rows are the prefilling lanes' real tokens (dense), or with
    `all_lanes` (moe, whose routing groups all B x `chunk` rows) every
    row of every lane: a prefilling lane's slice starts at most at
    min(prefilled + (steps - 1) x chunk, prompt_len), every other lane's
    (decoding, idle, or holding a stale count) at its `prefilled`, which
    is the chunk's carried progress, and each spans `chunk` positions."""
    pf = view.active & (view.prefilled < view.prompt_len)
    if not pf.any():
        return 0, 0
    left = view.prompt_len[pf] - view.prefilled[pf]
    need = stride if budgeted else int((-(-left // chunk)).max())
    steps = next((b for b in step_buckets(stride) if b >= need), stride)
    if all_lanes:
        start = np.where(pf, np.minimum(view.prefilled + (steps - 1) * chunk,
                                        view.prompt_len), view.prefilled)
        end = int(start.max()) + chunk
    else:
        end = int(np.minimum(view.prefilled[pf] + steps * chunk,
                             view.prompt_len[pf]).max())
    pages = min(-(-end // page_tokens), max_pages)
    return next(b for b in prefill_buckets(max_pages) if b >= pages), steps


def serve_graph_bound(geo, stride: int) -> int:
    """The most graphs a serve captures per (policy, overlap, trace
    capture, sampling, EOS, prefill budget): one with no prefill plane,
    and one per (page bucket, step bucket)."""
    return 1 + len(step_buckets(stride)) * len(prefill_buckets(geo.max_pages))


def _keep_unless(flag: torch.Tensor, new, old):
    """`new` where the 0-dim bool `flag` is set, else `old`, leaf by
    leaf (a skipped plane's state, on the device)."""
    return tree_map(lambda n, o: n if n is None else torch.where(flag, n, o),
                    new, old)


def _write_back(arena, tree) -> None:
    """Copy `tree`'s leaves into the arena's, in place, where they are
    other tensors (pools written in place already are the same)."""
    for dst, src in zip(tree_leaves(arena), tree_leaves(tree)):
        if dst is not None and dst is not src:
            dst.copy_(src)


def _same_layout(a, b) -> bool:
    """Whether two trees have the same structure and leaf shapes,
    dtypes and devices."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if (x is None) != (y is None):
            return False
        if x is not None and (x.shape != y.shape or x.dtype != y.dtype
                              or x.device != y.device):
            return False
    return True

def _get_cache(state) -> PagedKVCache:
    """The paged cache of a decode state (encdec: its "kv")."""
    return state if isinstance(state, PagedKVCache) else state["kv"]


def _set_cache(state, cache):
    """`state` with its paged cache replaced."""
    if isinstance(state, PagedKVCache):
        return cache
    return {**state, "kv": cache}


def _require_cache(state, family: str) -> None:
    """Raise ValueError for a decode state with no paged cache (the
    xlstm family's), which the placement loop cannot drive."""
    if isinstance(state, dict) and "kv" not in state:
        raise ValueError(
            f"family {family!r} keeps a recurrent decode state and no paged "
            f"KV cache, so there is nothing to place: step it with "
            f"Model.decode_step")


@dataclasses.dataclass
class MeshView:
    """A rank's part of a meshed serve: the rank-local model (its
    `TensorParallel` bound to the mesh), its mesh coordinate and the
    axis sizes."""

    model: Model
    coord: Dict[str, int]
    sizes: Dict[str, int]

    def model_for(self, split: bool) -> Model:
        """The rank-local model of a stream whose lanes are `split` over
        `data` or not: a moe model's routing then sees every data rank's
        lanes (`TensorParallel.rows`)."""
        return self.model.with_rows(
            (self.coord["data"], self.sizes["data"]) if split else None)


class Lanes(NamedTuple):
    """The lanes of a stream of `total` that this rank runs: `count` of
    them from `first`; `split`: whether they are split over a mesh's
    `data` axis (then the data-axis collectives join the ranks' blocks,
    whatever the axis size)."""

    first: int
    count: int
    total: int
    split: bool


@dataclasses.dataclass
class EngineConfig:
    """Static engine configuration (the reference's fields, so call
    sites read the same). Selects the cache geometry split
    (`max_context`, `hbm_fraction`), the placement policy and its
    knobs, attention sparsity, the boundary stride, chunked-prefill
    budgets and EOS."""

    max_context: int = 512
    hbm_fraction: float = 0.25
    policy: str = "importance"
    #: fraction of pages bypassed at attention (0 = dense attention)
    attention_sparsity: float = 0.0
    #: migration budget per step, as a fraction of HBM pages
    migration_budget_frac: float = 0.1
    promote_thresh: float = 0.02     # attention-mass EMA threshold
    #: the memory system the telemetry is priced on (H100 + PCIe host)
    spec: MemorySystemSpec = H100
    #: steps between host boundaries (admission, completion, telemetry)
    telemetry_stride: int = 32
    #: prompt tokens each PREFILLING lane consumes per mixed serve step
    prefill_chunk: int = 32
    #: per-batch prefill token bucket refilled each step (None = uncapped)
    prefill_budget: Optional[int] = None
    #: stop token for `serve` (None = budget-only completion)
    eos_id: Optional[int] = None
    #: keep per-step page read sets and read-time placements for the
    #: bridge: lane 0 of step/run/generate (`trace_bridge.collect`),
    #: every lane of `serve` with its bindings (`collect_serve`)
    trace_telemetry: bool = False
    #: policy fallback of the fault plane: static placement (all commits
    #: capped at 0) after this many consecutive boundaries whose chunk
    #: had a fully dropped step, or once a tier fault pushes the
    #: HBM:DRAM bandwidth ratio past this multiple of the base spec's
    fallback_commit_faults: int = 3
    fallback_tier_ratio: float = 8.0
    #: the staged plan/commit pipeline of `serve` (see the module doc);
    #: False keeps the serial plan-then-commit step. step/run/generate
    #: always run inline
    overlap_migrations: bool = False
    #: recalibrate cost_aware's payback thresholds from a MEASURED link
    #: bandwidth (a timed commit at serve start); telemetry pricing
    #: stays on `spec`
    measured_payback: bool = False


@dataclasses.dataclass
class StepStats:
    """One decode step's modeled cost under the paper's Eq. (1)-(5):
    the latency and byte volumes the device telemetry priced for that
    step, plus its HBM hit rate (fraction of read bytes from HBM)."""

    modeled_latency_s: float
    h_read: float
    e_read: float
    m_in: float
    m_out: float
    hbm_hit_rate: float


@dataclasses.dataclass
class ServeReport:
    """`serve()`'s return value: terminal requests plus request-level
    latency percentiles (seconds). `completed` holds every request that
    held a lane; `rejected` those refused before admission, each with a
    typed `Request.error`; `statuses` maps every submitted rid to its
    terminal status. `goodput` is stamped by `slo.score_goodput`,
    `request_scores` and `headroom` by `trace_bridge.score_serve`."""

    completed: List[Request]
    ttft: Dict[str, float] = dataclasses.field(default_factory=dict)
    tpot: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: TTFT decomposition percentiles: queue_wait / prefill / throttle
    ttft_parts: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    #: {"eos_id", "eos_stops", "budget_stops"}
    eos: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: goodput-under-SLO row (empty until scored)
    goodput: Dict[str, object] = dataclasses.field(default_factory=dict)
    rejected: List[Request] = dataclasses.field(default_factory=list)
    #: chronological degradation events (fault activations, pool
    #: resizes, payback measurement and recalibrations, SLO sheds,
    #: policy fallback)
    events: List[dict] = dataclasses.field(default_factory=list)
    #: rid -> per-request attribution scores (trace_bridge.score_serve)
    request_scores: Dict[int, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    #: aggregate stream headroom (live vs SA / Belady / static totals)
    headroom: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def statuses(self) -> Dict[int, str]:
        """rid -> terminal status over every request that entered serve."""
        return {r.rid: r.status for r in self.completed + self.rejected}

    @staticmethod
    def build(completed: List[Request],
              rejected: Optional[List[Request]] = None,
              events: Optional[List[dict]] = None,
              eos_id: Optional[int] = None) -> "ServeReport":
        """Assemble a report: TTFT/TPOT mean/p50/p95, the TTFT
        decomposition percentiles, and EOS-stop counts."""
        def pct(vals):
            if not vals:
                return {}
            v = np.asarray(vals, np.float64)
            return {"mean": float(v.mean()),
                    "p50": float(np.percentile(v, 50)),
                    "p95": float(np.percentile(v, 95))}

        ttfts = [r.first_token_at - r.submitted_at for r in completed
                 if r.first_token_at is not None]
        tpots = [(r.finished_at - r.first_token_at) / (len(r.output) - 1)
                 for r in completed
                 if r.first_token_at is not None
                 and r.finished_at is not None and len(r.output) > 1]
        attributed = [r for r in completed
                      if r.first_token_at is not None
                      and r.admitted_at is not None]
        parts = {
            "queue_wait": pct([r.queue_wait_s for r in attributed]),
            "prefill": pct([r.prefill_s for r in attributed]),
            "throttle": pct([r.throttle_s for r in attributed]),
        }
        eos = {
            "eos_id": eos_id,
            "eos_stops": sum(1 for r in completed if r.stop_reason == "eos"),
            "budget_stops": sum(1 for r in completed
                                if r.stop_reason == "budget"),
        }
        return ServeReport(completed=list(completed), ttft=pct(ttfts),
                           tpot=pct(tpots), ttft_parts=parts, eos=eos,
                           rejected=list(rejected or []),
                           events=list(events or []))

    def __iter__(self):
        return iter(self.completed)

    def __len__(self) -> int:
        return len(self.completed)

    def __getitem__(self, i):
        return self.completed[i]


def _to_device(tree, device):
    """Tensors of a nested dict (or an empty tuple) moved to `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    return tree.to(device)


def measured_link_spec(base: MemorySystemSpec, delta: float, moved: int,
                       rows: int):
    """Invert a timed commit into a link bandwidth (the reference's
    formula): the latency model prices a move at 1/link_bw + 1/hbm_bw
    seconds per byte, so `delta` seconds for `moved` bytes give
    link_bw = 1 / (delta / moved - 1 / hbm_bw). Returns (base with that
    link_bw and its name suffixed "+measured", or None when the
    difference is not positive or falls under the HBM floor; the
    `payback_measured` event's payload)."""
    detail = {"rows": int(rows), "bytes": int(moved),
              "delta_s": float(delta),
              "modeled_link_bw": float(base.link_bw),
              "measured_link_bw": None}
    if delta <= 0.0 or moved == 0:
        return None, detail
    inv_link = delta / moved - 1.0 / base.hbm_bw
    if inv_link <= 0.0:
        return None, detail
    link_bw = 1.0 / inv_link
    detail["measured_link_bw"] = float(link_bw)
    return dataclasses.replace(base, name=base.name + "+measured",
                               link_bw=link_bw), detail


def swap_plan(geo, cap: int, device, host_slots=None, *,
              promotes: bool = True, demotes: bool = True) -> MigrationPlan:
    """The payback probe's synthetic plan of `cap` rows: row r promotes
    host slot `host_slots[r]` (default r % host_pages) of layer
    r % L, lane (r // L) % B into HBM slot r % hbm_pages and demotes
    that slot's page to the same host slot (dem_dst = pro_src).
    `promotes` / `demotes` False leaves that half's columns at the
    sentinel -1."""
    r = np.arange(cap, dtype=np.int32)
    host = r % geo.host_pages if host_slots is None else \
        np.asarray(host_slots, dtype=np.int32)
    hbm = r % geo.hbm_pages
    lay, bat = r % geo.num_layers, (r // geo.num_layers) % geo.batch
    none = [np.full(cap, -1, np.int32)] * 5
    cols = [*((lay, bat, host, hbm, r % geo.max_pages) if promotes
              else none),
            *((lay, bat, hbm, host, (r + 1) % geo.max_pages) if demotes
              else none)]
    return MigrationPlan(*[torch.as_tensor(c, device=device) for c in cols])


def commit_seconds(cache: PagedKVCache, plan: MigrationPlan,
                   shard: Optional[PoolShard] = None) -> float:
    """Seconds of one `apply_migrations(cache, plan, shard)`: CUDA
    events on the card, `time.perf_counter` on the CPU."""
    if cache.k_hbm.device.type != "cuda":
        t0 = time.perf_counter()
        apply_migrations(cache, plan, shard)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    apply_migrations(cache, plan, shard)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


class ServingEngine:
    """The serving engine over the two-tier paged KV cache (see the
    module docstring). Runs on the CUDA card unless constructed with
    `device="cpu"`; `params` are moved to that device."""

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 mesh=None, device=None):
        if cfg.policy not in policy_names():
            raise ValueError(
                f"unknown EngineConfig.policy {cfg.policy!r}; registered "
                f"device policies: {', '.join(policy_names())}")
        if cfg.prefill_budget is not None and cfg.prefill_budget < 1:
            raise ValueError(
                f"EngineConfig.prefill_budget must be >= 1 tokens/step "
                f"or None (uncapped), got {cfg.prefill_budget}")
        if mesh is not None and "model" not in axis_names(mesh):
            raise ValueError(
                f"ServingEngine mesh needs a 'model' axis (and usually "
                f"'data'); got axes {axis_names(mesh)}")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        #: the device mesh `serve` and the single-stream path span (see
        #: the module docstring), or None; `_tp` is this rank's part of
        #: it (the dense and moe families)
        self.mesh = mesh
        self._tp = self._bind_mesh(mesh) if mesh is not None else None
        #: the weights on this device: the whole model's, or under a
        #: mesh this rank's shards alone (`params` may be whole, on the
        #: CPU or on the card, or already the shards, `bridge.
        #: init_shards`; the engine keeps no whole copy)
        if self._tp is None:
            self.params = _to_device(params, self.device)
        else:
            self.params = _to_device(shard_params(
                params, model.cfg, mesh, self._tp.coord), self.device)
        #: the (model, params) the decode and prefill steps run: the
        #: whole ones, or a meshed stream's rank-local ones
        self._run = (self._tp.model if self._tp else model, self.params)
        #: the lanes this rank runs (all of them unmeshed; `_setup`)
        self._lanes = Lanes(0, 0, 0, False)
        #: the rank's block of each tier's slots under the `pages` rule
        #: (None: its pools hold every slot)
        self._shard = self._tp.model.tp.pool if self._tp else None
        self.stats: List[StepStats] = []
        self._sampling = SamplingConfig()
        #: raw (base, access, tier) chunks when cfg.trace_telemetry
        #: (read by `trace_bridge.collect`)
        self._trace_log: List[tuple] = []
        #: per-chunk (access, tier, emitted, first, rids, prompt_len) of
        #: a serve stream when cfg.trace_telemetry (`collect_serve`)
        self._serve_trace_log: List[tuple] = []
        #: overlap mode on the card: the stream the commits' page copies
        #: run on, and the event of the last commit's copies
        self._copy_stream = None
        self._commit_done = None
        #: the fused chunks' graphs (see the module docstring) and the
        #: arenas they read: serve's, and run/generate's
        self._graphs = ChunkGraphs(self.device)
        self._serve_arena = None
        self._serve_arena_key = None
        self._stream_arena = None
        #: steps the fused chunks ran, eagerly or replayed
        self.steps_run = 0
        #: per serve chunk of the last `serve`: {"prefill_pages",
        #: "prefill_steps": its prefill plane, "replayed": whether a
        #: graph ran it, "captured": whether it captured that graph
        #: first, "issue_s": host seconds to run (or capture) and
        #: enqueue it, "span_s": the same up to its rows read back,
        #: "device_s": CUDA-event seconds on the current stream (None
        #: off the card)}
        self.chunk_log: List[dict] = []

    def _bind_mesh(self, mesh) -> Optional[MeshView]:
        """This rank's part of `mesh` for the dense and moe families'
        serve (other families: None, and they run unmeshed, as in the
        reference): its `TensorParallel`, with its block of the pools'
        slots under the `pages` rule (the tiers' sizes depend on
        `max_context` and `hbm_fraction` alone, not on the lanes). Warms
        both axes' communicators outside any capture."""
        cfg = self.model.cfg
        if cfg.family not in ("dense", "moe"):
            return None
        sizes = mesh_axis_sizes(mesh)
        coord = mesh_coordinate(mesh)
        geo = self.model.cache_geometry(1, self.cfg.max_context,
                                        hbm_fraction=self.cfg.hbm_fraction)
        tp = TensorParallel.serving(
            cfg, mesh, coord,
            reduce=lambda t: all_reduce_sum(t, mesh, "model"),
            gather=lambda t, dim: all_gather(t, mesh, "model", dim),
            gather_rows=lambda t, dim: all_gather(t, mesh, "data", dim),
            geo=geo)
        for axis in AXES:
            all_reduce_sum(torch.zeros(1, device=self.device), mesh, axis)
        return MeshView(model=Model(cfg.rank_local(sizes["model"]), tp=tp),
                        coord=coord, sizes=sizes)

    def _agree(self, value):
        """`value` as the mesh's first rank (coordinate (0, 0)) holds it,
        on every rank of a meshed serve (host decisions read from a
        clock or a per-rank measurement): broadcast over `data` from its
        first rank, then over `model` from its first; `value` itself
        otherwise."""
        if self._tp is None:
            return value
        box = [value]
        device = self.device if self.device.type == "cuda" else None
        for axis in AXES:
            group = self.mesh.get_group(axis)
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(group, 0), group=group,
                device=device)
        return box[0]

    def _lane_slice(self, x, dim: int = 0):
        """This rank's lanes of a host array over all B lanes (on `dim`)."""
        lo, n = self._lanes.first, self._lanes.count
        return x[(slice(None),) * dim + (slice(lo, lo + n),)]

    def _data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A per-rank count over its lanes summed over `data` (lanes
        split), in place on the temporary `t`; else `t`."""
        return all_reduce_sum(t, self.mesh, "data") if self._lanes.split \
            else t

    def _data_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A per-lane tensor over all B lanes: the ranks' blocks
        all-gathered over `data` on `dim` (lanes split); else `t`."""
        return all_gather(t, self.mesh, "data", dim) if self._lanes.split \
            else t

    def _throttle(self, plan: MigrationPlan, cap) -> MigrationPlan:
        """`throttle_plan` in the whole stream's plan's row order: the
        live rows the whole plan holds ahead of each of this rank's
        (layer, lane) blocks, from every rank's block counts when the
        lanes are split over `data` (else from this plan's own)."""
        lo, n = self._lanes.first, self._lanes.count
        live = (plan.pro_layer >= 0).to(torch.int32)
        L = live.shape[0] // (n * self._budget)
        per = self._data_gather(live.view(L, n, -1).sum(
            -1, dtype=torch.int32), 1).reshape(-1)
        ahead = (torch.cumsum(per, 0) - per).view(L, -1)[:, lo:lo + n]
        return throttle_plan(plan, cap, ahead=ahead)

    @property
    def captures(self):
        """Graph captures by key (a Counter; empty off the card): the
        counterpart of the reference's `_serve_jit._cache_size()`. A
        stream served again on the same engine captures nothing."""
        return self._graphs.captures

    # ------------------------------------------------------------------ #
    def _setup(self, geo):
        """Bind a stream of `geo` (whose geometry prices the telemetry):
        the rank's lanes and its cache's geometry (under a mesh, the
        lanes over `data` — all of them when the axis does not divide
        B — and the KV heads over `model` or, under the `pages` rule,
        the slots (`_shard`, which its caches are made with), with the
        rank-local model that runs them; else every lane and `geo`),
        then the policy, its state and the budget over the rank's
        cache, whose tier sizes are the whole ones. Returns the rank's
        geometry."""
        self.geo = geo
        tp, cfg = self._tp, self.cfg
        if tp is None:
            local = geo
            self._lanes = Lanes(0, geo.batch, geo.batch, False)
        else:
            B = geo.batch
            split = batch_axes(self.mesh, B) == ("data",)
            n = B // tp.sizes["data"] if split else B
            self._run = (tp.model_for(split), self.params)
            local = tp.model.cache_geometry(n, cfg.max_context,
                                            hbm_fraction=cfg.hbm_fraction)
            self._lanes = Lanes(tp.coord["data"] * n if split else 0, n, B,
                                split)
        self._policy = make_policy(cfg.policy, cfg=cfg, geo=local)
        self._pstate = _to_device(self._policy.init_state(local),
                                  self.device)
        self._budget = control.migration_budget(
            local, cfg.migration_budget_frac)
        return local

    def start(self, prompts: torch.Tensor, extra=None):
        """Prefill `prompts` [B, S] into a fresh cache and return the
        last-position logits [B, V]; resets the policy state and any
        captured trace. `self.stats` is kept, as the reference's code
        keeps it (only `serve` resets it). `extra` (vlm:
        {"patch_embeds"}, encdec: {"frame_embeds"}, [B, n, d] each,
        tensors or numpy) is moved to the engine's device. The
        single-stream entry point for `step`/`run`/`generate`; a meshed
        engine prefills its rank's lanes with its rank-local model (the
        whole logits on every rank)."""
        prompts = prompts.to(self.device)
        if extra is not None:
            extra = {k: torch.as_tensor(v).to(self.device)
                     for k, v in extra.items()}
        geo = self.model.cache_geometry(prompts.shape[0],
                                        self.cfg.max_context,
                                        hbm_fraction=self.cfg.hbm_fraction)
        local = self._setup(geo)
        model, params = self._run
        logits, self.state = model.prefill(
            params, self._lane_slice(prompts), local, extra=extra)
        self._trace_log = []
        self._trace_prompt_len = int(prompts.shape[1])
        return self._data_gather(logits, 0)

    def _decode(self, state, pstate, token, active=None, mig_cap=None):
        """The fused step: control plane + decode + lane merge + plan +
        migration, on `state`'s paged cache (the state itself, or
        encdec's "kv"). Returns (logits, state, pstate, stats): stats is
        (telemetry [4],) or, with `cfg.trace_telemetry`, (telemetry,
        read set bool [L, B, P], read-time placement int8 [L, B, P]).
        `mig_cap` (a 0-dim int32 device tensor, serve only): the fault
        plane's cap on the step's committed promote rows, applied every
        step (`throttle_plan`; the plan's capacity leaves it whole); the
        telemetry counts the committed moves."""
        cache = _get_cache(state)
        sparsity = self.cfg.attention_sparsity
        write_slot = control.choose_write_slot(cache)
        mask = control.quest_page_mask(cache, sparsity) \
            if sparsity > 0 else None
        # the read set this step's attention streams, for the policy
        read = mask if mask is not None else cache.page_table >= 0
        old = cache
        model, params = self._run
        logits, state = model.decode_step(
            params, state, token, write_slot=write_slot,
            logical_page_mask=mask, active=active)
        cache = _get_cache(state)
        if active is not None:
            # inactive lanes keep their pre-step tables (their pools
            # were never written)
            cache = control.lane_merge(old, cache, active)
        # read traffic is counted on post-decode, pre-migration residency
        occ = control.occupancy(cache)
        plan, pstate, (n_pro, n_dem) = self._policy.plan(
            cache, pstate, active, self._budget, read_mask=read)
        if mig_cap is not None:
            plan = self._throttle(plan, mig_cap)
            n_pro, n_dem = plan.row_counts()
        moves = torch.stack([n_pro, n_dem]).to(torch.int32)
        base = torch.cat([occ, moves])
        if self.cfg.trace_telemetry:
            # post-decode (the step's fresh page included),
            # pre-migration placement
            stats = (base, read, control.page_tiers(cache))
        else:
            stats = (base,)
        cache = apply_migrations(cache, plan, self._shard)
        return logits, _set_cache(state, cache), pstate, stats

    def _decode_overlap(self, cache: PagedKVCache, pstate, staged,
                        token, active, mig_cap=None):
        """The overlap-mode step (the reference's `step_overlap_fn`):
        decode on the pre-commit placement, revalidate the plan staged
        one step ago against the post-decode owner maps, cap it by the
        fault plane's `mig_cap`, commit it, then plan the next on the
        post-commit cache with this step's read set as the one-step-ahead
        oracle. `mig_cap` is a 0-dim int32 device tensor, as
        `_decode`'s. Returns (logits, cache, pstate, staged, stats);
        stats is (telemetry [4],) — pre-commit occupancy and the
        committed moves — or, with `cfg.trace_telemetry`, also the read
        set and the PRE-commit placement this step's attention read."""
        sparsity = self.cfg.attention_sparsity
        write_slot = control.choose_write_slot(cache)
        mask = control.quest_page_mask(cache, sparsity) \
            if sparsity > 0 else None
        read = mask if mask is not None else cache.page_table >= 0
        old = cache
        model, params = self._run
        logits, cache = model.decode_step(
            params, cache, token, write_slot=write_slot,
            logical_page_mask=mask, active=active,
            pool_ready=self._commit_done)
        cache = control.lane_merge(old, cache, active)
        # occupancy and placement are pre-commit: this step's attention
        # read them
        occ = control.occupancy(cache)
        tiers = control.page_tiers(cache) if self.cfg.trace_telemetry \
            else None
        commit = control.revalidate_plan(staged, cache)
        if mig_cap is not None:
            commit = self._throttle(commit, mig_cap)
        n_pro, n_dem = commit.row_counts()
        if self._copy_stream is not None:
            cache, self._commit_done = commit_async(
                cache, commit, self._copy_stream, self._shard)
        else:
            cache = apply_migrations(cache, commit, self._shard)
        staged, pstate, _ = self._policy.plan(cache, pstate, active,
                                              self._budget, read_mask=read)
        moves = torch.stack([n_pro, n_dem]).to(torch.int32)
        base = torch.cat([occ, moves])
        stats = (base, read, tiers) if tiers is not None else (base,)
        return logits, cache, pstate, staged, stats

    def _pools_ready(self) -> None:
        """The current stream waits for the last commit's page copies
        (overlap mode on the card; a no-op otherwise)."""
        if self._commit_done is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._commit_done)

    def _stream_stats(self, rows: List[tuple]) -> tuple:
        """Decode steps' stats tuples (`_decode`'s: base, then the read
        set and placement when traced) stacked by step and made global
        as a serve chunk's rows (`_global_rows`)."""
        cols = (torch.stack(col) for col in zip(*rows))
        return tuple(self._global_rows(
            dict(zip(("base", "access", "tier"), cols))).values())

    def step(self, token: torch.Tensor) -> torch.Tensor:
        """One decode step + one telemetry readback (eager, as the
        reference's `step`): token [B] -> logits [B, V]."""
        _require_cache(self.state, self.model.cfg.family)
        logits, self.state, self._pstate, stats = self._decode(
            self.state, self._pstate,
            self._lane_slice(token.to(self.device)))
        self._record(tuple(col.cpu().numpy()
                           for col in self._stream_stats([stats])))
        return self._data_gather(logits, 0)

    def _bind_stream_arena(self, batch: int):
        """The run/generate arena holding the current decode state and
        policy state: the one already there, with the states copied in
        place, when its layout matches (graphs captured over it stay
        valid); else the states themselves become the arena, and the
        old one's graphs are dropped."""
        a = self._stream_arena
        state, pstate = self.state, self._pstate
        if a is None or not _same_layout(a["state"], state) or \
                not _same_layout(a["pstate"], pstate) or \
                a["token"].shape[0] != batch or \
                a["tokens"].shape[0] != max(1, self.cfg.telemetry_stride):
            self._graphs.drop(lambda key: key[0] in ("run", "generate"))
            i32 = dict(dtype=torch.int32, device=self.device)
            a = self._stream_arena = {
                "state": state, "pstate": pstate,
                "tokens": torch.zeros(
                    (max(1, self.cfg.telemetry_stride), batch), **i32),
                "token": torch.zeros((batch,), **i32)}
        _write_back(a["state"], state)
        _write_back(a["pstate"], pstate)
        self.state, self._pstate = a["state"], a["pstate"]
        return a

    def _stream_chunk(self, a, n: int, mode: str):
        """`n` fused decode steps over the arena `a` (the reference's
        `chunk_fn` for mode "run": teacher-forced from a["tokens"][:n];
        `gen_fn` for "generate": greedy from a["token"]), over the
        rank's lanes. Writes the final states (and the last token) back
        into the arena and returns (logits [n, B, V] or tokens [n, B],
        stats rows stacked [n, ...]) over all B lanes (`_stream_stats`)."""
        state, pstate, token = a["state"], a["pstate"], a["token"]
        outs, rows = [], []
        for i in range(n):
            tok = a["tokens"][i] if mode == "run" else token
            logits, state, pstate, stats = self._decode(state, pstate, tok)
            if mode == "run":
                outs.append(logits)
            else:
                token = logits.argmax(dim=-1).to(torch.int32)
                outs.append(token)
            rows.append(stats)
        _write_back(a["state"], state)
        _write_back(a["pstate"], pstate)
        if mode == "generate":
            a["token"].copy_(token)
        return self._data_gather(torch.stack(outs), 1), \
            self._stream_stats(rows)

    def _stream_chunks(self, mode: str, steps: int, tokens=None,
                       token=None) -> torch.Tensor:
        """Drive `steps` fused steps in chunks of `telemetry_stride`,
        one readback each, through graphs on the card; the arena holds
        the rank's lanes of `tokens` [steps, B] or `token` [B]."""
        stride = max(1, self.cfg.telemetry_stride)
        if tokens is not None:
            tokens = self._lane_slice(tokens, 1)
        if token is not None:
            token = self._lane_slice(token)
        a = self._bind_stream_arena(self._lanes.count)
        if token is not None:
            a["token"].copy_(token)
        out = []
        for s in range(0, steps, stride):
            n = min(stride, steps - s)
            if tokens is not None:
                a["tokens"][:n].copy_(tokens[s:s + n])

            def chunk():
                return self._stream_chunk(a, n, mode)
            key = (mode, self.cfg.policy, self.cfg.trace_telemetry,
                   self._lanes.split, n)
            res, stats = self._graphs.run(key, chunk)
            self.steps_run += n
            # a replay overwrites the graph's outputs: keep a copy
            out.append(res.clone())
            self._record(tuple(col.cpu().numpy() for col in stats))
        return torch.cat(out)

    def run(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decode. tokens [K, B] -> logits [K, B, V].

        Fused chunks of `telemetry_stride` steps with one telemetry
        readback per chunk; the same logits and StepStats as K calls of
        `step()`."""
        _require_cache(self.state, self.model.cfg.family)
        tokens = tokens.to(self.device, torch.int32)
        K = tokens.shape[0]
        if K == 0:
            return torch.zeros((0, tokens.shape[1], self.model.cfg.vocab),
                               device=self.device)
        return self._stream_chunks("run", K, tokens=tokens)

    def generate(self, token: torch.Tensor, steps: int) -> torch.Tensor:
        """Greedy generation from `token` [B] -> tokens [steps, B], in
        fused chunks of `telemetry_stride` steps with one readback
        each."""
        _require_cache(self.state, self.model.cfg.family)
        token = token.to(self.device, torch.int32)
        if steps == 0:
            return torch.zeros((0,) + token.shape, dtype=torch.int32,
                               device=self.device)
        return self._stream_chunks("generate", steps, token=token)

    # ------------------------------------------------------------------ #
    # continuous-batching serve loop (the headline API)
    # ------------------------------------------------------------------ #
    def serve(self, requests: Sequence[Request], *,
              num_slots: Optional[int] = None,
              sampling: Optional[SamplingConfig] = None,
              seed: int = 0, total_pages: Optional[int] = None,
              max_skips: int = 8, faults: Optional[FaultPlane] = None,
              slo: Optional[SLOPolicy] = None) -> ServeReport:
        """Drive a request stream end to end (see the module docstring).

        A fixed batch of `num_slots` cache lanes runs MIXED
        prefill+decode steps; every `telemetry_stride` steps the host
        reads back emitted and first tokens, completes finished requests
        (EOS or budget), reclaims their pages with one masked
        `control.release_lanes`, honours deadlines and cancellation,
        applies the fault plane's pool delta, sheds queued requests
        that miss their SLO, and admits queued requests. Invalid
        requests are rejected with a typed error; the stream never
        raises on a per-request condition. Greedy by default; sampling
        draws from a per-lane key derived from (`seed`, rid)
        (`sampling.lane_key`) and the request's token count, so a
        request's tokens do not depend on its batch company.

        `faults` (a `FaultPlane`) and `slo` (an `SLOPolicy`) follow the
        reference's boundary logic step for step: per chunk the
        window's events, the spec that prices it, cost_aware's
        recalibration (from the measured link with `measured_payback`),
        the static fallback, per-step commit caps and poison masks; SLO
        shedding at stream start, after open-loop arrivals, and after
        the boundary's reaping (so a request is never both "timeout"
        and SLO-shed), projected with an EMA of the measured step time.
        """
        cfg = self.cfg
        dev = self.device
        fam = self.model.cfg.family
        if fam not in ("dense", "moe"):
            raise NotImplementedError(
                f"serve() drives cache-backed decode states (dense/moe); "
                f"family {fam!r} needs prefill extras or recurrent-state "
                f"lane insertion")
        if not requests:
            return ServeReport(completed=[])
        B = num_slots if num_slots is not None else min(len(requests), 4)
        geo = self.model.cache_geometry(B, cfg.max_context,
                                        hbm_fraction=cfg.hbm_fraction)
        local = self._setup(geo)
        self.stats = []
        self._serve_trace_log = []
        self.chunk_log = []
        self._sampling = sampling or SamplingConfig()
        sampler = make_sampler(self._sampling)
        overlap = cfg.overlap_migrations
        stride = max(1, cfg.telemetry_stride)
        a = self._bind_serve_arena(local, stride)
        faults = faults if faults is not None else FaultPlane()
        base_spec = cfg.spec
        cap_rows = control.plan_capacity(geo, cfg.migration_budget_frac)
        capture = cfg.trace_telemetry
        events: List[dict] = []
        # the policy's thresholds recalibrate from `calib_base` (the
        # measured link with measured_payback) under the tier faults;
        # pricing stays on cfg.spec under them
        calib_base = base_spec
        if cfg.measured_payback:
            measured, detail = self._agree(
                self._measure_migration_spec(local))
            if measured is not None:
                calib_base = measured
                self._recalibrate(a, measured)
            events.append({"kind": "payback_measured", "step": 0,
                           **detail})
        last_thresh = calib_base
        fallback = False
        drop_streak = 0
        # overlap mode: the host pools in pinned host memory (on the
        # card), and the staged plan, empty at first — step 0 commits
        # nothing; `stale` marks lanes (re)bound or released since the
        # plan was staged, whose rows are dropped before the next chunk
        if overlap and dev.type == "cuda" and self._copy_stream is None:
            # both side streams exist before any chunk is captured
            self._copy_stream = torch.cuda.Stream(dev)
            ops.side_stream(dev)
        self._commit_done = None
        stale = np.zeros((B,), bool)
        C = max(1, cfg.prefill_chunk)
        eos = cfg.eos_id
        key = ("serve", cfg.policy, overlap, cfg.trace_telemetry,
               self._sampling, eos, cfg.prefill_budget, C, stride)

        pool = total_pages if total_pages is not None \
            else B * geo.max_pages
        batcher = ContinuousBatcher(B, pool, page_tokens=geo.page_tokens,
                                    max_skips=max_skips)
        self.batcher = batcher

        def submit_one(r: Request) -> None:
            if r.prompt is None:
                batcher.reject_submit(
                    r, "empty_prompt",
                    f"request {r.rid}: serve() needs prompt tokens")
            elif r.max_new_tokens < 1:
                batcher.reject_submit(
                    r, "zero_budget",
                    f"request {r.rid}: max_new_tokens must be >= 1")
            elif r.prompt_len + r.max_new_tokens > geo.max_tokens:
                batcher.reject_submit(
                    r, "infeasible_context",
                    f"request {r.rid}: {r.prompt_len}+{r.max_new_tokens}"
                    f" tokens exceed cache capacity {geo.max_tokens}")
            else:
                batcher.submit(r)   # may itself reject (duplicate /
                #                     pool-infeasible footprint)

        # open-loop arrivals: a request with arrival_s > 0 is submitted
        # at the first boundary whose wall clock passes it
        t_start = time.time()
        pending: List[Request] = sorted(
            (r for r in requests if r.arrival_s > 0.0),
            key=lambda r: r.arrival_s)
        for r in requests:
            if r.arrival_s <= 0.0:
                submit_one(r)

        def submit_arrivals() -> bool:
            if not pending:
                return False
            now_rel = self._agree(time.time() - t_start)
            due = False
            while pending and pending[0].arrival_s <= now_rel:
                submit_one(pending.pop(0))
                due = True
            return due

        hs = {
            "seed": seed,
            "prompt_buf": np.zeros((B, geo.max_tokens), np.int32),
            "token": np.zeros((B,), np.int32),
            "keys": np.zeros((B, 2), np.int64),
        }
        live: Dict[int, Request] = {}          # lane -> request

        def admit():
            while True:
                admitted = batcher.admit()
                if not admitted:
                    return
                for req in admitted:
                    self._admit_lane(req, hs)
                    if req.lane >= 0:
                        live[req.lane] = req
                        stale[req.lane] = True

        #: EMA of the measured per-step wall seconds (from chunk spans),
        #: the SLO projection's prefill cadence
        est_step_s: Optional[float] = None

        def shed_slo() -> None:
            """Shed each QUEUED request whose projected TTFT already
            misses its tier's target, as `rejected` / "slo_shed"; a
            request due for the reaper (expired or cancelled) is left
            to it."""
            if slo is None:
                return
            now = time.time()
            shed = []
            for req in batcher.queue:
                if req.cancel_requested or (
                        req.deadline_s is not None
                        and now - req.submitted_at > req.deadline_s):
                    continue
                reason = slo.should_shed(req, now, est_step_s,
                                         cfg.prefill_chunk)
                if reason is not None:
                    shed.append((req.rid, reason))
            queued = {req.rid: req for req in batcher.queue}
            for rid, reason in self._agree(shed):
                req = queued[rid]
                batcher.drop_queued(req, "rejected", "slo_shed", reason)
                events.append({"kind": "slo_shed",
                               "step": batcher.step_idx,
                               "rid": req.rid, "tier": req.tier,
                               "reason": reason})

        admit()
        shed_slo()
        view = batcher.device_view()

        def upload(x):
            return torch.as_tensor(x, device=dev)

        while batcher.has_work or pending:
            if submit_arrivals():
                admit()
                shed_slo()
                view = batcher.device_view()
            if not view.active.any():
                if batcher.queue:
                    # nothing live but work queued: the head cannot be
                    # admitted with every page free — reject it
                    stuck = batcher.queue.popleft()
                    batcher.reject(
                        stuck, "admission_stalled",
                        f"needs {stuck.pages_needed} pages, pool has "
                        f"{batcher.free_pages}/{batcher.total_pages} free")
                    admit()
                    view = batcher.device_view()
                    continue
                if pending:
                    wait = pending[0].arrival_s - (time.time() - t_start)
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                    continue
                break
            step0 = batcher.step_idx
            events.extend(faults.window_events(step0, stride))
            # tier fault: the chunk's pricing spec, and the thresholds
            # recalibrated under the same scales; past the ratio
            # threshold migrating toward the host tier cannot pay back
            spec_now = faults.spec_at(step0, base_spec)
            thresh_now = faults.spec_at(step0, calib_base)
            if thresh_now != last_thresh:
                self._recalibrate(a, thresh_now)
                last_thresh = thresh_now
                events.append({"kind": "payback_recalibration",
                               "step": step0,
                               "bw_ratio": thresh_now.bw_ratio})
            if not fallback and spec_now.bw_ratio >= \
                    cfg.fallback_tier_ratio * base_spec.bw_ratio:
                fallback = True
                events.append({"kind": "policy_fallback", "step": step0,
                               "reason": "tier_ratio",
                               "bw_ratio": spec_now.bw_ratio})
            caps = faults.commit_caps(step0, stride, cap_rows)
            drop_streak = drop_streak + 1 if (caps == 0).any() else 0
            if not fallback and \
                    drop_streak >= max(1, cfg.fallback_commit_faults):
                fallback = True
                events.append({"kind": "policy_fallback", "step": step0,
                               "reason": "commit_faults",
                               "boundaries": drop_streak})
            if fallback:
                # static fallback: plans exist, none commit
                caps = np.zeros_like(caps)
            poison = faults.poison_steps(step0, stride, view.rids)
            t0 = time.time()
            for req in live.values():
                if req.admitted_at is None:
                    req.admitted_at = t0
            # the chunk's inputs (the rank's lanes), into the arena in place
            lanes = self._lane_slice
            for name, value in (
                    ("tok", lanes(hs["token"])), ("act", lanes(view.active)),
                    ("rem", lanes(view.remaining)),
                    ("prog", lanes(view.prefilled)),
                    ("prompt_len", lanes(view.prompt_len)),
                    ("prompt_buf", lanes(hs["prompt_buf"])),
                    ("keys", lanes(hs["keys"])), ("caps", caps),
                    ("poison", lanes(poison, 1)), ("stale", lanes(stale))):
                a[name].copy_(torch.as_tensor(value))
            stale[:] = False
            plane = prefill_plane(view, stride, C, geo.page_tokens,
                                  geo.max_pages,
                                  cfg.prefill_budget is not None,
                                  all_lanes=fam == "moe")

            def chunk():
                return self._serve_chunk(a, stride, plane, sampler)
            t_issue = time.perf_counter()
            replays = sum(self._graphs.replays.values())
            captures = sum(self._graphs.captures.values())
            timers = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)] if dev.type == "cuda" else None
            if timers:
                timers[0].record()
            rows = self._graphs.run(key + plane, chunk)
            if timers:
                timers[1].record()
            issued = time.perf_counter() - t_issue
            self.steps_run += stride
            out = {k: v.cpu().numpy()
                   for k, v in self._global_rows(rows).items()}
            self.chunk_log.append({
                "prefill_pages": plane[0], "prefill_steps": plane[1],
                "replayed": sum(self._graphs.replays.values()) > replays,
                "captured": sum(self._graphs.captures.values()) > captures,
                "issue_s": issued, "span_s": time.perf_counter() - t_issue,
                "device_s": timers[0].elapsed_time(timers[1]) / 1e3
                if timers else None})
            emitted = out["emitted"]                    # [stride, B]
            first = out["first"]
            pf_tok = out["pf"]
            failed_lane = out["failed"].any(axis=0)      # [B]
            hs["token"] = self._data_gather(a["tok"], 0).cpu().numpy().copy()
            prog_np = self._data_gather(a["prog"], 0).cpu().numpy()
            done_d = ~self._data_gather(a["act"], 0).cpu().numpy()
            # telemetry: only steps where at least one lane DECODED,
            # each priced under the spec governing its step
            row_mask = emitted.max(axis=1) >= 0
            specs = [faults.spec_at(step0 + i, base_spec)
                     for i in np.nonzero(row_mask)[0]] if faults.tier \
                else None
            self._record((out["base"][row_mask],), specs=specs)
            if capture:
                self._serve_trace_log.append(
                    (out["access"], out["tier"], emitted, first,
                     view.rids.copy(), view.prompt_len.copy()))
            span = time.time() - t0
            est = span / stride
            est_step_s = est if est_step_s is None else \
                0.5 * (est_step_s + est)

            def stamp(row):
                return t0 + (row + 1) / stride * span

            release = np.zeros((B,), bool)
            for lane, req in list(live.items()):
                # a lane never emits both in one step
                rws = np.where(first[:, lane] >= 0, first[:, lane],
                               emitted[:, lane])
                got = np.nonzero(rws >= 0)[0]
                if req.first_token_at is None and \
                        req.admitted_at is not None:
                    # TTFT attribution up to the crossing row: prefill
                    # rows to prefill_s, budget-throttled rows and host
                    # gaps to throttle_s, so queue_wait + prefill +
                    # throttle == TTFT
                    crossed_any = first[:, lane].max() >= 0
                    c = int(np.argmax(first[:, lane] >= 0)) \
                        if crossed_any else stride - 1
                    cursor = (req.admitted_at + req.prefill_s +
                              req.throttle_s)
                    req.throttle_s += max(0.0, t0 - cursor)
                    ran = int((pf_tok[:c + 1, lane] > 0).sum())
                    w = span / stride
                    req.prefill_s += ran * w
                    req.throttle_s += (c + 1 - ran) * w
                if req.first_token_at is None and first[:, lane].max() >= 0:
                    req.first_token_at = stamp(
                        int(np.argmax(first[:, lane] >= 0)))
                    req.phase = "decoding"
                req.output.extend(int(rws[s]) for s in got)
                req.generated += len(got)
                req.prefilled = int(min(prog_np[lane], req.prompt_len))
                if done_d[lane]:      # EOS / budget / quarantine
                    del live[lane]
                    release[lane] = True
                    if failed_lane[lane]:
                        batcher.complete(req, "failed", RequestError(
                            "poisoned_logits",
                            f"non-finite logits on lane {lane}"))
                    else:
                        req.stop_reason = "eos" if (
                            eos is not None and req.output
                            and req.output[-1] == eos) else "budget"
                        batcher.complete(req)
                    if got.size:
                        req.finished_at = stamp(int(got[-1]))
            # deadline + cooperative cancellation, at boundaries
            now = time.time()

            def reaped(req) -> Optional[str]:
                if req.cancel_requested:
                    return "cancelled"
                if req.deadline_s is not None and \
                        now - req.submitted_at > req.deadline_s:
                    return "timeout"
                return None
            live_out, queued_out = self._agree((
                [(lane, reaped(req)) for lane, req in live.items()
                 if reaped(req)],
                [(req.rid, reaped(req)) for req in batcher.queue
                 if reaped(req)]))
            for lane, status in live_out:
                req = live.pop(lane)
                release[lane] = True
                batcher.complete(req, status, RequestError(
                    "cancelled" if status == "cancelled"
                    else "deadline_exceeded",
                    f"reaped at step {batcher.step_idx + stride}"))
            queued = {req.rid: req for req in batcher.queue}
            for rid, status in queued_out:
                batcher.drop_queued(
                    queued[rid], status,
                    "cancelled" if status == "cancelled"
                    else "deadline_exceeded",
                    "reaped while queued")
            stale |= release
            if release.any():
                _write_back(a["cache"], control.release_lanes(
                    a["cache"], upload(self._lane_slice(release))))
            delta = faults.pool_delta(step0, stride)
            if delta:
                batcher.resize_pool(delta)
            batcher.step_idx += stride
            # after the reaping (never both "timeout" and SLO-shed),
            # before admission refills the freed lanes
            shed_slo()
            admit()
            view = batcher.device_view()
        return ServeReport.build(batcher.completed, batcher.rejected,
                                 events, eos_id=cfg.eos_id)

    def _global_rows(self, rows: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """A serve or stream chunk's per-step rows over all B lanes:
        with lanes split over `data`, the per-lane rows and the trace
        ([steps, L, B, P]) all-gathered and the telemetry's page counts
        summed; else `rows`."""
        if not self._lanes.split:
            return rows
        return {k: self._data_sum(v.clone()) if k == "base"
                else self._data_gather(v, 2 if k in ("access", "tier")
                                       else 1)
                for k, v in rows.items()}

    def _bind_serve_arena(self, geo, stride: int):
        """The serve arena for `geo`, reset in place for a new stream:
        the one already there when the geometry, stride and mode match
        (graphs captured over it stay valid), else a new one, which
        drops the old one's graphs. Also makes its cache `self.state`.

        Holds the cache, the policy state, the staged plan (overlap
        mode), the per-lane carries (tok, act, rem, prog, prompt_len,
        prompt_buf [B, max_tokens], keys [B, 2]), the prefill credits,
        the fault plane's rows (caps [stride] int32, poison [stride, B]
        bool) and the lanes gone stale at the boundary."""
        dev = self.device
        overlap = self.cfg.overlap_migrations
        B = geo.batch
        cap = control.plan_capacity(geo, self.cfg.migration_budget_frac)
        pstate = _to_device(self._policy.init_state(geo), dev)
        arena_key = (geo, stride, overlap, self.cfg.policy)
        a = self._serve_arena
        if a is None or self._serve_arena_key != arena_key:
            self._graphs.drop(lambda key: key[0] == "serve")
            self._serve_arena = None        # free the old pools first
            i32 = dict(dtype=torch.int32, device=dev)
            flags = dict(dtype=torch.bool, device=dev)
            a = {"cache": init_cache(geo, device=dev, host_pinned=overlap,
                                     shard=self._shard),
                 "pstate": pstate,
                 "staged": MigrationPlan.empty(cap, device=dev)
                 if overlap else None,
                 "tok": torch.zeros((B,), **i32),
                 "act": torch.zeros((B,), **flags),
                 "rem": torch.zeros((B,), **i32),
                 "prog": torch.zeros((B,), **i32),
                 "prompt_len": torch.zeros((B,), **i32),
                 "prompt_buf": torch.zeros((B, geo.max_tokens), **i32),
                 "keys": torch.zeros((B, 2), dtype=torch.int64, device=dev),
                 "credits": torch.zeros((), **i32),
                 "caps": torch.zeros((stride,), **i32),
                 "poison": torch.zeros((stride, B), **flags),
                 "stale": torch.zeros((B,), **flags)}
            self._serve_arena, self._serve_arena_key = a, arena_key
        else:
            cache = a["cache"]
            cache.page_table.fill_(NO_SLOT)
            cache.hbm_owner.fill_(NO_SLOT)
            cache.host_owner.fill_(NO_SLOT)
            cache.length.zero_()
            cache.importance.zero_()
            if self.model.cfg.family == "moe":
                # moe routing groups every lane, and a lane's prefill
                # rows attend over its pools in slot order: an idle
                # lane's rows must read the zeros of the reference's
                # fresh cache, not the last stream's pages
                for pool in (cache.k_hbm, cache.v_hbm, cache.k_host,
                             cache.v_host):
                    pool.zero_()
            _write_back(a["pstate"], pstate)
            if overlap:
                _write_back(a["staged"], MigrationPlan.empty(cap, device=dev))
            a["credits"].zero_()
        self._pstate = a["pstate"]
        self.state = a["cache"]
        return a

    def _recalibrate(self, a, spec) -> None:
        """The policy state's spec-dependent values re-derived for
        `spec`, written into the arena in place (a graph reads them)."""
        _write_back(a["pstate"], _to_device(
            self._policy.recalibrate(a["pstate"], spec), self.device))

    def _serve_chunk(self, a, stride: int, plane, sampler):
        """One fused chunk of `stride` MIXED prefill+decode steps over
        the arena `a` (the reference's `_serve_chunk_impl`).

        Per step the lane modes come from the device carries; the decode
        plane runs with `dec` as its lanes, and with no decoding lane it
        is an exact no-op through the 0-dim flag `dec.any()`: its
        migration cap becomes 0, and the policy state and the staged
        plan keep their values (`_keep_unless`); `lane_merge` keeps every
        lane's tables and no pool row is written. The poison row NaNs
        the logits of its lanes; the non-finite guard quarantines them.
        The prefill plane (`plane` = (pages, steps), `prefill_plane`'s)
        runs on the chunk's first `steps` steps, every lane at fixed
        shapes over the first `pages` pages of each tier's slot space; a
        lane with n_valid 0 writes nothing. The step a lane's prefill
        crosses its prompt samples its first token. Writes the carries,
        tables and policy state back into the arena and returns the
        per-step rows stacked [stride, ...]: emitted, first, failed, pf
        (prompt tokens consumed), base (telemetry [4]) and, with trace
        capture, access and tier."""
        cfg = self.cfg
        overlap = cfg.overlap_migrations
        capture = cfg.trace_telemetry
        C = max(1, cfg.prefill_chunk)
        Pb = cfg.prefill_budget
        eos = cfg.eos_id
        cache, pstate = a["cache"], a["pstate"]
        tok, act, rem, prog, credits = (a[k] for k in (
            "tok", "act", "rem", "prog", "credits"))
        prompt_len, prompt_buf, keys = (a[k] for k in (
            "prompt_len", "prompt_buf", "keys"))
        B, S_cap = prompt_buf.shape
        dev = prompt_buf.device
        T = cache.k_hbm.shape[3]
        pf_pages, pf_steps = plane
        staged = control.mask_plan_lanes(a["staged"], a["stale"]) \
            if overlap else None
        ar_c = torch.arange(C, dtype=torch.int32, device=dev)
        bidx = torch.arange(B, device=dev)
        nan = torch.full((), float("nan"), device=dev)
        rows = {"emitted": [], "first": [], "failed": [], "pf": [],
                "base": []}
        if capture:
            rows.update(access=[], tier=[])
        self._commit_done = None
        for n_step in range(stride):
            pf, dec = control.lane_modes(act, prog, prompt_len)
            # decode plane: an exact no-op on steps with no decoding
            # lane (its stats row is filtered at the boundary; in
            # overlap mode the staged plan waits); over every rank's
            # lanes in a meshed serve
            live = self._data_sum(dec.sum(dtype=torch.int32)) > 0
            cap = torch.where(live, a["caps"][n_step], 0)
            if overlap:
                logits, cache, new_ps, new_staged, stats = \
                    self._decode_overlap(cache, pstate, staged, tok, dec,
                                         mig_cap=cap)
                staged = _keep_unless(live, new_staged, staged)
            else:
                logits, cache, new_ps, stats = self._decode(
                    cache, pstate, tok, dec, mig_cap=cap)
            pstate = _keep_unless(live, new_ps, pstate)
            logits = torch.where((dec & a["poison"][n_step])[:, None],
                                 nan.to(logits.dtype), logits)
            # non-finite sampling guard: such a lane emits nothing,
            # flips inactive, and completes "failed"
            bad = dec & ~torch.isfinite(logits).all(dim=-1)
            if capture:
                # decode-plane attribution: a lane's reads count while
                # it decodes
                rows["access"].append(stats[1] & dec[None, :, None])
                rows["tier"].append(stats[2])
            dec_ok = dec & ~bad
            nxt = sampler(logits, keys, rem)
            rem = rem - dec_ok.to(rem.dtype)
            fin = dec_ok & (rem <= 0)
            if eos is not None:
                fin = fin | (dec_ok & (nxt == eos))
            emitted = torch.where(dec_ok, nxt, -1)
            tok = torch.where(dec_ok, nxt, tok)
            act = act & ~fin & ~bad

            # prefill plane: a C-token slice per prefilling lane
            n_val = torch.where(pf, (prompt_len - prog).clamp(0, C),
                                0).to(torch.int32)
            if Pb is not None:
                # per-batch token bucket: run the prefill plane only
                # when the accrued budget covers the step's demand (of
                # every rank's lanes in a meshed serve)
                want_tot = self._data_sum(n_val.sum(dtype=torch.int32))
                credits = torch.clamp_max(credits + Pb,
                                          self._lanes.total * C)
                run_now = credits >= want_tot
                n_val = torch.where(run_now, n_val, 0)
                credits = credits - torch.where(run_now, want_tot, 0)
            first = torch.full_like(tok, -1)
            bad0 = torch.zeros_like(pf)
            if n_step < pf_steps:
                idx = (prog[:, None] + ar_c).clamp(0, S_cap - 1).long()
                sl_toks = torch.gather(prompt_buf, 1, idx)
                self._pools_ready()
                model, params = self._run
                logits_c, cache = model.prefill_chunk(
                    params, cache, sl_toks, prog, n_val, pf_pages * T)
                prog = prog + n_val
                crossed = pf & (prog >= prompt_len)
                last = (n_val - 1).clamp(0, C - 1).long()
                # a lane poisoned at its first token fails before
                # emitting anything
                logits1 = torch.where(
                    (pf & a["poison"][n_step])[:, None],
                    nan.to(logits_c.dtype), logits_c[bidx, last])
                bad0 = crossed & ~torch.isfinite(logits1).all(dim=-1)
                crossed = crossed & ~bad0
                tok0 = sampler(logits1, keys, rem)
                first = torch.where(crossed, tok0, -1)
                tok = torch.where(crossed, tok0, tok)
                rem = rem - crossed.to(rem.dtype)
                fin0 = crossed & (rem <= 0)
                if eos is not None:
                    fin0 = fin0 | (crossed & (tok0 == eos))
                act = act & ~fin0 & ~bad0
            rows["emitted"].append(emitted)
            rows["first"].append(first)
            rows["failed"].append(bad | bad0)
            rows["pf"].append(n_val)
            rows["base"].append(stats[0])
        self._pools_ready()        # the chunk ends with the commits done
        self._commit_done = None
        _write_back(a["cache"], cache)
        _write_back(a["pstate"], pstate)
        if overlap:
            _write_back(a["staged"], staged)
        for name, value in (("tok", tok), ("act", act), ("rem", rem),
                            ("prog", prog), ("credits", credits)):
            a[name].copy_(value)
        return {k: torch.stack(v) for k, v in rows.items()}

    def _measure_migration_spec(self, geo, *, iters: int = 5):
        """Time the migration commit and derive a spec whose link
        bandwidth is MEASURED rather than modeled (the reference's
        `_measure_migration_spec`).

        Times `apply_migrations` of a synthetic full-capacity swap plan
        (`swap_plan`: every row a promote + demote pair, one page across
        the link each way) against the all-sentinel plan over the same
        cache, whose host pools are pinned on the card: the difference
        is the per-page move cost without the fixed overhead, the best
        of `iters` runs of each (`commit_seconds`). Every commit, the
        serve's too, stages a clamped host page for each sentinel row
        (`stage_plan`, as the reference's), so the baseline already
        reads as many host pages as the swap's promotes: the difference
        is the commit's marginal cost, its demotes' writes, while
        `moved` counts both directions. `measured_link_spec` inverts
        it. Returns `(spec or None, detail)`, `detail` being the
        `payback_measured` event's payload."""
        cap = control.plan_capacity(geo, self.cfg.migration_budget_frac)
        plan = swap_plan(geo, cap, self.device)
        empty = MigrationPlan.empty(cap, device=self.device)
        cache = init_cache(geo, device=self.device, host_pinned=True,
                           shard=self._shard)
        shard = self._shard
        commit_seconds(cache, plan, shard)  # warm both outside the timing
        commit_seconds(cache, empty, shard)
        delta = min(commit_seconds(cache, plan, shard)
                    for _ in range(iters)) - \
            min(commit_seconds(cache, empty, shard) for _ in range(iters))
        moved = 2 * cap * geo.page_bytes()
        return measured_link_spec(self.cfg.spec, delta, moved, rows=cap)

    def _admit_lane(self, req: Request, hs: Dict) -> None:
        """Bind an admitted request to its cache lane for chunked
        prefill: the prompt row, the carried token, and the request's
        sampling key, on the host (the next chunk uploads them)."""
        lane = req.lane
        prompt = np.asarray(req.prompt).astype(np.int32).ravel()
        hs["prompt_buf"][lane, :] = 0
        hs["prompt_buf"][lane, :prompt.size] = prompt
        hs["token"][lane] = 0
        hs["keys"][lane] = lane_key(hs["seed"], req.rid)

    # ------------------------------------------------------------------ #
    # telemetry (host side, Eq. (1)-(5) pricing)
    # ------------------------------------------------------------------ #
    def _record(self, stats, specs=None):
        """Price per-step telemetry rows into `self.stats`.

        stats: a tuple off the device — `(base,)` or, with
        `cfg.trace_telemetry`, `(base, access, tier)`: base is [n, 4]
        int rows of (hbm_pages, host_pages, promotes, demotes),
        access/tier the per-step [n, L, B, P] read set and placement,
        of which lane 0 is kept raw in `_trace_log` for
        `trace_bridge.collect`. `specs` optionally prices each row with
        its own `MemorySystemSpec` instead of `cfg.spec`."""
        if len(stats) == 3:
            self._trace_log.append(
                (stats[0], stats[1][:, :, 0], stats[2][:, :, 0]))
        stats = stats[0]
        geo = self.geo
        pb = geo.page_bytes()
        frac = 1.0 - self.cfg.attention_sparsity
        for i, (h_pages, e_pages, n_pro, n_dem) in enumerate(stats):
            spec = specs[i] if specs is not None else self.cfg.spec
            traffic = dict(
                h_read=float(h_pages) * pb * frac,
                e_read=float(e_pages) * pb * frac,
                m_in=float(n_pro) * pb, m_out=float(n_dem) * pb,
                h_write=pb / geo.page_tokens, e_write=0.0)
            lat = float(step_latency(StepTraffic(**traffic), spec))
            denom = traffic["h_read"] + traffic["e_read"]
            self.stats.append(StepStats(
                modeled_latency_s=lat,
                h_read=traffic["h_read"], e_read=traffic["e_read"],
                m_in=traffic["m_in"], m_out=traffic["m_out"],
                hbm_hit_rate=traffic["h_read"] / denom if denom else 1.0))

    def summary(self) -> Dict[str, float]:
        """Aggregate the recorded StepStats: step count, modeled total
        seconds and tokens/s, mean HBM hit rate, migrated bytes."""
        if not self.stats:
            return {}
        lat = np.array([s.modeled_latency_s for s in self.stats])
        return {
            "steps": len(self.stats),
            "modeled_total_s": float(lat.sum()),
            "modeled_tokens_per_s": len(lat) / float(lat.sum()),
            "mean_hbm_hit_rate": float(np.mean(
                [s.hbm_hit_rate for s in self.stats])),
            "migrated_bytes": float(sum(s.m_in + s.m_out
                                        for s in self.stats)),
        }
