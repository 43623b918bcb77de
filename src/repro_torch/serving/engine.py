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

The reference runs each boundary-to-boundary chunk as one `lax.scan`;
here it is a Python loop over the steps, and the reference's two
`lax.cond` skips (no decoding lane, no prefill demand) are host `if`s —
one device sync each per step.

`serve(faults=FaultPlane(...))` folds a seeded fault schedule into the
stream at chunk boundaries (`serving.faults`): tier faults reprice the
telemetry and recalibrate cost_aware, migration faults cap each step's
committed rows, pool faults resize the scheduler's pool, poison faults
NaN a lane's logits, which the non-finite guard quarantines; repeated
commit drops or a tier ratio past `fallback_tier_ratio` fall back to
static placement (every commit capped at 0). `serve(slo=SLOPolicy(...))`
sheds queued requests whose projected TTFT already misses their tier's
target (`serving.slo`). With `EngineConfig.trace_telemetry`, `serve`
keeps every lane's decode read set and read-time placement per step,
with the chunk's lane->request bindings, in `_serve_trace_log` for
`trace_bridge.collect_serve`; the per-step arrays stay on the device
until the chunk's one readback.

Not ported (raises NotImplementedError, `refuse_mesh`): `mesh`, which
spans more than one card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.latency_model import StepTraffic, step_latency
from repro_torch.core.tiers import H100, MemorySystemSpec
from repro_torch.kvcache.migrate import (
    MigrationPlan, apply_migrations, commit_async,
)
from repro_torch.kvcache.paged import PagedKVCache, init_cache
from repro_torch.models.model import Model
from repro_torch.serving import control
from repro_torch.serving.faults import FaultPlane, throttle_plan
from repro_torch.serving.policies import make_policy, policy_names
from repro_torch.serving.sampling import (
    SamplingConfig, lane_generator, make_sampler,
)
from repro_torch.serving.scheduler import (
    ContinuousBatcher, Request, RequestError,
)
from repro_torch.serving.slo import SLOPolicy

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


def refuse_mesh():
    """Raise the port's refusal of a device mesh: the engine, the serve
    CLI's `--mesh` and the dry run's `--mesh multi` share it."""
    raise NotImplementedError(
        "serving across a device mesh spans more than one card and is not "
        "ported yet: the port runs on one card")


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


def commit_seconds(cache: PagedKVCache, plan: MigrationPlan) -> float:
    """Seconds of one `apply_migrations(cache, plan)`: CUDA events on
    the card, `time.perf_counter` on the CPU."""
    if cache.k_hbm.device.type != "cuda":
        t0 = time.perf_counter()
        apply_migrations(cache, plan)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    apply_migrations(cache, plan)
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
        if mesh is not None:
            refuse_mesh()
        self.device = resolve_device(device)
        self.model = model
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.mesh = None
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

    # ------------------------------------------------------------------ #
    def _setup(self, geo):
        """Bind the stream's geometry: policy, its state, the budget."""
        self.geo = geo
        self._policy = make_policy(self.cfg.policy, cfg=self.cfg, geo=geo)
        self._pstate = _to_device(self._policy.init_state(geo), self.device)
        self._budget = control.migration_budget(
            geo, self.cfg.migration_budget_frac)

    def start(self, prompts: torch.Tensor, extra=None):
        """Prefill `prompts` [B, S] into a fresh cache and return the
        last-position logits; resets the policy state and any captured
        trace. `self.stats` is kept, as the reference's code keeps it
        (only `serve` resets it). `extra` (vlm: {"patch_embeds"},
        encdec: {"frame_embeds"}, [B, n, d] each, tensors or numpy) is
        moved to the engine's device. The single-stream entry point for
        `step`/`run`/`generate`."""
        prompts = prompts.to(self.device)
        if extra is not None:
            extra = {k: torch.as_tensor(v).to(self.device)
                     for k, v in extra.items()}
        geo = self.model.cache_geometry(prompts.shape[0],
                                        self.cfg.max_context,
                                        hbm_fraction=self.cfg.hbm_fraction)
        logits, self.state = self.model.prefill(self.params, prompts, geo,
                                                extra=extra)
        self._setup(geo)
        self._trace_log = []
        self._trace_prompt_len = int(prompts.shape[1])
        return logits

    def _decode(self, state, pstate, token, active=None, mig_cap=None):
        """The fused step: control plane + decode + lane merge + plan +
        migration, on `state`'s paged cache (the state itself, or
        encdec's "kv"). Returns (logits, state, pstate, stats): stats is
        (telemetry [4],) or, with `cfg.trace_telemetry`, (telemetry,
        read set bool [L, B, P], read-time placement int8 [L, B, P]).
        `mig_cap` (a host int, serve only): the fault plane's cap on the
        step's committed promote rows; the telemetry counts the
        committed moves."""
        cache = _get_cache(state)
        sparsity = self.cfg.attention_sparsity
        write_slot = control.choose_write_slot(cache)
        mask = control.quest_page_mask(cache, sparsity) \
            if sparsity > 0 else None
        # the read set this step's attention streams, for the policy
        read = mask if mask is not None else cache.page_table >= 0
        old = cache
        logits, state = self.model.decode_step(
            self.params, state, token, write_slot=write_slot,
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
        if mig_cap is not None and mig_cap < plan.capacity:
            plan = throttle_plan(plan, mig_cap)
            n_pro, n_dem = plan.row_counts()
        moves = torch.stack([n_pro, n_dem]).to(torch.int32)
        base = torch.cat([occ, moves])
        if self.cfg.trace_telemetry:
            # post-decode (the step's fresh page included),
            # pre-migration placement
            stats = (base, read, control.page_tiers(cache))
        else:
            stats = (base,)
        cache = apply_migrations(cache, plan)
        return logits, _set_cache(state, cache), pstate, stats

    def _decode_overlap(self, cache: PagedKVCache, pstate, staged,
                        token, active, mig_cap=None):
        """The overlap-mode step (the reference's `step_overlap_fn`):
        decode on the pre-commit placement, revalidate the plan staged
        one step ago against the post-decode owner maps, cap it by the
        fault plane's `mig_cap`, commit it, then plan the next on the
        post-commit cache with this step's read set as the one-step-ahead
        oracle. Returns (logits, cache, pstate, staged, stats); stats is
        (telemetry [4],) — pre-commit occupancy and the committed moves —
        or, with `cfg.trace_telemetry`, also the read set and the
        PRE-commit placement this step's attention read."""
        sparsity = self.cfg.attention_sparsity
        write_slot = control.choose_write_slot(cache)
        mask = control.quest_page_mask(cache, sparsity) \
            if sparsity > 0 else None
        read = mask if mask is not None else cache.page_table >= 0
        old = cache
        logits, cache = self.model.decode_step(
            self.params, cache, token, write_slot=write_slot,
            logical_page_mask=mask, active=active,
            pool_ready=self._commit_done)
        cache = control.lane_merge(old, cache, active)
        # occupancy and placement are pre-commit: this step's attention
        # read them
        occ = control.occupancy(cache)
        tiers = control.page_tiers(cache) if self.cfg.trace_telemetry \
            else None
        commit = control.revalidate_plan(staged, cache)
        if mig_cap is not None and mig_cap < commit.capacity:
            commit = throttle_plan(commit, mig_cap)
        n_pro, n_dem = commit.row_counts()
        if self._copy_stream is not None:
            cache, self._commit_done = commit_async(cache, commit,
                                                    self._copy_stream)
        else:
            cache = apply_migrations(cache, commit)
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

    def _readback(self, rows: List[tuple]) -> None:
        """One host readback of a chunk's stats tuples, then pricing."""
        self._record(tuple(torch.stack(col).cpu().numpy()
                           for col in zip(*rows)))

    def step(self, token: torch.Tensor) -> torch.Tensor:
        """One decode step + one telemetry readback."""
        _require_cache(self.state, self.model.cfg.family)
        logits, self.state, self._pstate, stats = self._decode(
            self.state, self._pstate, token.to(self.device))
        self._readback([stats])
        return logits

    def run(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decode. tokens [K, B] -> logits [K, B, V].

        Chunks of `telemetry_stride` steps with one telemetry readback
        per chunk; the same logits and StepStats as K calls of
        `step()`."""
        _require_cache(self.state, self.model.cfg.family)
        tokens = tokens.to(self.device, torch.int32)
        K = tokens.shape[0]
        if K == 0:
            return torch.zeros((0, tokens.shape[1], self.model.cfg.vocab),
                               device=self.device)
        stride = max(1, self.cfg.telemetry_stride)
        out = []
        for s in range(0, K, stride):
            rows = []
            for tok in tokens[s:s + stride]:
                logits, self.state, self._pstate, stats = self._decode(
                    self.state, self._pstate, tok)
                out.append(logits)
                rows.append(stats)
            self._readback(rows)
        return torch.stack(out)

    def generate(self, token: torch.Tensor, steps: int) -> torch.Tensor:
        """Greedy generation from `token` [B] -> tokens [steps, B], in
        chunks of `telemetry_stride` steps with one readback each."""
        _require_cache(self.state, self.model.cfg.family)
        token = token.to(self.device, torch.int32)
        if steps == 0:
            return torch.zeros((0,) + token.shape, dtype=torch.int32,
                               device=self.device)
        stride = max(1, self.cfg.telemetry_stride)
        out = []
        for s in range(0, steps, stride):
            rows = []
            for _ in range(min(stride, steps - s)):
                logits, self.state, self._pstate, stats = self._decode(
                    self.state, self._pstate, token)
                token = logits.argmax(dim=-1).to(torch.int32)
                out.append(token)
                rows.append(stats)
            self._readback(rows)
        return torch.stack(out)

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
        draws from one `torch.Generator` per request, seeded from
        (`seed`, rid).

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
        self._setup(geo)
        self.stats = []
        self._serve_trace_log = []
        self._sampling = sampling or SamplingConfig()
        sampler = make_sampler(self._sampling)
        pstate = self._pstate
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
            measured, detail = self._measure_migration_spec(geo)
            if measured is not None:
                calib_base = measured
                pstate = _to_device(self._policy.recalibrate(pstate,
                                                             measured), dev)
            events.append({"kind": "payback_measured", "step": 0,
                           **detail})
        last_thresh = calib_base
        fallback = False
        drop_streak = 0
        # overlap mode: the host pools in pinned host memory (on the
        # card), and the staged plan, empty at first — step 0 commits
        # nothing; `stale` marks lanes (re)bound or released since the
        # plan was staged, whose rows are dropped before the next chunk
        overlap = cfg.overlap_migrations
        self.state = init_cache(geo, device=dev, host_pinned=overlap)
        self._copy_stream = torch.cuda.Stream(dev) \
            if overlap and dev.type == "cuda" else None
        self._commit_done = None
        staged = MigrationPlan.empty(cap_rows, device=dev) \
            if overlap else None
        stale = np.zeros((B,), bool)
        C = max(1, cfg.prefill_chunk)
        S_cap = geo.max_tokens
        Pb = cfg.prefill_budget
        eos = cfg.eos_id
        credits = torch.zeros((), dtype=torch.int32, device=dev)

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
            now_rel = time.time() - t_start
            due = False
            while pending and pending[0].arrival_s <= now_rel:
                submit_one(pending.pop(0))
                due = True
            return due

        stride = max(1, cfg.telemetry_stride)
        hs = {
            "seed": seed,
            "prompt_buf": np.zeros((B, geo.max_tokens), np.int32),
            "token": np.zeros((B,), np.int32),
            "gens": [None] * B,
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
            for req in list(batcher.queue):
                if req.cancel_requested or (
                        req.deadline_s is not None
                        and now - req.submitted_at > req.deadline_s):
                    continue
                reason = slo.should_shed(req, now, est_step_s,
                                         cfg.prefill_chunk)
                if reason is not None:
                    batcher.drop_queued(req, "rejected", "slo_shed",
                                        reason)
                    events.append({"kind": "slo_shed",
                                   "step": batcher.step_idx,
                                   "rid": req.rid, "tier": req.tier,
                                   "reason": reason})

        admit()
        shed_slo()
        view = batcher.device_view()
        ar_c = torch.arange(C, dtype=torch.int32, device=dev)
        bidx = torch.arange(B, device=dev)

        def upload(a):
            return torch.as_tensor(a, device=dev)

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
                pstate = _to_device(self._policy.recalibrate(pstate,
                                                             thresh_now),
                                    dev)
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
            poison_np = faults.poison_steps(step0, stride, view.rids)
            poison = upload(poison_np) if poison_np.any() else None
            t0 = time.time()
            for req in live.values():
                if req.admitted_at is None:
                    req.admitted_at = t0

            cache = self.state
            tok = upload(hs["token"])
            act = upload(view.active)
            rem = upload(view.remaining)
            prog = upload(view.prefilled)
            prompt_len = upload(view.prompt_len)
            prompt_buf = upload(hs["prompt_buf"])
            gens = hs["gens"]
            rows = {"emitted": [], "first": [], "failed": [], "pf": [],
                    "base": []}
            if capture:
                rows.update(access=[], tier=[])
            if overlap:
                staged = control.mask_plan_lanes(staged, upload(stale))
                stale[:] = False
            for n_step in range(stride):
                pf, dec = control.lane_modes(act, prog, prompt_len)
                cap = int(caps[n_step])
                # decode plane: skipped on steps with no decoding lane
                # (its stats row is filtered at the boundary anyway; in
                # overlap mode the staged plan waits)
                if bool(dec.any()):
                    if overlap:
                        logits, cache, pstate, staged, stats = \
                            self._decode_overlap(cache, pstate, staged,
                                                 tok, dec, mig_cap=cap)
                    else:
                        logits, cache, pstate, stats = self._decode(
                            cache, pstate, tok, dec, mig_cap=cap)
                    if poison is not None:
                        logits = torch.where((dec & poison[n_step])[:, None],
                                             float("nan"), logits)
                    # non-finite sampling guard: such a lane emits
                    # nothing, flips inactive, and completes "failed"
                    bad = dec & ~torch.isfinite(logits).all(dim=-1)
                else:
                    logits = None
                    base = torch.cat([control.occupancy(cache),
                                      torch.zeros(2, dtype=torch.int32,
                                                  device=dev)])
                    stats = (base, torch.zeros_like(cache.page_table,
                                                    dtype=torch.bool),
                             control.page_tiers(cache)) if capture \
                        else (base,)
                    bad = torch.zeros_like(dec)
                if capture:
                    # decode-plane attribution: a lane's reads count
                    # while it decodes
                    rows["access"].append(stats[1] & dec[None, :, None])
                    rows["tier"].append(stats[2])
                dec_ok = dec & ~bad
                if logits is not None:
                    nxt = sampler(logits, gens, dec_ok)
                else:
                    nxt = tok
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
                    # when the accrued budget covers the step's demand
                    want_tot = n_val.sum().to(torch.int32)
                    credits = torch.clamp_max(credits + Pb, B * C)
                    run_now = credits >= want_tot
                    n_val = torch.where(run_now, n_val, 0)
                    credits = credits - torch.where(run_now, want_tot, 0)
                crossed = torch.zeros_like(pf)
                bad0 = torch.zeros_like(pf)
                first = torch.full_like(tok, -1)
                if bool((n_val > 0).any()):
                    idx = (prog[:, None] + ar_c).clamp(0, S_cap - 1).long()
                    sl_toks = torch.gather(prompt_buf, 1, idx)
                    self._pools_ready()
                    # every lane's slice ends by here (host-side bound:
                    # a lane prefills at most C tokens a step)
                    end = int(np.minimum(view.prefilled + (n_step + 1) * C,
                                         view.prompt_len).max())
                    logits_c, cache = self.model.prefill_chunk(
                        self.params, cache, sl_toks, prog, n_val, end)
                    prog = prog + n_val
                    crossed = pf & (prog >= prompt_len)
                    last = (n_val - 1).clamp(0, C - 1).long()
                    logits1 = logits_c[bidx, last]
                    if poison is not None:
                        # a lane poisoned at its first token fails
                        # before emitting anything
                        logits1 = torch.where(
                            (pf & poison[n_step])[:, None], float("nan"),
                            logits1)
                    bad0 = crossed & ~torch.isfinite(logits1).all(dim=-1)
                    crossed = crossed & ~bad0
                    tok0 = sampler(logits1, gens, crossed)
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
            self.state = cache
            self._pools_ready()        # the readback drains the commits
            out = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
            emitted = out["emitted"]                    # [stride, B]
            first = out["first"]
            pf_tok = out["pf"]
            failed_lane = out["failed"].any(axis=0)      # [B]
            hs["token"] = tok.cpu().numpy().copy()
            prog_np = prog.cpu().numpy()
            done_d = ~act.cpu().numpy()
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
            for lane, req in list(live.items()):
                timed_out = req.deadline_s is not None and \
                    now - req.submitted_at > req.deadline_s
                if not (req.cancel_requested or timed_out):
                    continue
                status = "cancelled" if req.cancel_requested else "timeout"
                del live[lane]
                release[lane] = True
                batcher.complete(req, status, RequestError(
                    "cancelled" if status == "cancelled"
                    else "deadline_exceeded",
                    f"reaped at step {batcher.step_idx + stride}"))
            for req in [q for q in batcher.queue
                        if q.cancel_requested or
                        (q.deadline_s is not None and
                         now - q.submitted_at > q.deadline_s)]:
                status = "cancelled" if req.cancel_requested else "timeout"
                batcher.drop_queued(
                    req, status,
                    "cancelled" if status == "cancelled"
                    else "deadline_exceeded",
                    "reaped while queued")
            stale |= release
            if release.any():
                self.state = control.release_lanes(self.state,
                                                   upload(release))
            delta = faults.pool_delta(step0, stride)
            if delta:
                batcher.resize_pool(delta)
            batcher.step_idx += stride
            # after the reaping (never both "timeout" and SLO-shed),
            # before admission refills the freed lanes
            shed_slo()
            admit()
            view = batcher.device_view()
        self._pstate = pstate
        return ServeReport.build(batcher.completed, batcher.rejected,
                                 events, eos_id=cfg.eos_id)

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
        cache = init_cache(geo, device=self.device, host_pinned=True)
        commit_seconds(cache, plan)         # warm both outside the timing
        commit_seconds(cache, empty)
        delta = min(commit_seconds(cache, plan) for _ in range(iters)) - \
            min(commit_seconds(cache, empty) for _ in range(iters))
        moved = 2 * cap * geo.page_bytes()
        return measured_link_spec(self.cfg.spec, delta, moved, rows=cap)

    def _admit_lane(self, req: Request, hs: Dict) -> None:
        """Bind an admitted request to its cache lane for chunked
        prefill: the prompt row, the carried token, and the request's
        sampling generator. No device compute."""
        lane = req.lane
        prompt = np.asarray(req.prompt).astype(np.int32).ravel()
        hs["prompt_buf"][lane, :] = 0
        hs["prompt_buf"][lane, :prompt.size] = prompt
        hs["token"][lane] = 0
        hs["gens"][lane] = lane_generator(hs["seed"], req.rid, self.device)

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
