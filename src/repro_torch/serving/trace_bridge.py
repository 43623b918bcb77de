"""Live-telemetry -> simulator bridge (the port of the reference's
`serving/trace_bridge.py`).

With `EngineConfig.trace_telemetry` every decode step of `step`,
`run` and `generate` keeps lane 0's page read set and read-time
placement ([L, P] each) in `ServingEngine._trace_log`. `collect`
stacks them into a `TelemetryRecord`; from it the bridge

  1. prices the live policy's ACHIEVED placement with the Eq. (1)-(5)
     model the simulator uses (`live_traffic` — reads from the captured
     access x tier, migrations from tier transitions, writes by the
     newest page's tier, weights excluded);
  2. replays the SAME access pattern through the simulator's oracles
     (`layer_trace` -> `core.simulator`): the SA-guided upper bound, the
     Belady oracle and the static baseline, each per layer under the
     live engine's per-layer HBM page budget;
  3. sums per-layer traffic per step before the Eq. (2) max and reports
     `bound_fraction = T_sa / T_live` (1.0: the live policy matched the
     foresight bound) and `headroom_vs_static = T_static / T_live`.

Serve streams go through the same loop under continuous batching: with
`trace_telemetry` every serve step keeps EVERY lane's read set (decode
plane only) and read-time placement, stamped with the chunk's
lane->request bindings. `collect_serve` stacks the chunks, `attribute`
stitches each REQUEST's rows (lanes are reused across admissions, so
identity comes from the bindings, never the lane number) into a
per-request `TelemetryRecord`, and `score_serve` prices the aggregate
stream (per-lane traffic summed per step before the Eq. (2) max) and
each request against SA / Belady / static; `goodput_curve` turns that
into goodput under scaled SLO targets.

Everything here is host numpy over records read back from the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.experiment import Workload, run_strategy
from repro_torch.core.latency_model import StepTraffic, step_latency
from repro_torch.core.placement.base import DRAM, HBM, UNALLOC
from repro_torch.core.traces import Trace


@dataclasses.dataclass
class TelemetryRecord:
    """One lane's decode stream as the simulator sees the world.

    access[s, l, p]: layer l read logical page p at decode step s.
    tier[s, l, p]:   page p's placement when step s's reads ran
                     (post-decode, pre-migration): HBM / DRAM /
                     UNALLOC tier codes from `core.placement.base`.
    moves[s]:        (promotes, demotes) the planner executed at step
                     s, summed over layers and lanes (cross-check for
                     the per-layer transition counts).
    """

    access: np.ndarray       # bool  [S, L, P]
    tier: np.ndarray         # int8  [S, L, P]
    moves: np.ndarray        # int32 [S, 2]
    page_tokens: int
    prompt_len: int          # tokens cached when the stream started
    page_bytes: int          # per-layer bytes of one page
    hbm_pages: int           # per-layer HBM slots (the live budget)

    @property
    def num_steps(self) -> int:
        """Decode steps captured in this record."""
        return self.access.shape[0]

    @property
    def num_layers(self) -> int:
        """Attention layers captured per step."""
        return self.access.shape[1]

    @property
    def num_pages(self) -> int:
        """Logical page slots per layer (the cache's max_pages)."""
        return self.access.shape[2]


def collect(engine) -> TelemetryRecord:
    """Stack an engine's captured telemetry chunks into one record.

    Drive pattern: construct the engine with
    `EngineConfig(trace_telemetry=True, ...)`, `start(prompts)` (which
    resets the log), then any mix of `step`/`run`/`generate`.
    """
    if not getattr(engine, "_trace_log", None):
        raise ValueError(
            "no trace telemetry captured — construct the engine with "
            "EngineConfig(trace_telemetry=True), start() it, and drive "
            "step()/run()/generate() before collect()")
    base = np.concatenate([c[0] for c in engine._trace_log])
    access = np.concatenate([c[1] for c in engine._trace_log])
    tier = np.concatenate([c[2] for c in engine._trace_log])
    geo = engine.geo
    return TelemetryRecord(
        access=access.astype(bool), tier=tier.astype(np.int8),
        moves=base[:, 2:4].astype(np.int32),
        page_tokens=geo.page_tokens,
        prompt_len=int(engine._trace_prompt_len),
        page_bytes=int(geo.page_bytes()), hbm_pages=int(geo.hbm_pages))


def layer_trace(rec: TelemetryRecord, layer: int) -> Trace:
    """One layer's captured stream as a simulator `Trace`.

    Logical page ids, page birth steps, and the per-step access mask
    transfer 1:1 — the live engine's per-layer placement problem IS the
    simulator's single-request problem (same page axis, same
    `prompt_len + step` newest-page arithmetic).
    """
    S = rec.num_steps
    exists = rec.tier[:, layer] != UNALLOC                  # [S, P]
    born = np.where(exists.any(axis=0), exists.argmax(axis=0),
                    S + 1).astype(np.int32)
    access = rec.access[:, layer] & exists
    alive = born[None, :] <= np.arange(S)[:, None]
    sparsity = 1.0 - access.sum() / max(int(alive.sum()), 1)
    tr = Trace(access=access, page_born=born,
               page_tokens=rec.page_tokens, prompt_len=rec.prompt_len,
               decode_len=S, sparsity=float(sparsity))
    tr.validate()
    return tr


def layer_migrations(rec: TelemetryRecord, layer: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(promotes[S], demotes[S]) for one layer, recovered from tier
    transitions: the migration applied at the end of step s is visible
    as step s+1's read-time placement (the final step's moves are
    unobservable and charged as zero — one step of slack out of S)."""
    t = rec.tier[:, layer]
    promote = (t[:-1] == DRAM) & (t[1:] == HBM)
    demote = (t[:-1] == HBM) & (t[1:] == DRAM)
    z = np.zeros((1,), np.int64)
    return (np.concatenate([promote.sum(axis=1), z]),
            np.concatenate([demote.sum(axis=1), z]))


def live_traffic(rec: TelemetryRecord) -> StepTraffic:
    """Per-step traffic volumes of the live stream, aggregated over
    layers, under the simulator's byte-accounting conventions (reads
    from the access x placement product, one appended token per layer
    per step charged to the newest page's tier, weights excluded)."""
    S, L, P = rec.access.shape
    hbm_hit = rec.access & (rec.tier == HBM)
    n_h = hbm_hit.sum(axis=(1, 2))
    n_e = rec.access.sum(axis=(1, 2)) - n_h
    m_in = np.zeros(S, np.int64)
    m_out = np.zeros(S, np.int64)
    for layer in range(L):
        p, d = layer_migrations(rec, layer)
        m_in += p
        m_out += d
    newest = np.minimum((rec.prompt_len + np.arange(S))
                        // rec.page_tokens, P - 1)           # [S]
    new_tier = rec.tier[np.arange(S)[:, None],
                        np.arange(L)[None, :],
                        newest[:, None]]                     # [S, L]
    bytes_per_token = rec.page_bytes / rec.page_tokens
    return StepTraffic.from_page_counts(
        n_hbm_read=n_h, n_dram_read=n_e, n_promote=m_in, n_demote=m_out,
        page_bytes=rec.page_bytes,
        h_write=(new_tier == HBM).sum(axis=1) * bytes_per_token,
        e_write=(new_tier == DRAM).sum(axis=1) * bytes_per_token)


def hit_fraction(rec: TelemetryRecord) -> float:
    """Fraction of page reads served from HBM over the whole stream."""
    reads = int(rec.access.sum())
    hits = int((rec.access & (rec.tier == HBM)).sum())
    return hits / reads if reads else 1.0


def score_headroom(rec: TelemetryRecord, spec, *,
                   oracles: Sequence[str] = ("sa", "belady"),
                   sa_cfg=None) -> Dict[str, float]:
    """Score a live stream against the simulator's bounds.

    Replays each oracle (plus the static baseline) per layer on the
    bridged traces under the live per-layer HBM budget, sums per-layer
    traffic per step, and prices everything with the identical Eq.(2)
    max. Returns a flat dict:

      live_total_s, live_hit_fraction, static_total_s, <oracle>_total_s,
      bound_fraction (= sa_total_s / live_total_s when "sa" is among
      the oracles), headroom_vs_static (= static_total_s / live_total_s
      — the live policy's speedup over never migrating; the SA bound's
      value of the same ratio is the paper's headline headroom).
    """
    live = live_traffic(rec)
    live_total = float(np.sum(step_latency(live, spec)))
    out: Dict[str, float] = {
        "steps": float(rec.num_steps),
        "live_total_s": live_total,
        "live_hit_fraction": hit_fraction(rec),
    }
    names = dict.fromkeys(tuple(oracles) + ("static",))   # ordered dedupe
    for name in names:
        agg = oracle_traffic(rec, name, spec, sa_cfg=sa_cfg)
        out[f"{name}_total_s"] = float(np.sum(step_latency(agg, spec)))
    if live_total > 0:
        if "sa" in oracles:
            out["bound_fraction"] = out["sa_total_s"] / live_total
        out["headroom_vs_static"] = out["static_total_s"] / live_total
    return out


def oracle_traffic(rec: TelemetryRecord, name: str, spec, *,
                   sa_cfg=None) -> StepTraffic:
    """Per-step traffic of oracle `name` replayed on `rec`'s bridged
    traces under the live per-layer HBM page budget, summed over layers
    (layers execute within one decode step, so their volumes add before
    the Eq. (2) max). The building block `score_headroom` and
    `score_serve` share, exposed so callers can re-aggregate across
    requests before pricing."""
    wl = Workload(bytes_per_token_layer=rec.page_bytes // rec.page_tokens,
                  num_layers=1)
    budget_bytes = float(rec.hbm_pages * rec.page_bytes)
    agg: Optional[StepTraffic] = None
    for layer in range(rec.num_layers):
        res = run_strategy(name, layer_trace(rec, layer), spec, wl,
                           budget_bytes, sa_cfg=sa_cfg)
        agg = res.step_traffic if agg is None else agg + res.step_traffic
    return agg


# --------------------------------------------------------------------------
# serve streams: capture, per-request stitching, and attribution scoring
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ServeTraceRecord:
    """A full continuous-batching serve stream's decode-plane telemetry.

    Per captured step s and batch lane b:

    access[s, l, b, p]:  layer l of lane b read logical page p while
                         DECODING at step s (prefilling / inactive
                         lanes contribute no reads — prefill writes are
                         outside the access model).
    tier[s, l, b, p]:    page p's read-time placement (post-decode,
                         pre-migration) — HBM / DRAM / UNALLOC codes.
    emitted[s, b]:       the token lane b decoded at step s, -1 if the
                         lane did not decode (prefilling, crossing, or
                         idle). The stitching predicate.
    first[s, b]:         the first token sampled at lane b's
                         prefill->decode crossing, -1 elsewhere
                         (a prefill-plane event, excluded from traces).
    rids[s, b]:          the request bound to lane b during step s's
                         chunk, -1 when the lane is free. Lane indices
                         are REUSED across admissions; this is the
                         identity channel.
    prompt_len[s, b]:    the bound request's prompt length in tokens.
    """

    access: np.ndarray       # bool  [S, L, B, P]
    tier: np.ndarray         # int8  [S, L, B, P]
    emitted: np.ndarray      # int32 [S, B]
    first: np.ndarray        # int32 [S, B]
    rids: np.ndarray         # int32 [S, B]
    prompt_len: np.ndarray   # int32 [S, B]
    page_tokens: int
    page_bytes: int          # per-layer bytes of one page
    hbm_pages: int           # per-layer HBM slots (the live budget)

    @property
    def num_steps(self) -> int:
        """Captured serve steps (prefill-only steps included)."""
        return self.access.shape[0]

    @property
    def num_lanes(self) -> int:
        """Batch lanes (serve slots) in the stream."""
        return self.access.shape[2]


@dataclasses.dataclass
class RequestAttribution:
    """One request's stitched slice of a serve stream.

    `record` is the request's decode stream in exactly the shape the
    single-stream bridge emits (so `layer_trace` / `live_traffic` /
    `score_headroom` apply verbatim); `rows` maps each of its steps
    back to the global serve step axis (for cross-request aggregation)
    and `lanes` names the lane it occupied there. `record.moves` is
    recovered from tier transitions — the planner's counts aggregate
    over lanes and cannot be attributed per request."""

    rid: int
    record: TelemetryRecord
    rows: np.ndarray         # int64 [S_r] global serve step indices
    lanes: np.ndarray        # int64 [S_r] lane occupied at each row


def collect_serve(engine) -> ServeTraceRecord:
    """Stack a serve stream's captured telemetry chunks into one record.

    Drive pattern: construct the engine with
    `EngineConfig(trace_telemetry=True, ...)` and call
    `serve(requests)`; each chunk boundary logs the chunk's read sets,
    placements, emitted/first tokens, and lane->request bindings
    (fixed within a chunk — admission happens only at boundaries).
    A meshed engine's log is already the whole stream's on every rank:
    each chunk's per-lane trace rows are all-gathered over `data` at
    its one readback (`ServingEngine._global_rows`), so rank 0 (or any
    rank) scores the whole stream.
    """
    log = getattr(engine, "_serve_trace_log", None)
    if not log:
        raise ValueError(
            "no serve trace telemetry captured — construct the engine "
            "with EngineConfig(trace_telemetry=True) and drive serve() "
            "before collect_serve()")
    def tile(chunk, row):
        n = chunk[0].shape[0]
        return np.broadcast_to(row, (n,) + row.shape)

    geo = engine.geo
    return ServeTraceRecord(
        access=np.concatenate([c[0] for c in log]).astype(bool),
        tier=np.concatenate([c[1] for c in log]).astype(np.int8),
        emitted=np.concatenate([c[2] for c in log]).astype(np.int32),
        first=np.concatenate([c[3] for c in log]).astype(np.int32),
        rids=np.concatenate([tile(c, c[4]) for c in log]).astype(np.int32),
        prompt_len=np.concatenate([tile(c, c[5])
                                   for c in log]).astype(np.int32),
        page_tokens=geo.page_tokens, page_bytes=int(geo.page_bytes()),
        hbm_pages=int(geo.hbm_pages))


def attribute(rec: ServeTraceRecord) -> List[RequestAttribution]:
    """Stitch each request's decode stream out of a serve record.

    A request's trace is the ordered set of (step, lane) cells where
    its lane DECODED (`emitted >= 0`) while bound to it (`rids`
    matches) — admission, the prefill phase, the first-token crossing,
    and reclaim all fall outside the predicate, so two requests reusing
    the same lane can never cross-contaminate: the earlier request's
    rows end before its release, the later one's begin after its own
    prefill, and the released lane's cleared page table (tier UNALLOC)
    never reaches either record. Requests that decoded zero steps
    (max_new_tokens == 1: only the crossing token) have no access
    pattern to score and are omitted. Ordered by first decode step.
    """
    decoded = rec.emitted >= 0                              # [S, B]
    out: List[RequestAttribution] = []
    for rid in np.unique(rec.rids[rec.rids >= 0]):
        mask = (rec.rids == rid) & decoded
        rows, lanes = np.nonzero(mask)
        if rows.size == 0:
            continue
        access = rec.access[rows, :, lanes]                 # [S_r, L, P]
        tier = rec.tier[rows, :, lanes]
        record = TelemetryRecord(
            access=access, tier=tier,
            moves=np.zeros((rows.size, 2), np.int32),
            page_tokens=rec.page_tokens,
            prompt_len=int(rec.prompt_len[rows[0], lanes[0]]),
            page_bytes=rec.page_bytes, hbm_pages=rec.hbm_pages)
        moves = np.zeros((rows.size, 2), np.int64)
        for layer in range(record.num_layers):
            p, d = layer_migrations(record, layer)
            moves[:, 0] += p
            moves[:, 1] += d
        record.moves = moves.astype(np.int32)
        out.append(RequestAttribution(rid=int(rid), record=record,
                                      rows=rows, lanes=lanes))
    out.sort(key=lambda a: int(a.rows[0]))
    return out


_TRAFFIC_FIELDS = ("h_read", "e_read", "h_write", "e_write",
                   "m_in", "m_out")


def _scatter(acc: Dict[str, np.ndarray], traffic: StepTraffic,
             rows: np.ndarray) -> None:
    """Add a request's per-step traffic into the global step axis."""
    for f in _TRAFFIC_FIELDS:
        val = np.broadcast_to(
            np.asarray(getattr(traffic, f), np.float64), rows.shape)
        acc[f][rows] += val


def score_serve(rec: ServeTraceRecord, spec, *,
                oracles: Sequence[str] = ("sa", "belady"),
                sa_cfg=None, report=None) -> Dict[str, object]:
    """Score a serve stream — aggregate and per request — against the
    simulator's bounds.

    Each attributed request is replayed per layer through the oracles
    (plus the static baseline) under the live per-layer HBM budget,
    exactly as `score_headroom` does for a single stream. Two views
    come out of the same replay:

      per request — the request's lane-private traffic priced in
        isolation (its own Eq. (2) max per step): `hit_fraction`,
        `bound_fraction`, and the oracle totals. This is the
        request-level attribution the ServeReport carries.
      aggregate — every request's per-step volumes scattered back onto
        the GLOBAL serve step axis and summed before the Eq. (2) max
        (lanes execute within one serve step, so their volumes add —
        the same aggregation per-layer traffic already gets). The
        aggregate `bound_fraction` is the paper's headroom under
        continuous batching.

    Returns {"aggregate": {...}, "requests": {rid: {...}}}. When
    `report` (a ServeReport) is given, stamps `report.request_scores`
    and `report.headroom` with the same dicts.

    Degraded streams score transparently: the telemetry a faulted
    serve run captured already reflects what actually happened —
    throttled migration commits, quarantined lanes' truncated traces,
    the placements a fallen-back (static-behaving) policy stopped
    improving — so the live totals here price the DEGRADED placement
    against the same bounds, which is the honest headroom under
    adversity. When the report carries degradation events
    (`ServeReport.events`, see `serving.faults`), their count
    and the policy-fallback flag are stamped into the aggregate so a
    scored stream names the faults that shaped it.
    """
    atts = attribute(rec)
    S = rec.num_steps
    names = dict.fromkeys(tuple(oracles) + ("static",))   # ordered dedupe
    acc = {"live": {f: np.zeros(S) for f in _TRAFFIC_FIELDS}}
    for name in names:
        acc[name] = {f: np.zeros(S) for f in _TRAFFIC_FIELDS}

    requests: Dict[int, Dict[str, float]] = {}
    for att in atts:
        r = att.record
        live = live_traffic(r)
        _scatter(acc["live"], live, att.rows)
        live_total = float(np.sum(step_latency(live, spec)))
        sc: Dict[str, float] = {
            "steps": float(r.num_steps),
            "live_total_s": live_total,
            "hit_fraction": hit_fraction(r),
        }
        for name in names:
            tr = oracle_traffic(r, name, spec, sa_cfg=sa_cfg)
            _scatter(acc[name], tr, att.rows)
            sc[f"{name}_total_s"] = float(np.sum(step_latency(tr, spec)))
        if live_total > 0:
            if "sa" in oracles:
                sc["bound_fraction"] = sc["sa_total_s"] / live_total
            sc["headroom_vs_static"] = sc["static_total_s"] / live_total
        requests[att.rid] = sc

    reads = int(rec.access.sum())
    hits = int((rec.access & (rec.tier == HBM)).sum())
    agg: Dict[str, float] = {
        "steps": float(S),
        "decode_steps": float(int((rec.emitted >= 0).any(axis=1).sum())),
        "requests": float(len(atts)),
        "live_hit_fraction": hits / reads if reads else 1.0,
        "live_total_s": float(np.sum(step_latency(
            StepTraffic(**acc["live"]), spec))),
    }
    for name in names:
        agg[f"{name}_total_s"] = float(np.sum(step_latency(
            StepTraffic(**acc[name]), spec)))
    if agg["live_total_s"] > 0:
        if "sa" in oracles:
            agg["bound_fraction"] = agg["sa_total_s"] / agg["live_total_s"]
        agg["headroom_vs_static"] = \
            agg["static_total_s"] / agg["live_total_s"]

    if report is not None:
        if getattr(report, "events", None):
            agg["fault_events"] = float(len(report.events))
            agg["policy_fallback"] = float(any(
                e.get("kind") == "policy_fallback"
                for e in report.events))
        report.request_scores.update(requests)
        report.headroom.update(agg)
    return {"aggregate": agg, "requests": requests}


def goodput_curve(rec: ServeTraceRecord, spec, report, policy, *,
                  scales: Sequence[float] = (0.25, 0.5, 1.0, 2.0,
                                             4.0, 8.0),
                  latency: str = "modeled",
                  sa_cfg=None) -> Dict[str, object]:
    """Goodput-under-SLO curve for one served stream, scored against
    the live SA bound.

    Runs `score_serve` once (stamping `report.request_scores`, which
    the modeled-latency goodput view reads), then scores the report's
    terminal statuses + latencies against the SLO `policy` at each
    target scale (`serving.slo.score_goodput`). The curve pairs
    with the aggregate `bound_fraction`: a policy can only convert
    placement headroom into goodput at the scales where latency — not
    admission — is the binding constraint, which is exactly what the
    per-policy curves in `BENCH_engine.json["rows"]["goodput"]` show
    (see `benchmarks/perf_engine.py --goodput-sweep`).
    """
    from repro_torch.serving.slo import score_goodput

    scored = score_serve(rec, spec, report=report, sa_cfg=sa_cfg)
    curve = [score_goodput(report, policy, scale=s, latency=latency)
             for s in scales]
    return {"aggregate": scored["aggregate"], "curve": curve}
