"""Live-telemetry -> simulator bridge for the single-stream path (the
port of the reference's `serving/trace_bridge.py`, lines 69-251).

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

Everything here is host numpy over records read back from the card.
The serve-stream half (`collect_serve`, `attribute`, `score_serve`,
`goodput_curve`) arrives with the port's serve-trace slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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
