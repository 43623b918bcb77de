"""Behavioral decode-stage memory simulator (paper Section IV-A).

The port's copy of the reference's `core/simulator.py` (numpy only).

Plays an attention `Trace` against a `PlacementPolicy` on a two-tier
`MemorySystemSpec` and scores every step with the Eq.(1)-(5) latency
model. All strategies in the paper's Fig. 3/4/5 are instances of this
loop with different policies.

Byte accounting convention (see EXPERIMENTS.md §Repro for discussion):
the paper's headline 4-5.87x ratios are only reachable if the constant
per-step weight stream is *not* charged against the KV placement problem
(it is an additive constant for every strategy and would compress all
ratios to ~1.2x). We default to the paper's convention
(`include_weights=False`) and also report the weight-inclusive numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.latency_model import (
    StepTraffic, dram_latency, hbm_latency,
)
from repro_torch.core.placement.base import DRAM, HBM, UNALLOC, PlacementPolicy
from repro_torch.core.tiers import MemorySystemSpec
from repro_torch.core.traces import Trace


@dataclasses.dataclass
class SimResult:
    policy: str
    total_latency_s: float
    tokens_per_s: float
    hbm_hit_rate: float
    migrated_bytes: float
    read_bytes_hbm: float
    read_bytes_dram: float
    step_latency_s: np.ndarray
    spec_name: str
    include_weights: bool
    #: per-step traffic volumes ([steps]-arrays per field), so callers
    #: can re-aggregate across layers/requests before pricing Eq. (2)
    #: (see repro_torch.serving.trace_bridge).
    step_traffic: Optional[StepTraffic] = None

    def speedup_over(self, other: "SimResult") -> float:
        if self.total_latency_s == 0.0:
            return float("inf") if other.total_latency_s > 0.0 else 1.0
        return other.total_latency_s / self.total_latency_s


class HeteroMemSimulator:
    """One decode request's KV traffic under a placement policy."""

    def __init__(
        self,
        trace: Trace,
        spec: MemorySystemSpec,
        policy: PlacementPolicy,
        *,
        bytes_per_token_layer: int,
        num_layers: int,
        hbm_kv_budget_bytes: Optional[float] = None,
        weight_bytes: float = 0.0,
        include_weights: bool = False,
    ):
        self.trace = trace
        self.spec = spec
        self.policy = policy
        self.num_layers = num_layers
        self.bytes_per_token = bytes_per_token_layer * num_layers
        self.page_bytes = self.bytes_per_token * trace.page_tokens
        budget = spec.hbm_capacity if hbm_kv_budget_bytes is None \
            else hbm_kv_budget_bytes
        if np.isinf(budget):
            self.hbm_budget_pages = trace.num_pages + 1
        else:
            self.hbm_budget_pages = max(1, int(budget // self.page_bytes))
        self.weight_bytes = weight_bytes
        self.include_weights = include_weights

        n = trace.num_pages
        # --- state the policies may read ---
        self.placement = np.full(n, UNALLOC, dtype=np.int8)
        self.hbm_used = 0
        self.last_access = np.full(n, -1, dtype=np.int64)
        self.step = 0

    # -- state mutation helpers (capacity-checked) --------------------------
    def _apply_migrations(self, promote: np.ndarray, demote: np.ndarray
                          ) -> tuple[int, int]:
        """Apply and return (n_promoted, n_demoted) actually performed."""
        demote = demote[self.placement[demote] == HBM]
        promote = promote[self.placement[promote] == DRAM]
        # Demotions first (frees room), then promotions up to capacity.
        if len(demote):
            self.placement[demote] = DRAM
            self.hbm_used -= len(demote)
        room = self.hbm_budget_pages - self.hbm_used
        promote = promote[: max(room, 0)]
        if len(promote):
            self.placement[promote] = HBM
            self.hbm_used += len(promote)
        return len(promote), len(demote)

    def _place_new(self, pages: np.ndarray) -> tuple[float, float]:
        tiers = np.asarray(self.policy.place_new(self, pages), dtype=np.int8)
        # Enforce the capacity constraint regardless of policy behaviour.
        want_hbm = pages[tiers == HBM]
        room = self.hbm_budget_pages - self.hbm_used
        to_hbm = want_hbm[: max(room, 0)]
        to_dram = np.setdiff1d(pages, to_hbm, assume_unique=True)
        self.placement[to_hbm] = HBM
        self.placement[to_dram] = DRAM
        self.hbm_used += len(to_hbm)
        return len(to_hbm), len(to_dram)

    # -- main loop -----------------------------------------------------------
    def run(self) -> SimResult:
        tr, spec = self.trace, self.spec
        self.policy.reset(self)

        # Group pages by birth step ONCE (one argsort) instead of scanning
        # `page_born == s` every step — the per-step scan made long-trace
        # policy sweeps quadratic in trace length.
        born_order = np.argsort(tr.page_born, kind="stable").astype(np.int64)
        born_starts = np.searchsorted(tr.page_born, np.arange(
            tr.num_steps + 1), sorter=born_order)

        def born_at(s: int) -> np.ndarray:
            return born_order[born_starts[s]:born_starts[s + 1]]

        # Pages alive at step 0 (the prompt) are placed before decoding
        # starts; the paper charges prefill placement to the prefill stage,
        # so we do not count these writes in decode latency.
        self._place_new(born_at(0))

        steps = tr.num_steps
        lat = np.zeros(steps, dtype=np.float64)
        vol = StepTraffic(*(np.zeros(steps, dtype=np.float64)
                            for _ in range(6)))
        hits = 0
        reads = 0
        migrated = 0.0
        hbm_read_total = 0.0
        dram_read_total = 0.0

        for s in range(steps):
            self.step = s
            # 1. new pages born this step
            if s > 0:
                born = born_at(s)
                if len(born):
                    self._place_new(born)
            # one decoded token's KV is appended every step
            new_tier_hbm = self.placement[_newest_page(tr, s)] == HBM
            h_write = self.bytes_per_token if new_tier_hbm else 0.0
            e_write = 0.0 if new_tier_hbm else self.bytes_per_token

            # 2. proactive migrations
            p, d = self.policy.migrations(self, s)
            n_p, n_d = self._apply_migrations(np.asarray(p, dtype=np.int64),
                                              np.asarray(d, dtype=np.int64))

            # 3. reads
            acc = np.nonzero(tr.access[s])[0]
            in_hbm = self.placement[acc] == HBM
            n_hbm = int(in_hbm.sum())
            n_dram = len(acc) - n_hbm
            self.last_access[acc] = s

            # 4. reactive migrations (charged this step as well)
            rp, rd = self.policy.on_access(self, s, acc)
            rn_p, rn_d = self._apply_migrations(
                np.asarray(rp, dtype=np.int64), np.asarray(rd, dtype=np.int64))

            m_in = (n_p + rn_p) * self.page_bytes
            m_out = (n_d + rn_d) * self.page_bytes
            h_read = n_hbm * self.page_bytes
            e_read = n_dram * self.page_bytes
            if self.include_weights:
                h_read += self.weight_bytes

            t = StepTraffic(h_read=h_read, e_read=e_read, h_write=h_write,
                            e_write=e_write, m_in=m_in, m_out=m_out)
            lat[s] = max(hbm_latency(t, spec), dram_latency(t, spec))
            for field in ("h_read", "e_read", "h_write", "e_write",
                          "m_in", "m_out"):
                getattr(vol, field)[s] = getattr(t, field)

            hits += n_hbm
            reads += len(acc)
            migrated += m_in + m_out
            hbm_read_total += h_read
            dram_read_total += e_read

        total = float(lat.sum())
        return SimResult(
            policy=self.policy.name,
            total_latency_s=total,
            tokens_per_s=(steps / total if total > 0 else float("inf")),
            hbm_hit_rate=(hits / reads if reads else 1.0),
            migrated_bytes=migrated,
            read_bytes_hbm=hbm_read_total,
            read_bytes_dram=dram_read_total,
            step_latency_s=lat,
            spec_name=spec.name,
            include_weights=self.include_weights,
            step_traffic=vol,
        )


def _newest_page(tr: Trace, step: int) -> int:
    """Index of the page receiving the token decoded at `step`."""
    token = tr.prompt_len + step
    return min(token // tr.page_tokens, tr.num_pages - 1)
