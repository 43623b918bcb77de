"""Uniform harness to score placement strategies on a trace.

The port's copy of the reference's `core/experiment.py` (numpy only).

This is what the paper's Fig. 3/4/5 are made of: one trace, one memory
spec, five (plus our extra) strategies, identical byte accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import sa as sa_mod
from repro_torch.core.placement import POLICIES, SAGuided, UnlimitedHBM
from repro_torch.core.simulator import HeteroMemSimulator, SimResult
from repro_torch.core.tiers import MemorySystemSpec
from repro_torch.core.traces import Trace


@dataclasses.dataclass
class Workload:
    """Byte-accounting parameters of the modeled model."""
    bytes_per_token_layer: int
    num_layers: int
    weight_bytes: float = 0.0

    @classmethod
    def llama31_8b(cls) -> "Workload":
        # kv_heads=8, head_dim=128, bf16, 32 layers; weights ~16 GB.
        return cls(bytes_per_token_layer=2 * 8 * 128 * 2, num_layers=32,
                   weight_bytes=16e9)


def make_sim(trace: Trace, spec: MemorySystemSpec, policy,
             workload: Workload, hbm_kv_budget_bytes: Optional[float],
             include_weights: bool = False) -> HeteroMemSimulator:
    return HeteroMemSimulator(
        trace, spec, policy,
        bytes_per_token_layer=workload.bytes_per_token_layer,
        num_layers=workload.num_layers,
        hbm_kv_budget_bytes=hbm_kv_budget_bytes,
        weight_bytes=workload.weight_bytes,
        include_weights=include_weights,
    )


def run_strategy(name: str, trace: Trace, spec: MemorySystemSpec,
                 workload: Workload,
                 hbm_kv_budget_bytes: Optional[float] = None,
                 include_weights: bool = False,
                 sa_cfg: Optional[sa_mod.SAConfig] = None,
                 policy_kwargs: Optional[dict] = None,
                 ) -> SimResult:
    """Run one named strategy; for "sa" runs the annealer first."""
    policy_kwargs = dict(policy_kwargs or {})
    if name == "unlimited":
        sim = make_sim(trace, spec, UnlimitedHBM(), workload,
                       hbm_kv_budget_bytes=float("inf"),
                       include_weights=include_weights)
        sim.hbm_budget_pages = trace.num_pages + 1
        return sim.run()
    if name == "sa":
        sa_result = tune_sa(trace, spec, workload, hbm_kv_budget_bytes,
                            include_weights=include_weights, cfg=sa_cfg)
        w, r = sa_result.best_state
        policy = SAGuided(window=w, ratio=r)
        res = make_sim(trace, spec, policy, workload, hbm_kv_budget_bytes,
                       include_weights).run()
        res.policy = f"sa(W={w},R={r:.1f})"
        return res
    cls = POLICIES[name]
    policy = cls(**policy_kwargs)
    return make_sim(trace, spec, policy, workload, hbm_kv_budget_bytes,
                    include_weights).run()


def tune_sa(trace: Trace, spec: MemorySystemSpec, workload: Workload,
            hbm_kv_budget_bytes: Optional[float],
            include_weights: bool = False,
            cfg: Optional[sa_mod.SAConfig] = None) -> sa_mod.SAResult:
    def objective(w: int, r: float) -> float:
        policy = SAGuided(window=w, ratio=r)
        sim = make_sim(trace, spec, policy, workload, hbm_kv_budget_bytes,
                       include_weights)
        return sim.run().total_latency_s
    return sa_mod.anneal(objective, cfg=cfg)


def run_all(trace: Trace, spec: MemorySystemSpec, workload: Workload,
            hbm_kv_budget_bytes: Optional[float],
            strategies=("unlimited", "static", "reactive", "quest", "sa"),
            include_weights: bool = False,
            sa_cfg: Optional[sa_mod.SAConfig] = None,
            ) -> Dict[str, SimResult]:
    return {name: run_strategy(
                name, trace, spec, workload, hbm_kv_budget_bytes,
                include_weights=include_weights, sa_cfg=sa_cfg)
            for name in strategies}
