"""Simulated-annealing search over the (W, R) knobs (paper Section III-B).

The port's copy of the reference's `core/sa.py` (numpy only).

The SA state is the pair (W, R): look-ahead window and migration ratio.
Faithful to the paper:

  * proposal operators sampled with probabilities (0.4, 0.4, 0.2):
      (i)   window move  dW in {+-1, +-2}, R fixed
      (ii)  ratio move   dR in {+-0.1},   W fixed
      (iii) diagonal move: one perturbation of each kind simultaneously
  * Metropolis rule  P(accept) = exp(-dT / C)
  * initial temperature calibrated to an initial acceptance ratio
    p0 = 0.8 over uphill moves
  * geometric cooling with alpha = 0.9
  * termination when the best latency improves < 0.1% across successive
    temperature levels, when C falls below a cutoff, or at an iteration
    budget.

The objective T(W, R) is one full simulator run; evaluations are
memoized because the discrete (W, R) lattice is small and SA revisits
points frequently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np

State = Tuple[int, float]


@dataclasses.dataclass
class SAResult:
    best_state: State
    best_latency: float
    history: List[Tuple[int, State, float, bool]]  # (iter, state, T, accepted)
    evaluations: int
    temperature_levels: int
    accept_attribution: Dict[str, int]  # accepted improvements per operator


@dataclasses.dataclass
class SAConfig:
    p0: float = 0.8                # target initial acceptance ratio
    alpha: float = 0.9             # cooling rate
    iters_per_level: int = 20
    stop_rel_improvement: float = 1e-3   # 0.1%
    min_temperature_frac: float = 1e-4   # cutoff relative to C0
    max_evaluations: int = 400
    w_min: int = 1
    w_max: int = 64
    r_step: float = 0.1
    seed: int = 0


def _clip_state(w: int, r: float, cfg: SAConfig) -> State:
    w = int(min(max(w, cfg.w_min), cfg.w_max))
    r = round(min(max(r, 0.0), 1.0), 6)
    return w, r


def _propose(state: State, rng: np.random.Generator,
             cfg: SAConfig) -> Tuple[State, str]:
    w, r = state
    u = rng.random()
    if u < 0.4:                       # (i) window move
        dw = int(rng.choice([-2, -1, 1, 2]))
        return _clip_state(w + dw, r, cfg), "dW"
    if u < 0.8:                       # (ii) ratio move
        dr = float(rng.choice([-cfg.r_step, cfg.r_step]))
        return _clip_state(w, r + dr, cfg), "dR"
    dw = int(rng.choice([-2, -1, 1, 2]))          # (iii) diagonal
    dr = float(rng.choice([-cfg.r_step, cfg.r_step]))
    return _clip_state(w + dw, r + dr, cfg), "dWdR"


def anneal(objective: Callable[[int, float], float],
           init: State = (8, 0.5),
           cfg: SAConfig | None = None) -> SAResult:
    cfg = cfg or SAConfig()
    rng = np.random.default_rng(cfg.seed)
    cache: Dict[State, float] = {}
    evals = 0

    def T(state: State) -> float:
        nonlocal evals
        if state not in cache:
            cache[state] = float(objective(*state))
            evals += 1
        return cache[state]

    cur = _clip_state(*init, cfg)
    cur_T = T(cur)
    best, best_T = cur, cur_T

    # --- temperature calibration: sample uphill moves, set C0 so the mean
    # uphill dT is accepted with probability p0.
    uphill = []
    probe = cur
    for _ in range(16):
        cand, _op = _propose(probe, rng, cfg)
        dT = T(cand) - T(probe)
        if dT > 0:
            uphill.append(dT)
        probe = cand
        if evals >= cfg.max_evaluations // 4:
            break
    mean_up = float(np.mean(uphill)) if uphill else max(cur_T * 0.01, 1e-12)
    C0 = -mean_up / math.log(cfg.p0)
    C = C0

    history: List[Tuple[int, State, float, bool]] = []
    attribution = {"dW": 0, "dR": 0, "dWdR": 0}
    level = 0
    it = 0
    prev_level_best = best_T

    while evals < cfg.max_evaluations and C > C0 * cfg.min_temperature_frac:
        for _ in range(cfg.iters_per_level):
            if evals >= cfg.max_evaluations:
                break
            cand, op = _propose(cur, rng, cfg)
            cand_T = T(cand)
            dT = cand_T - cur_T
            accept = dT <= 0 or rng.random() < math.exp(-dT / C)
            if accept:
                if cand_T < cur_T:
                    attribution[op] += 1
                cur, cur_T = cand, cand_T
                if cur_T < best_T:
                    best, best_T = cur, cur_T
            history.append((it, cand, cand_T, accept))
            it += 1
        level += 1
        # stop when best improves < 0.1% across successive levels
        if prev_level_best - best_T < cfg.stop_rel_improvement * prev_level_best:
            break
        prev_level_best = best_T
        C *= cfg.alpha

    return SAResult(best_state=best, best_latency=best_T, history=history,
                    evaluations=evals, temperature_levels=level,
                    accept_attribution=attribution)
