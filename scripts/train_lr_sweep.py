#!/usr/bin/env python3
"""Phase 12's training run (`chip_smoke.py`: internlm2-1.8b at full width
and depth, random bf16 weights with no f32 master copy, B=8 x S=512
tokens from `SyntheticCorpus`, remat, 6 steps) under several learning
rates, with and without a warm-up, for several seeds, on one CUDA card.

    python3 scripts/train_lr_sweep.py [--seeds 0 1 2 3] [--steps 6]

A rate is a constant or `cosine_schedule(step, peak_lr, warmup,
total=steps)`. Prints each run's losses and grad norms, and for each
rate the seeds whose loss at the last step is below the first step's
(phase 12's check) and the smallest such fall. Then phase 12c
(`chip_smoke.train_witness_phase`) for each seed.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (label, constant lr, or (peak lr, warm-up steps) of `cosine_schedule`)
RATES = (("1e-4", 1e-4), ("2e-4", 2e-4), ("5e-4", 5e-4), ("1e-3", 1e-3),
         ("warm 3 to 5e-4", (5e-4, 3)), ("warm 3 to 1e-3", (1e-3, 3)),
         ("warm 3 to 2e-3", (2e-3, 3)), ("warm 6 to 1e-3", (1e-3, 6)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import cosine_schedule
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    print(cs.card_line())
    model = Model(configs.get("internlm2-1.8b"))
    falls = {label: {} for label, _ in RATES}
    for seed in args.seeds:
        batches = cs.train_batches(model.cfg.vocab, seed, args.steps)
        for label, rate in RATES:
            lr = rate if isinstance(rate, float) else (
                lambda step, peak=rate[0], warm=rate[1]: cosine_schedule(
                    step, peak_lr=peak, warmup=warm, total=args.steps))
            step_fn = make_train_step(model, lr=lr)
            state = init_train_state(model, seed, "cuda")
            losses, norms = [], []
            for tokens in batches:
                state, m = step_fn(state, {"tokens": tokens})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            del state
            cs.free_card()
            falls[label][seed] = losses[0] - losses[-1]
            print(f"seed {seed} lr {label}: losses "
                  f"{[round(x, 4) for x in losses]} grad norms "
                  f"{[round(x, 3) for x in norms]}", flush=True)
    for label, by_seed in falls.items():
        fell = [s for s, f in by_seed.items() if f > 0]
        print(f"lr {label}: the loss fell in {len(fell)} of {len(by_seed)} "
              f"seeds {fell}; falls {[round(f, 4) for f in by_seed.values()]}")
    for seed in args.seeds:
        cs.train_witness_phase(seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
