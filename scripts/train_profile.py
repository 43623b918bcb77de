#!/usr/bin/env python3
"""Where a full-width training step's time goes (phase 12 of
`chip_smoke.py`: internlm2-1.8b, 24 layers, B=8 x S=512, remat, lr
1e-4), on one CUDA card.

    python3 scripts/train_profile.py [--steps 3] [--out DIR]

Builds the kernels, makes the train state from seed 0 and warms up two
steps. Then, per step, the host clock (each part ended by a
synchronize) splits the step into the loss's forward + backward
(`value_and_grad`) and the AdamW update; and one more step runs under
torch.profiler: the device's busy share and its kernel time by group
and by kernel (`chip_smoke.breakdown`; the profiler's table goes to
DIR, default build/train_profile). The profiled step's wall time
includes the profiler's cost.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "train_profile"))
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_step import (
        TrainState, init_train_state, make_train_step, value_and_grad)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    print(cs.card_line())
    cfg = configs.get("internlm2-1.8b")
    model = Model(cfg)
    state = init_train_state(model, 0, "cuda")
    batches = cs.train_batches(cfg.vocab, 0, 3 + args.steps)
    step_fn = make_train_step(model, lr=cs.TRAIN_LR)
    for tokens in batches[:2]:
        state, _ = step_fn(state, {"tokens": tokens})
    torch.cuda.synchronize()
    fwd_bwd, update = [], []
    for tokens in batches[2:2 + args.steps]:
        t = time.time()
        _, grads = value_and_grad(model, state.params, tokens)
        torch.cuda.synchronize()
        fwd_bwd.append(time.time() - t)
        t = time.time()
        params, opt = adamw_update(grads, state.opt, state.params,
                                   lr=cs.TRAIN_LR)
        torch.cuda.synchronize()
        update.append(time.time() - t)
        del grads
        state = TrainState(params=params, opt=opt)
        del params, opt
    print(f"train step split over {args.steps} steps (median): forward + "
          f"backward {statistics.median(fwd_bwd) * 1e3:.1f} ms, AdamW "
          f"update {statistics.median(update) * 1e3:.1f} ms")
    t = time.time()
    (state, _), prof = cs.profiled(
        lambda: step_fn(state, {"tokens": batches[-1]}))
    torch.cuda.synchronize()
    wall = time.time() - t
    print(f"profiled step: {wall * 1e3:.1f} ms wall")
    cs.breakdown(prof, wall, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
