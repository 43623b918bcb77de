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

    python3 scripts/train_profile.py --mesh [--rounds 3] [--out DIR]

The price of the meshed step (phase 14a): on a world-size-1 NCCL mesh
(a `file://` store in a temporary directory), after two warm-up steps
of each, `make_train_step` unmeshed (P) and `make_train_step(...,
mesh=)` (M) each take a step from the same state (its result dropped,
so the card holds one train state) in the order P M M P, `--rounds`
times, each timed by the host clock up to a synchronize; then one step
of each under torch.profiler, broken down as above (the tables go to
DIR/plain and DIR/mesh).
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
    ap.add_argument("--mesh", action="store_true",
                    help="time and profile the meshed step (world size 1) "
                         "against the unmeshed one")
    ap.add_argument("--rounds", type=int, default=3)
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
    if args.mesh:
        return mesh_ab(args)
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


def mesh_ab(args) -> int:
    """`--mesh`: the unmeshed and the meshed step, P M M P, then one of
    each profiled."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    tmp = tempfile.mkdtemp(prefix="train_profile_mesh_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        cfg = configs.get("internlm2-1.8b")
        model = Model(cfg)
        mesh = make_test_mesh(1, 1)
        state = init_train_state(model, 0, "cuda")
        tokens = cs.train_batches(cfg.vocab, 0, 1)[0]
        steps = {"plain": make_train_step(model, lr=cs.TRAIN_LR),
                 "mesh": make_train_step(model, lr=cs.TRAIN_LR, mesh=mesh)}

        def one(name):
            t = time.time()
            _, m = steps[name](state, {"tokens": tokens})
            float(m["loss"])
            torch.cuda.synchronize()
            return time.time() - t
        for name in ("plain", "mesh", "plain", "mesh"):
            one(name)                                    # warm-up
        times = {"plain": [], "mesh": []}
        for _ in range(args.rounds):
            for name in ("plain", "mesh", "mesh", "plain"):
                times[name].append(one(name))
        for name, ts in times.items():
            print(f"train step {name}: median "
                  f"{statistics.median(ts) * 1e3:.1f} ms of "
                  f"{[round(t * 1e3, 1) for t in ts]}")
        for name in ("plain", "mesh"):
            t = time.time()
            _, prof = cs.profiled(lambda: one(name))
            wall = time.time() - t
            print(f"profiled {name} step: {wall * 1e3:.1f} ms wall")
            cs.breakdown(prof, wall, os.path.join(args.out, name))
        return 0
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
