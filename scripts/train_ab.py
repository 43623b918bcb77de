#!/usr/bin/env python3
"""ms a step and peak memory of the training configurations of
`chip_smoke.py`'s phases 12, 12b, 14a, 15c, 16a and 19b, for one or more
checkouts, each in a process of its own, in the order given, on one
CUDA card: the donated step with the fused AdamW kernels against a
checkout whose step is pure and whose update is plain PyTorch.

    python3 scripts/train_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR \\
        PARENT_DIR [--cells train "moe train" ...] [--steps 3]

Each process imports its checkout's `src/` and `chip_smoke.py`, builds
that checkout's kernels and runs each cell: the train state from seed
0, one warm-up step, then `--steps` timed steps (each by the host clock
up to a synchronize; xlstm-125m's sLSTM loop takes seconds a step, so
it takes one), through `make_train_step(..., donate=True)` where the
checkout's step takes `donate`, else the pure step. A cell's peak is
`max_memory_allocated` from before its state is made. Each cell prints
one JSON line, labelled `P` (the first directory) or `C`: {"cell",
"donate", "ms" (the median), "step_ms", "peak_gb", "loss"}, or
{"cell", "oom": true, "peak_gb"} where it does not fit the card. Give
the directories so that neither side always runs first (P C C P).

Cells:
  train          internlm2-1.8b, 24 layers, B=8 x S=512 (phase 12)
  train resume   the same at 2 layers (12b)
  mesh train     phase 12's step on a world-size-1 NCCL mesh (14a)
  moe train 16   granite-moe-3b-a800m at 16 of its 32 layers
  moe train      granite-moe-3b-a800m at 32 layers (15c)
  family train NAME   internvl2-2b, whisper-tiny, zamba2-1.2b and
                 xlstm-125m with their patch / frame embeddings (16a)
  mesh family train NAME   the same on a world-size-1 NCCL mesh (16a)
  kv train step  internlm2-1.8b at 4 layers in f32, the logits 128
                 positions a chunk (19b's unmeshed steps)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FAMILY = ("internvl2-2b", "whisper-tiny", "zamba2-1.2b", "xlstm-125m")
CELLS = ("train", "train resume", "mesh train", "moe train 16",
         "moe train", *(f"family train {a}" for a in FAMILY),
         *(f"mesh family train {a}" for a in FAMILY), "kv train step")


def cell_setup(cs, cell):
    """(config, make_train_step keywords, batch extras, steps) of a
    cell (a meshed cell's are its unmeshed twin's)."""
    import dataclasses
    import torch
    from repro_torch import configs
    cell = cell.removeprefix("mesh ")
    if cell == "train":
        return configs.get("internlm2-1.8b"), {}, {}, None
    if cell == "train resume":
        return dataclasses.replace(configs.get("internlm2-1.8b"),
                                   num_layers=2), {}, {}, None
    if cell.startswith("moe train"):
        layers = 16 if cell.endswith(" 16") else 32
        return dataclasses.replace(configs.get("granite-moe-3b-a800m"),
                                   num_layers=layers), {}, {}, None
    if cell.startswith("family train "):
        cfg = configs.get(cell.split()[-1])
        extra = cs.family_batch_extra(cfg, 0)
        return cfg, {"extra_keys": tuple(extra)}, extra, \
            1 if cfg.family == "xlstm" else None
    cfg = dataclasses.replace(configs.get("internlm2-1.8b"),
                              num_layers=cs.KV_STEP_LAYERS,
                              dtype=torch.float32,
                              param_dtype=torch.float32)
    return cfg, {"lr": cs.KV_STEP_LR, "logit_chunk": cs.KV_STEP_CHUNK}, \
        {}, None


def run_cell(cs, cell, steps, mesh):
    """The cell's JSON record."""
    import inspect
    import statistics
    import time
    import torch
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    cfg, kw, extra, own_steps = cell_setup(cs, cell)
    steps = own_steps or steps
    model = Model(cfg)
    kw = {"lr": cs.TRAIN_LR, **kw}
    if mesh is not None:
        kw["mesh"] = mesh
    donate = "donate" in inspect.signature(make_train_step).parameters
    if donate:
        kw["donate"] = True
    step = make_train_step(model, **kw)
    batches = cs.train_batches(cfg.vocab, 0, steps + 1)
    cs.free_card()
    torch.cuda.reset_peak_memory_stats()
    times, loss = [], None
    try:
        state = init_train_state(model, 0, "cuda", mesh=mesh)
        for tokens in batches:
            torch.cuda.synchronize()
            t = time.time()
            state, m = step(state, {"tokens": tokens, **extra})
            loss = float(m["loss"])
            torch.cuda.synchronize()
            times.append(time.time() - t)
    except torch.cuda.OutOfMemoryError:
        peak = torch.cuda.max_memory_allocated()
        state = m = None
        cs.free_card()
        return {"cell": cell, "donate": donate, "oom": True,
                "layers": cfg.num_layers, "peak_gb": peak / 1e9}
    peak = torch.cuda.max_memory_allocated()
    del state, m
    cs.free_card()
    return {"cell": cell, "donate": donate, "layers": cfg.num_layers,
            "ms": statistics.median(times[1:]) * 1e3,
            "step_ms": [x * 1e3 for x in times], "peak_gb": peak / 1e9,
            "loss": loss}


def one(tree: str, cells, steps: int) -> None:
    """The cells of `tree` in this process."""
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    for cell in cells:
        if cell.startswith("mesh "):
            with cs.world_of_one("train_ab_mesh_") as mesh:
                record = run_cell(cs, cell, steps, mesh)
        else:
            record = run_cell(cs, cell, steps, None)
        print("record", json.dumps(record), flush=True)
    print("card", cs.card_line(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--cells", nargs="+", default=list(CELLS),
                    choices=CELLS)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one, args.cells, args.steps)
        return 0
    first = os.path.abspath(args.trees[0])
    for tree in map(os.path.abspath, args.trees):
        label = "P" if tree == first else "C"
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--one", tree,
             "--steps", str(args.steps), "--cells", *args.cells],
            capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith(("record ", "card ")):
                print(label, line, flush=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
