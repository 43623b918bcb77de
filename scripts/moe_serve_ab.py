#!/usr/bin/env python3
"""Phases 7 and 15a of `chip_smoke.py` (granite-moe-3b-a800m's
full-width serve, then the same stream on a world-size-1 NCCL mesh) for
one or more checkouts, each in a process of its own, in the order given,
on one CUDA card.

    python3 scripts/moe_serve_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR \\
        PARENT_DIR [--phases 3e 7 15a]

Each process imports its checkout's `chip_smoke.py` and `src/`, builds
that checkout's kernels, and runs the phases named (default: 7 and 15a;
3e, the moe smoke serves on the card against the CPU, runs first when
named), printing each phase's summary lines with its checkout's label
(`P` for the first directory given, `C` for any other), then its wall
time. Give the directories so that neither side always runs first (P C
C P). A checkout whose phase 7 serves once prints one serve; one whose
serves are captured also prints the stream served again on the same
engine and its numbers beside the eager serve's.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

#: the lines each phase prints that carry its numbers
KEEP = ("serve moe", "mesh moe serve", "moe parity", "phase ", "card ")
SKIP = ("chunks (prefill", "served again, chunks", "kernel nodes")


def one(tree: str, phases) -> None:
    """The phases of `tree`'s `chip_smoke.py` in this process."""
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import time
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)

    def phase(name, fn):
        t = time.time()
        out = fn()
        cs.log(f"phase {name}: {time.time() - t:.1f} s wall")
        return out
    phase("build", lambda: build.build_all(force=True))
    if "3e" in phases:
        phase("moe parity", lambda: cs.moe_parity_phase(0))
    if "7" in phases:
        model, params = phase("moe model", lambda: cs.full_width(
            0, "granite-moe-3b-a800m"))
        _, numbers = phase("moe", lambda: cs.moe_phase(model, params, 0))
        if "15a" in phases:
            phase("mesh moe serve", lambda: cs.mesh_moe_serve_phase(
                model, params, 0, numbers))
    print("card", cs.card_line(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--phases", nargs="+", default=["7", "15a"],
                    choices=["3e", "7", "15a"])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one, args.phases)
        return 0
    first = os.path.abspath(args.trees[0])
    for tree in map(os.path.abspath, args.trees):
        label = "P" if tree == first else "C"
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--one", tree,
             "--phases", *args.phases], capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith(KEEP) and not any(s in line for s in SKIP):
                print(label, line, flush=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
