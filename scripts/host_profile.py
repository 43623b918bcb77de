#!/usr/bin/env python3
"""Where the host's time goes in phase 4 of `chip_smoke.py` (the
full-width inline serve), by cProfile, on one CUDA card.

    python3 scripts/host_profile.py [TREE] [--top 25]

TREE is a checkout (default: this one), e.g. a parent unpacked by `git
archive` into a gitignored directory, so two trees can be profiled in
one call. Builds the kernels, makes the full-width model, serves once
unprofiled (first-use costs), then once under cProfile, and prints the
serve's line, the functions with the most time of their own, and the
port's functions by cumulative time. The profiler's cost is in the
profiled serve's wall time; compare trees only by the same script.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import os
import pstats
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", nargs="?", default=ROOT)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    if not torch.cuda.is_available():
        print("host_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    model = cs.full_width(0)
    with contextlib.redirect_stdout(io.StringIO()):
        cs.serve_phase(*model, 0)
    prof = cProfile.Profile()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prof.enable()
        cs.serve_phase(*model, 0)
        prof.disable()
    print(tree, *[x for x in out.getvalue().splitlines() if " s wall" in x])
    stats = pstats.Stats(prof)
    stats.sort_stats("tottime").print_stats(args.top)
    stats.sort_stats("cumulative").print_stats("repro_torch", 2 * args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
