#!/usr/bin/env python3
"""Phase 4 of `chip_smoke.py` (the full-width serve) for two checkouts,
in alternating processes on one CUDA card.

    python3 scripts/serve_ab.py PARENT_DIR CHANGE_DIR [--rounds 5]
                                [--overlap] [--big NAME]

Each process imports one checkout's `chip_smoke.py` and `src/`, builds
its kernels, makes the full-width model and runs the serve twice (the
first run pays first-use costs); it prints one line per serve,
`<label> <run> serve: ... tokens/s ...`, and, for a checkout whose
`serve_phase` takes `again` (the fused drive mode: a new engine's first
serve captures its chunks as CUDA graphs), the same stream served again
on the same engine, every chunk a replay,
`<label> <run> serve: served again on the same engine: ...`; with
`--overlap` it then
runs phase 4b (overlap mode, pinned host pools) twice as well,
`<label> <run> serve overlap: ...`, and its measured payback line;
with `--big NAME` then once phase 9's overlap serve of the config
NAME (`big_serve_phase`), its line and its payback line. The
serve lines carry the migrated bytes and the hit rate. The processes
go P C C P
(P = parent, C = change), repeated for `--rounds` pairs, so neither
side always runs first. It reads checkouts whose `serve_phase` makes
its own model (`serve_phase(seed)`) or takes one
(`serve_phase(model, params, seed)`).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys


def one(tree: str, label: str, overlap: bool = False,
        big: str = "") -> None:
    """Two serves of `tree`'s phase 4 in this process (then two of 4b
    with `overlap`, then one of phase 9's overlap serve of `big`)."""
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import inspect
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if hasattr(cs, "full_width"):
        from repro_torch.kernels import build
        build.build_all()
        model = cs.full_width(0)

        if "again" in inspect.signature(cs.serve_phase).parameters:
            kw_again = {"again": True}
        else:
            kw_again = {}

        def serve(**kw):
            cs.serve_phase(*model, 0, **kw, **kw_again)
    else:
        from repro_torch.kernels import paged_attention as pa
        pa.build()

        def serve(**kw):
            cs.serve_phase(0, **kw)

    def show(run, fn):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        for line in buf.getvalue().splitlines():
            if " s wall" in line or "measured payback" in line:
                line = line.split("; captures")[0]
                print(label, run, line, flush=True)
    for kw in ({}, {"overlap": True}) if overlap else ({},):
        for run in range(2):
            show(run, lambda: serve(**kw))
    if big:
        model = None                # the big config takes the card
        show(0, lambda: cs.big_serve_phase(big, 0, overlap=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--overlap", action="store_true",
                    help="also serve phase 4b (overlap mode) twice a process")
    ap.add_argument("--big", default="",
                    help="then serve phase 9's overlap serve of this "
                         "config once a process")
    ap.add_argument("--one", nargs=2, metavar=("TREE", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(os.path.abspath(args.one[0]), args.one[1], args.overlap,
            args.big)
        return 0
    if not (args.parent and args.change):
        ap.error("PARENT_DIR and CHANGE_DIR are required")
    order = ("P", "C", "C", "P") * ((args.rounds + 1) // 2)
    trees = {"P": os.path.abspath(args.parent),
             "C": os.path.abspath(args.change)}
    for label in order[:2 * args.rounds]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             trees[label], label] + ["--overlap"] * args.overlap
            + ["--big", args.big] * bool(args.big),
            check=False)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
