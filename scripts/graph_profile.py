#!/usr/bin/env python3
"""Where a captured serve's device time goes, on one CUDA card: phase 4
of `chip_smoke.py` (the full-width internlm2-1.8b serve) served once,
which captures its chunks as CUDA graphs, then served again with every
chunk a replay, under torch.profiler; with `--overlap` then phase 4b
(overlap mode) the same way.

    python3 scripts/graph_profile.py [--overlap] [--no-profile] [--out DIR]

Prints the phase's lines (captures, kernel nodes per graph, per-chunk
host time, the second serve's numbers) and the profile's breakdown:
host calls, the device's busy share, kernel time by group and the
twelve largest kernels; the profiler's tables go to DIR (default
`chiprun_out/graph_profile`).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--overlap", action="store_true",
                    help="also profile phase 4b (overlap mode)")
    ap.add_argument("--no-profile", action="store_true",
                    help="serve twice without the profiler (its cost "
                    "then stays out of the second serve's wall time)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "graph_profile"))
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("graph_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    model, params = cs.full_width(0)
    out = None if args.no_profile else args.out
    cs.serve_phase(model, params, 0, profile_dir=out, again=True)
    if args.overlap:
        cs.serve_phase(model, params, 0, overlap=True, again=True,
                       profile_dir=out and os.path.join(out, "overlap"))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
