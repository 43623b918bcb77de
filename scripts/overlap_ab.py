#!/usr/bin/env python3
"""Phase 4 (inline) against phase 4b (overlap mode: host pools pinned,
commits on a side stream, measured payback) of `chip_smoke.py`, in one
process on one CUDA card, in alternating order.

    python3 scripts/overlap_ab.py [--rounds 3] [--profile DIR]

Builds the kernels, makes the full-width model once, warms both modes
with one serve each, then serves I O O I I O ... (I = inline, O =
overlap) for `--rounds` pairs, so neither mode always runs first; one
line per serve, then the median tokens/s, TTFT p50 and TPOT p50 of each
mode. With `--profile DIR`, one more serve of each mode runs under
torch.profiler and prints where its device time goes (the profiler's
cost is in those two serves' wall time, which is not counted).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("overlap_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    model, params = cs.full_width(args.seed)

    def serve(overlap: bool, quiet: bool = True):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf) if quiet else \
                contextlib.nullcontext():
            return cs.serve_phase(model, params, args.seed,
                                  overlap=overlap)[1]

    serve(False)                      # first-use costs of each mode
    serve(True)
    order = (False, True, True, False) * ((args.rounds + 1) // 2)
    got = {False: [], True: []}
    for overlap in order[:2 * args.rounds]:
        n = serve(overlap)
        got[overlap].append(n)
        print(f"{'overlap' if overlap else 'inline '} tokens/s "
              f"{n['tokens_per_s']:.1f} TTFT p50 {n['ttft_p50']:.3f} s "
              f"TPOT p50 {n['tpot_p50'] * 1e3:.2f} ms hit rate "
              f"{n['hit_rate']:.4f} migrated {n['migrated']:.0f} peak "
              f"{n['peak_bytes'] / 1e9:.2f} GB", flush=True)
    for overlap, runs in got.items():
        med = {k: statistics.median(r[k] for r in runs)
               for k in ("tokens_per_s", "ttft_p50", "tpot_p50")}
        print(f"median {'overlap' if overlap else 'inline'} "
              f"({len(runs)} serves): tokens/s {med['tokens_per_s']:.1f} "
              f"TTFT p50 {med['ttft_p50']:.3f} s TPOT p50 "
              f"{med['tpot_p50'] * 1e3:.2f} ms", flush=True)
    if args.profile:
        for overlap in (False, True):
            name = "overlap" if overlap else "inline"
            t0 = time.time()
            _, prof = cs.profiled(lambda: serve(overlap))
            torch.cuda.synchronize()
            print(f"profile of one {name} serve:", flush=True)
            cs.breakdown(prof, time.time() - t0,
                         os.path.join(args.profile, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
