#!/usr/bin/env python3
"""Time variants of the hand-written kernels' tuning constants on one
CUDA card, beside the committed choice.

    python3 scripts/kernel_variants.py [--flash-stages N ...]
                                       [--paged-per-sm N ...]

Flash: each variant is `csrc/flash_attention.cu` with `kStages` (the
depth of its TMA ring of K/V tiles) replaced, built with the nvcc
flags of `kernels/build.py` into `build/variants/`, checked against
the plain version (bf16 tolerance 1e-2) and timed at the prefill shape
of `chip_smoke.py` phase 5 (B=4, S=2304, H=16/8, D=128, causal) by
CUDA-graph replay; each runs in its own process under a time limit.
Paged: the kernel as committed, at `chip_smoke.py` phase 2's shapes
(N=64 and 208), with its page range split for each given number of
CTAs per SM. Prints one line per variant and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def build_flash(stage_counts):
    """One nvcc per variant, all at once; returns {tag: library path}."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir = os.path.join(build.build_dir(), "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for stages in stage_counts:
        text, n = re.subn(r"constexpr int kStages = \d+;",
                          f"constexpr int kStages = {stages};", src)
        assert n == 1
        tag = f"stages{stages}"
        cu = os.path.join(out_dir, f"flash_{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = cu[:-3] + ".so"
        procs[tag] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            print(f"flash {tag}: nvcc failed\n{report[-2000:]}", flush=True)
            continue
        lines = report.splitlines()
        for i, line in enumerate(lines):    # the D=128 bf16 body
            if "Function properties" in line and "wgmma_kernelILi128" in line:
                print(f"flash {tag}: ptxas {lines[i + 1].strip()} | "
                      f"{lines[i + 2].strip()}", flush=True)
        libs[tag] = lib
    return libs


def time_flash(tag, lib_path):
    """Check and time one built variant (runs in its own process)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    lib = ctypes.CDLL(lib_path)
    fn = lib.flash_attention_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 9
                   + [i32, ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    fa._library = lambda: lib
    torch.manual_seed(0)
    dev = torch.device("cuda")
    B, S, H, KH, D = 4, 2304, 16, 8, 128
    sets = [tuple(torch.randn(shape, device=dev, dtype=torch.bfloat16)
                  for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
            for _ in range(3)]                  # 3 x 113 MB beat the L2
    got = fa.flash_attention(*sets[0])
    want = ref.flash_attention_ref(*sets[0])
    err = float((got.float() - want.float()).abs().max())
    ms = cs.device_ms(lambda i: fa.flash_attention(*sets[i % 3]), 3)
    flops = cs.flash_work(B, S, H, KH, D, True, 2)[1]
    print(f"flash {tag}: device {ms:.4f} ms  {flops / ms / 1e9:.1f} "
          f"TFLOP/s  max err {err:.3e} (tolerance 1e-2)", flush=True)
    if not err <= 1e-2:
        raise SystemExit(f"flash {tag} disagrees with the plain version")


def time_paged(per_sm_values):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    committed = pa.launch_plan
    rng = np.random.default_rng(0)
    B, KH, G, HD, T = 8, 8, 2, 128, 16
    for N in (64, 208):
        copies = 8 if N == 64 else 3                # beat the 50 MB L2
        sets = [cs.paged_inputs(rng, B, KH, G, HD, N, T, torch.bfloat16,
                                dev) for _ in range(copies)]
        for per_sm in per_sm_values:
            def plan(B, KH, G, HD, T, N, itemsize, sm_count, per_sm=per_sm):
                warps = committed(B, KH, G, HD, T, N, itemsize,
                                  sm_count).warps
                return pa.Plan(*pa.choose_splits(B, KH, N, sm_count, per_sm,
                                                 2 * warps), warps)
            pa.launch_plan = plan
            got = pa.paged_attention(*sets[0])
            want = ref.paged_attention_ref(*sets[0])
            err = float((got[0].float() - want[0].float()).abs().max())
            ms = cs.device_ms(lambda i: pa.paged_attention(
                *sets[i % copies]), copies)
            print(f"paged N={N} CTAs per SM {per_sm}: "
                  f"{plan(B, KH, G, HD, T, N, 2, sms)} device {ms:.4f} ms "
                  f"max err out {err:.3e}", flush=True)
        pa.launch_plan = committed
        del sets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flash-stages", nargs="*", type=int, default=[2, 3],
                    help="TMA ring depths (2 is committed)")
    ap.add_argument("--paged-per-sm", nargs="*", type=int,
                    default=[1, 2, 4])
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    if args.one:
        time_flash(*args.one)
        return 0
    failed = 0
    for tag, lib in build_flash(args.flash_stages).items():
        try:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--one", tag, lib], timeout=180).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        failed += rc != 0
        if rc != 0:
            print(f"flash {tag}: exit {rc}", flush=True)
    time_paged(args.paged_per_sm)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
