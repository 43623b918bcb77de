#!/usr/bin/env python3
"""Time variants of the hand-written kernels' tuning constants on one
CUDA card, beside the committed choice.

    python3 scripts/kernel_variants.py [--flash-stages N ...]
                                       [--bwd KEYWGS,STAGES,SPLIT ...]
                                       [--bwd-file PATH ...]
                                       [--paged-per-sm N ...]
                                       [--copy TAG ...]

Flash: each variant is `csrc/flash_attention.cu` with `kStages` (the
depth of its TMA ring of K/V tiles) replaced, built with the nvcc
flags of `kernels/build.py` into `build/variants/`, checked against
the plain version (bf16 tolerance 1e-2) and timed at the prefill shape
of `chip_smoke.py` phase 5 (B=4, S=2304, H=16/8, D=128, causal) by
CUDA-graph replay; each runs in its own process under a time limit.
Backward: each variant is `csrc/flash_attention_bwd.cu` with
`kKeyWgs` (64-key blocks of a dkdv CTA: key block 64 or 128),
`kBwdStages` (the depth of its TMA rings) and `kSplitAbove` (padded
head dims past it give dK its own warpgroup; 0 splits at every D)
replaced, checked against the plain version (1e-2 of each gradient's
max |value|, two runs bitwise equal) and timed at phase 12's training
shape (B=8, S=512, H=16/8, D=128, bf16, causal), in the same way, with
each of its three kernels' mean time under torch.profiler. A
`--bwd-file` (another checkout's `flash_attention_bwd.cu`, with the
same C entry point) is built as it is and timed before the variants
and again after them. Each variant's directory gets a copy of the
`csrc/` headers its source includes.
Paged: the kernel as committed, at `chip_smoke.py` phase 2's shapes
(N=64 and 208), with its page range split for each given number of
CTAs per SM.
Row copy (`--copy`, tags of COPY_VARIANTS): each design of
`csrc/page_copy.cu` (`kDesign` 1, bulk copies through a shared ring,
by chunk bytes, ring depth and CTAs per SM; `kDesign` 0, 16-byte
vector loads, by threads, vectors per thread and the load's cache
qualifiers), checked exact against the plain version and timed at
`chip_smoke.py` phase 2c's shapes (a commit's 1,152 pages of 32 KB
gathered out of a pinned pool, scattered into it, gathered on the
card, and in the pool's order; one layer's decode token write), each
in its own process; then
one contiguous `copy_` of the same bytes each way (the copy engine's
rate). Prints one line per variant and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def build_variants(source, variants):
    """`csrc/<source>.cu` with constants replaced, one nvcc per variant,
    all at once; variants {tag: {constant: value}}. Returns {tag:
    (library path, ptxas' report)}."""
    from repro_torch.kernels import build
    src = (build.CSRC / f"{source}.cu").read_text()
    out_dir = os.path.join(build.build_dir(), "variants")
    os.makedirs(out_dir, exist_ok=True)
    for header in build.headers(source):
        shutil.copyfile(header, os.path.join(out_dir, header.name))
    procs = {}
    for tag, consts in variants.items():
        text = src
        for name, value in consts.items():
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            assert n == 1, name
        cu = os.path.join(out_dir, f"{source}_{tag}.cu")
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
            print(f"{source} {tag}: nvcc failed\n{report[-2000:]}",
                  flush=True)
            continue
        libs[tag] = (lib, report)
    return libs


def build_flash(stage_counts):
    """The forward's ring depths; returns {tag: library path}."""
    import chip_smoke as cs
    libs = build_variants("flash_attention", {
        f"stages{n}": {"kStages": n} for n in stage_counts})
    for tag, (_, report) in libs.items():    # the D=128 bf16 body
        for name, (regs, st, ld) in cs.ptxas_usage(report).items():
            if name == "flash_wgmma_kernel<128>":
                print(f"flash {tag}: ptxas {regs} registers, spill stores "
                      f"{st} bytes, spill loads {ld} bytes", flush=True)
    return {tag: lib for tag, (lib, _) in libs.items()}


def build_bwd_files(paths):
    """Backward sources as they are (another checkout's), one nvcc each,
    all at once; returns {tag: library path}."""
    from repro_torch.kernels import build
    out_dir = os.path.join(build.build_dir(), "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, path in enumerate(paths):
        lib = os.path.join(out_dir, f"flash_attention_bwd_file{i}.so")
        procs[f"file{i}"] = (path, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (path, lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            print(f"bwd {tag} ({path}): nvcc failed\n{report[-2000:]}",
                  flush=True)
            continue
        print(f"bwd {tag}: {path}", flush=True)
        libs[tag] = lib
    return libs


def build_bwd(specs):
    """The backward's (kKeyWgs, kBwdStages, kSplitAbove) variants;
    returns {tag: library path}."""
    import chip_smoke as cs
    variants = {}
    for spec in specs:
        key_wgs, stages, split = (int(x) for x in spec.split(","))
        variants[f"kb{64 * key_wgs}_st{stages}_split{split}"] = {
            "kKeyWgs": key_wgs, "kBwdStages": stages,
            "kSplitAbove": split}
    libs = build_variants("flash_attention_bwd", variants)
    for tag, (_, report) in libs.items():    # the D=128 bodies
        for name, (regs, st, ld) in cs.ptxas_usage(report).items():
            if "wgmma" in name and "<128" in name:
                print(f"bwd {tag}: ptxas {name} {regs} registers, spill "
                      f"stores {st} bytes, spill loads {ld} bytes",
                      flush=True)
    return {tag: lib for tag, (lib, _) in libs.items()}


#: the row copy's designs by tag: the constants of csrc/page_copy.cu
COPY_VARIANTS = {
    # design 1, bulk copies: chunk bytes, ring depth, CTAs per SM
    "bulk_c32k_s2_p3": {"kDesign": 1, "kChunk": 32768, "kStages": 2,
                        "kCtasPerSm": 3},                  # committed
    "bulk_c8k_s4_p4": {"kDesign": 1, "kChunk": 8192, "kStages": 4,
                       "kCtasPerSm": 4},
    "bulk_c16k_s4_p3": {"kDesign": 1, "kChunk": 16384, "kStages": 4,
                        "kCtasPerSm": 3},
    "bulk_c4k_s8_p4": {"kDesign": 1, "kChunk": 4096, "kStages": 8,
                       "kCtasPerSm": 4},
    "bulk_c32k_s3_p2": {"kDesign": 1, "kChunk": 32768, "kStages": 3,
                        "kCtasPerSm": 2},
    "bulk_c32k_s2_p1": {"kDesign": 1, "kChunk": 32768, "kStages": 2,
                        "kCtasPerSm": 1},
    "bulk_c32k_s3_p1": {"kDesign": 1, "kChunk": 32768, "kStages": 3,
                        "kCtasPerSm": 1},
    "bulk_c32k_s6_p1": {"kDesign": 1, "kChunk": 32768, "kStages": 6,
                        "kCtasPerSm": 1},
    "bulk_c32k_s2_p2": {"kDesign": 1, "kChunk": 32768, "kStages": 2,
                        "kCtasPerSm": 2},
    "bulk_c16k_s4_p1": {"kDesign": 1, "kChunk": 16384, "kStages": 4,
                        "kCtasPerSm": 1},
    "bulk_c8k_s4_p1": {"kDesign": 1, "kChunk": 8192, "kStages": 4,
                       "kCtasPerSm": 1},
    # design 0, vector loads: threads, vectors a thread, no-allocate
    "vector_t256_u4": {"kDesign": 0, "kThreads": 256, "kUnroll": 4,
                       "kLoad": 0},                  # the earlier design
    "vector_t128_u8_nc": {"kDesign": 0, "kThreads": 128, "kUnroll": 8,
                          "kLoad": 1},
    "vector_t64_u16_nc": {"kDesign": 0, "kThreads": 64, "kUnroll": 16,
                          "kLoad": 1},
    # ... with an L2 fetch of 256 bytes a miss (.L2::256B)
    "vector_t256_u4_nc256": {"kDesign": 0, "kThreads": 256, "kUnroll": 4,
                             "kLoad": 2},
    "vector_t256_u4_l2_256": {"kDesign": 0, "kThreads": 256, "kUnroll": 4,
                              "kLoad": 3},
    "vector_t128_u8_nc256": {"kDesign": 0, "kThreads": 128, "kUnroll": 8,
                             "kLoad": 2},
}


def build_copy(tags):
    """The row copy's designs; returns {tag: library path}."""
    import chip_smoke as cs
    libs = build_variants("page_copy", {t: COPY_VARIANTS[t] for t in tags})
    for tag, (_, report) in libs.items():
        for name, (regs, st, ld) in cs.ptxas_usage(report).items():
            print(f"copy {tag}: ptxas {name} {regs} registers, spill "
                  f"stores {st} bytes, spill loads {ld} bytes", flush=True)
    return {tag: lib for tag, (lib, _) in libs.items()}


def time_copy(tag, lib_path):
    """Check and time one built row-copy design (own process) at phase
    2c's shapes."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import page_copy as pc
    lib = ctypes.CDLL(lib_path)
    lib.page_copy_launch.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.page_copy_launch.restype = ctypes.c_int
    pc._library = lambda: lib
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    moves, x = cs.page_moves(rng, dev)
    ok = True
    for mv in moves:
        mv["kernel"](0)
        mv["plain"](0)
        torch.cuda.synchronize()
        same = mv["exact"]()
        ok &= same
        card = mv["way"] == "card -> card"
        ms = cs.device_ms(mv["kernel"], 1) if card \
            else cs.eager_ms(mv["kernel"], 20)
        print(f"copy {tag} {mv['name']} ({mv['way']}): exact {same}  "
              f"{'device' if card else 'eager (20 calls)'} {ms:.4f} ms  "
              f"{x['bytes'] / ms / 1e6:.2f} GB/s", flush=True)
    # the same bytes out of the pinned pool's first pages, in order: what
    # the gather reads when its pages lie together
    pool, staged = x["pool"], x["staged"]
    first = tuple(torch.as_tensor(c.astype(np.int32), device=dev)
                  for c in np.unravel_index(np.arange(x["cap"]),
                                            pool.shape[:3]))
    got = torch.empty_like(staged)
    ms = cs.eager_ms(lambda i: pc.page_copy((got, (None,), pool, first)), 20)
    same = torch.equal(got, pool.view(-1, *staged.shape[1:])[
        :x["cap"]].to(dev))
    ok &= same
    print(f"copy {tag} gather (pinned -> card, the pool's first pages in "
          f"order): exact {same}  eager (20 calls) {ms:.4f} ms  "
          f"{x['bytes'] / ms / 1e6:.2f} GB/s", flush=True)
    write, check, _ = cs.token_write_case(rng, dev, x["geo"], False)
    same, launches = check()
    ok &= same and launches == 1
    print(f"copy {tag} token write (K and V, both tiers, one lane "
          f"inactive): exact {same}, {launches} launch, device "
          f"{cs.device_ms(write, 1):.4f} ms  eager "
          f"{cs.eager_ms(write, 200):.4f} ms", flush=True)
    if not ok:
        raise SystemExit(f"copy {tag} disagrees with the plain version")


#: the bytes of phase 2c's page moves: 1,152 pages of 16 x 8 x 128 bf16
COPY_BYTES = 1152 * 16 * 8 * 128 * 2


def copy_engine(nbytes):
    """One contiguous `copy_` of `nbytes` each way between pinned host
    memory and the card (20 calls, CUDA events)."""
    import torch
    import chip_smoke as cs
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    for way, dst, src in (("pinned -> card", card, host),
                          ("card -> pinned", host, card)):
        ms = cs.eager_ms(lambda i: dst.copy_(src, non_blocking=True), 20)
        print(f"copy_ {way}: {nbytes / 1e6:.2f} MB contiguous  {ms:.4f} ms  "
              f"{nbytes / ms / 1e6:.2f} GB/s", flush=True)


def time_flash(tag, lib_path):
    """Check and time one built variant (runs in its own process)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    lib = ctypes.CDLL(lib_path)
    fn = lib.flash_attention_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 9
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
    flops = cs.flash_work(B, S, S, H, KH, D, True, 2)[1]
    print(f"flash {tag}: device {ms:.4f} ms  {flops / ms / 1e9:.1f} "
          f"TFLOP/s  max err {err:.3e} (tolerance 1e-2)", flush=True)
    if not err <= 1e-2:
        raise SystemExit(f"flash {tag} disagrees with the plain version")


def time_bwd(tag, lib_path):
    """Check and time one built backward variant (own process)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    lib = ctypes.CDLL(lib_path)
    fn = lib.flash_attention_bwd_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 10 + [i32] * 6 + [i64] * 9
                   + [i32, ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    fa._bwd_library = lambda: lib
    torch.manual_seed(0)
    dev = torch.device("cuda")
    B, S, H, KH, D = 8, 512, 16, 8, 128

    def inputs():
        q = torch.randn((B, S, H, D), device=dev, dtype=torch.bfloat16)
        k = torch.randn((B, S, KH, D), device=dev, dtype=torch.bfloat16)
        v = torch.randn((B, S, KH, D), device=dev, dtype=torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        return q, k, v, out, torch.randn_like(out), lse
    sets = [inputs() for _ in range(3)]      # 3 x 101 MB beat the L2
    got = fa.flash_attention_bwd(*sets[0])
    again = fa.flash_attention_bwd(*sets[0])
    want = ref.flash_attention_bwd_ref(*sets[0])
    rel = max(float((a.float() - b.float()).abs().max()
                    / b.float().abs().max()) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ms = cs.device_ms(lambda i: fa.flash_attention_bwd(*sets[i % 3]), 3)
    flops = cs.flash_bwd_work(B, S, S, H, KH, D, True, 2)[1]
    print(f"bwd {tag}: device {ms:.4f} ms  {flops / ms / 1e9:.1f} "
          f"TFLOP/s (2.5x the forward's flops)  max err {rel:.3e} of max "
          f"|grad| (tolerance 1e-2), bitwise {same}", flush=True)
    split = kernel_split(lambda i: fa.flash_attention_bwd(*sets[i % 3]))
    print(f"bwd {tag}: {split}", flush=True)
    if not (rel <= 1e-2 and same):
        raise SystemExit(f"bwd {tag} disagrees with the plain version")


def kernel_split(fn, calls: int = 30) -> str:
    """Mean device microseconds a call of each kernel of fn(i) takes
    under torch.profiler, over `calls` calls: the Δ pre-pass, dkdv and
    dq of a backward."""
    import torch
    import chip_smoke as cs
    fn(0)
    torch.cuda.synchronize()
    _, prof = cs.profiled(lambda: [fn(i) for i in range(calls)]
                          + [torch.cuda.synchronize()])
    times = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = next((k for k in ("delta", "dkdv", "dq") if f"{k}_" in e.name),
                    "other")
        times[part] = times.get(part, 0.0) + e.time_range.elapsed_us()
    if not times:
        return "profile: no device time (not measured)"
    return "profile: " + "  ".join(
        f"{k} {v / calls:.1f} us" for k, v in times.items()) + \
        f" (mean of {calls} calls)"


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
    ap.add_argument("--bwd", nargs="*",
                    default=["1,2,128", "2,2,128", "1,3,128", "1,2,0"],
                    help="backward variants kKeyWgs,kBwdStages,kSplitAbove "
                    "(1,2,128 is committed)")
    ap.add_argument("--bwd-file", nargs="*", default=[],
                    help="backward sources timed as they are, before and "
                    "after the variants")
    ap.add_argument("--paged-per-sm", nargs="*", type=int,
                    default=[1, 2, 4])
    ap.add_argument("--copy", nargs="*", default=list(COPY_VARIANTS),
                    choices=list(COPY_VARIANTS),
                    help="row-copy designs (bulk_c32k_s2_p3 is committed)")
    ap.add_argument("--one", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    if args.one:
        kind, tag, lib = args.one
        {"flash": time_flash, "bwd": time_bwd,
         "copy": time_copy}[kind](tag, lib)
        return 0
    failed = 0
    runs = [("flash", tag, lib)
            for tag, lib in build_flash(args.flash_stages).items()]
    files = [("bwd", tag, lib)
             for tag, lib in build_bwd_files(args.bwd_file).items()]
    runs += files
    runs += [("bwd", tag, lib) for tag, lib in build_bwd(args.bwd).items()]
    runs += files
    runs += [("copy", tag, lib) for tag, lib in build_copy(args.copy).items()]
    for kind, tag, lib in runs:
        try:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--one", kind, tag, lib],
                                timeout=180).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        failed += rc != 0
        if rc != 0:
            print(f"{kind} {tag}: exit {rc}", flush=True)
    if args.paged_per_sm:
        time_paged(args.paged_per_sm)
    if args.copy:
        copy_engine(COPY_BYTES)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
