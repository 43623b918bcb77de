#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing a line (any failure exits non-zero):

  1. build   compile the paged-attention kernel from
             src/repro_torch/csrc/ with nvcc for sm_90a.
  2. kernel  run it against the plain version (ref.paged_attention_ref)
             on the same CUDA tensors at the full-width decode shapes
             (B=8, KH=8, G=2, HD=128, T=16, N in {64, 208}, bf16 pools)
             with holes, a permuted page list, partial pages and an
             all-hole lane; time it beside the plain version and one
             scaled_dot_product_attention call over the same keys.
             Times are device times (CUDA-graph replay over input sets
             that overflow the L2); the kernel's eager per-call time,
             the host's launch cost included, is printed beside them.
  3. parity  serve a small f32 request stream on the card and on the
             CPU (the plain path) with the same weights: greedy tokens,
             statuses and per-step byte counts must match exactly.
  4. serve   ServingEngine.serve() at the full width of internlm2-1.8b
             (random bf16 weights from --seed): 12 greedy requests that
             spill into the host tier and reuse lanes; every status ok,
             every output its full budget, and the kernel launched
             2 x layers x decode-plane steps times.

Then a `kernels` JSON line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
and prints no result. `--profile DIR` runs phase 4 under torch.profiler
and prints where the device time goes.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BW = 3.35e12         # H100 SXM HBM3 bytes/s (NVIDIA datasheet)
BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
TOL = {"out": 1e-2, "m": 1e-4, "lse": 1e-4, "l_rel": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls issued from Python
    (CUDA events): the host's launch cost included, as a caller that
    launches one call at a time sees it."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, n_sets: int, reps: int = 10) -> float:
    """Device milliseconds per call: `n_sets` calls (one per input set,
    so the 50 MB L2 cannot hold them) captured into one CUDA graph and
    replayed `reps` times, timed with CUDA events. The host's launch
    cost is not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_sets):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * n_sets)
    del graph
    return ms


# --------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------

def paged_inputs(rng, B, KH, G, HD, N, T, dtype, device):
    """Decode-attention inputs with holes, a permuted page list, partial
    pages, pages listed with zero valid tokens, and an all-hole lane."""
    import torch
    P = N
    page_list = np.full((B, N), -1, np.int32)
    page_valid = np.zeros((B, N), np.int32)
    for b in range(B - 1):                      # lane B-1: all holes
        n_res = int(rng.integers(N // 2, N + 1))
        where = rng.choice(N, size=n_res, replace=False)
        page_list[b, where] = rng.permutation(P)[:n_res]
        page_valid[b, where] = T
        partial = rng.choice(where, size=max(1, n_res // 16), replace=False)
        page_valid[b, partial] = rng.integers(1, T, partial.size)
        page_valid[b, rng.choice(where)] = 0    # listed, but no token
    q = torch.randn((B, KH, G, HD), dtype=dtype, device=device)
    k = torch.randn((B, P, T, KH, HD), dtype=dtype, device=device)
    v = torch.randn((B, P, T, KH, HD), dtype=dtype, device=device)
    return (q, k, v, torch.as_tensor(page_list, device=device),
            torch.as_tensor(page_valid, device=device))


def work(inputs):
    """(bytes, flops) the function needs on these inputs: each input
    byte read once (only the valid K/V tokens), each output written
    once; 4 flops per (token, query row, head-dim element)."""
    q, k, _, page_list, page_valid = inputs
    B, KH, G, HD = q.shape
    N = page_list.shape[1]
    T = k.shape[2]
    tokens = int(page_valid.clamp(0, T)[page_list >= 0].sum())
    es = q.element_size()
    kv = 2 * tokens * KH * HD * es
    bytes_ = (q.numel() * es + kv + 2 * B * N * 4
              + q.numel() * es + 2 * B * KH * G * 4 + B * KH * G * N * 4)
    return bytes_, 4 * tokens * KH * G * HD


def dense_for_sdpa(inputs):
    """The same valid keys as a dense [B, H, N*T, HD] buffer + mask, for
    the library yardstick (built outside the timed region)."""
    import torch
    q, k, v, page_list, page_valid = inputs
    B, KH, G, HD = q.shape
    N, T = page_list.shape[1], k.shape[2]
    slot = page_list.clamp_min(0).long()
    bidx = torch.arange(B, device=q.device)[:, None]
    kd = k[bidx, slot].reshape(B, N * T, KH, HD).permute(0, 2, 1, 3)
    vd = v[bidx, slot].reshape(B, N * T, KH, HD).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(G, dim=1).contiguous()
    vd = vd.repeat_interleave(G, dim=1).contiguous()
    tok = torch.arange(T, device=q.device)
    valid = (page_list[:, :, None] >= 0) & (tok < page_valid[:, :, None])
    mask = valid.reshape(B, 1, 1, N * T)
    return q.reshape(B, KH * G, 1, HD), kd, vd, mask


def kernel_phase(rng, device):
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    B, KH, G, HD, T = 8, 8, 2, 128, 16
    shapes = []
    for N in (64, 208):
        per_copy = 2 * B * N * T * KH * HD * 2
        copies = max(2, math.ceil(256e6 / per_copy))   # beat the 50 MB L2
        sets = [paged_inputs(rng, B, KH, G, HD, N, T, torch.bfloat16, device)
                for _ in range(copies)]
        got = pa.paged_attention(*sets[0])
        want = ref.paged_attention_ref(*sets[0])
        torch.cuda.synchronize()
        err = {
            "out": float((got[0].float() - want[0].float()).abs().max()),
            "m": float((got[1] - want[1]).abs().max()),
            "l_rel": float(((got[2] - want[2]).abs()
                            / want[2].abs().clamp_min(1e-30)).max()),
            "lse": float((got[3] - want[3]).abs().max()),
        }
        empty = got[2][B - 1]
        if not bool((empty == 0).all()) or not bool((got[0][B - 1] == 0).all()):
            raise AssertionError(f"N={N}: the all-hole lane is not empty")
        bad = {k: v for k, v in err.items() if not v <= TOL[k]}
        log(f"kernel N={N}: max err out {err['out']:.3e} m {err['m']:.3e} "
            f"l(rel) {err['l_rel']:.3e} lse {err['lse']:.3e} "
            f"(tolerance {TOL})")
        if bad:
            raise AssertionError(f"kernel N={N} disagrees with the plain "
                                 f"version: {bad}")

        def kernel(i):
            return pa.paged_attention(*sets[i % copies])

        def plain(i):
            return ref.paged_attention_ref(*sets[i % copies])

        dense = [dense_for_sdpa(s) for s in sets]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def library(i):
            d = dense[i % copies]
            return sdpa(*d[:3], attn_mask=d[3])

        ms = device_ms(kernel, copies)
        plain_ms = device_ms(plain, copies)
        lib_ms = device_ms(library, copies)
        kernel_eager = eager_ms(kernel, 200)
        # the mean over the timed input sets, whose valid pages differ
        nbytes, flops = (sum(x) / copies for x in zip(*map(work, sets)))
        bound = max(nbytes / HBM_BW, flops / BF16_FLOPS) * 1e3
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        log(f"kernel N={N}: device {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"sdpa {lib_ms:.4f} ms  bound {bound:.4f} ms "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)  "
            f"eager call {kernel_eager:.4f} ms  splits "
            f"{pa.choose_splits(B, KH, N, sms)}")
        shapes.append({"N": N, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": bound,
                       "eager_ms": kernel_eager,
                       "bytes": nbytes, "flops": flops,
                       "bound_by": "bytes" if nbytes / HBM_BW
                       >= flops / BF16_FLOPS else "operations",
                       "max_abs_err": err["out"], "errors": err})
        del sets, dense
    return shapes


# --------------------------------------------------------------------------
# phases 3-4: serving
# --------------------------------------------------------------------------

def parity_phase(seed):
    """A small f32 stream, on the card and on the CPU, same weights."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.core.tiers import H100
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.scheduler import Request

    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in (300, 40, 280, 20)]
    ecfg = EngineConfig(max_context=512, policy="importance", spec=H100,
                        prefill_chunk=32, telemetry_stride=8)
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(model, params, ecfg, device=dev)
        rep = eng.serve([Request(rid=i, prompt=p, max_new_tokens=12)
                         for i, p in enumerate(prompts)], num_slots=2)
        runs[dev] = ({r.rid: r.output for r in rep}, rep.statuses,
                     [(s.h_read, s.e_read, s.m_in, s.m_out)
                      for s in eng.stats])
    same = [runs["cuda"][i] == runs["cpu"][i] for i in range(3)]
    migrated = sum(r[2] + r[3] for r in runs["cuda"][2])
    log(f"parity: tokens {same[0]} statuses {same[1]} step bytes "
        f"{same[2]} ({len(runs['cuda'][2])} decode steps, {migrated:.0f} "
        f"bytes migrated)")
    if not all(same):
        raise AssertionError("the card's serve disagrees with the CPU's")


KERNEL_GROUPS = (   # (group, lower-case substrings of its kernel names)
    ("paged attention (csrc/paged_attention.cu)", ("paged_split_kernel",
                                                   "paged_merge_kernel")),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")),
    ("softmax", ("softmax",)),
    ("gather / scatter / copy", ("index", "gather", "scatter", "copy",
                                 "cat")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def profiled(fn):
    """fn() under torch.profiler (CPU and CUDA): (its result, profile)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
    return result, prof


def breakdown(prof, wall: float, out_dir: str) -> None:
    """Print the device's busy share over the window and its kernel time
    by group and by kernel; write the profiler's table to out_dir."""
    import torch
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = collections.Counter(e.name for e in events if e.name in (
        "cudaLaunchKernel", "cudaStreamSynchronize"))
    log(f"profile: host calls: {calls['cudaLaunchKernel']} kernel "
        f"launches, {calls['cudaStreamSynchronize']} stream syncs")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for s, e in spans:                      # union of kernel intervals
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    total = sum(e.time_range.elapsed_us() for e in kernels)
    log(f"profile: {len(kernels)} kernels, device busy "
        f"{busy / 1e6:.3f} s of {wall:.3f} s wall "
        f"({busy / 1e6 / wall:.4f}), kernel time {total / 1e6:.3f} s")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    groups = {}
    for name, (t, n) in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + t
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile: {group}: {t / 1e6:.3f} s ({t / total:.4f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, n) in top:
        log(f"profile:   {t / 1e6:.4f} s  {n:6d} x  {name[:110]}")
    os.makedirs(out_dir, exist_ok=True)
    avgs = prof.key_averages()
    device_key = "self_device_time_total" if hasattr(
        avgs[0], "self_device_time_total") else "self_cuda_time_total"
    with open(os.path.join(out_dir, "serve_profile.txt"), "w") as f:
        for key in ("self_cpu_time_total", device_key):
            f.write(f"sorted by {key}\n")
            f.write(avgs.table(sort_by=key, row_limit=40) + "\n")


def serve_phase(seed, profile_dir=None):
    import torch
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.scheduler import Request

    cfg = configs.get("internlm2-1.8b")
    model = Model(cfg)
    t = time.time()
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"serve: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.kv_heads} vocab {cfg.vocab}, "
        f"{n_params / 1e9:.3f} B params bf16 in {time.time() - t:.1f} s")
    ecfg = EngineConfig(max_context=4096, hbm_fraction=0.25,
                        policy="importance", prefill_chunk=256,
                        telemetry_stride=16)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, (n,)),
                    max_new_tokens=64)
            for i, n in enumerate(rng.integers(1200, 3001, 8))]
    reqs += [Request(rid=8 + i, prompt=rng.integers(0, cfg.vocab, (n,)),
                     max_new_tokens=16)
             for i, n in enumerate(rng.integers(64, 257, 4))]
    eng = ServingEngine(model, params, ecfg)
    geo = model.cache_geometry(8, ecfg.max_context, ecfg.hbm_fraction)
    log(f"serve: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, cache {geo.hbm_pages} HBM + "
        f"{geo.host_pages} host pages per lane per layer, "
        f"{2 * geo.num_layers * geo.batch * geo.max_pages * geo.page_tokens * geo.kv_heads * geo.head_dim * 2 / 1e9:.2f} GB of KV")
    pa.COUNTS.clear()                       # the main path's run only
    torch.cuda.synchronize()
    t0 = time.time()
    if profile_dir:
        rep, prof = profiled(lambda: eng.serve(reqs, num_slots=8, seed=seed))
    else:
        rep = eng.serve(reqs, num_slots=8, seed=seed)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if profile_dir:
        breakdown(prof, wall, profile_dir)
    launches = pa.COUNTS["paged_attention"]
    steps = len(eng.stats)
    tokens = sum(len(r.output) for r in rep)
    summ = eng.summary()
    log(f"serve: {wall:.2f} s wall, {tokens} tokens, "
        f"{tokens / wall:.1f} tokens/s, TTFT p50 {rep.ttft['p50']:.3f} s, "
        f"TPOT p50 {rep.tpot['p50'] * 1e3:.2f} ms, mean HBM hit rate "
        f"{summ['mean_hbm_hit_rate']:.4f}, migrated "
        f"{summ['migrated_bytes']:.0f} bytes, {steps} decode-plane steps, "
        f"{launches} kernel launches, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    bad = {rid: s for rid, s in rep.statuses.items() if s != "ok"}
    short = {r.rid: len(r.output) for r in rep
             if len(r.output) != r.max_new_tokens}
    if bad or short or len(rep.statuses) != len(reqs):
        raise AssertionError(f"serve: statuses {bad}, short outputs {short}")
    if launches != 2 * cfg.num_layers * steps or steps == 0:
        raise AssertionError(f"serve: {launches} launches for {steps} "
                             f"decode steps x {cfg.num_layers} layers x 2")
    if summ["mean_hbm_hit_rate"] >= 1.0:
        raise AssertionError("serve: the stream never read the host tier")
    return launches


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="run the full-width serve under torch.profiler, "
                    "print where the device time goes and write the "
                    "profiler's table to DIR (the serve's wall time then "
                    "includes the profiler's cost)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import paged_attention as pa

    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)
    t = time.time()
    lib, report = pa.build(force=True)
    log(f"build: {lib.name} in {time.time() - t:.1f} s (nvcc sm_90a)")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  {line.strip()}")

    rng = np.random.default_rng(args.seed)
    shapes = kernel_phase(rng, torch.device("cuda"))
    parity_phase(args.seed)
    launches = serve_phase(args.seed, args.profile)

    entry = {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:99",
        "launches": launches,
        # one decode layer: the HBM-tier (N=64) + host-tier (N=208) launch
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": sum(s["bound_ms"] for s in shapes),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                   for s in shapes) else "operations",
        "library_ms": sum(s["library_ms"] for s in shapes),
        "per_shape": shapes,
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
