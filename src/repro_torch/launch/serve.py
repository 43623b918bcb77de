"""Serving entry point (the port of the reference's `launch/serve.py`):
the two-tier serving engine over a mixed request stream, on the CUDA
card unless `--device cpu` is given, optionally across a device mesh.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --requests 6 --new-tokens 8 [--device cpu]

`--mesh data=N,model=M` serves across a (`data`, `model`) mesh of N x M
ranks, one process each (`ServingEngine(..., mesh=)`): under `torchrun
--nproc-per-node N*M` (RANK, WORLD_SIZE, LOCAL_RANK from it; rank r on
`cuda:LOCAL_RANK` over NCCL, or the CPU over gloo with `--device cpu`),
or, with no RANK in the environment, the CLI spawns the N x M ranks
itself over a `file://` store in a temporary directory, so one command
serves:

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --mesh data=2,model=2 --device cpu

A `model` axis that does not divide the KV heads serves under the
reference's `pages` or `none` KV pool rule (`--mesh data=1,model=4` on
the smoke config's 2 KV heads: each rank's pools hold a quarter of
each tier's slots).

Rank 0 prints the summary; the exit status is the worst rank's.

`--parity` without `--mesh` runs the stream twice with the same weights,
on the card and on the CPU; with `--mesh` it runs the reference's mesh
check: every rank serves the stream on the mesh, and rank 0 also serves
it unmeshed on its own device and compares (`MESH PARITY OK`). Either
way the contract is the reference's: identical tokens and terminal
statuses, hit and bound fractions within 0.02 and 0.05. Both run the
chosen config in float32 (bf16 greedy tokens of random weights differ
between the card's and the CPU's arithmetic, and between a sum split
over ranks and one matmul), so they are meant for `--smoke`; the stream
served without them is unchanged. Exit status is the check's result;
the card-against-CPU check exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.core.sa import SAConfig
from repro_torch.core.tiers import SPECS
from repro_torch.bridge import init_shards
from repro_torch.launch.mesh import join_mesh, mesh_coordinate, spawn_ranks
from repro_torch.models.model import Model
from repro_torch.models.params import param_bytes
from repro_torch.serving import trace_bridge
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.policies import policy_names
from repro_torch.serving.scheduler import Request
from repro_torch.tree import tree_leaves


def parse_mesh(spec: str) -> Optional[Dict[str, int]]:
    """'data=2,model=2' -> {"data": 2, "model": 2}; '' -> None."""
    if not spec:
        return None
    sizes = {"data": 1, "model": 1}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        if name.strip() not in sizes or not val.strip().isdigit() \
                or int(val) < 1:
            raise SystemExit(f"--mesh wants 'data=N,model=M', got {spec!r}")
        sizes[name.strip()] = int(val)
    return sizes


def build_requests(vocab: int, n: int, prompt_len: int,
                   new_tokens: int, seed: int = 0):
    """A mixed request stream: three page-rounded prompt lengths and
    staggered budgets, so admissions/completions churn lanes."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab,
                                        (prompt_len + 16 * (i % 3),)),
                    max_new_tokens=new_tokens + 2 * (i % 3))
            for i in range(n)]


def engine_config(args, trace: bool = False) -> EngineConfig:
    """The engine the CLI's flags ask for."""
    return EngineConfig(
        max_context=args.prompt_len + 32 + args.new_tokens + 16,
        hbm_fraction=args.hbm_fraction, policy=args.policy,
        attention_sparsity=args.sparsity, spec=SPECS[args.spec],
        telemetry_stride=args.stride, prefill_chunk=16,
        trace_telemetry=trace)


def run_stream(model, params, args, device=None, *, trace: bool = False,
               mesh=None):
    """Serve one stream on `device` (default: the card), across `mesh`
    when given; returns (engine, ServeReport, wall seconds)."""
    eng = ServingEngine(model, params, engine_config(args, trace),
                        device=device, mesh=mesh)
    reqs = build_requests(model.cfg.vocab, args.requests,
                          args.prompt_len, args.new_tokens)
    t0 = time.perf_counter()
    report = eng.serve(reqs, num_slots=args.batch_slots, seed=args.seed)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, report, time.perf_counter() - t0


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def check_parity(model, params, args) -> bool:
    """The same stream on the card and on the CPU, same weights.

    Pins: identical tokens + terminal statuses per request, and
    aggregate hit/bound fractions within tolerance (migration choices
    may flip on ulp-level importance-EMA differences, which moves
    telemetry without touching tokens)."""
    ref_eng, ref, _ = run_stream(model, params, args, "cpu", trace=True)
    card_eng, got, _ = run_stream(model, params, args, "cuda", trace=True)
    frac, ok = compare_streams(args, ("cpu", ref_eng, ref),
                               ("card", card_eng, got))
    if ok:
        print(f"CARD PARITY OK: {len(ref.completed)} requests, tokens + "
              f"statuses identical on {device_name(card_eng.device)} and "
              f"the cpu, hit {frac['card'][0]:.3f} (d={frac['d'][0]:.4f}), "
              f"bound {frac['card'][1]:.3f} (d={frac['d'][1]:.4f})")
    return ok


def check_mesh_parity(model, params, args, mesh, device) -> bool:
    """Unmeshed against meshed serve of one stream (the reference's
    mesh check), run by every rank of `mesh`: every rank serves the
    meshed stream; rank 0 also serves it unmeshed on `device` and
    compares as `compare_streams` does; on cards, also that the meshed
    engine captures no new graph serving the stream again (the
    reference's one executable). Returns rank 0's verdict (True on the
    other ranks)."""
    mesh_eng, got, _ = run_stream(model, params, args, device, trace=True,
                                  mesh=mesh)
    again = 0
    if device.type == "cuda":           # graphs exist on the card only
        before = sum(mesh_eng.captures.values())
        mesh_eng.serve(build_requests(model.cfg.vocab, args.requests,
                                      args.prompt_len, args.new_tokens),
                       num_slots=args.batch_slots, seed=args.seed)
        again = sum(mesh_eng.captures.values()) - before
    if dist.get_rank() != 0:
        return True
    ref_eng, ref, _ = run_stream(model, params, args, device, trace=True)
    frac, ok = compare_streams(args, ("1dev", ref_eng, ref),
                               ("mesh", mesh_eng, got))
    if again:
        print(f"PARITY FAIL: {again} graphs captured serving again")
        ok = False
    if ok:
        print(f"MESH PARITY OK: {len(ref.completed)} requests, tokens + "
              f"statuses identical, hit {frac['mesh'][0]:.3f} "
              f"(d={frac['d'][0]:.4f}), bound {frac['mesh'][1]:.3f} "
              f"(d={frac['d'][1]:.4f}), {dist.get_world_size()} ranks "
              f"on {device_name(device)}, "
              f"{sum(mesh_eng.captures.values())} graphs captured")
    return ok


def compare_streams(args, want, got):
    """Two served streams, each (tag, engine, report) with trace
    capture: tokens and statuses identical, aggregate hit and bound
    fractions within 0.02 and 0.05 (migration choices may flip on
    ulp-level importance-EMA differences, which moves telemetry without
    touching tokens). Returns ({tag: (hit, bound), "d": differences},
    ok), printing each failure."""
    (wtag, _, ref), (gtag, _, rep) = want, got
    ok = True
    if ref.statuses != rep.statuses:
        print(f"PARITY FAIL: statuses {ref.statuses} != {rep.statuses}")
        ok = False
    ref_out = {r.rid: list(r.output) for r in ref}
    got_out = {r.rid: list(r.output) for r in rep}
    for rid in sorted(ref_out):
        if ref_out[rid] != got_out.get(rid):
            print(f"PARITY FAIL: request {rid} tokens diverge\n"
                  f"  {wtag}: {ref_out[rid]}\n"
                  f"  {gtag}: {got_out.get(rid)}")
            ok = False
    sa_cfg = SAConfig(max_evaluations=6, iters_per_level=2, seed=0)
    spec = SPECS[args.spec]
    frac = {}
    for tag, eng, report in (want, got):
        score = trace_bridge.score_serve(
            trace_bridge.collect_serve(eng), spec, sa_cfg=sa_cfg,
            report=report)
        agg = score["aggregate"]
        frac[tag] = (agg["live_hit_fraction"],
                     agg.get("bound_fraction", 0.0))
    frac["d"] = (abs(frac[wtag][0] - frac[gtag][0]),
                 abs(frac[wtag][1] - frac[gtag][1]))
    if frac["d"][0] > 0.02 or frac["d"][1] > 0.05:
        print(f"PARITY FAIL: fractions drift hit={frac[wtag][0]:.3f}"
              f"/{frac[gtag][0]:.3f} bound={frac[wtag][1]:.3f}"
              f"/{frac[gtag][1]:.3f}")
        ok = False
    return frac, ok


def main(argv=None) -> int:
    """CLI driver; returns a process exit status."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--policy", default="importance",
                    choices=list(policy_names()))
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--hbm-fraction", type=float, default=0.25)
    ap.add_argument("--spec", default="h100", choices=list(SPECS),
                    help="the memory system the telemetry is priced on")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--stride", type=int, default=8,
                    help="steps per chunk boundary")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default="",
                    help="'data=N,model=M' serves across a mesh of N x M "
                         "ranks (under torchrun, or spawned here)")
    ap.add_argument("--parity", action="store_true",
                    help="serve the stream on the card AND on the CPU "
                         "(with --mesh: unmeshed AND meshed) in float32 "
                         "with the same weights and check tokens/"
                         "statuses/fractions match; exit 1 on divergence "
                         "(meant for --smoke; without --mesh it needs a "
                         "card)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    sizes = parse_mesh(args.mesh)
    if sizes is not None:
        if "RANK" not in os.environ:
            return spawn_ranks(sizes["data"] * sizes["model"], main,
                               list(argv if argv is not None
                                    else sys.argv[1:]))
        return mesh_main(cfg, sizes, args)

    if args.parity:
        if not torch.cuda.is_available():
            print("PARITY REFUSED: --parity compares the card with the CPU "
                  "and no CUDA card is available", file=sys.stderr)
            return 2
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32)
        model = Model(cfg)
        params = model.init(0, device="cpu")
        return 0 if check_parity(model, params, args) else 1

    device = resolve_device(args.device)
    model = Model(cfg)
    params = model.init(0, device=device)
    eng, report, wall = run_stream(model, params, args, device)
    total = sum(len(r.output) for r in report)
    s = eng.summary()
    print(f"served {len(report)} requests / {total} tokens on 1 device "
          f"in {wall:.2f}s ({total / wall:.1f} tok/s wall)")
    if report.ttft:
        print(f"ttft p50 {report.ttft['p50'] * 1e3:.1f} ms  "
              f"tpot p50 {report.tpot.get('p50', 0.0) * 1e3:.2f} ms")
    print(f"modeled tokens/s {s.get('modeled_tokens_per_s', 0.0):.0f}  "
          f"hbm hit rate {s.get('mean_hbm_hit_rate', 0.0):.2f}  "
          f"device {device_name(eng.device)}")
    return 0


def mesh_main(cfg, sizes: Dict[str, int], args) -> int:
    """One rank of `--mesh` (RANK in the environment): serve the stream
    across the mesh, or `--parity`'s check in float32; rank 0 prints.
    The serve draws only the rank's weight shards onto its device
    (`bridge.init_shards`), so a rank holds about 1/model of the
    weights; the parity check starts from the whole model on the CPU,
    which its unmeshed serve needs. The engine and its graphs, which
    hold the group's communicators, are freed before the process group
    is torn down."""
    mesh, device = join_mesh(sizes, args.device)
    try:
        if args.parity:
            cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                      param_dtype=torch.float32)
            model = Model(cfg)
            params = model.init(0, device="cpu")
            return 0 if check_mesh_parity(model, params, args, mesh,
                                          device) else 1
        mesh_serve(cfg, sizes, args, mesh, device)
        return 0
    finally:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.destroy_process_group()


def mesh_serve(cfg, sizes: Dict[str, int], args, mesh, device) -> None:
    """The stream served across `mesh` from the rank's weight shards;
    rank 0 prints the summary and the rank's weight bytes beside the
    whole model's."""
    model = Model(cfg)
    params = init_shards(cfg, 0, mesh, mesh_coordinate(mesh), device)
    eng, report, wall = run_stream(model, params, args, device, mesh=mesh)
    if dist.get_rank() == 0:
        total = sum(len(r.output) for r in report)
        print(f"served {len(report)} requests / {total} tokens on "
              f"{dist.get_world_size()} devices (data={sizes['data']}"
              f", model={sizes['model']}) in {wall:.2f}s "
              f"({total / wall:.1f} tok/s wall)")
        if report.ttft:
            print(f"ttft p50 {report.ttft['p50'] * 1e3:.1f} ms  "
                  f"tpot p50 {report.tpot.get('p50', 0.0) * 1e3:.2f} "
                  f"ms")
        s = eng.summary()
        print(f"modeled tokens/s "
              f"{s.get('modeled_tokens_per_s', 0.0):.0f}  hbm hit "
              f"rate {s.get('mean_hbm_hit_rate', 0.0):.2f}  device "
              f"{device_name(device)}")
        whole = param_bytes(model.schema(), cfg.param_dtype.itemsize)
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        print(f"rank 0 weights "
              f"{sum(t.nbytes for t in tree_leaves(eng.params)) / 1e6:.1f}"
              f" MB of the whole model's {whole / 1e6:.1f} MB"
              + (f", peak memory {peak / 1e9:.2f} GB" if peak else ""))


if __name__ == "__main__":
    sys.exit(main())
