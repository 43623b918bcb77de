"""Serving entry point for one card (the port of the reference's
`launch/serve.py`): the two-tier serving engine over a mixed request
stream, on the CUDA card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --requests 6 --new-tokens 8 [--device cpu]

`--parity` runs the stream twice with the same weights, on the card and
on the CPU, and checks the reference's contract between the two
placements: identical tokens and terminal statuses, hit and bound
fractions within 0.02 and 0.05. It runs the chosen config in float32 on
both sides (bf16 greedy tokens of random weights differ between the
card's and the CPU's arithmetic), so it is meant for `--smoke`; the
stream served without it is unchanged. Exit status is the check's
result; without a card it exits non-zero. `--mesh` is refused: serving
across a device mesh spans more than one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.sa import SAConfig
from repro_torch.core.tiers import SPECS
from repro_torch.models.model import Model
from repro_torch.serving import trace_bridge
from repro_torch.serving.engine import EngineConfig, ServingEngine, refuse_mesh
from repro_torch.serving.policies import policy_names
from repro_torch.serving.scheduler import Request


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


def run_stream(model, params, args, device=None, *, trace: bool = False):
    """Serve one stream on `device` (default: the card); returns
    (engine, ServeReport, wall seconds)."""
    cfg = EngineConfig(
        max_context=args.prompt_len + 32 + args.new_tokens + 16,
        hbm_fraction=args.hbm_fraction, policy=args.policy,
        attention_sparsity=args.sparsity, spec=SPECS[args.spec],
        telemetry_stride=args.stride, prefill_chunk=16,
        trace_telemetry=trace)
    eng = ServingEngine(model, params, cfg, device=device)
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

    ok = True
    if ref.statuses != got.statuses:
        print(f"PARITY FAIL: statuses {ref.statuses} != {got.statuses}")
        ok = False
    ref_out = {r.rid: list(r.output) for r in ref}
    got_out = {r.rid: list(r.output) for r in got}
    for rid in sorted(ref_out):
        if ref_out[rid] != got_out.get(rid):
            print(f"PARITY FAIL: request {rid} tokens diverge\n"
                  f"  cpu:  {ref_out[rid]}\n"
                  f"  card: {got_out.get(rid)}")
            ok = False
    sa_cfg = SAConfig(max_evaluations=6, iters_per_level=2, seed=0)
    spec = SPECS[args.spec]
    frac = {}
    for tag, eng, rep in (("cpu", ref_eng, ref), ("card", card_eng, got)):
        score = trace_bridge.score_serve(
            trace_bridge.collect_serve(eng), spec, sa_cfg=sa_cfg,
            report=rep)
        agg = score["aggregate"]
        frac[tag] = (agg["live_hit_fraction"],
                     agg.get("bound_fraction", 0.0))
    d_hit = abs(frac["cpu"][0] - frac["card"][0])
    d_bound = abs(frac["cpu"][1] - frac["card"][1])
    if d_hit > 0.02 or d_bound > 0.05:
        print(f"PARITY FAIL: fractions drift hit={frac['cpu'][0]:.3f}"
              f"/{frac['card'][0]:.3f} bound={frac['cpu'][1]:.3f}"
              f"/{frac['card'][1]:.3f}")
        ok = False
    if ok:
        print(f"CARD PARITY OK: {len(ref_out)} requests, tokens + "
              f"statuses identical on {device_name(card_eng.device)} and "
              f"the cpu, hit {frac['card'][0]:.3f} (d={d_hit:.4f}), bound "
              f"{frac['card'][1]:.3f} (d={d_bound:.4f})")
    return ok


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
                    help="'data=N,model=M' serves across a device mesh: "
                         "refused, it spans more than one card")
    ap.add_argument("--parity", action="store_true",
                    help="serve the stream on the card AND on the CPU in "
                         "float32 with the same weights and check tokens/"
                         "statuses/fractions match; exit 1 on divergence "
                         "(meant for --smoke; needs a card)")
    args = ap.parse_args(argv)

    if args.mesh:
        refuse_mesh()
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))

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


if __name__ == "__main__":
    sys.exit(main())
