"""The single-stream path of a meshed engine, one process a rank under
torchrun: `start` of BATCH prompts of PROMPT_LEN tokens, then
`generate(STEPS)` twice (the first captures its chunks on the card,
the second replays them), on `ServingEngine(..., mesh=)` over a
(`data`, `model`) mesh, each rank holding only its weight shards
(`bridge.init_shards`). Random weights and prompts from `--seed`. Rank
0 prints the `start` wall time, ms per generated step and tokens/s of
each `generate`, the captures, and every rank's weight, KV pool and
peak bytes; every rank's tokens must be the same.

Then, where the whole model's weights take at most ONE_CARD_BYTES
(llama31-8b, not qwen3-32b), rank 0 holds the meshed stream against an
unmeshed engine on its own card, built after the meshed one and the
process group are gone, from the same seed: `start`'s logits within
STREAM_TOL of max |logit|, and every greedy token of both `generate`
calls within a near tie (2 x STREAM_TOL of max |logit|) of the unmeshed
engine's largest logit when `run` teacher-forces the meshed tokens
through it; it prints the first step where the two argmaxes differ.

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      scripts/mesh_stream.py --arch qwen3-32b --data 1 --model 4

(`--smoke --device cpu` runs the smoke config over gloo on the CPU.)
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.bridge import init_shards
from repro_torch.launch.mesh import join_mesh, mesh_coordinate
from repro_torch.models.model import Model
from repro_torch.models.params import param_bytes
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.tree import tree_leaves

BATCH, PROMPT_LEN, STEPS = 4, 2304, 64
ENGINE = dict(max_context=4096, hbm_fraction=0.25, policy="importance",
              telemetry_stride=16)
#: the most whole-model weight bytes for which rank 0 also runs the
#: unmeshed engine on its card (llama31-8b's 16.1 GB; qwen3-32b's 65.5
#: GB would leave too little beside its cache)
ONE_CARD_BYTES = 32e9
#: meshed `start` logits against the unmeshed engine's (bf16): max
#: |diff| over max |unmeshed logit| (the meshed rank sums its partial
#: attention and MLP outputs in bf16 over `model`); about twice the
#: largest seen on an H100 (llama31-8b at data=2, model=2: 1.958e-2;
#: the largest greedy gap 1.099e-2)
STREAM_TOL = 4e-2


def timed(fn, device):
    """(fn(), its wall seconds, ended by a synchronize on the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.time() - t0


def meshed(cfg, args, mesh, device, prompts):
    """Drive the meshed stream on this rank; rank 0 gets {"ok", "start"
    logits, "token" (the first greedy token), "tokens" [2 x STEPS, B]}
    on the CPU, the other ranks None. The engine is gone on return."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = init_shards(cfg, args.seed, mesh, mesh_coordinate(mesh),
                         device)
    eng = ServingEngine(Model(cfg), params, EngineConfig(**ENGINE),
                        mesh=mesh, device=device)
    del params
    logits, t_start = timed(lambda: eng.start(prompts), device)
    token = logits.argmax(-1).to(torch.int32)
    tokens, t_gen = timed(lambda: eng.generate(token, STEPS), device)
    again, t_again = timed(lambda: eng.generate(tokens[-1], STEPS), device)
    state = eng.state
    mine = {"rank": dist.get_rank(), "coord": mesh_coordinate(mesh),
            "weights": sum(t.nbytes for t in tree_leaves(eng.params)),
            "kv": sum(t.nbytes for t in (state.k_hbm, state.v_hbm,
                                         state.k_host, state.v_host)),
            "peak": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None,
            "tokens": torch.cat([tokens, again]).cpu().numpy(),
            "finite": bool(torch.isfinite(logits).all())}
    captures = sum(eng.captures.values())
    del eng, state
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if dist.get_rank() != 0:
        return None
    same = all(np.array_equal(r["tokens"], mine["tokens"]) for r in ranks)
    whole = param_bytes(Model(cfg).schema(), cfg.param_dtype.itemsize)
    print(f"{cfg.name} data={args.data} model={args.model}: B={BATCH} "
          f"S={PROMPT_LEN}, start {t_start:.3f} s; generate({STEPS}) "
          f"{t_gen * 1e3 / STEPS:.2f} ms a step, "
          f"{BATCH * STEPS / t_gen:.1f} tokens/s (its chunks captured); "
          f"again {t_again * 1e3 / STEPS:.2f} ms a step, "
          f"{BATCH * STEPS / t_again:.1f} tokens/s (replayed); captures "
          f"{captures}; tokens the same on every rank {same}; logits "
          f"finite {mine['finite']}; the whole model's weights "
          f"{whole / 1e6:.1f} MB", flush=True)
    for r in ranks:
        peak = "" if r["peak"] is None else \
            f", peak {r['peak'] / 1e9:.2f} GB"
        print(f"  rank {r['rank']} {r['coord']}: weights "
              f"{r['weights'] / 1e6:.1f} MB, KV pools "
              f"{r['kv'] / 1e6:.1f} MB{peak}", flush=True)
    return {"ok": same and mine["finite"], "whole": whole,
            "start": logits.float().cpu(), "token": token.cpu(),
            "tokens": torch.as_tensor(mine["tokens"])}


def unmeshed_check(cfg, args, device, prompts, got) -> bool:
    """Rank 0's unmeshed engine against the meshed stream `got` (see the
    module docstring); prints the errors, returns whether they hold."""
    eng = ServingEngine(Model(cfg), Model(cfg).init(args.seed, device),
                        EngineConfig(**ENGINE), device=device)
    want = eng.start(prompts).float().cpu()
    scale = float(want.abs().max())
    err = float((got["start"] - want).abs().max()) / scale
    # the unmeshed logits along the meshed path: step i's input is the
    # token the meshed engine fed it
    fed = torch.cat([got["token"][None], got["tokens"][:-1]])
    along = eng.run(fed).float().cpu()
    del eng
    picked = along.gather(-1, got["tokens"].long()[..., None])[..., 0]
    gap = (along.max(-1).values - picked) / float(along.abs().max())
    differ = (along.argmax(-1) != got["tokens"]).any(-1).nonzero()
    first = int(differ[0]) if len(differ) else None
    ok = err <= STREAM_TOL and float(gap.max()) <= 2 * STREAM_TOL
    print(f"against the unmeshed engine on one card: start logits max "
          f"|diff| / max |logit| {err:.3e} (tolerance {STREAM_TOL}); "
          f"{2 * STEPS} greedy steps x {BATCH} lanes teacher-forced: the "
          f"meshed token is the unmeshed argmax in "
          f"{int((gap == 0).sum())} of {gap.numel()}, the largest gap to "
          f"the unmeshed top logit {float(gap.max()):.3e} of max |logit| "
          f"(near tie {2 * STREAM_TOL}); first step whose argmaxes "
          f"differ: {first}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu: gloo on the CPU (default: cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    prompts = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (BATCH, PROMPT_LEN)), dtype=torch.int32)
    mesh, device = join_mesh({"data": args.data, "model": args.model},
                             args.device)
    try:
        got = meshed(cfg, args, mesh, device, prompts)
    finally:
        gc.collect()                  # the engine goes before the group
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.destroy_process_group()
    if got is None:
        return 0
    ok = got["ok"]
    if got["whole"] <= ONE_CARD_BYTES:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ok = unmeshed_check(cfg, args, device, prompts, got) and ok
    else:
        print(f"no unmeshed check: the whole model's "
              f"{got['whole'] / 1e9:.1f} GB of weights exceed "
              f"{ONE_CARD_BYTES / 1e9:.0f} GB", flush=True)
    if ok:
        print("done", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
