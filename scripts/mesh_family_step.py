"""A family's meshed train steps with its modality input, one process a
rank under torchrun: the path the train CLI does not take for the vlm
and encdec families (it feeds tokens alone, as the reference's CLI), so
they train across a mesh through `make_train_step(..., extra_keys=,
mesh=)` as here. Any (`data`, `model`) mesh: a `model` axis that does
not divide the KV heads too. Random weights and embeddings from
`--seed`, batches from `SyntheticCorpus`; rank 0 prints each step's
loss, grad norm and ms, then every rank's weight, m/v and peak bytes
(the train CLI's `report_ranks`).

Then, where the whole model's train state (weights, m and v) takes at
most ONE_CARD_BYTES (internlm2-1.8b, not llama31-8b), every rank
gathers the whole parameters and m after the steps, the group is torn
down, and rank 0 takes the same steps unmeshed on its card from the
same weights and batches: it prints a `check:` line and exits 1 unless
the losses and grad norms are within CHECK_TOL of the unmeshed ones and
each leaf's m is within CHECK_TOL["m"] of the unmeshed m (max |diff|
over max |value|, the worst leaf; the parameters' largest difference
and the update's relative L2 beside them).

  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      scripts/mesh_family_step.py --arch whisper-tiny --data 1 --model 2

(`--smoke --device cpu` runs the smoke config over gloo on the CPU.)
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import bridge, configs
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.mesh import join_mesh
from repro_torch.launch.train import report_ranks
from repro_torch.models.model import Model
from repro_torch.models.params import count_params, param_bytes
from repro_torch.training.train_step import (
    init_train_state, make_train_step,
)
from repro_torch.tree import leaves_with_path, path_name

#: each family's modality input, by family
EXTRA = {"vlm": "patch_embeds", "encdec": "frame_embeds"}
#: the most bytes of the whole model's train state (bf16 weights, f32 m
#: and v) for which rank 0 also takes the steps unmeshed on its card
#: (internlm2-1.8b's 18.9 GB; llama31-8b's 80.3 GB do not fit)
ONE_CARD_BYTES = 32e9
#: the hold against the unmeshed steps, relative: a meshed step's bf16
#: partial sums over `model` round otherwise than the unmeshed step's
#: products (a split layer's gradients within 3e-2 of their largest,
#: chip_smoke phase 16b). m, per leaf: about twice the largest seen on
#: H100s (internlm2-1.8b at (1, 3), 3 steps: `wk` 2.121e-2; whisper-tiny
#: at (1, 4), 10 steps: 1.237e-2), where a leaf whose gradient a part run
#: whole on every model rank counted m times (an enter or sum it should
#: not take) is off by m - 1 of its largest value
CHECK_TOL = {"loss": 1e-3, "grad_norm": 1e-2, "m": 5e-2}


def batch_of(cfg, args, device):
    """(the step's extra inputs, the tokens of each step) from `--seed`,
    on `device`."""
    extra = {}
    if cfg.family in EXTRA:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + 11)
        extra[EXTRA[cfg.family]] = torch.randn(
            (args.batch, cfg.frontend.num_embeddings, cfg.d_model),
            generator=gen, device=device).to(cfg.dtype)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    tokens = [torch.as_tensor(corpus.batch(0, i)["tokens"], device=device)
              for i in range(args.steps)]
    return extra, tokens


def run_steps(cfg, args, device, mesh=None, lead=True):
    """`args.steps` steps (across `mesh` when given) from
    `init_train_state(..., seed)`: (the state, losses, grad norms); the
    lead prints each step."""
    model = Model(cfg)
    extra, tokens = batch_of(cfg, args, device)
    state = init_train_state(model, args.seed, device, mesh=mesh)
    step = make_train_step(model, lr=args.lr, extra_keys=tuple(extra),
                           mesh=mesh)
    losses, gnorms = [], []
    for i, toks in enumerate(tokens):
        t = time.time()
        state, m = step(state, {"tokens": toks, **extra})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if lead:
            print(f"step {i + 1:5d} loss {losses[-1]:.4f} gnorm "
                  f"{gnorms[-1]:.3f} ({(time.time() - t) * 1e3:.1f} ms)",
                  flush=True)
    return state, losses, gnorms


def state_bytes(cfg) -> int:
    """The whole model's train state: its weights and AdamW's f32 m and
    v."""
    schema = Model(cfg).schema()
    return param_bytes(schema, cfg.param_dtype.itemsize) + \
        8 * count_params(schema)


def check(cfg, args, device, meshed) -> int:
    """Rank 0's hold of the meshed steps (`meshed`: losses, grad norms,
    the whole parameters and m on the CPU) against the same steps taken
    unmeshed on `device`; 0 if within CHECK_TOL."""
    start = {path_name(p): t.cpu() for p, t in leaves_with_path(
        Model(cfg).init(args.seed, device=device))}
    state, losses, gnorms = run_steps(cfg, args, device, lead=False)
    want = {key: {path_name(p): t.cpu() for p, t in leaves_with_path(tree)}
            for key, tree in (("params", state.params), ("m", state.opt.m))}
    del state
    got_losses, got_gnorms, got = meshed
    err = {"loss": max(abs(a - b) / abs(b)
                       for a, b in zip(got_losses, losses)),
           "grad_norm": max(abs(a - b) / abs(b)
                            for a, b in zip(got_gnorms, gnorms))}
    m_err = {k: float((got["m"][k] - w).abs().max()
                      / max(float(w.abs().max()), 1e-30))
             for k, w in want["m"].items()}
    worst = max(m_err, key=m_err.get)
    err["m"] = m_err[worst]
    want = want["params"]
    diff = max(float((got["params"][k].float() - want[k].float()).abs()
                     .max()) for k in want)
    update = (sum(float((got["params"][k].double() - want[k].double())
                        .square().sum()) for k in want)
              / sum(float((want[k].double() - start[k].double()).square()
                          .sum()) for k in want)) ** 0.5
    ok = all(err[k] <= CHECK_TOL[k] for k in err)
    print(f"check: {cfg.name} {args.steps} steps on data={args.data} "
          f"model={args.model} against the unmeshed steps on one card: "
          f"unmeshed losses {losses} grad norms {gnorms}; relative errors "
          f"loss {err['loss']:.3e} grad norm {err['grad_norm']:.3e} "
          f"m {err['m']:.3e} (worst leaf {worst}; tolerance {CHECK_TOL}); "
          f"each leaf's m "
          f"{', '.join(f'{k} {e:.3e}' for k, e in m_err.items())}; "
          f"largest parameter |diff| {diff:.3e}, update's relative L2 "
          f"{update:.3e}; {'CHECK OK' if ok else 'CHECK FAILED'}",
          flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=513)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu: gloo on the CPU (default: cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    mesh, device = join_mesh({"data": args.data, "model": args.model},
                             args.device)
    state = meshed = None
    lead = dist.get_rank() == 0
    hold = state_bytes(cfg) <= ONE_CARD_BYTES
    try:
        state, losses, gnorms = run_steps(cfg, args, device, mesh, lead)
        report_ranks(cfg, state, mesh, device)
        if hold:
            got = {}
            for key, tree in (("params", state.params), ("m", state.opt.m)):
                whole = bridge.unshard(tree, cfg, mesh)
                if lead:
                    got[key] = {path_name(p): t.cpu()
                                for p, t in leaves_with_path(whole)}
                del whole
            if lead:
                meshed = (losses, gnorms, got)
            del got
        elif lead:
            print(f"no unmeshed check: the whole model's train state "
                  f"({state_bytes(cfg) / 1e9:.1f} GB) exceeds "
                  f"{ONE_CARD_BYTES / 1e9:.0f} GB", flush=True)
        if lead:
            print("done", flush=True)
    finally:
        del state                     # the state goes before the group
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.destroy_process_group()
    if meshed is None:
        return 0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return check(cfg, args, device, meshed)


if __name__ == "__main__":
    sys.exit(main())
