"""Training entry point (the port of the reference's `launch/train.py`):
data pipeline, train step, checkpoint manager (async save,
auto-resume), on one card or across a (`data`, `model`) mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 50 --ckpt-dir CKPT_DIR [--device cpu]

`--data N --model M` (N x M above 1) trains across a mesh of N x M
ranks, one process each (`make_train_step(..., mesh=)`, any family whose
KV heads the `model` axis divides: FSDP over `data`, tensor parallelism
over `model`, a moe model's experts split over it, a recurrent block's
heads): under
`torchrun --nproc-per-node N*M` (rank r on `cuda:LOCAL_RANK` over NCCL,
or the CPU over gloo with `--device cpu`), or, with no RANK in the
environment, the CLI spawns its ranks itself over a `file://` store in
a temporary directory:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --data 2 --model 2 --steps 20 --ckpt-dir CKPT_DIR \\
      [--arch granite-moe-3b-a800m | zamba2-1.2b | xlstm-125m]

Each rank draws only its shards of the parameters and of AdamW's m and
v, and takes its rows of each batch; rank 0 prints the step lines and,
at the end, every rank's weight, optimizer-state and peak memory bytes.
Every step donates its state, as the reference's jitted step does
(`make_train_step(..., donate=True)`): the new parameters, m and v are
written into the state's own tensors, so training holds 12 bytes a
bf16 parameter beside its activations. An async checkpoint still holds
its own step's state: `CheckpointManager.save` copies it to host memory
before it returns. A checkpoint holds whole leaves whatever mesh wrote
it, and auto-resume restores it onto the mesh the job has (or onto
none). The exit status is the worst rank's. The CLI feeds tokens alone, as the
reference's: the vlm and encdec families, which need patch or frame
embeddings beside them, train through `make_train_step(...,
extra_keys=, mesh=)` (`scripts/mesh_family_step.py`).
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.bridge import train_state_specs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.mesh import join_mesh, mesh_coordinate, spawn_ranks
from repro_torch.models.model import Model
from repro_torch.models.params import param_bytes
from repro_torch.training.train_step import (
    init_train_state, make_train_step,
)
from repro_torch.tree import tree_leaves


def main(argv=None) -> int:
    """CLI: a short training run on the smoke or full config; returns a
    process exit status."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel (FSDP) mesh axis")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel mesh axis")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    world = args.data * args.model
    if world == 1:
        train(cfg, args, resolve_device(args.device))
        return 0
    if "RANK" not in os.environ:
        return spawn_ranks(world, main, list(argv if argv is not None
                                             else sys.argv[1:]))
    mesh, device = join_mesh({"data": args.data, "model": args.model},
                             args.device)
    try:
        train(cfg, args, device, mesh)
        return 0
    finally:
        gc.collect()                  # the state goes before the group
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.destroy_process_group()


def train(cfg, args, device, mesh=None) -> None:
    """`args.steps` steps from step 0 or the latest committed checkpoint
    of `args.ckpt_dir`, on `device`, across `mesh` when given."""
    model = Model(cfg)
    # the step writes its new state into the state it is given, as the
    # reference's jitted step donates it
    step_fn = make_train_step(model, lr=args.lr, mesh=mesh, donate=True)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    lead = mesh is None or dist.get_rank() == 0
    specs = None if mesh is None else train_state_specs(cfg, mesh)

    mgr = CheckpointManager(args.ckpt_dir, mesh=mesh) if args.ckpt_dir \
        else None
    state = init_train_state(model, 0, device, mesh=mesh)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(state, step=start, device=device, specs=specs)
        if lead:
            print(f"auto-resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = {"tokens": torch.as_tensor(corpus.batch(0, i)["tokens"],
                                           device=device)}
        state, metrics = step_fn(state, batch)
        if (i + 1) % 10 == 0 and lead:
            dt = (time.time() - t0) / (i + 1 - start)
            print(f"step {i + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt * 1e3:.0f} ms/step)")
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, specs=specs)     # async
    if mgr is not None:
        mgr.save(args.steps, state, blocking=True, specs=specs)
    if mesh is not None:
        report_ranks(cfg, state, mesh, device)
    if lead:
        print("done")


def report_ranks(cfg, state, mesh, device) -> None:
    """Rank 0 prints each rank's bytes of weights and of AdamW's m and v
    (its shards alone, the tensors the donated steps updated in place)
    and its peak device memory, beside the whole model's weight
    bytes."""
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    mine = (mesh_coordinate(mesh),
            sum(t.nbytes for t in tree_leaves(state.params)),
            sum(t.nbytes for t in tree_leaves((state.opt.m, state.opt.v))),
            peak)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if dist.get_rank() != 0:
        return
    whole = param_bytes(Model(cfg).schema(), cfg.param_dtype.itemsize)
    for r, (coord, weights, opt, peak) in enumerate(ranks):
        print(f"rank {r} (data {coord['data']}, model {coord['model']}): "
              f"weights {weights / 1e6:.1f} MB of the whole model's "
              f"{whole / 1e6:.1f} MB, AdamW m and v {opt / 1e6:.1f} MB"
              + (f", peak memory {peak / 1e9:.2f} GB" if peak else ""))


if __name__ == "__main__":
    sys.exit(main())
