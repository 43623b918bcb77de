"""A family's meshed train steps with its modality input, one process a
rank under torchrun: the path the train CLI does not take for the vlm
and encdec families (it feeds tokens alone, as the reference's CLI), so
they train across a mesh through `make_train_step(..., extra_keys=,
mesh=)` as here. Random weights and embeddings from `--seed`, batches
from `SyntheticCorpus`; rank 0 prints each step's loss, grad norm and
ms, then every rank's weight, m/v and peak bytes (the train CLI's
`report_ranks`).

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

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.mesh import join_mesh
from repro_torch.launch.train import report_ranks
from repro_torch.models.model import Model
from repro_torch.training.train_step import (
    check_train_mesh, init_train_state, make_train_step,
)

#: each family's modality input, by family
EXTRA = {"vlm": "patch_embeds", "encdec": "frame_embeds"}


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
    check_train_mesh(cfg, args.model)
    mesh, device = join_mesh({"data": args.data, "model": args.model},
                             args.device)
    state = None
    try:
        model = Model(cfg)
        extra = {}
        if cfg.family in EXTRA:
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed + 11)
            extra[EXTRA[cfg.family]] = torch.randn(
                (args.batch, cfg.frontend.num_embeddings, cfg.d_model),
                generator=gen, device=device).to(cfg.dtype)
        state = init_train_state(model, args.seed, device, mesh=mesh)
        step = make_train_step(model, lr=args.lr, extra_keys=tuple(extra),
                               mesh=mesh)
        corpus = SyntheticCorpus(DataConfig(
            vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
            seed=args.seed))
        lead = dist.get_rank() == 0
        for i in range(args.steps):
            t = time.time()
            tokens = torch.as_tensor(corpus.batch(0, i)["tokens"],
                                     device=device)
            state, m = step(state, {"tokens": tokens, **extra})
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            if lead:
                print(f"step {i + 1:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"({(time.time() - t) * 1e3:.1f} ms)", flush=True)
        report_ranks(cfg, state, mesh, device)
        if lead:
            print("done", flush=True)
        return 0
    finally:
        del state                     # the state goes before the group
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
