"""Training entry point for one card (the port of the reference's
`launch/train.py`): data pipeline, train step, checkpoint manager
(async save, auto-resume). The reference's mesh options (`--data`,
`--model`) are accepted at 1; above 1 (FSDP over data and TP in the
train step) they raise NotImplementedError (`refuse_mesh("train")`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 50 --ckpt-dir CKPT_DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models.model import Model
from repro_torch.serving.engine import refuse_mesh
from repro_torch.training.train_step import init_train_state, make_train_step


def main(argv=None):
    """CLI: a short training run on the smoke or full config."""
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
                    help="data-parallel (FSDP) mesh axis: 1 (above 1 is "
                         "not ported)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel mesh axis: 1 (above 1 is not "
                         "ported)")
    args = ap.parse_args(argv)

    if args.data > 1 or args.model > 1:
        refuse_mesh("train")
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    model = Model(cfg)
    step_fn = make_train_step(model, lr=args.lr)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = init_train_state(model, 0, device)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(state, step=start, device=device)
        print(f"auto-resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = {"tokens": torch.as_tensor(corpus.batch(0, i)["tokens"],
                                           device=device)}
        state, metrics = step_fn(state, batch)
        if (i + 1) % 10 == 0:
            dt = (time.time() - t0) / (i + 1 - start)
            print(f"step {i + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt * 1e3:.0f} ms/step)")
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state)      # async
    if mgr is not None:
        mgr.save(args.steps, state, blocking=True)
    print("done")


if __name__ == "__main__":
    main()
