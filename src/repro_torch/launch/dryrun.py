"""One-card dry run: count every (arch x shape) cell's step without
allocating it (the port of the reference's `launch/dryrun.py`).

The reference lowers and compiles each cell for a 256-chip pod mesh
(or a 512-chip twin-pod one) and reads XLA's cost and memory analyses.
The port runs on one card, so a cell here is the same step at the
per-card batch, ceil(global_batch / 256) (the reference's single mesh
is 16 x 16), built entirely on the meta device (shapes, no data):
parameters, state (the AdamW state for `train`, the paged cache at
hbm_fraction=0.25 for `decode`) and inputs. The step — the train step,
`Model.prefill` (xlstm: `forward_hidden`, as the reference) or
`Model.decode_step` — runs under `launch.op_cost.OpCost`, which counts
its FLOPs and bytes; `launch.roofline` turns them into time against the
H100. A cell whose arguments, or arguments and activations, do not fit
the card's memory (`H100_CHIP.hbm_capacity`, the bytes the card
reports) is recorded as `skip` with its byte counts.

`memory` holds the bytes the step's arguments keep on the card
(parameters, optimizer state or the cache's HBM tier and tables,
inputs), in pinned host memory (the cache's host tier, where the
overlap placement keeps it) and the step's activations (`OpCost.peak`:
the most bytes of its results alive at once, new state included). The
CUDA context and the allocator's rounding are not counted, so a cell
within a few GB of the limit may still not fit.

Usage:
  python -m repro_torch.launch.dryrun                     # all cells
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k
                                                          # one, in-process
  python -m repro_torch.launch.dryrun --list              # enumerate cells

The sweep runs each cell in a fresh subprocess, so a failure never
poisons it; results append to build/dryrun_results.jsonl. `--mesh
multi` (the reference's twin-pod mesh: per-card shard bytes) is
refused, NotImplementedError naming it (`refuse_mesh("dryrun")`): it
spans more than one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch import configs
from repro_torch.core.tiers import H100_CHIP
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.launch.op_cost import OpCost, tensor_bytes
from repro_torch.models.model import Model
from repro_torch.models.params import abstract_params
from repro_torch.serving.engine import refuse_mesh
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import TrainState, make_train_step

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

SUBQUADRATIC = {"xlstm-125m", "zamba2-1-2b", "zamba2-1.2b"}

#: chips of the reference's single (16 x 16) mesh: the per-card batch is
#: the global batch over these
REFERENCE_CHIPS = 256

RESULTS = os.path.join("build", "dryrun_results.jsonl")


def cells(archs=None, shapes=None):
    """Enumerate (arch, shape, RUN|SKIP, reason) cells for the sweep."""
    out = []
    for arch in (archs or configs.all_arch_names()):
        for shape in (shapes or SHAPES):
            if shape == "long_500k" and arch not in SUBQUADRATIC:
                out.append((arch, shape, "SKIP",
                            "pure full-attention arch; sub-quadratic "
                            "attention required at 524288 (DESIGN.md §4)"))
                continue
            out.append((arch, shape, "RUN", ""))
    return out


def card_batch(global_batch: int) -> int:
    return -(-global_batch // REFERENCE_CHIPS)


def input_specs(cfg, seq: int, batch: int, kind: str):
    """Meta stand-ins for every model input of a cell."""
    meta = torch.device("meta")
    specs = {}
    if kind == "decode":
        specs["token"] = torch.empty((batch,), dtype=torch.int32,
                                     device=meta)
        return specs
    specs["tokens"] = torch.empty((batch, seq), dtype=torch.int32,
                                  device=meta)
    extra = {"vlm": "patch_embeds", "encdec": "frame_embeds"}
    if cfg.family in extra:
        specs[extra[cfg.family]] = torch.empty(
            (batch, cfg.frontend.num_embeddings, cfg.d_model),
            dtype=cfg.dtype, device=meta)
    return specs


def _decode_state(model, batch, context):
    """The cell's decode state on meta: the paged cache at
    hbm_fraction=0.25 (encdec: and the encoder output; hybrid: and the
    Mamba2 state), or xlstm's recurrent state."""
    cfg = model.cfg
    geo = model.cache_geometry(batch, context, hbm_fraction=0.25) \
        if cfg.family != "xlstm" else None
    state = model.init_decode_state(batch, geo, device="meta")
    if cfg.family == "encdec":
        state = {"kv": state, "enc": torch.empty(
            (batch, cfg.frontend.num_embeddings, cfg.d_model),
            dtype=cfg.dtype, device="meta")}
    return state


def _host_tier_bytes(state) -> int:
    """Bytes of the host tier of a decode state's paged cache."""
    cache = state if isinstance(state, PagedKVCache) else \
        state.get("kv") if isinstance(state, dict) else None
    if cache is None:
        return 0
    return sum(t.numel() * t.element_size()
               for t in (cache.k_host, cache.v_host))


def run_cell(arch: str, shape: str, mesh_kind: str = "single") -> dict:
    """Count one cell's step on the meta device; returns its record."""
    if mesh_kind != "single":
        refuse_mesh("dryrun")
    t0 = time.time()
    cfg = configs.get(arch)
    model = Model(cfg)
    seq, global_batch, kind = SHAPES[shape]
    batch = card_batch(global_batch)
    specs = input_specs(cfg, seq, batch, kind)
    params = abstract_params(model.schema(), cfg.param_dtype)

    host = 0
    card = tensor_bytes(params)
    if kind == "train":
        state = TrainState(params=params, opt=adamw_init(params))
        card += tensor_bytes(state.opt)
    elif kind == "decode":
        state = _decode_state(model, batch, seq)
        host = _host_tier_bytes(state)
        card += tensor_bytes(state) - host
    card += tensor_bytes(specs)
    record = {"arch": arch, "shape": shape, "mesh": mesh_kind, "devices": 1,
              "seq": seq, "batch": batch, "global_batch": global_batch,
              "kind": kind,
              "memory": {"card_bytes": int(card),
                         "pinned_host_bytes": int(host)},
              "params": int(cfg.param_count()),
              "active_params": int(cfg.active_param_count())}
    if card > H100_CHIP.hbm_capacity:
        record.update(status="skip", reason=(
            f"{card} bytes of arguments on the card exceed the H100's "
            f"{int(H100_CHIP.hbm_capacity)}"))
        return record

    with OpCost() as cost:
        if kind == "train":
            step = make_train_step(
                model, extra_keys=tuple(k for k in specs if k != "tokens"))
            step(state, specs)
        elif kind == "prefill":
            extra = {k: v for k, v in specs.items() if k != "tokens"} or None
            if cfg.family == "xlstm":
                # recurrent arch: parallel prompt scoring is the prefill
                # analogue, as in the reference
                model.forward_hidden(params, specs["tokens"], remat=False)
            else:
                geo = model.cache_geometry(batch, seq, hbm_fraction=0.25)
                model.prefill(params, specs["tokens"], geo, extra=extra)
        else:
            model.decode_step(params, state, specs["token"])
    record["memory"]["activation_bytes"] = int(cost.peak)
    fits = card + cost.peak <= H100_CHIP.hbm_capacity
    record.update(
        status="ok" if fits else "skip", trace_s=round(time.time() - t0, 1),
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes),
        collective_bytes_per_device={"total": 0.0},
        kernels=dict(cost.kernels))
    if not fits:
        record["reason"] = (
            f"{card} bytes of arguments and {cost.peak} of activations on "
            f"the card exceed the H100's {int(H100_CHIP.hbm_capacity)}")
    return record


def main(argv=None):
    """CLI driver: one in-process cell, or the subprocess-per-cell sweep."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single",
                    help="'multi' (the reference's twin-pod mesh) is "
                         "refused: it spans more than one card")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    if args.mesh != "single":
        refuse_mesh("dryrun")
    todo = cells([args.arch] if args.arch else None,
                 [args.shape] if args.shape else None)
    if args.list:
        for c in todo:
            print(*c)
        return 0

    if args.arch and args.shape:
        arch, shape, status, why = todo[0]
        rec = ({"arch": arch, "shape": shape, "mesh": "single",
                "status": "skip", "reason": why} if status == "SKIP"
               else run_cell(arch, shape))
        print(json.dumps(rec))
        return 0

    # sweep: one subprocess per cell, appending to the results file
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with open(args.out, "a") as out:
        for arch, shape, status, why in todo:
            if status == "SKIP":
                rec = {"arch": arch, "shape": shape, "mesh": "single",
                       "status": "skip", "reason": why}
                out.write(json.dumps(rec) + "\n")
                out.flush()
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape]
            t0 = time.time()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=3600, env=env)
            if proc.returncode == 0 and proc.stdout.strip():
                line = proc.stdout.strip().splitlines()[-1]
                out.write(line + "\n")
                print(f"{json.loads(line)['status'].upper():4s} {arch} "
                      f"{shape} ({time.time() - t0:.0f}s)")
            else:
                rec = {"arch": arch, "shape": shape, "mesh": "single",
                       "status": "fail", "stderr": proc.stderr[-2000:]}
                out.write(json.dumps(rec) + "\n")
                print(f"FAIL {arch} {shape}: {proc.stderr[-300:]}")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
