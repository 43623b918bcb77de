"""Dry run: count every (arch x shape x mesh) cell's step without
allocating it (the port of the reference's `launch/dryrun.py`).

The reference lowers and compiles each cell for a 256-chip pod mesh
(or a 512-chip twin-pod one) and reads XLA's cost and memory analyses.
The port has no compiler to partition a step, so its two meshes are
counted two ways.

`single` (one card): the same step at the per-card batch,
ceil(global_batch / 256) (the reference's single mesh is 16 x 16),
built entirely on the meta device (shapes, no data):
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

`multi` (the reference's twin-pod mesh, (`pod`, `data`, `model`) =
(2, 16, 16), 512 cards: `launch.mesh.make_production_mesh`): one card's
rank-local step, counted on the meta device with its collectives. The
step's structure is the same on every rank, so the rank at coordinate 0
on every axis stands for all of them. A `launch.op_cost.CountingRank`
hands the step its collectives and records each one's (kind, axis,
bytes):

  train    the port's meshed train step (`make_train_step(..., mesh=,
           comm=)` over (`data`, `model`) = (16, 16)) on the rank's
           train-mode blocks (`bridge.shard_params(mode="train")`) and
           its rows, 256 / (pod x data) = 8 a card; the parameters are
           replicated over `pod` (the reference's FSDP runs over `data`
           alone), so one all-reduce of the rank's gradient blocks over
           `pod` is added;
  prefill, decode
           the rank-local `Model(cfg.rank_local(16), tp=
           TensorParallel.serving(...))` on the rank's serve-mode
           blocks, its pools' slots under the `pages` KV pool rule, at
           the per-card batch over the batch axes in use
           (`shardings.batch_axes`: decode_32k 4, prefill_32k 1,
           long_500k's 1 repeated on every card); a moe rank routes every
           card's rows of those axes (`gather_rows` over them).

`flops_per_device`, `bytes_per_device` and `memory.activation_bytes`
are the rank's own `OpCost` counts (FLOPs, bytes, peak);
`collective_bytes_per_device` holds the bytes of each kind, their
`total` and `by_axis`. `memory` keeps each card's bytes of the
arguments by the reference's rules (`launch.shardings` rule for rule,
`local_shape`): the parameters by `param_pspec` in the reference's mode
(train for `train`, else serve), AdamW's f32 m and v on their specs, a
decode cell's state by `state_shardings_for` (its host tier in pinned
host memory, the rest on the card) and the inputs by `tokens_sharding`
/ `batch_axes`: the layouts GSPMD gives the reference. The port's rank
holds some leaves whole that GSPMD splits (the norm weights and a moe
router on `model`, the attention and recurrent leaves and state where
the axis divides no head count, the cache's tables, the conv states):
`memory.rank_extra_bytes` is its arguments' bytes on the card less
those. A cell is `ok` when the rank's arguments and its activations fit
the card, else `skip` with both counts.

Usage:
  python -m repro_torch.launch.dryrun                     # all cells
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k
                                                          # one, in-process
  python -m repro_torch.launch.dryrun --mesh multi        # the twin-pod
                                                          # mesh (or both)
  python -m repro_torch.launch.dryrun --list              # enumerate cells

The sweep runs each (cell, mesh) in a fresh subprocess, so a failure
never poisons it; results append to build/dryrun_results.jsonl. One
cell in-process prints one record per mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

from repro_torch import bridge, configs
from repro_torch.core.tiers import H100_CHIP
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.launch import shardings
from repro_torch.launch.mesh import (
    AbstractMesh, make_production_mesh, mesh_axis_sizes,
)
from repro_torch.launch.op_cost import CountingRank, OpCost, tensor_bytes
from repro_torch.models.model import Model
from repro_torch.models.params import abstract_params
from repro_torch.models.transformer import TensorParallel
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import TrainState, make_train_step
from repro_torch.tree import tree_leaves

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

#: the dry run's meshes (`--mesh both` runs them in this order)
MESHES = ("single", "multi")

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


def _count_step(model, kind, state, params, specs, batch, seq) -> OpCost:
    """The cell's step (the train step, the prefill or one decode step)
    on the meta device under `OpCost`."""
    cfg = model.cfg
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
    return cost


def run_cell(arch: str, shape: str, mesh_kind: str = "single") -> dict:
    """Count one cell's step on the meta device under `mesh_kind`
    ("single" or "multi", see the module docstring); returns its
    record."""
    if mesh_kind == "multi":
        return _multi_cell(arch, shape)
    if mesh_kind != "single":
        raise ValueError(f"mesh {mesh_kind!r}: one of {MESHES}")
    t0 = time.time()
    cfg = configs.get(arch)
    model = Model(cfg)
    seq, global_batch, kind = SHAPES[shape]
    batch = card_batch(global_batch)
    specs = input_specs(cfg, seq, batch, kind)
    params = abstract_params(model.schema(), cfg.param_dtype)

    host = 0
    card = tensor_bytes(params)
    state = None
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

    cost = _count_step(model, kind, state, params, specs, batch, seq)
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


def _pairs(tree, spec):
    """(tensor, spec) of each leaf of `tree` (nested dicts and
    dataclasses) against `spec`, the tree of its specs."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], spec[k])
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _pairs(getattr(tree, f.name), getattr(spec, f.name))
    else:
        yield tree, spec


def card_bytes(tree, spec, mesh, itemsize=None) -> int:
    """Bytes of one card's blocks of `tree`'s tensors under `spec` (the
    tree of their specs) on `mesh`; `itemsize` counts every element at
    that many bytes (AdamW's f32 moments of bf16 parameters)."""
    return sum(math.prod(shardings.local_shape(tuple(t.shape), s, mesh))
               * (itemsize or t.element_size())
               for t, s in _pairs(tree, spec))


def multi_memory(arch: str, shape: str) -> dict:
    """Each card's bytes of `arch`'s `shape` cell on the reference's
    twin-pod mesh (see the module docstring): {"params", "opt" (AdamW's
    m and v, and its step), "state" (a decode cell's, on the card),
    "pinned_host" (its host tier), "inputs"} bytes."""
    cfg = configs.get(arch)
    model = Model(cfg)
    seq, batch, kind = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=True)
    mode = "train" if kind == "train" else "serve"
    params = abstract_params(model.schema(), cfg.param_dtype)
    pspecs = shardings.param_shardings(model.logical_axes(), params, mesh,
                                       mode)
    specs = input_specs(cfg, seq, batch, kind)
    b_ax = shardings.batch_axes(mesh, batch)
    ispecs = {k: shardings.tokens_sharding(mesh, batch) if k == "tokens"
              else (b_ax,) if k == "token" else (b_ax, None, None)
              for k in specs}
    out = {"params": card_bytes(params, pspecs, mesh), "opt": 0,
           "state": 0, "pinned_host": 0,
           "inputs": card_bytes(specs, ispecs, mesh)}
    if kind == "train":
        out["opt"] = 2 * card_bytes(params, pspecs, mesh, itemsize=4) + \
            adamw_init(params).step.element_size()
    elif kind == "decode":
        state = _decode_state(model, batch, seq)
        sspecs = shardings.state_shardings_for(model, state, mesh)
        total = card_bytes(state, sspecs, mesh)
        cache = state if isinstance(state, PagedKVCache) else \
            state.get("kv")
        if cache is not None:
            cspecs = sspecs if isinstance(state, PagedKVCache) else \
                sspecs["kv"]
            out["pinned_host"] = sum(
                card_bytes(getattr(cache, f), getattr(cspecs, f), mesh)
                for f in ("k_host", "v_host"))
        out["state"] = total - out["pinned_host"]
    return out


def rank_step(cfg, kind: str, seq: int, batch: int, mesh):
    """One card's rank-local step of a cell of `kind` at `seq` and the
    global `batch` on `mesh` (an `AbstractMesh`: the twin-pod one, see
    the module docstring, or any (`data`, `model`) mesh), counted: (its
    `OpCost`, its `CountingRank`, its arguments' bytes on the card)."""
    sizes = mesh_axis_sizes(mesh)
    b_ax = shardings.batch_axes(mesh, batch)
    split = math.prod(sizes[a] for a in b_ax)
    rows = batch // split
    coord = {a: 0 for a in sizes}
    params = abstract_params(Model(cfg).schema(), cfg.param_dtype)
    rank = CountingRank(sizes, b_ax)
    if kind == "train":
        # the port's meshed step over (data, model); the batch over pod
        # and data, the parameters replicated over pod
        tmesh = AbstractMesh(("data", "model"),
                             (sizes["data"], sizes["model"]))
        mine = bridge.shard_params(params, cfg, tmesh, coord, "train")
        state = TrainState(params=mine, opt=adamw_init(mine))
        inputs = input_specs(cfg, seq, batch // sizes.get("pod", 1), kind)
        step = make_train_step(
            Model(cfg), mesh=tmesh, comm=rank.collectives(),
            extra_keys=tuple(k for k in inputs if k != "tokens"))
        with OpCost() as cost:
            step(state, inputs)
        if "pod" in sizes:
            rank.all_reduce(torch.empty(
                (sum(t.numel() for t in tree_leaves(mine)),),
                dtype=cfg.param_dtype, device="meta"), "pod")
        # the rank's rows of the inputs
        inputs = input_specs(cfg, seq, rows, kind)
        return cost, rank, tensor_bytes(state) + tensor_bytes(inputs)
    whole = Model(cfg)
    mine = bridge.shard_params(params, cfg, mesh, coord, "serve")
    tp = TensorParallel.serving(
        cfg, mesh, coord, rank.reduce, rank.gather,
        gather_rows=rank.gather_rows,
        geo=whole.cache_geometry(rows, seq, hbm_fraction=0.25))
    model = Model(cfg.rank_local(sizes["model"]), tp=tp)
    if cfg.family == "moe" and b_ax:
        model = model.with_rows((0, split))
    inputs = input_specs(cfg, seq, rows, kind)
    state = _decode_state(model, rows, seq) if kind == "decode" else None
    host = _host_tier_bytes(state)
    with OpCost() as cost:
        if kind == "decode":
            model.decode_step(mine, state, inputs["token"])
        elif cfg.family == "xlstm":
            model.forward_hidden(mine, inputs["tokens"], remat=False)
        else:
            extra = {k: v for k, v in inputs.items() if k != "tokens"}
            model.prefill(mine, inputs["tokens"],
                          model.cache_geometry(rows, seq, hbm_fraction=0.25),
                          extra=extra or None)
    return cost, rank, tensor_bytes(mine) + tensor_bytes(state) - host + \
        tensor_bytes(inputs)


def _multi_cell(arch: str, shape: str) -> dict:
    """`run_cell` on the reference's twin-pod mesh."""
    t0 = time.time()
    cfg = configs.get(arch)
    seq, batch, kind = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=True)
    n_dev = math.prod(mesh.sizes)
    mem = multi_memory(arch, shape)
    card = mem["params"] + mem["opt"] + mem["state"] + mem["inputs"]
    record = {"arch": arch, "shape": shape, "mesh": "multi",
              "devices": n_dev, "seq": seq, "batch": batch,
              "global_batch": batch, "kind": kind,
              "memory": {"card_bytes": int(card),
                         "pinned_host_bytes": int(mem["pinned_host"]),
                         "param_bytes": int(mem["params"]),
                         "opt_bytes": int(mem["opt"]),
                         "state_bytes": int(mem["state"]),
                         "input_bytes": int(mem["inputs"]),
                         "activation_bytes": None},
              "params": int(cfg.param_count()),
              "active_params": int(cfg.active_param_count())}
    if card > H100_CHIP.hbm_capacity:
        record.update(status="skip", reason=(
            f"{card} bytes of arguments on each card exceed the H100's "
            f"{int(H100_CHIP.hbm_capacity)}"))
        return record
    cost, rank, held = rank_step(cfg, kind, seq, batch, mesh)
    args = max(card, held)
    record["memory"].update(activation_bytes=int(cost.peak),
                            rank_extra_bytes=int(held - card))
    fits = args + cost.peak <= H100_CHIP.hbm_capacity
    record.update(
        status="ok" if fits else "skip", trace_s=round(time.time() - t0, 1),
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes),
        collective_bytes_per_device=rank.tally(),
        kernels=dict(cost.kernels))
    if not fits:
        record["reason"] = (
            f"{args} bytes of the rank's arguments and {cost.peak} of "
            f"activations on each card exceed the H100's "
            f"{int(H100_CHIP.hbm_capacity)}")
    return record


def main(argv=None):
    """CLI driver: one in-process cell, or the subprocess-per-cell sweep."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=[*MESHES, "both"], default="single",
                    help="one card, the reference's 512-card twin-pod "
                         "mesh, or both in turn")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    meshes = MESHES if args.mesh == "both" else (args.mesh,)
    todo = cells([args.arch] if args.arch else None,
                 [args.shape] if args.shape else None)
    if args.list:
        for c in todo:
            print(*c)
        return 0

    if args.arch and args.shape:
        arch, shape, status, why = todo[0]
        for mesh_kind in meshes:
            rec = ({"arch": arch, "shape": shape, "mesh": mesh_kind,
                    "status": "skip", "reason": why} if status == "SKIP"
                   else run_cell(arch, shape, mesh_kind))
            print(json.dumps(rec), flush=True)
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
            for mesh_kind in meshes:
                if status == "SKIP":
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "skip", "reason": why}
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh",
                       mesh_kind]
                t0 = time.time()
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=3600, env=env)
                if proc.returncode == 0 and proc.stdout.strip():
                    line = proc.stdout.strip().splitlines()[-1]
                    out.write(line + "\n")
                    print(f"{json.loads(line)['status'].upper():4s} {arch} "
                          f"{shape} {mesh_kind} ({time.time() - t0:.0f}s)")
                else:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "fail", "stderr": proc.stderr[-2000:]}
                    out.write(json.dumps(rec) + "\n")
                    print(f"FAIL {arch} {shape} {mesh_kind}: "
                          f"{proc.stderr[-300:]}")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
