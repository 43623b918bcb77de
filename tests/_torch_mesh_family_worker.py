"""Rank processes of the port's meshed family training tests
(`tests/test_torch_mesh_families.py`): spawned processes on the CPU, one
a rank, joined over gloo through a `file://` store, building one
(`data`, `model`) mesh after another and training on each, for every
family they are handed, from the state and batches the test gives,
pickling what they saw. Every collective fails after `TIMEOUT_S`, so a
rank that goes astray fails the run instead of hanging it. Imports no
JAX: the ranks start from a fresh interpreter.

The cases (`CASES`, in order on a mesh; `restored` reads the checkpoint
`steps` saved on `SAVED_ON`, which the test builds first):

  steps     `STEPS` steps of `make_train_step(..., mesh=)` (the family's
            modality extra among the batch's keys), the whole state
            after them, what the rank holds, and on `SAVED_ON` a
            checkpoint of the state
  accum     the same steps with accum_steps=2
  restored  one more step from the checkpoint `SAVED_ON` saved
"""

import dataclasses
import datetime
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model
from repro_torch.training.train_step import (
    init_train_state, make_train_step,
)
from repro_torch.tree import leaves_with_path, path_name, tree_leaves

#: seconds a collective waits before it fails
TIMEOUT_S = 60
LR = 1e-3
#: the steps taken before the checkpoint
STEPS = 2
#: the mesh whose checkpoint the `restored` case restores
SAVED_ON = (2, 2)
#: each family's modality extra, by family
EXTRA = {"vlm": "patch_embeds", "encdec": "frame_embeds"}


def family_cfg(name):
    """The float32 smoke config of `name`; "zamba2-ssm" is zamba2's with
    no attention site (the ssm family, as test_torch_hybrid builds it)."""
    base = name.replace("-ssm", "-1.2b") if name.endswith("-ssm") else name
    cfg = dataclasses.replace(tconfigs.get_smoke(base), dtype=torch.float32,
                              param_dtype=torch.float32)
    if name.endswith("-ssm"):
        cfg = dataclasses.replace(cfg, family="ssm", ssm=dataclasses.replace(
            cfg.ssm, attn_every=0))
    return cfg


def extra_keys(cfg):
    key = EXTRA.get(cfg.family)
    return () if key is None else (key,)


def ckpt_dir(out_dir, name):
    return os.path.join(out_dir, f"ckpt_{name}")


def numpy_tree(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def run_steps(state, step, batches):
    """`state` after one `step` per batch (dicts of numpy arrays), and
    each step's (loss, grad norm, step) as Python numbers."""
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    return state, metrics


def whole(state, cfg, mesh):
    """The whole parameters, m and v (numpy, in tree order) of a rank's
    shards: every rank gathers, rank 0 keeps them."""
    got = bridge.unshard(state, cfg, mesh)
    if dist.get_rank() != 0:
        return None
    return {k: numpy_tree(t) for k, t in (
        ("params", got.params), ("m", got.opt.m), ("v", got.opt.v))}


def held(state):
    """{leaf name: shape} and the bytes of what the rank's state holds."""
    return ({path_name(p): tuple(t.shape)
             for p, t in leaves_with_path(state)},
            sum(t.nbytes for t in tree_leaves(state)))


def case_steps(data, cfg, mesh, out_dir, shape):
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh,
                           extra_keys=extra_keys(cfg))
    state = bridge.train_state_from_jax(data["params"], data["opt"], cfg,
                                        device="cpu", mesh=mesh)
    state, metrics = run_steps(state, step, data["batches"][:STEPS])
    if shape == SAVED_ON:
        CheckpointManager(ckpt_dir(out_dir, data["name"]), mesh=mesh).save(
            STEPS, state, blocking=True,
            specs=bridge.train_state_specs(cfg, mesh))
    return {"metrics": metrics, "whole": whole(state, cfg, mesh),
            "held": held(state)}


def case_accum(data, cfg, mesh, out_dir, shape):
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh, accum_steps=2,
                           extra_keys=extra_keys(cfg))
    state = bridge.train_state_from_jax(data["params"], data["opt"], cfg,
                                        device="cpu", mesh=mesh)
    state, metrics = run_steps(state, step, data["batches"][:STEPS])
    return {"metrics": metrics, "whole": whole(state, cfg, mesh)}


def case_restored(data, cfg, mesh, out_dir, shape):
    """The step after the checkpoint `SAVED_ON` saved, restored here."""
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh,
                           extra_keys=extra_keys(cfg))
    target = init_train_state(Model(cfg), 0, "cpu", mesh=mesh)
    state = CheckpointManager(ckpt_dir(out_dir, data["name"]),
                              mesh=mesh).restore(
        target, step=STEPS, device="cpu",
        specs=bridge.train_state_specs(cfg, mesh))
    state, metrics = run_steps(state, step,
                               data["batches"][STEPS:STEPS + 1])
    return {"metrics": metrics, "whole": whole(state, cfg, mesh)}


#: name -> the function running it on a rank
CASES = {"steps": case_steps, "accum": case_accum,
         "restored": case_restored}


def rank_main(rank, world, store, plan, data_path, out_dir):
    """One rank: join the gloo group of `world` ranks, then for each
    ((data, model), cases) of `plan` build that mesh over the first
    data x model ranks (the others take part in building it and train
    nothing) and run `cases` on it for every family of the data file;
    pickle {(data, model): {"coord", family: {case: result}}} to
    out_dir/rank{rank}.pkl. One thread a rank: the ranks share the
    host's cores."""
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(data_path, "rb") as f:
            families = pickle.load(f)
        res = {}
        for (d, m), cases in plan:
            n = d * m
            mesh = mesh_mod.make_test_mesh(d, m) if n == world else \
                DeviceMesh("cpu", torch.arange(n).reshape(d, m),
                           mesh_dim_names=mesh_mod.AXES)
            if rank >= n:
                continue
            res[(d, m)] = out = {"coord": mesh_mod.mesh_coordinate(mesh)}
            for data in families:
                cfg = family_cfg(data["name"])
                out[data["name"]] = {
                    name: CASES[name](data, cfg, mesh, out_dir, (d, m))
                    for name in cases}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
