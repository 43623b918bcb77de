"""Rank processes of `tests/test_torch_mesh_kv_train.py`: spawned
processes on the CPU, one a rank, joined over gloo through a `file://`
store, building one (`data`, `model`) mesh after another whose `model`
axis does not divide the KV heads of the config trained on it, running
the cases they are handed and pickling what they saw. The cases reuse
`_torch_mesh_family_worker`'s pieces (its steps, its gathered whole
state, what a rank holds); every collective fails after `TIMEOUT_S`, so
a rank that goes astray fails the run instead of hanging it. Imports no
JAX.

The cases (`CASES`, in the plan's order; `restored` reads the
checkpoint `steps` saved on `SAVED_ON`):

  steps     `STEPS` steps of `make_train_step(..., mesh=)`, the whole
            state after them and what the rank holds; on `SAVED_ON` a
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

import _torch_mesh_family_worker as family
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model
from repro_torch.training.train_step import (
    init_train_state, make_train_step,
)

#: seconds a collective waits before it fails
TIMEOUT_S = 60
LR = family.LR
#: the steps taken before the checkpoint
STEPS = 3
#: the config and mesh whose checkpoint `restored` restores
SAVED_ON = ("internlm2-1.8b", (1, 4))


def config(tag):
    """The float32 smoke config a tag names: a config's name, or "kv1",
    internlm2-1.8b's with one KV head."""
    if tag == "kv1":
        return dataclasses.replace(family.family_cfg("internlm2-1.8b"),
                                   kv_heads=1)
    return family.family_cfg(tag)


def ckpt_dir(out_dir):
    return os.path.join(out_dir, "ckpt")


def step_fn(cfg, mesh, accum=1):
    return make_train_step(Model(cfg), lr=LR, mesh=mesh, accum_steps=accum,
                           extra_keys=family.extra_keys(cfg))


def start_state(data, cfg, mesh):
    return bridge.train_state_from_jax(data["params"], data["opt"], cfg,
                                       device="cpu", mesh=mesh)


def case_steps(data, cfg, mesh, out_dir, at):
    state, metrics = family.run_steps(start_state(data, cfg, mesh),
                                      step_fn(cfg, mesh),
                                      data["batches"][:STEPS])
    if at == SAVED_ON:
        CheckpointManager(ckpt_dir(out_dir), mesh=mesh).save(
            STEPS, state, blocking=True,
            specs=bridge.train_state_specs(cfg, mesh))
    return {"metrics": metrics, "whole": family.whole(state, cfg, mesh),
            "held": family.held(state)}


def case_accum(data, cfg, mesh, out_dir, at):
    state, metrics = family.run_steps(start_state(data, cfg, mesh),
                                      step_fn(cfg, mesh, 2),
                                      data["batches"][:STEPS])
    return {"metrics": metrics, "whole": family.whole(state, cfg, mesh)}


def case_restored(data, cfg, mesh, out_dir, at):
    """The step after the checkpoint `SAVED_ON` saved, restored here."""
    target = init_train_state(Model(cfg), 0, "cpu", mesh=mesh)
    state = CheckpointManager(ckpt_dir(out_dir), mesh=mesh).restore(
        target, step=STEPS, device="cpu",
        specs=bridge.train_state_specs(cfg, mesh))
    state, metrics = family.run_steps(state, step_fn(cfg, mesh),
                                      data["batches"][STEPS:STEPS + 1])
    return {"metrics": metrics, "whole": family.whole(state, cfg, mesh),
            "held": family.held(state)}


#: name -> the function running it on a rank
CASES = {"steps": case_steps, "accum": case_accum,
         "restored": case_restored}


def rank_main(rank, world, store, plan, data_path, out_dir):
    """One rank: join the gloo group of `world` ranks, then for each
    (tag, (data, model), cases) of `plan` build that mesh over the first
    data x model ranks (the others take part in building it and train
    nothing) and run `cases` on the config `tag` names, from the data
    file's {tag: {"params", "opt", "batches"}}; pickle {(tag, (data,
    model)): {"coord", case: result}} to out_dir/rank{rank}.pkl. One
    thread a rank: the ranks share the host's cores."""
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        res = {}
        for tag, (d, m), cases in plan:
            n = d * m
            mesh = mesh_mod.make_test_mesh(d, m) if n == world else \
                DeviceMesh("cpu", torch.arange(n).reshape(d, m),
                           mesh_dim_names=mesh_mod.AXES)
            if rank >= n:
                continue
            out = res[(tag, (d, m))] = {
                "coord": mesh_mod.mesh_coordinate(mesh)}
            for name in cases:
                out[name] = CASES[name](data[tag], config(tag), mesh,
                                        out_dir, (tag, (d, m)))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
