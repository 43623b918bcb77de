"""Rank processes of the port's meshed-training tests
(`tests/test_torch_mesh_train.py`): spawned processes on the CPU, one a
rank, joined over gloo through a `file://` store, building one
(`data`, `model`) mesh after another and training on each from the
state and batches they are handed, pickling what they saw. Every
collective fails after `TIMEOUT_S`, so a rank that goes astray fails
the run instead of hanging it. Imports no JAX: the ranks start from a
fresh interpreter.

The cases (`CASES`, in order; a later one may restore an earlier one's
checkpoint):

  steps      three steps of `make_train_step(..., mesh=)`, then a
             checkpoint of the state on the mesh, a fourth step
             straight, and the same fourth step after a restore on the
             same mesh (on the mesh that saved: bitwise)
  accum      three steps with accum_steps=2
  replicated three steps of 3 rows, which no data axis here divides
  restored   the fourth step after restoring the checkpoint the
             `steps` case saved on `SAVED_ON`
  qk_norm    two steps of qwen3-32b's smoke config (per-head norm
             weights, whole on `model` and used on its heads alone)
  collectives the differentiable collectives of `launch.mesh` on known
             tensors: forward values and gradients
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
from repro_torch.launch.shardings import shard
from repro_torch.models.model import Model
from repro_torch.training.train_step import (
    init_train_state, make_train_step,
)
from repro_torch.tree import leaves_with_path, path_name, tree_leaves

#: seconds a collective waits before it fails
TIMEOUT_S = 60
LR = 1e-3
#: the step the checkpoint is taken after
CKPT_STEP = 3
#: the mesh whose checkpoint the `restored` case restores
SAVED_ON = (2, 2)


def ckpt_dir(out_dir, shape):
    """Where the `steps` case on a mesh of `shape` saves."""
    return os.path.join(out_dir, "ckpt{}x{}".format(*shape))


def f32_smoke(name):
    return dataclasses.replace(tconfigs.get_smoke(name),
                               dtype=torch.float32,
                               param_dtype=torch.float32)


def numpy_tree(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def run_steps(state, step, batches):
    """`state` after one `step` per batch, and each step's (loss, grad
    norm, step) as Python numbers."""
    metrics = []
    for toks in batches:
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    return state, metrics


def whole(state, cfg, mesh):
    """The whole parameters, m and v (numpy, in tree order) of a
    rank's shards: every rank gathers, rank 0 keeps them."""
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


def start_state(data, cfg, mesh):
    """The rank's shards of the reference's initial state."""
    return bridge.train_state_from_jax(data["params"], data["opt"], cfg,
                                       device="cpu", mesh=mesh)


def case_steps(data, cfg, mesh, ckpt):
    model = Model(cfg)
    step = make_train_step(model, lr=LR, mesh=mesh)
    state, metrics = run_steps(start_state(data, cfg, mesh), step,
                               data["batches"][:CKPT_STEP])
    out = {"metrics": metrics, "whole": whole(state, cfg, mesh),
           "held": held(state)}
    specs = bridge.train_state_specs(cfg, mesh)
    mgr = CheckpointManager(ckpt, mesh=mesh)
    mgr.save(CKPT_STEP, state, blocking=True, specs=specs)
    fourth = data["batches"][CKPT_STEP:CKPT_STEP + 1]
    straight, m_straight = run_steps(state, step, fourth)
    restored = mgr.restore(state, step=CKPT_STEP, device="cpu",
                           specs=specs)
    again, m_again = run_steps(restored, step, fourth)
    out["bitwise"] = m_straight == m_again and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(straight),
                                          tree_leaves(again)))
    out["restored_metrics"] = m_again
    return out


def case_accum(data, cfg, mesh, ckpt):
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh, accum_steps=2)
    state, metrics = run_steps(start_state(data, cfg, mesh), step,
                               data["batches"][:CKPT_STEP])
    return {"metrics": metrics, "whole": whole(state, cfg, mesh)}


def case_replicated(data, cfg, mesh, ckpt):
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh)
    state, metrics = run_steps(start_state(data, cfg, mesh), step,
                               data["odd_batches"])
    return {"metrics": metrics, "whole": whole(state, cfg, mesh)}


def case_restored(data, cfg, mesh, ckpt):
    """The fourth step from the checkpoint another mesh saved."""
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh)
    target = init_train_state(Model(cfg), 0, "cpu", mesh=mesh)
    saved = ckpt_dir(os.path.dirname(ckpt), SAVED_ON)
    state = CheckpointManager(saved, mesh=mesh).restore(
        target, step=CKPT_STEP, device="cpu",
        specs=bridge.train_state_specs(cfg, mesh))
    state, metrics = run_steps(state, step,
                               data["batches"][CKPT_STEP:CKPT_STEP + 1])
    return {"metrics": metrics, "whole": whole(state, cfg, mesh),
            "held": held(state)}


def case_qk_norm(data, cfg, mesh, ckpt):
    cfg = f32_smoke("qwen3-32b")
    model = Model(cfg)
    state = init_train_state(model, 1, "cpu", mesh=mesh)
    state, metrics = run_steps(state, make_train_step(model, lr=LR,
                                                      mesh=mesh),
                               data["batches"][:2])
    return {"metrics": metrics, "whole": whole(state, cfg, mesh)}


def case_collectives(data, cfg, mesh, ckpt):
    """Forward values and input gradients of the four differentiable
    collectives on tensors every rank draws alike, each rank weighting
    the output by its own weights (so a gradient that is not summed, or
    not sliced, shows)."""
    rank = dist.get_rank()
    coord = mesh_mod.mesh_coordinate(mesh)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((4, 6), generator=gen)
    w = torch.randn((4, 6), generator=torch.Generator().manual_seed(rank))
    out = {"rank": rank, "w": w.numpy()}
    for name, axis in (("gather_data", "data"), ("gather_model", "model")):
        spec = (None, axis)
        block = shard(x, spec, mesh, coord).requires_grad_(True)
        y = getattr(mesh_mod, name)(block, mesh, 1)
        (g,) = torch.autograd.grad((y * w).sum(), block)
        out[name] = (torch.equal(y.detach(), x), g.numpy())
    for name in ("enter_model", "sum_model"):
        leaf = x.clone().requires_grad_(True)
        y = getattr(mesh_mod, name)(leaf, mesh)
        (g,) = torch.autograd.grad((y * w).sum(), leaf)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


#: name -> the function running it on a rank
CASES = {"steps": case_steps, "accum": case_accum,
         "replicated": case_replicated, "restored": case_restored,
         "qk_norm": case_qk_norm, "collectives": case_collectives}


def rank_main(rank, world, store, plan, data_path, out_dir):
    """One rank: join the gloo group of `world` ranks, then for each
    ((data, model), cases) of `plan` build that mesh over the first
    data x model ranks (the others take part in building it and train
    nothing) and run `cases` on it; pickle {(data, model): {"coord",
    case: result}} to out_dir/rank{rank}.pkl. One thread a rank: the
    ranks share the host's cores."""
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        cfg = f32_smoke("internlm2-1.8b")
        res = {}
        for (d, m), cases in plan:
            n = d * m
            mesh = mesh_mod.make_test_mesh(d, m) if n == world else \
                DeviceMesh("cpu", torch.arange(n).reshape(d, m),
                           mesh_dim_names=mesh_mod.AXES)
            if rank >= n:
                continue
            res[(d, m)] = out = {"coord": mesh_mod.mesh_coordinate(mesh)}
            for name in cases:
                out[name] = CASES[name](data, cfg, mesh,
                                        ckpt_dir(out_dir, (d, m)))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
