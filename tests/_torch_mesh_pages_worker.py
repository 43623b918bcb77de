"""Rank processes of `tests/test_torch_mesh_pages.py`: spawned processes
on the CPU, one a rank, joined over gloo through a `file://` store,
building one (`data`, `model`) mesh after another over configs whose
KV heads the `model` axis does not divide (the reference's `pages` and
`none` KV pool rules), serving on each the cases they are handed and
pickling what they saw. The cases are `_torch_mesh_worker`'s (the
dense family) and `_torch_mesh_moe_worker`'s (the moe family); every
collective fails after `TIMEOUT_S`, so a rank that goes astray fails
the run instead of hanging it. Imports no JAX.
"""

import datetime
import os
import pickle

import torch
import torch.distributed as dist

import _torch_mesh_moe_worker as moe_worker
import _torch_mesh_worker as worker
from repro_torch.launch import mesh as mesh_mod

#: seconds a collective waits before it fails
TIMEOUT_S = 60


def run_case(tag, cfg, params, case, mesh=None):
    """Case `case` of the config tagged `tag` on the port's engine
    (`mesh` when given): a moe serve mode or single stream of
    `_torch_mesh_moe_worker`, else a case of `_torch_mesh_worker`."""
    if tag == "moe":
        if case in moe_worker.MODES:
            return moe_worker.serve_case(cfg, params, case, mesh)
        return moe_worker.stream_case(cfg, params, case, mesh)
    return worker.run_case(case, cfg, params, mesh)


def rank_main(rank, world, store, plan, data_path, out_dir):
    """One rank: join the gloo group of `world` ranks, then for each
    (tag, (data, model), cases) of `plan` build that mesh over the first
    data x model ranks (the others take part in building it and serve
    nothing) and run `cases` on the config `tag` names in the data file
    ({tag: (cfg, params)}); pickle {(tag, (data, model)): {"coord",
    case: outcome}} to out_dir/rank{rank}.pkl. One thread a rank."""
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        data = torch.load(data_path, weights_only=False)
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
            cfg, params = data[tag]
            for case in cases:
                out[case] = run_case(tag, cfg, params, case, mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
