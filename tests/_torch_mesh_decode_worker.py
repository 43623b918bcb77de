"""Rank processes of `tests/test_torch_mesh_decode_families.py` and
`tests/test_torch_dryrun_multi.py`: spawned processes on the CPU, one a
rank, joined over gloo through a `file://` store, building one (`data`,
`model`) mesh after another and running on each the cases they are
handed, then pickling what they saw. Every collective fails after
`TIMEOUT_S`, so a rank that goes astray fails the run instead of
hanging it. Imports no JAX.

Two kinds of case, each on a config the data file names by tag:

  "steps"   the rank-local prefill and greedy decode of `run_steps`
            (`TensorParallel.serving`, the engine's binding of a rank,
            for any family) on the rank's rows and serve shards: its
            logits, tokens and final state;
  "record"  one step of `dryrun.rank_step`'s kind (the meshed train
            step, or one decode step) on real tensors, every collective
            the port's `launch.mesh` functions issue recorded as
            (kind, axis, bytes) by `record_collectives`: what the dry
            run's counting rank must issue on the meta device.
"""

import contextlib
import datetime
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.op_cost import collective_bytes
from repro_torch.launch.shardings import batch_axes, tokens_sharding
from repro_torch.models.model import Model
from repro_torch.models.transformer import TensorParallel

#: seconds a collective waits before it fails
TIMEOUT_S = 60


def serving_model(cfg, mesh, coord, geo):
    """The rank-local model of the rank at `coord` of `mesh` (None: the
    whole model) for a cache of `geo`'s tiers."""
    if mesh is None:
        return Model(cfg)
    tp = TensorParallel.serving(
        cfg, mesh, coord,
        reduce=lambda t: mesh_mod.all_reduce_sum(t, mesh, "model"),
        gather=lambda t, dim: mesh_mod.all_gather(t, mesh, "model", dim),
        gather_rows=lambda t, dim: mesh_mod.all_gather(t, mesh, "data", dim),
        geo=geo)
    return Model(cfg.rank_local(mesh_mod.mesh_axis_sizes(mesh)["model"]),
                 tp=tp)


def rows_of(t, mesh, coord):
    """The rank's rows of a [B, ...] batch tensor (`tokens_sharding`: all
    of them where `data` does not divide B); `t` without a mesh."""
    if mesh is None or t is None:
        return t
    from repro_torch.launch.shardings import shard
    spec = tokens_sharding(mesh, t.shape[0])
    return shard(t, spec + (None,) * (t.dim() - 2), mesh, coord)


def run_steps(cfg, params, prompts, extra, steps, mesh=None, context=256):
    """Prefill `prompts` ([B, S] numpy; `extra` numpy arrays or None) and
    take `steps` greedy decode steps on the rank's rows (the whole model
    without `mesh`); the ssm family, which has no prefill, decodes the
    prompt's tokens from the zero state. Returns {"logits": [per step
    numpy], "tokens", "state" (`bridge.cache_to_numpy`), "facts"}."""
    coord = mesh_mod.mesh_coordinate(mesh) if mesh is not None else None
    params = bridge.shard_params(params, cfg, mesh, coord) \
        if mesh is not None else params
    whole = Model(cfg)
    toks = rows_of(torch.from_numpy(prompts), mesh, coord)
    ex = None if extra is None else {
        k: rows_of(torch.from_numpy(v), mesh, coord)
        for k, v in extra.items()}
    B = toks.shape[0]
    geo = whole.cache_geometry(B, context) if cfg.attention_layer_ids() \
        else None
    model = serving_model(cfg, mesh, coord, geo)
    if cfg.family == "ssm":
        state = model.init_decode_state(B, device="cpu")
        for t in range(toks.shape[1]):
            logits, state = model.decode_step(params, state, toks[:, t])
    else:
        local = model.cache_geometry(B, context) if geo is not None \
            else None
        logits, state = model.prefill(params, toks, local, extra=ex)
    out = {"logits": [logits.numpy()], "tokens": []}
    for _ in range(steps):
        tok = logits.argmax(-1).to(torch.int32)
        out["tokens"].append(tok.numpy())
        logits, state = model.decode_step(params, state, tok)
        out["logits"].append(logits.numpy())
    out["state"] = bridge.cache_to_numpy(state)
    tp = model.tp
    out["facts"] = None if tp is None else {
        "kv_split": tp.kv_split, "recurrent_split": tp.recurrent_split,
        "heads": tp.heads, "pool": None if tp.pool is None else
        (tp.pool.hbm, tp.pool.host), "rank": tp.rank, "size": tp.size}
    return out


@contextlib.contextmanager
def record_collectives(log):
    """Every collective `launch.mesh` issues (its `all_reduce_sum`,
    `all_gather` and `reduce_scatter_sum`, which the differentiable
    collectives and every serving callable call) appended to `log` as
    (kind, axis, bytes), bytes as the dry run's counting rank takes
    them (`op_cost.collective_bytes`)."""
    real = {n: getattr(mesh_mod, n) for n in (
        "all_reduce_sum", "all_gather", "reduce_scatter_sum")}
    kinds = {"all_reduce_sum": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter_sum": "reduce-scatter"}

    def wrap(name):
        def call(t, mesh, axis, *rest):
            out = real[name](t, mesh, axis, *rest)
            log.append((kinds[name], axis, collective_bytes(kinds[name],
                                                            out)))
            return out
        return call
    try:
        for n in real:
            setattr(mesh_mod, n, wrap(n))
        yield log
    finally:
        for n, f in real.items():
            setattr(mesh_mod, n, f)


def record_step(cfg, params, kind, seq, batch, mesh):
    """The collectives one rank-local step of `kind` ("train": the meshed
    train step on the rank's train-mode shards; "decode": one decode
    step of a zero state of `dryrun._decode_state`'s geometry) issues
    at the global `batch` and `seq` on real tensors: [(kind, axis,
    bytes)], in order."""
    from repro_torch.launch import dryrun
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState, make_train_step
    coord = mesh_mod.mesh_coordinate(mesh)
    sizes = mesh_mod.mesh_axis_sizes(mesh)
    gen = torch.Generator().manual_seed(0)
    log = []
    if kind == "train":
        mine = bridge.shard_params(params, cfg, mesh, coord, "train")
        state = TrainState(params=mine, opt=adamw_init(mine))
        inputs = {k: (torch.randint(0, cfg.vocab, tuple(v.shape),
                                    generator=gen, dtype=torch.int32)
                      if v.dtype == torch.int32 else
                      torch.randn(tuple(v.shape), generator=gen).to(v.dtype))
                  for k, v in dryrun.input_specs(cfg, seq, batch,
                                                 kind).items()}
        step = make_train_step(Model(cfg), mesh=mesh, extra_keys=tuple(
            k for k in inputs if k != "tokens"))
        with record_collectives(log):
            step(state, inputs)
        return log
    b_ax = batch_axes(mesh, batch)
    rows = batch // (sizes["data"] if b_ax else 1)
    whole = Model(cfg)
    model = serving_model(cfg, mesh, coord,
                          whole.cache_geometry(rows, seq, hbm_fraction=0.25))
    if cfg.family == "moe" and b_ax:
        model = model.with_rows((coord["data"], sizes["data"]))
    mine = bridge.shard_params(params, cfg, mesh, coord)
    geo = model.cache_geometry(rows, seq, hbm_fraction=0.25) \
        if cfg.family != "xlstm" else None
    state = model.init_decode_state(rows, geo, device="cpu")
    if cfg.family == "encdec":
        state = {"kv": state, "enc": torch.zeros(
            (rows, cfg.frontend.num_embeddings, cfg.d_model),
            dtype=cfg.dtype)}
    token = torch.randint(0, cfg.vocab, (rows,), generator=gen,
                          dtype=torch.int32)
    with record_collectives(log):
        model.decode_step(mine, state, token)
    return log


def rank_main(rank, world, store, plan, data_path, out_dir):
    """One rank: join the gloo group of `world` ranks, then for each
    (tag, (data, model), case) of `plan` build that mesh over the first
    data x model ranks (the others take part in building it and run
    nothing) and run `case` ("steps", or ("record", kind, seq, batch))
    on the config `tag` names in the data file ({tag: (cfg, params,
    prompts, extra, steps)}); pickle {(tag, (data, model), case):
    {"coord", "out"}} to out_dir/rank{rank}.pkl. One thread a rank."""
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        res = {}
        for tag, (d, m), case in plan:
            n = d * m
            mesh = mesh_mod.make_test_mesh(d, m) if n == world else \
                DeviceMesh("cpu", torch.arange(n).reshape(d, m),
                           mesh_dim_names=mesh_mod.AXES)
            if rank >= n:
                continue
            cfg, params, prompts, extra, steps = data[tag]
            if case == "steps":
                out = run_steps(cfg, params, prompts, extra, steps, mesh)
            else:
                out = record_step(cfg, params, *case[1:], mesh)
            res[(tag, (d, m), case)] = {
                "coord": mesh_mod.mesh_coordinate(mesh), "out": out}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
