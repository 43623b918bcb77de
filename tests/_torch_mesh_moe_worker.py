"""Rank processes of the port's meshed moe tests
(`tests/test_torch_mesh_moe.py`): spawned processes on the CPU, one a
rank, joined over gloo through a `file://` store, building one
(`data`, `model`) mesh after another and, on each, serving the moe
streams and training the moe step they are handed, pickling what they
saw. Every collective fails after `TIMEOUT_S`, so a rank that goes
astray fails the run instead of hanging it. Imports no JAX: the ranks
start from a fresh interpreter.

The serves: `stream` (8 requests through 8 lanes, prompts of 17-300
tokens spilling into the host tier) on granite-smoke and llama4-smoke
at capacity factor 0.5, inline and in overlap mode. The single streams
(`stream_cases`): `_torch_mesh_worker.drive_stream` (`start`,
`generate`, `start`, `run`, `step`, with trace capture) of 8 prompts of
`STREAM_PROMPT` tokens on both, and on (2, 2) also of 3 prompts (lanes
`data` does not divide) and `serve`, `start` + `generate`, `serve` again
on one engine, on granite-smoke. The training: granite-smoke's three
steps from the reference's initial state, a checkpoint of the state
after them on `SAVED_ON`, and the fourth step from that checkpoint
restored on `RESTORED_ON`.
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.tiers import H100
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model
from repro_torch.serving import trace_bridge
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.training.train_step import (
    init_train_state, make_train_step,
)
from repro_torch.tree import leaves_with_path, path_name, tree_leaves

from _torch_mesh_worker import (
    again_case, drive_stream, pools_of, stream_prompts,
)

#: seconds a collective waits before it fails
TIMEOUT_S = 60
LR = 1e-3
#: the steps taken before the checkpoint
CKPT_STEP = 3
#: the mesh whose checkpoint `RESTORED_ON` restores
SAVED_ON = (2, 2)
RESTORED_ON = (1, 2)
#: the serve's engine (test_torch_moe_serve's) and stream size
ENGINE = dict(max_context=512, policy="importance", prefill_chunk=16,
              telemetry_stride=8, promote_thresh=1e-4)
SLOTS = 8
BUDGET = 6
MODES = ("inline", "overlap")
#: single-stream prompt tokens (19 pages, past the 16-page HBM tier of a
#: 512-token context) and lanes, by case
STREAM_PROMPT = 300
STREAMS = {"stream": SLOTS, "stream3": 3}
#: the serve -> start + generate -> serve case on one engine
AGAIN = "again"
#: the mesh and the arch that also run "stream3" and `AGAIN`
EXTRA_ON, EXTRA_ARCH = (2, 2), "granite"


def stream_cases(shape, archs):
    """The (arch, case) single-stream cases a mesh of `shape` runs."""
    out = [(arch, "stream") for arch in archs]
    if tuple(shape) == EXTRA_ON:
        out += [(EXTRA_ARCH, "stream3"), (EXTRA_ARCH, AGAIN)]
    return out


def stream_config() -> EngineConfig:
    """The serve's engine with trace capture, in chunks of 4 steps."""
    return EngineConfig(spec=H100, trace_telemetry=True,
                        **{**ENGINE, "telemetry_stride": 4})


def stream(cls, vocab):
    """8 greedy requests, prompts of 17 to 300 tokens (past the 8-page
    HBM tier of a 512-token context)."""
    rng = np.random.default_rng(21)
    lens = (300, 40, 280, 20, 150, 64, 33, 17)
    return [cls(rid=i, prompt=rng.integers(0, vocab, (n,)),
                max_new_tokens=BUDGET) for i, n in enumerate(lens)]


def engine_config(mode) -> EngineConfig:
    return EngineConfig(spec=H100, overlap_migrations=mode == "overlap",
                        **ENGINE)


def outcome(eng, rep):
    """Tokens, statuses with error codes, events and every priced step's
    bytes and modeled latency (`_torch_serve_ref.outcome`'s keys), and
    what the rank holds."""
    reqs = list(rep.completed) + list(rep.rejected)
    return {
        "outputs": {r.rid: list(r.output) for r in reqs},
        "statuses": {r.rid: (r.status, r.error.code if r.error else None)
                     for r in reqs},
        "events": list(rep.events),
        "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats],
        "latency": [s.modeled_latency_s for s in eng.stats],
        "held": {path_name(p): tuple(t.shape)
                 for p, t in leaves_with_path(eng.params)},
        "pools": pools_of(eng.state),
    }


def serve_case(cfg, params, mode, mesh=None):
    from repro_torch.serving.scheduler import Request
    eng = ServingEngine(Model(cfg), params, engine_config(mode), mesh=mesh,
                        device="cpu")
    rep = eng.serve(stream(Request, cfg.vocab), num_slots=SLOTS, seed=0)
    return outcome(eng, rep)


def stream_case(cfg, params, case, mesh=None):
    """Single-stream `case` (a key of `STREAMS`, or `AGAIN`) on the
    port's engine (`mesh` when given)."""
    from repro_torch.serving.scheduler import Request
    model = Model(cfg)
    if case in STREAMS:
        eng = ServingEngine(model, params, stream_config(), mesh=mesh,
                            device="cpu")
        return drive_stream(
            eng, stream_prompts(STREAMS[case], cfg.vocab, STREAM_PROMPT),
            torch.from_numpy, lambda t: t.numpy(), trace_bridge.collect)
    eng = ServingEngine(model, params, engine_config("inline"), mesh=mesh,
                        device="cpu")
    return again_case(
        eng, lambda e: e.serve(stream(Request, cfg.vocab), num_slots=SLOTS,
                               seed=0),
        stream_prompts(SLOTS, cfg.vocab, STREAM_PROMPT), outcome)


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
    """The whole parameters, m and v (numpy, tree order) of a rank's
    shards, on rank 0 (None elsewhere)."""
    got = bridge.unshard(state, cfg, mesh)
    if dist.get_rank() != 0:
        return None
    return {k: numpy_tree(t) for k, t in (
        ("params", got.params), ("m", got.opt.m), ("v", got.opt.v))}


def train_case(data, cfg, mesh, ckpt):
    """Three steps from the reference's initial state (and a checkpoint
    after them on `SAVED_ON`)."""
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh)
    start = bridge.train_state_from_jax(data["params"], data["opt"], cfg,
                                        device="cpu", mesh=mesh)
    state, metrics = run_steps(start, step, data["batches"][:CKPT_STEP])
    out = {"metrics": metrics, "whole": whole(state, cfg, mesh),
           "held": {path_name(p): tuple(t.shape)
                    for p, t in leaves_with_path(state)}}
    if tuple(mesh_mod.mesh_axis_sizes(mesh).values()) == SAVED_ON:
        CheckpointManager(ckpt, mesh=mesh).save(
            CKPT_STEP, state, blocking=True,
            specs=bridge.train_state_specs(cfg, mesh))
    return out


def restore_case(data, cfg, mesh, ckpt):
    """The fourth step from the checkpoint `SAVED_ON` wrote."""
    step = make_train_step(Model(cfg), lr=LR, mesh=mesh)
    target = init_train_state(Model(cfg), 0, "cpu", mesh=mesh)
    state = CheckpointManager(ckpt, mesh=mesh).restore(
        target, step=CKPT_STEP, device="cpu",
        specs=bridge.train_state_specs(cfg, mesh))
    state, metrics = run_steps(state, step,
                               data["batches"][CKPT_STEP:CKPT_STEP + 1])
    return {"metrics": metrics, "whole": whole(state, cfg, mesh)}


def rank_main(rank, world, store, plan, data_path, out_dir):
    """One rank: join the gloo group of `world` ranks, then for each
    (data, model) of `plan` build that mesh over the first data x model
    ranks (the others take part in building it and run nothing), serve
    every arch's stream in both modes and train; pickle {(data, model):
    {"coord", (arch, mode): outcome, "train": ..., "restored": ...}} to
    out_dir/rank{rank}.pkl. One thread a rank: the ranks share the
    host's cores."""
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        ckpt = os.path.join(out_dir, "ckpt")
        res = {}
        for d, m in plan:
            n = d * m
            mesh = mesh_mod.make_test_mesh(d, m) if n == world else \
                DeviceMesh("cpu", torch.arange(n).reshape(d, m),
                           mesh_dim_names=mesh_mod.AXES)
            if rank >= n:
                continue
            res[(d, m)] = out = {"coord": mesh_mod.mesh_coordinate(mesh)}
            for arch, (cfg, params) in data["serve"].items():
                for mode in MODES:
                    out[(arch, mode)] = serve_case(cfg, params, mode, mesh)
            for arch, case in stream_cases((d, m), data["serve"]):
                cfg, params = data["serve"][arch]
                out[(arch, case)] = stream_case(cfg, params, case, mesh)
            cfg = data["train_cfg"]
            out["train"] = train_case(data, cfg, mesh, ckpt)
            if (d, m) == RESTORED_ON:
                out["restored"] = restore_case(data, cfg, mesh, ckpt)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
