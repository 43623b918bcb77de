"""The moe family across a device mesh on real multi-rank gloo meshes on
the CPU: the meshed serve (`ServingEngine(..., mesh=)`, experts split
over `model`) and the meshed train step (`make_train_step(...,
mesh=)`), against the reference's unmeshed serve and step and the
port's own.

granite-smoke (top-2 of 4) and llama4-smoke (top-1, interleave 2,
shared expert) in float32 with the reference's weights, both at
capacity factor 0.5 as `tests/test_torch_moe_serve.py` runs them: a
decode step routes its 8 lanes as one group with 4 slots an expert and
a prefill chunk its 8 x 16 slots, so choices drop, and a rank that
routed only its own lanes (or its own rows, in training) would answer
otherwise. Four ranks are spawned once, over a `file://` store in
`tmp_path`, and build the meshes (2, 2), (4, 1) and (1, 2) (the last
over ranks 0 and 1) one after another, running on each
`_torch_mesh_moe_worker`'s serves and steps (every collective times out
after 60 s). While they run, this process serves and trains the same
through the reference and the port unmeshed.

The serves: tokens, statuses, events and every StepStats row exactly
equal to both unmeshed serves (modeled latencies within 1e-12
relative), in both modes. The single streams (`worker.stream_cases`:
`start`, `generate`, `run`, `step` of 8 prompts, whose prefill routing
groups span the data ranks, on both configs; 3 prompts and `serve`,
`start` + `generate`, `serve` again on granite-smoke at (2, 2)):
tokens, StepStats bytes and the trace equal the port's unmeshed engine
and the reference's, logits within `STREAM_ATOL`. The steps: `tests/test_torch_mesh_train.py`'s
`TOL` against the reference's. Beside them: each rank's weight shards
at `launch.shardings.local_shape` (and at the rank-local config's
schema), a (2, 2) checkpoint restored on (1, 2) and without a mesh, and
the serve CLI's `--parity --mesh` for granite-moe in a subprocess.
"""

import collections
import dataclasses
import multiprocessing
import os
import pickle
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import trace_bridge as jtb  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.shardings import local_shape  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from repro_torch.models.transformer import TensorParallel  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training.train_step import TrainState  # noqa: E402
from repro_torch.tree import leaves_with_path, path_name  # noqa: E402

import _torch_mesh_moe_worker as worker  # noqa: E402
from _torch_mesh_worker import drive_stream, stream_prompts  # noqa: E402
from _torch_serve_ref import (  # noqa: E402
    JAX_H100, assert_same, engines, smoke_pair,
)
from _torch_serve_ref import outcome as ref_outcome  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"granite": "granite-moe-3b-a800m",
         "llama4": "llama4-maverick-400b-a17b"}
#: the meshes, in the order the ranks build them (the checkpoint of
#: `worker.SAVED_ON` before its restore on `worker.RESTORED_ON`)
SHAPES = [(2, 2), (4, 1), (1, 2)]
IDS = [f"{d}x{m}" for d, m in SHAPES]
#: the ranks spawned; a smaller mesh takes the first of them
WORLD = 4
#: seconds to wait for the ranks
JOIN_S = 420
#: `tests/test_torch_mesh_train.py`'s
TOL = {"metric": 1e-5, "params": 1e-4, "opt": 1e-6}
TRAIN_ARCH = "granite"
#: a meshed single stream's logits against the unmeshed streams' (f32;
#: `tests/test_torch_mesh_serve.py`'s)
STREAM_ATOL = 2e-5


def moe_pair(arch):
    name = ARCHS[arch]
    moe = dataclasses.replace(tconfigs.get_smoke(name).moe,
                              capacity_factor=0.5)
    return smoke_pair(name, moe=moe)


def unmeshed_serves(models):
    """{mode: (the reference's outcome, the port's)} of the stream, and
    under "drops" the choices the port's inline serve dropped, by
    routing group size."""
    from repro_torch.models import moe
    out = {"drops": collections.Counter()}
    route = moe.route_logits

    def counted(logits, cfg):
        dispatch, combine = route(logits, cfg)
        G, s = logits.shape[:2]
        out["drops"][s] += G * s * cfg.moe.top_k - int(dispatch.sum())
        return dispatch, combine
    for mode in worker.MODES:
        jeng, _ = engines(models, overlap=mode == "overlap",
                          **worker.ENGINE)
        jrep = jeng.serve(worker.stream(JRequest, models[2].cfg.vocab),
                          num_slots=worker.SLOTS, seed=0)
        _, _, tm, tp = models
        moe.route_logits = counted if mode == "inline" else route
        try:
            port = worker.serve_case(tm.cfg, tp, mode)
        finally:
            moe.route_logits = route
        out[mode] = (ref_outcome(jeng, jrep), port)
    return out


def unmeshed_streams(models, arch):
    """{case: (the reference's outcome or None, the port's)} of the
    arch's single-stream cases (the reference has no `AGAIN` here: the
    port's unmeshed one is held to its serves)."""
    jm, jp, tm, tp = models
    out = {}
    for _, case in worker.stream_cases(worker.EXTRA_ON, [arch]):
        if case != worker.AGAIN and (case == "stream"
                                     or arch == worker.EXTRA_ARCH):
            eng = JEngine(jm, jp, JConfig(**{**dataclasses.asdict(
                worker.stream_config()), "spec": JAX_H100}))
            ref = drive_stream(eng, stream_prompts(
                worker.STREAMS[case], jm.cfg.vocab, worker.STREAM_PROMPT),
                jnp.asarray, np.asarray, jtb.collect)
        else:
            ref = None
        if case == "stream" or arch == worker.EXTRA_ARCH:
            out[case] = (ref, worker.stream_case(tm.cfg, tp, case))
    return out


def numpy_state(params, opt):
    return {"params": [np.asarray(x) for x in jax.tree.leaves(params)],
            "m": [np.asarray(x) for x in jax.tree.leaves(opt.m)],
            "v": [np.asarray(x) for x in jax.tree.leaves(opt.v)]}


def reference_steps(jm, js, batches):
    """The reference's state after each batch (numpy) and its metrics."""
    step = jax.jit(jmake(jm, lr=worker.LR))
    states, metrics = [], []
    for toks in batches:
        js, m = step(js, {"tokens": jnp.asarray(toks)})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
        states.append(numpy_state(js.params, js.opt))
    return states, metrics


def run_ranks(tmp, data_path):
    """Spawn the `WORLD` ranks over `SHAPES` and wait for them; their
    exit codes. Ranks still alive after `JOIN_S` are killed."""
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=worker.rank_main,
                         args=(r, WORLD, str(tmp / "store"), SHAPES,
                               data_path, str(tmp)))
             for r in range(WORLD)]
    try:
        for proc in ranks:
            proc.start()
        for proc in ranks:
            proc.join(JOIN_S)
    finally:
        for proc in ranks:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [proc.exitcode for proc in ranks]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"serve": {arch: {mode: (reference, port)}}, "train": the
    reference's (states, metrics), (data, model): [each rank's results,
    by rank], "cfgs": {arch: the port's config}}."""
    models = {arch: moe_pair(arch) for arch in ARCHS}
    jm, _, tm, _ = models[TRAIN_ARCH]
    js = jinit(jm, jax.random.key(0))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, tm.cfg.vocab, (4, 33)).astype(np.int32)
               for _ in range(worker.CKPT_STEP + 1)]
    tmp = tmp_path_factory.mktemp("mesh_moe")
    data_path = str(tmp / "data.pkl")
    with open(data_path, "wb") as f:
        pickle.dump({
            "serve": {arch: (m[2].cfg, m[3]) for arch, m in models.items()},
            "train_cfg": tm.cfg, "params": jax.device_get(js.params),
            "opt": {"step": np.asarray(js.opt.step),
                    "m": jax.device_get(js.opt.m),
                    "v": jax.device_get(js.opt.v)},
            "batches": batches}, f)
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(
        run_ranks(tmp, data_path)))
    ranks.start()
    try:
        got = {"serve": {arch: unmeshed_serves(m)
                         for arch, m in models.items()},
               "streams": {arch: unmeshed_streams(m, arch)
                           for arch, m in models.items()},
               "train": reference_steps(jm, js, batches)}
    finally:
        ranks.join()
    assert codes == [0] * WORLD, codes
    by_rank = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(WORLD)]
    for (data, model) in SHAPES:
        got[(data, model)] = [res[(data, model)]
                              for res in by_rank[:data * model]]
    got["cfgs"] = {arch: m[2].cfg for arch, m in models.items()}
    got["tmp"] = tmp
    got["batches"] = batches
    return got


def shapes(cfg):
    """{leaf name: shape} of `cfg`'s parameters."""
    return {path_name(p): tuple(t.shape) for p, t in leaves_with_path(
        abstract_params(Model(cfg).schema(), cfg.param_dtype))}


SERVES = [(shape, arch, mode) for shape in SHAPES for arch in ARCHS
          for mode in worker.MODES]


@pytest.mark.parametrize("shape,arch,mode", SERVES,
                         ids=[f"{d}x{m}-{a}-{o}" for (d, m), a, o in SERVES])
def test_meshed_moe_serve_equals_the_unmeshed_serves(runs, shape, arch,
                                                     mode):
    """Tokens, statuses, events and every priced step's bytes on every
    rank equal the reference's unmeshed serve and the port's."""
    ref, port = runs["serve"][arch][mode]
    assert_same(port, ref)
    for rank, res in enumerate(runs[shape]):
        got = res[(arch, mode)]
        assert_same(got, ref)
        assert_same(got, port)


STREAMS = [(shape, arch, case) for shape in SHAPES
           for arch, case in worker.stream_cases(shape, ARCHS)
           if case != worker.AGAIN]


@pytest.mark.parametrize("shape,arch,case", STREAMS,
                         ids=[f"{d}x{m}-{a}-{c}" for (d, m), a, c in STREAMS])
def test_meshed_moe_single_stream_equals_the_unmeshed_streams(
        runs, shape, arch, case):
    """`start`, `generate`, `run` and `step` of a meshed moe engine on
    every rank: tokens, every StepStats row's bytes and the collected
    trace equal the port's unmeshed stream's and the reference's, the
    logits (whole on every rank) within `STREAM_ATOL`; the stream reads
    the host tier."""
    ref, port = runs["streams"][arch][case]
    assert any(b[1] > 0 for b in ref["bytes"])
    for res in runs[shape]:
        got = res[(arch, case)]
        for want in (port, ref):
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            assert got["bytes"] == want["bytes"]
            for a, b in zip(got["trace"], want["trace"]):
                np.testing.assert_array_equal(a, b)
            for k in ("start", "run", "step"):
                assert got[k].shape == want[k].shape, k
                np.testing.assert_allclose(got[k], want[k],
                                           atol=STREAM_ATOL, err_msg=k)


def test_serve_start_generate_serve_on_one_meshed_moe_engine(runs):
    """granite-smoke's `serve`, `start` + `generate`, `serve` again on one
    engine at (2, 2), on every rank, against the same on the port's
    unmeshed engine, whose serves equal the reference's serve."""
    arch = worker.EXTRA_ARCH
    _, want = runs["streams"][arch][worker.AGAIN]
    ref, _ = runs["serve"][arch]["inline"]
    for part in ("serve", "served again"):
        assert_same(want[part], ref)
    for res in runs[worker.EXTRA_ON]:
        got = res[(arch, worker.AGAIN)]
        for part in ("serve", "served again"):
            assert_same(got[part], want[part])
        np.testing.assert_array_equal(got["stream"]["tokens"],
                                      want["stream"]["tokens"])
        assert got["stream"]["bytes"] == want["stream"]["bytes"]
        np.testing.assert_allclose(got["stream"]["start"],
                                   want["stream"]["start"],
                                   atol=STREAM_ATOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_streams_drop_choices_and_spill(runs, arch):
    """Every request completes; the stream reads the host tier and
    migrates pages; decode groups (the 8 lanes) and prefill groups (8 x
    16 slots) both drop choices past an expert's capacity."""
    ref, _ = runs["serve"][arch]["inline"]
    assert set(s for s, _ in ref["statuses"].values()) == {"ok"}
    assert sum(b[1] for b in ref["bytes"]) > 0
    assert sum(b[2] + b[3] for b in ref["bytes"]) > 0
    drops = runs["serve"][arch]["drops"]
    chunk = worker.ENGINE["prefill_chunk"]
    assert drops[worker.SLOTS] > 0, drops
    assert drops[worker.SLOTS * chunk] > 0, drops


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_rank_holds_its_expert_shards(runs, shape, arch):
    """Each rank's weights are its serve-mode shards: every leaf at
    `local_shape` of its `leaf_spec` (the expert leaves split by experts
    over `model`, the router whole), equal to the rank-local config's
    schema but for the vocabulary rows (`TensorParallel.vocab`)."""
    cfg = runs["cfgs"][arch]
    mesh = AbstractMesh(("data", "model"), shape)
    specs = bridge.param_specs(cfg, mesh, "serve")
    want = {k: local_shape(s, specs[k], mesh)
            for k, s in shapes(cfg).items()}
    lo, hi = TensorParallel.of(cfg, shape[1], 0, None, None).vocab or (
        0, cfg.vocab)
    local = shapes(cfg.rank_local(shape[1]))
    local["embed"] = (hi - lo, cfg.d_model)
    local["unembed"] = (cfg.d_model, hi - lo)
    assert local == want
    E = cfg.moe.num_experts_padded
    assert want["layers/we_gate" if cfg.moe.interleave == 1
                else "layers/moe/we_gate"][1] == E // shape[1]
    for res in runs[shape]:
        for mode in worker.MODES:
            assert res[(arch, mode)]["held"] == want


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 4), (2, 4)],
                         ids=["1x2", "2x2", "1x4", "2x4"])
def test_full_width_expert_rule(data, model):
    """granite-moe-3b-a800m's 48 padded experts split over `model` (24 or
    12 a rank), each expert's MLP whole; in train mode `data` takes
    their `embed`; the router and moe_norm whole on both axes; the
    rank-local config and `TensorParallel.of` count the same."""
    cfg = tconfigs.get("granite-moe-3b-a800m")
    mesh = AbstractMesh(("data", "model"), (data, model))
    serve = bridge.param_specs(cfg, mesh, "serve")
    train = bridge.param_specs(cfg, mesh, "train")
    assert serve["layers/we_gate"] == (None, "model", None, None)
    assert serve["layers/we_down"] == (None, "model", None, None)
    fsdp = "data" if data > 1 else None
    assert train["layers/we_gate"] == (None, "model", fsdp, None)
    assert train["layers/we_down"] == (None, "model", None, fsdp)
    for name in ("layers/router", "layers/moe_norm"):
        assert set(train[name]) == {None}, name
    local = cfg.rank_local(model)
    assert local.moe.local_experts == 48 // model
    assert local.moe.expert_d_ff == cfg.d_ff
    assert local.moe.num_experts_padded == 48
    for rank in (0, model - 1):
        tp = TensorParallel.of(cfg, model, rank, None, None)
        assert tp.experts == (rank * 48 // model, (rank + 1) * 48 // model)


def assert_metrics(got, want):
    assert len(got) == len(want)
    for (gl, gn, gs), (wl, wn, ws) in zip(got, want):
        assert gs == ws
        assert abs(gl - wl) <= TOL["metric"] * abs(wl), (gl, wl)
        assert abs(gn - wn) <= TOL["metric"] * abs(wn), (gn, wn)


def assert_state(got, want):
    for key, tol in (("params", TOL["params"]), ("m", TOL["opt"]),
                     ("v", TOL["opt"])):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            assert a.shape == b.shape, key
            err = float(np.abs(a - b).max())
            assert err <= tol, (key, err)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_three_meshed_moe_steps_equal_the_references(runs, shape):
    """Three meshed steps of granite-smoke (routing groups of all 4 rows'
    128 tokens, across the data ranks) against the reference's: every
    rank reports the global loss and grad norm, and the whole leaves
    gathered from the shards match."""
    states, metrics = runs["train"]
    for res in runs[shape]:
        assert_metrics(res["train"]["metrics"], metrics[:worker.CKPT_STEP])
    assert_state(runs[shape][0]["train"]["whole"],
                 states[worker.CKPT_STEP - 1])


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_train_state_holds_train_mode_shards(runs, shape):
    """A training rank's parameters, m and v are its train-mode shards
    (`bridge.train_state_specs`): the expert leaves split by experts
    over `model` and by `embed` over `data`."""
    cfg = runs["cfgs"][TRAIN_ARCH]
    mesh = AbstractMesh(("data", "model"), shape)
    specs = bridge.train_state_specs(cfg, mesh)
    params = abstract_params(Model(cfg).schema(), cfg.param_dtype)
    state = TrainState(params=params, opt=adamw_init(params))
    want = {path_name(p): local_shape(t.shape, specs[path_name(p)], mesh)
            for p, t in leaves_with_path(state)}
    for res in runs[shape]:
        assert res["train"]["held"] == want
    d, m = shape
    assert want[".params/layers/we_gate"][1:3] == (4 // m, 64 // d)


def test_checkpoint_saved_on_2x2_restores_on_1x2(runs):
    """The (2, 2) checkpoint after three steps, restored on (1, 2): its
    fourth step's metrics and state are the reference's."""
    states, metrics = runs["train"]
    for res in runs[worker.RESTORED_ON]:
        assert_metrics(res["restored"]["metrics"],
                       metrics[worker.CKPT_STEP:])
    assert_state(runs[worker.RESTORED_ON][0]["restored"]["whole"],
                 states[worker.CKPT_STEP])


def test_checkpoint_saved_on_2x2_restores_without_a_mesh(runs):
    """The (2, 2) checkpoint holds whole leaves: restored here with no
    mesh, its fourth step is the reference's."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.training.train_step import make_train_step
    cfg = runs["cfgs"][TRAIN_ARCH]
    params = abstract_params(Model(cfg).schema(), cfg.param_dtype)
    state = CheckpointManager(str(runs["tmp"] / "ckpt")).restore(
        TrainState(params=params, opt=adamw_init(params)),
        step=worker.CKPT_STEP, device="cpu")
    state, metrics = worker.run_steps(
        state, make_train_step(Model(cfg), lr=worker.LR),
        runs["batches"][worker.CKPT_STEP:])
    states, want = runs["train"]
    assert_metrics(metrics, want[worker.CKPT_STEP:])
    assert_state({"params": worker.numpy_tree(state.params),
                  "m": worker.numpy_tree(state.opt.m),
                  "v": worker.numpy_tree(state.opt.v)},
                 states[worker.CKPT_STEP])


def test_cli_moe_mesh_parity_subprocess():
    """`repro_torch.launch.serve --smoke --parity --mesh data=2,model=2
    --arch granite-moe-3b-a800m --device cpu` spawns its 4 ranks and
    prints MESH PARITY OK."""
    env = dict(os.environ)
    src = os.path.join(REPO, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--arch", "granite-moe-3b-a800m", "--parity", "--mesh",
         "data=2,model=2", "--device", "cpu", "--requests", "4",
         "--new-tokens", "3", "--batch-slots", "4", "--stride", "8"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "MESH PARITY OK" in proc.stdout, proc.stdout
