"""The port's meshed train step (`make_train_step(..., mesh=)`) on real
multi-rank gloo meshes on the CPU, against the reference's
`make_train_step` and the port's unmeshed step.

internlm2-1.8b's smoke config in float32 (2 layers, d 64, 4/2 heads,
d_ff 128, vocab 256), from one `init_train_state` of the reference
(carried by the bridge, each rank cutting its train-mode shards). Four
ranks are spawned once, over a `file://` store in `tmp_path`, and build
the meshes (2, 2), (4, 1) and (1, 2) (the last over ranks 0 and 1) one
after another, running on each the cases of
`_torch_mesh_train_worker.CASES` given here (every collective times
out after 60 s). While they run, this process takes the same steps
through the reference and the port unmeshed.

Tolerances are `tests/test_torch_train.py`'s: loss and grad norm 1e-5
relative, parameters 1e-4 (a tenth of lr = 1e-3), m and v 1e-6, on the
whole leaves gathered by `bridge.unshard`. Beside them: accum_steps=2,
the donated step on (2, 2) (bitwise the pure one's, in place),
rows no data axis divides, each rank's stored bytes, a checkpoint saved
on (2, 2) restored on (2, 2) (bitwise), (4, 1), (1, 2) and without a
mesh, the differentiable collectives, per-head norm weights (qwen3's
qk norm), and the train CLI across a mesh in a subprocess (a `model`
axis that does not divide the KV heads:
tests/test_torch_mesh_kv_train.py).
"""

import math
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

from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.shardings import local_shape  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainState, init_train_state, make_train_step,
)
from repro_torch.tree import (  # noqa: E402
    leaves_with_path, path_name, tree_leaves,
)

import _torch_mesh_train_worker as worker  # noqa: E402
from _torch_serve_ref import smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (data, model) -> the cases its ranks run, in order
SHAPES = {(2, 2): ("steps", "accum", "donated", "qk_norm", "collectives"),
          (4, 1): ("steps", "replicated", "restored"),
          (1, 2): ("steps", "restored")}
#: the ranks spawned; a smaller mesh takes the first of them
WORLD = 4
#: seconds to wait for the ranks
JOIN_S = 300
TOL = {"metric": 1e-5, "params": 1e-4, "opt": 1e-6}


def run_ranks(tmp, data_path):
    """Spawn the `WORLD` ranks over `SHAPES` and wait for them; their
    exit codes. Ranks still alive after `JOIN_S` are killed."""
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(
        target=worker.rank_main,
        args=(r, WORLD, str(tmp / "store"), list(SHAPES.items()), data_path,
              str(tmp))) for r in range(WORLD)]
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


def numpy_state(params, opt):
    """{"params", "m", "v"}: numpy leaves in tree order."""
    return {"params": [np.asarray(x) for x in jax.tree.leaves(params)],
            "m": [np.asarray(x) for x in jax.tree.leaves(opt.m)],
            "v": [np.asarray(x) for x in jax.tree.leaves(opt.v)]}


def reference_steps(jm, js, batches, accum=1):
    """The reference's state after each batch (numpy) and its metrics."""
    step = jax.jit(jmake(jm, lr=worker.LR, accum_steps=accum))
    states, metrics = [], []
    for toks in batches:
        js, m = step(js, {"tokens": jnp.asarray(toks)})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
        states.append(numpy_state(js.params, js.opt))
    return states, metrics


def port_steps(model, state, batches):
    """The port's unmeshed state after the batches (numpy) and the
    metrics of each step."""
    state, metrics = worker.run_steps(
        state, make_train_step(model, lr=worker.LR), batches)
    return {"params": worker.numpy_tree(state.params),
            "m": worker.numpy_tree(state.opt.m),
            "v": worker.numpy_tree(state.opt.v)}, metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's {case: (states, metrics)}, "port": the
    port's unmeshed {case: (state, metrics)}, (data, model): [each
    rank's results, by rank], "tmp": the ranks' directory}."""
    jm, _, tm, _ = smoke_pair("internlm2-1.8b")
    js = jinit(jm, jax.random.key(0))
    params_np = jax.device_get(js.params)
    opt_np = {"step": np.asarray(js.opt.step),
              "m": jax.device_get(js.opt.m), "v": jax.device_get(js.opt.v)}
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, tm.cfg.vocab, (4, 33)).astype(np.int32)
               for _ in range(worker.CKPT_STEP + 1)]
    odd = [rng.integers(0, tm.cfg.vocab, (3, 33)).astype(np.int32)
           for _ in range(3)]
    tmp = tmp_path_factory.mktemp("mesh_train")
    data_path = str(tmp / "data.pkl")
    with open(data_path, "wb") as f:
        pickle.dump({"params": params_np, "opt": opt_np, "batches": batches,
                     "odd_batches": odd}, f)
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(
        run_ranks(tmp, data_path)))
    ranks.start()
    try:
        start = bridge.train_state_from_jax(params_np, opt_np, tm.cfg,
                                            device="cpu")
        qwen = Model(worker.f32_smoke("qwen3-32b"))
        got = {"ref": {"steps": reference_steps(jm, js, batches),
                       "accum": reference_steps(jm, js, batches[:3], 2),
                       "replicated": reference_steps(jm, js, odd)},
               "port": {"steps": port_steps(tm, start, batches[:3]),
                        "qk_norm": port_steps(
                            qwen, init_train_state(qwen, 1, "cpu"),
                            batches[:2])}}
    finally:
        ranks.join()
    assert codes == [0] * WORLD, codes
    by_rank = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(WORLD)]
    for (data, model) in SHAPES:
        got[(data, model)] = [res[(data, model)]
                              for res in by_rank[:data * model]]
    got["tmp"] = tmp
    got["model"] = tm
    return got


def abstract_state(model):
    """A `TrainState` of the whole model on the meta device."""
    params = abstract_params(model.schema(), model.cfg.param_dtype)
    return TrainState(params=params, opt=adamw_init(params))


def assert_metrics(got, want):
    assert len(got) == len(want)
    for (gl, gn, gs), (wl, wn, ws) in zip(got, want):
        assert gs == ws
        assert abs(gl - wl) <= TOL["metric"] * abs(wl), (gl, wl)
        assert abs(gn - wn) <= TOL["metric"] * abs(wn), (gn, wn)


def assert_state(got, want, params_tol=TOL["params"]):
    for key, tol in (("params", params_tol), ("m", TOL["opt"]),
                     ("v", TOL["opt"])):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            assert a.shape == b.shape, key
            err = float(np.abs(a - b).max())
            assert err <= tol, (key, err)


MESHES = list(SHAPES)
IDS = [f"{d}x{m}" for d, m in MESHES]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_three_steps_equal_the_references(runs, shape):
    """Three meshed steps against the reference's and the port's
    unmeshed ones: every rank reports the global loss and grad norm, and
    the whole leaves gathered from the shards match."""
    ref_states, ref_metrics = runs["ref"]["steps"]
    port_state, port_metrics = runs["port"]["steps"]
    for res in runs[shape]:
        got = res["steps"]["metrics"]
        assert_metrics(got, ref_metrics[:3])
        assert_metrics(got, port_metrics)
    whole = runs[shape][0]["steps"]["whole"]
    assert_state(whole, ref_states[2])
    assert_state(whole, port_state)


def test_accumulation_on_a_2x2_mesh(runs):
    """accum_steps=2 splits each data rank's rows into micro-batches:
    the step equals the reference's accumulated one."""
    ref_states, ref_metrics = runs["ref"]["accum"]
    for res in runs[(2, 2)]:
        assert_metrics(res["accum"]["metrics"], ref_metrics)
    assert_state(runs[(2, 2)][0]["accum"]["whole"], ref_states[-1])


def test_donated_steps_on_a_2x2_mesh(runs):
    """Three donated meshed steps (`donate=True`, as the train CLI runs
    them): each rank's state is its own tensors written in place, and
    its shards, losses and grad norms are bitwise the pure steps'."""
    for res in runs[(2, 2)]:
        got, want = res["donated"], res["steps"]
        assert got["in_place"]
        assert got["metrics"] == want["metrics"]
        for key in ("params", "m", "v"):
            for a, b in zip(got["shards"][key], want["shards"][key],
                            strict=True):
                np.testing.assert_array_equal(a, b)


def test_rows_the_data_axis_does_not_divide(runs):
    """3 rows over a data axis of 4: every rank takes every row
    (`batch_axes` gives ()), and the step is still the reference's."""
    ref_states, ref_metrics = runs["ref"]["replicated"]
    for res in runs[(4, 1)]:
        assert_metrics(res["replicated"]["metrics"], ref_metrics)
    assert_state(runs[(4, 1)][0]["replicated"]["whole"], ref_states[-1])


def test_per_head_norm_weights_train_across_the_model_axis(runs):
    """qwen3's q/k norms are whole on `model` and used on each rank's
    heads alone: their gradients are summed over the axis (`enter`), so
    two steps on (2, 2) equal the unmeshed port's."""
    port_state, port_metrics = runs["port"]["qk_norm"]
    for res in runs[(2, 2)]:
        assert_metrics(res["qk_norm"]["metrics"], port_metrics)
    assert_state(runs[(2, 2)][0]["qk_norm"]["whole"], port_state)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_rank_holds_its_shards_alone(runs, shape):
    """A rank's parameters, m and v are exactly its train-mode shards
    (`bridge.train_state_specs`): every leaf at its block's shape, no
    whole copy beside them; the bytes add up to the shards', below the
    whole state's on every mesh here."""
    tm = runs["model"]
    mesh = AbstractMesh(("data", "model"), shape)
    specs = bridge.train_state_specs(tm.cfg, mesh)
    whole_state = abstract_state(tm)
    wants = {path_name(p): local_shape(t.shape, specs[path_name(p)], mesh)
             for p, t in leaves_with_path(whole_state)}
    whole_bytes = sum(math.prod(t.shape) * 4
                      for t in tree_leaves(whole_state))
    for res in runs[shape]:
        shapes, nbytes = res["steps"]["held"]
        assert shapes == wants
        assert nbytes == sum(math.prod(s) * 4 for s in wants.values())
        assert nbytes < whole_bytes


def test_train_rule_of_internlm2_at_2x2():
    """The FSDP blocks internlm2's leaves get at (2, 2): `wq` embed over
    data and heads over model, `w_down` mlp over model and embed over
    data, `embed` vocab over model and embed over data; the norms whole
    on both (the train rule keeps `model` off `embed`)."""
    cfg = tconfigs.get("internlm2-1.8b")
    specs = bridge.param_specs(cfg, AbstractMesh(("data", "model"), (2, 2)))
    assert specs["layers/wq"] == (None, "data", "model", None)
    assert specs["layers/w_down"] == (None, "model", "data")
    assert specs["embed"] == ("model", "data")
    assert specs["unembed"] == ("data", "model")
    for name in ("layers/attn_norm", "layers/mlp_norm", "final_norm"):
        assert set(specs[name]) == {None}, name


def test_checkpoint_restores_bitwise_on_the_mesh_that_saved(runs):
    """Each mesh saves its state after step 3 and restores it: the
    fourth step from the restored shards is bitwise the straight one."""
    for shape in SHAPES:
        for res in runs[shape]:
            assert res["steps"]["bitwise"], shape


@pytest.mark.parametrize("shape", [(4, 1), (1, 2)], ids=["4x1", "1x2"])
def test_checkpoint_restores_on_another_mesh(runs, shape):
    """The (2, 2) checkpoint restored on another mesh continues as the
    reference does: its fourth step's metrics and state."""
    ref_states, ref_metrics = runs["ref"]["steps"]
    for res in runs[shape]:
        assert_metrics(res["restored"]["metrics"], ref_metrics[3:])
    assert_state(runs[shape][0]["restored"]["whole"], ref_states[3])


def test_checkpoint_restores_without_a_mesh(runs):
    """The (2, 2) checkpoint holds whole leaves: restored here with no
    mesh it continues as the reference does."""
    tm = runs["model"]
    ref_states, ref_metrics = runs["ref"]["steps"]
    mgr = CheckpointManager(worker.ckpt_dir(str(runs["tmp"]),
                                            worker.SAVED_ON))
    assert mgr.latest_step() == worker.CKPT_STEP
    state = mgr.restore(abstract_state(tm), device="cpu")
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, tm.cfg.vocab, (4, 33)).astype(np.int32)
               for _ in range(worker.CKPT_STEP + 1)]
    got, metrics = port_steps(tm, state, batches[worker.CKPT_STEP:])
    assert_metrics(metrics, ref_metrics[3:])
    assert_state(got, ref_states[3])


def test_collectives_transpose_each_other(runs):
    """On (2, 2): `gather_data` and `gather_model` reassemble the blocks
    `shard` cuts (first axis major); `gather_data`'s gradient is the sum
    over the data ranks of their gradients' blocks, `gather_model`'s the
    rank's own slice; `enter_model` is the identity with the gradient
    summed over `model`, `sum_model` the sum with the gradient passed
    through."""
    ranks = runs[(2, 2)]
    w = {res["collectives"]["rank"]: res["collectives"]["w"] for res in ranks}
    for res in ranks:
        got, coord = res["collectives"], res["coord"]
        d, m = coord["data"], coord["model"]
        data_peers = [dd * 2 + m for dd in range(2)]
        model_peers = [d * 2 + mm for mm in range(2)]
        same, g = got["gather_data"]
        assert same
        np.testing.assert_allclose(
            g, sum(w[r] for r in data_peers)[:, 3 * d:3 * d + 3], rtol=1e-6)
        same, g = got["gather_model"]
        assert same
        np.testing.assert_array_equal(g, w[got["rank"]][:, 3 * m:3 * m + 3])
        x, g = got["enter_model"]
        np.testing.assert_allclose(g, sum(w[r] for r in model_peers),
                                   rtol=1e-6)
        y, g = got["sum_model"]
        np.testing.assert_allclose(y, 2 * ranks[0]["collectives"][
            "enter_model"][0], rtol=1e-6)
        np.testing.assert_array_equal(g, w[got["rank"]])


def cli(*args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(REPO, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--seq", "32", "--batch", "4", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


def test_cli_trains_saves_and_resumes_across_a_mesh(tmp_path):
    """`--data 2 --model 2` spawns its 4 ranks, trains and checkpoints;
    a second call at `--data 1 --model 2` auto-resumes that checkpoint
    on its 2 ranks and trains on; rank 0 prints, and reports each
    rank's bytes."""
    ck = str(tmp_path / "ck")
    first = cli("--data", "2", "--model", "2", "--steps", "2",
                "--ckpt-dir", ck)
    assert first.returncode == 0, (first.stdout, first.stderr)
    lines = first.stdout.strip().splitlines()
    assert lines[-1] == "done", first.stdout
    assert sum(line.startswith("rank ") for line in lines) == 4
    assert os.path.exists(os.path.join(ck, "step_2", "COMMIT"))

    second = cli("--data", "1", "--model", "2", "--steps", "10",
                 "--ckpt-dir", ck, "--ckpt-every", "100")
    assert second.returncode == 0, (second.stdout, second.stderr)
    lines = second.stdout.strip().splitlines()
    assert lines[0] == "auto-resumed from step 2"
    assert lines[1].startswith("step    10 loss ")
    loss = float(lines[1].split()[3])
    assert math.isfinite(loss)
    assert sum(line.startswith("rank ") for line in lines) == 2
    assert lines[-1] == "done"
    assert sorted(os.listdir(ck)) == ["step_10", "step_2"]
