"""The cases of the port's meshed family training tests
(`tests/test_torch_mesh_families.py`: vlm and encdec;
`tests/test_torch_mesh_recurrent.py`: hybrid, ssm and xlstm), made per
family group by `family_tests` so each file spawns its own ranks and
the two run side by side: the port's meshed train step
(`make_train_step(..., mesh=)`) on real multi-rank gloo meshes on the
CPU, against the reference's `make_train_step` and the port's unmeshed
step.

The float32 smoke configs of internvl2-2b (vlm: 16 patch embeddings
before the text), whisper-tiny (encdec: 64 frames, tied vocabulary),
zamba2-1.2b (hybrid: Mamba2 blocks and the shared attention site),
zamba2's stack with no site (ssm) and xlstm-125m (mLSTM and sLSTM
blocks), each from one `init_train_state` of the reference carried by
the bridge, each rank cutting its train-mode shards. Four ranks are
spawned once a file, over a `file://` store in `tmp_path`, and build
the meshes (2, 2), (4, 1) and (1, 2) (the last over ranks 0 and 1) one
after another, running the cases of `_torch_mesh_family_worker.CASES`
given here for every family (every collective times out after 60 s).
While they run, the test process takes the same steps through the
reference and the port unmeshed.

Tolerances are `tests/test_torch_train.py`'s for a train step: loss and
grad norm 1e-5 relative, parameters 1e-4 (a tenth of lr = 1e-3), m and
v 1e-6, on the whole leaves gathered by `bridge.unshard`; the Mamba2
families' (`MAMBA_TOL`) are wider, for the reason stated there. Beside
them: accum_steps=2, each rank's stored bytes, and a checkpoint saved
on (2, 2) restored on (4, 1), (1, 2) and without a mesh.
"""

import dataclasses
import math
import multiprocessing
import os
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.model import Model as JModel
from repro.training.train_step import init_train_state as jinit
from repro.training.train_step import make_train_step as jmake
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.shardings import local_shape
from repro_torch.models.model import Model
from repro_torch.models.params import abstract_params
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import (
    TrainState, make_train_step,
)
from repro_torch.tree import (
    leaves_with_path, path_name, tree_leaves,
)

import _torch_mesh_family_worker as worker
from repro import configs as jconfigs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (data, model) -> the cases its ranks run, in order (the saving mesh
#: first)
SHAPES = {(2, 2): ("steps", "accum"),
          (4, 1): ("steps", "restored"),
          (1, 2): ("steps", "restored")}
#: the ranks spawned; a smaller mesh takes the first of them
WORLD = 4
#: seconds to wait for the ranks
JOIN_S = 300
TOL = {"metric": 1e-5, "params": 1e-4, "opt": 1e-6}
#: the hybrid and ssm families'. AdamW's first update is g / (|g| + eps)
#: per element, so a gradient element near eps after the clip (here
#: ~1e-7, a millionth of its leaf's largest, in `w_in`, `w_out` and the
#: site's `w_up`) turns its f32 noise into a tenth of a step: the
#: unmeshed port's parameters differ from the reference's by up to
#: 7.7e-5 after two steps, the meshed step's from the unmeshed port's
#: by up to 1.1e-4 after one (at (1, 2)), and the second step's
#: gradient, taken at those parameters, with them: its norm by 7e-5
#: relative, m by up to 2.9e-6 (the ssm family's embedding). After the
#: first step m and v, the gradient itself, stay within 1e-6.
MAMBA_TOL = {"metric": 1e-4, "params": 2.5e-4, "opt": 1e-5}
#: batch rows and tokens a row
ROWS, SEQ = 4, 17


def reference_model(name):
    """The reference's model of `worker.family_cfg(name)`."""
    base = name.replace("-ssm", "-1.2b") if name.endswith("-ssm") else name
    jcfg = dataclasses.replace(jconfigs.get_smoke(base), dtype=jnp.float32,
                               param_dtype=jnp.float32)
    if name.endswith("-ssm"):
        jcfg = dataclasses.replace(jcfg, family="ssm",
                                   ssm=dataclasses.replace(jcfg.ssm,
                                                           attn_every=0))
    return JModel(jcfg)


def batches(cfg, n, seed=3):
    """`n` batches of `ROWS` rows: tokens and the family's extra."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (ROWS, SEQ)).astype(
            np.int32)}
        for key in worker.extra_keys(cfg):
            b[key] = rng.standard_normal(
                (ROWS, cfg.frontend.num_embeddings, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


def numpy_state(params, opt):
    """{"params", "m", "v"}: numpy leaves in tree order."""
    return {"params": [np.asarray(x) for x in jax.tree.leaves(params)],
            "m": [np.asarray(x) for x in jax.tree.leaves(opt.m)],
            "v": [np.asarray(x) for x in jax.tree.leaves(opt.v)]}


def reference_steps(jm, js, bs, keys, accum=1):
    """The reference's state after each batch (numpy) and its metrics."""
    step = jax.jit(jmake(jm, lr=worker.LR, accum_steps=accum,
                         extra_keys=keys))
    states, metrics = [], []
    for b in bs:
        js, m = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
        states.append(numpy_state(js.params, js.opt))
    return states, metrics


def port_steps(model, state, bs):
    """The port's unmeshed state after the batches (numpy) and the
    metrics of each step."""
    state, metrics = worker.run_steps(
        state, make_train_step(model, lr=worker.LR,
                               extra_keys=worker.extra_keys(model.cfg)), bs)
    return {"params": worker.numpy_tree(state.params),
            "m": worker.numpy_tree(state.opt.m),
            "v": worker.numpy_tree(state.opt.v)}, metrics


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


def abstract_state(model):
    """A `TrainState` of the whole model on the meta device."""
    params = abstract_params(model.schema(), model.cfg.param_dtype)
    return TrainState(params=params, opt=adamw_init(params))


def tol_of(name):
    return MAMBA_TOL if name.startswith("zamba2") else TOL


def assert_metrics(got, want, tol=TOL):
    assert len(got) == len(want)
    for (gl, gn, gs), (wl, wn, ws) in zip(got, want):
        assert gs == ws
        assert abs(gl - wl) <= tol["metric"] * abs(wl), (gl, wl)
        assert abs(gn - wn) <= tol["metric"] * abs(wn), (gn, wn)


def assert_state(got, want, tol=TOL):
    for key, tol in (("params", tol["params"]), ("m", tol["opt"]),
                     ("v", tol["opt"])):
        assert len(got[key]) == len(want[key])
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            assert a.shape == b.shape, (key, i)
            err = float(np.abs(a - b).max())
            assert err <= tol, (key, i, err)


def test_split_layers_on_threads_equal_the_unsplit():
    """`chip_smoke.py`'s phase 16b on the CPU at the f32 smoke configs
    (4 rows of 24 tokens): each family's layer blocks run split over
    (data, model) = (1, 2), (2, 2) and (1, 4), zamba2's blocks also over
    (1, 3) and xlstm's over (1, 8), the ranks as threads each bound as
    the meshed train step binds it (every collective with its backward
    across the threads) and taking its own backward; each rank's dx and
    weight gradients within the phase's f32 tolerance of its block of
    the unsplit layer's (the phase raises otherwise).
    internvl2's 2 KV heads over model = 4 split its query heads over
    whole KV heads; at (1, 3) and (1, 8) the recurrent blocks run whole
    on every rank (at (1, 8) xlstm's mLSTM gathers its inner width)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    _, out = chip_smoke.family_train_split_phase(
        0, device="cpu", get=worker.family_cfg, rows=4, seq=24)
    run = {(o["layer"], o["data"], o["model"]) for o in out}
    assert len(out) == 22, sorted(run)
    assert ("internvl2-smoke decoder layer", 1, 4) in run
    assert {(label, 1, 3) for label, _, _ in run
            if label.startswith("zamba2")} <= run
    assert {(label, 1, 8) for label, _, _ in run
            if label.startswith("xlstm")} <= run
    limit = chip_smoke.FAMILY_TRAIN_SPLIT_TOL["f32"]
    assert max(e for o in out for e in o["errors"].values()) <= limit


def cli(*args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(REPO, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--seq", "32", "--batch", "4", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)




def family_tests(families):
    """The module fixture `runs` and the tests of `families` (names as
    `worker.family_cfg` takes them), by name, for a test module's
    globals."""

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        """{family: {"ref": {case: (states, metrics)}, "port": (state,
        metrics), "model", "batches", (data, model): [each rank's results,
        by rank]}, "tmp": the ranks' directory}."""
        tmp = tmp_path_factory.mktemp("mesh_families")
        data, got = [], {"tmp": tmp}
        for name in families:
            jm = reference_model(name)
            js = jinit(jm, jax.random.key(0))
            tm = Model(worker.family_cfg(name))
            opt_np = {"step": np.asarray(js.opt.step),
                      "m": jax.device_get(js.opt.m),
                      "v": jax.device_get(js.opt.v)}
            bs = batches(tm.cfg, worker.STEPS + 1)
            data.append({"name": name, "params": jax.device_get(js.params),
                         "opt": opt_np, "batches": bs})
            got[name] = {"jm": jm, "js": js, "model": tm, "batches": bs}
        data_path = str(tmp / "data.pkl")
        with open(data_path, "wb") as f:
            pickle.dump(data, f)
        codes = []
        ranks = threading.Thread(target=lambda: codes.extend(
            run_ranks(tmp, data_path)))
        ranks.start()
        try:
            for d in data:
                fam = got[d["name"]]
                jm, js, tm, bs = fam["jm"], fam["js"], fam["model"], \
                    fam["batches"]
                keys = worker.extra_keys(tm.cfg)
                fam["ref"] = {"steps": reference_steps(jm, js, bs, keys),
                              "accum": reference_steps(
                                  jm, js, bs[:worker.STEPS], keys, 2)}
                start = bridge.train_state_from_jax(d["params"], d["opt"],
                                                    tm.cfg, device="cpu")
                fam["port"] = port_steps(tm, start, bs[:worker.STEPS])
        finally:
            ranks.join()
        assert codes == [0] * WORLD, codes
        by_rank = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
                   for r in range(WORLD)]
        for (d, m) in SHAPES:
            for name in families:
                got[name][(d, m)] = [res[(d, m)][name]
                                     for res in by_rank[:d * m]]
        return got

    MESHES = list(SHAPES)
    CELLS = [(f, s) for f in families for s in MESHES]
    CELL_IDS = [f"{f}-{d}x{m}" for f, (d, m) in CELLS]

    @pytest.mark.parametrize("name,shape", CELLS, ids=CELL_IDS)
    def test_steps_equal_the_references(runs, name, shape):
        """Two meshed steps against the reference's and the port's unmeshed
        ones: every rank reports the global loss and grad norm, and the
        whole leaves gathered from the shards match."""
        fam = runs[name]
        ref_states, ref_metrics = fam["ref"]["steps"]
        port_state, port_metrics = fam["port"]
        tol = tol_of(name)
        for res in fam[shape]:
            got = res["steps"]["metrics"]
            assert_metrics(got, ref_metrics[:worker.STEPS], tol)
            assert_metrics(got, port_metrics, tol)
        whole = fam[shape][0]["steps"]["whole"]
        assert_state(whole, ref_states[worker.STEPS - 1], tol)
        assert_state(whole, port_state, tol)

    @pytest.mark.parametrize("name", families)
    def test_accumulation_on_a_2x2_mesh(runs, name):
        """accum_steps=2 splits the batch into micro-batches of global rows,
        each data rank taking its rows (and its rows of the extra) of each:
        the step equals the reference's accumulated one."""
        ref_states, ref_metrics = runs[name]["ref"]["accum"]
        tol = tol_of(name)
        for res in runs[name][(2, 2)]:
            assert_metrics(res["accum"]["metrics"], ref_metrics, tol)
        assert_state(runs[name][(2, 2)][0]["accum"]["whole"], ref_states[-1],
                     tol)

    @pytest.mark.parametrize("name,shape", CELLS, ids=CELL_IDS)
    def test_rank_holds_its_shards_alone(runs, name, shape):
        """A rank's parameters, m and v are exactly its train-mode shards
        (`bridge.train_state_specs`): every leaf at its block's shape
        (`local_shape`), no whole copy beside them, below the whole state's
        bytes."""
        tm = runs[name]["model"]
        mesh = AbstractMesh(("data", "model"), shape)
        specs = bridge.train_state_specs(tm.cfg, mesh)
        whole_state = abstract_state(tm)
        wants = {path_name(p): local_shape(t.shape, specs[path_name(p)], mesh)
                 for p, t in leaves_with_path(whole_state)}
        whole_bytes = sum(math.prod(t.shape) * 4
                          for t in tree_leaves(whole_state))
        for res in runs[name][shape]:
            shapes, nbytes = res["steps"]["held"]
            assert shapes == wants
            assert nbytes == sum(math.prod(s) * 4 for s in wants.values())
            assert nbytes < whole_bytes

    RESTORED = [(f, s) for f in families for s in ((4, 1), (1, 2))]

    @pytest.mark.parametrize("name,shape", RESTORED,
                             ids=[f"{f}-{d}x{m}" for f, (d, m) in RESTORED])
    def test_checkpoint_restores_on_another_mesh(runs, name, shape):
        """The (2, 2) checkpoint (the shared attention site's unstacked
        leaves among a hybrid's) restored on another mesh continues as the
        reference does: its third step's metrics and state."""
        ref_states, ref_metrics = runs[name]["ref"]["steps"]
        tol = tol_of(name)
        for res in runs[name][shape]:
            assert_metrics(res["restored"]["metrics"],
                           ref_metrics[worker.STEPS:], tol)
        assert_state(runs[name][shape][0]["restored"]["whole"],
                     ref_states[worker.STEPS], tol)

    @pytest.mark.parametrize("name", families)
    def test_checkpoint_restores_without_a_mesh(runs, name):
        """The (2, 2) checkpoint holds whole leaves: restored here with no
        mesh it continues as the reference does."""
        fam = runs[name]
        tm = fam["model"]
        ref_states, ref_metrics = fam["ref"]["steps"]
        mgr = CheckpointManager(worker.ckpt_dir(str(runs["tmp"]), name))
        assert mgr.latest_step() == worker.STEPS
        state = mgr.restore(abstract_state(tm), device="cpu")
        got, metrics = port_steps(tm, state, fam["batches"][worker.STEPS:])
        assert_metrics(metrics, ref_metrics[worker.STEPS:], tol_of(name))
        assert_state(got, ref_states[worker.STEPS], tol_of(name))


    return {k: v for k, v in locals().items()
            if k == "runs" or k.startswith("test_")}


def test_cli_trains_a_hybrid_saves_and_resumes_across_a_mesh(tmp_path):
    """zamba2's smoke config: `--data 2 --model 2` spawns its 4 ranks,
    trains and checkpoints; a second call at `--data 1 --model 2`
    auto-resumes that checkpoint on its 2 ranks and trains on."""
    ck = str(tmp_path / "ck")
    arch = ("--arch", "zamba2-1.2b")
    first = cli(*arch, "--data", "2", "--model", "2", "--steps", "2",
                "--ckpt-dir", ck)
    assert first.returncode == 0, (first.stdout, first.stderr)
    lines = first.stdout.strip().splitlines()
    assert lines[-1] == "done", first.stdout
    assert sum(line.startswith("rank ") for line in lines) == 4
    assert os.path.exists(os.path.join(ck, "step_2", "COMMIT"))

    second = cli(*arch, "--data", "1", "--model", "2", "--steps", "10",
                 "--ckpt-dir", ck, "--ckpt-every", "100")
    assert second.returncode == 0, (second.stdout, second.stderr)
    lines = second.stdout.strip().splitlines()
    assert lines[0] == "auto-resumed from step 2"
    assert lines[1].startswith("step    10 loss ")
    assert math.isfinite(float(lines[1].split()[3]))
    assert sum(line.startswith("rank ") for line in lines) == 2
    assert lines[-1] == "done"
    assert sorted(os.listdir(ck)) == ["step_10", "step_2"]
