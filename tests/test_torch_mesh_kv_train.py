"""The port's meshed train step (`make_train_step(..., mesh=)`) across a
`model` axis that does not divide the KV heads, on real gloo meshes on
the CPU, against the reference's unmeshed `make_train_step` and the
port's unmeshed step.

A training rank meets three shapes there (`transformer.TensorParallel`):
its query heads split over every KV head (`wk`/`wv` whole, their
gradient summed over `model`): internlm2, qwen3-32b (qk norm),
granite-moe (with its experts split) and internvl2 smoke configs at
(1, 4), and a one-KV-head internlm2 at (2, 2) with FSDP over `data`;
its heads whole (the attention run whole and alike on every model
rank, neither entered nor summed): internlm2 and granite-moe at (1, 3),
where the axis divides no dim of internlm2's, whisper-tiny and zamba2's
shared site at (1, 3); and a recurrent block run whole: zamba2's Mamba2
blocks and xlstm's mLSTM and sLSTM blocks at (1, 3). Every config is
the float32 smoke config, from one `init_train_state` of the reference
carried by the bridge, each rank cutting its train-mode shards. Four
ranks are spawned once (`_torch_mesh_kv_train_worker`, over a `file://`
store in `tmp_path`) and build the meshes of `PLAN` in turn (every
collective times out after 60 s); while they run, this process takes
the same steps through the reference and the port unmeshed.

Tolerances are `tests/test_torch_train.py`'s: loss and grad norm 1e-5
relative, parameters 1e-4 (a tenth of lr = 1e-3), m and v 1e-6, on the
whole leaves gathered by `bridge.unshard` (zamba2's: the Mamba2
families' `MAMBA_TOL`, `_torch_mesh_family_tests`). Beside them:
accum_steps=2 at (1, 4), each rank's stored leaves at `local_shape`, a
checkpoint saved at (1, 4) restored at (1, 2) and without a mesh, the
train CLI at `--data 1 --model 4` in a subprocess, and the sharding
rules' and `TensorParallel`'s split of each shape.
"""

import math
import multiprocessing
import os
import pickle
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.shardings import (  # noqa: E402
    local_shape, param_pspec,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import TensorParallel  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    leaves_with_path, path_name, tree_leaves,
)

import _torch_mesh_family_worker as family  # noqa: E402
import _torch_mesh_kv_train_worker as worker  # noqa: E402
from _torch_mesh_family_tests import (  # noqa: E402
    MAMBA_TOL, TOL, abstract_state, assert_metrics, assert_state, batches,
    cli, port_steps, reference_model, reference_steps,
)
from _torch_serve_ref import smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (config tag, (data, model), cases): what the ranks run, in order
PLAN = (("internlm2-1.8b", (1, 4), ("steps", "accum")),
        ("internlm2-1.8b", (1, 3), ("steps",)),
        ("internlm2-1.8b", (1, 2), ("restored",)),
        ("qwen3-32b", (1, 4), ("steps",)),
        ("kv1", (2, 2), ("steps",)),
        ("granite-moe-3b-a800m", (1, 4), ("steps",)),
        ("granite-moe-3b-a800m", (1, 3), ("steps",)),
        ("internvl2-2b", (1, 4), ("steps",)),
        ("whisper-tiny", (1, 3), ("steps",)),
        ("zamba2-1.2b", (1, 3), ("steps",)),
        ("xlstm-125m", (1, 3), ("steps",)))
#: the ranks spawned; a smaller mesh takes the first of them
WORLD = 4
#: seconds to wait for the ranks
JOIN_S = 420
STEPS = worker.STEPS
#: the (tag, mesh) cells that take steps
CELLS = [(tag, shape) for tag, shape, cases in PLAN if "steps" in cases]
CELL_IDS = [f"{tag}-{d}x{m}" for tag, (d, m) in CELLS]


def tol_of(tag):
    return MAMBA_TOL if tag.startswith("zamba2") else TOL


def reference(tag):
    """The reference's model of `worker.config(tag)`."""
    if tag == "kv1":
        return smoke_pair(kv_heads=1)[0]
    return reference_model(tag)


def run_ranks(tmp, data_path):
    """Spawn the `WORLD` ranks over `PLAN` and wait for them; their exit
    codes. Ranks still alive after `JOIN_S` are killed."""
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(
        target=worker.rank_main,
        args=(r, WORLD, str(tmp / "store"), list(PLAN), data_path,
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{tag: {"ref": {case: (states, metrics)}, "port": the unmeshed
    port's (state, metrics), "model", "batches"}, (tag, (data, model)):
    [each rank's results, by rank], "tmp": the ranks' directory}."""
    tmp = tmp_path_factory.mktemp("mesh_kv_train")
    tags = sorted({tag for tag, _, _ in PLAN})
    data, got = {}, {"tmp": tmp}
    for tag in tags:
        jm = reference(tag)
        js = jinit(jm, jax.random.key(0))
        tm = Model(worker.config(tag))
        bs = batches(tm.cfg, STEPS + 1)
        data[tag] = {"params": jax.device_get(js.params),
                     "opt": {"step": np.asarray(js.opt.step),
                             "m": jax.device_get(js.opt.m),
                             "v": jax.device_get(js.opt.v)},
                     "batches": bs}
        got[tag] = {"jm": jm, "js": js, "model": tm, "batches": bs}
    data_path = str(tmp / "data.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(data, f)
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(
        run_ranks(tmp, data_path)))
    ranks.start()
    try:
        for tag in tags:
            fam = got[tag]
            keys = family.extra_keys(fam["model"].cfg)
            fam["ref"] = {"steps": reference_steps(
                fam["jm"], fam["js"], fam["batches"], keys)}
            if tag == "internlm2-1.8b":
                fam["ref"]["accum"] = reference_steps(
                    fam["jm"], fam["js"], fam["batches"][:STEPS], keys, 2)
                start = bridge.train_state_from_jax(
                    data[tag]["params"], data[tag]["opt"],
                    fam["model"].cfg, device="cpu")
                fam["port"] = port_steps(fam["model"], start,
                                         fam["batches"][:STEPS])
    finally:
        ranks.join()
    assert codes == [0] * WORLD, codes
    by_rank = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(WORLD)]
    for tag, (d, m), _ in PLAN:
        got[(tag, (d, m))] = [res[(tag, (d, m))] for res in by_rank[:d * m]]
    return got


@pytest.mark.parametrize("tag,shape", CELLS, ids=CELL_IDS)
def test_steps_equal_the_references(runs, tag, shape):
    """Three meshed steps against the reference's unmeshed ones: every
    rank reports the global loss and grad norm, and the whole leaves
    gathered from the shards match (a gradient of `wk`/`wv` left
    unsummed, or a part run whole that entered or was summed, is off
    by a factor here)."""
    ref_states, ref_metrics = runs[tag]["ref"]["steps"]
    tol = tol_of(tag)
    for res in runs[(tag, shape)]:
        assert_metrics(res["steps"]["metrics"], ref_metrics[:STEPS], tol)
    assert_state(runs[(tag, shape)][0]["steps"]["whole"],
                 ref_states[STEPS - 1], tol)


def test_where_nothing_splits_every_rank_takes_the_unmeshed_step(runs):
    """internlm2's smoke config at (1, 3): 3 divides none of its 4
    heads, 2 KV heads, 128 MLP units or 256 vocabulary rows, so every
    rank runs the whole model alike, and its steps equal the port's
    unmeshed steps (within the tolerances; each rank's metrics)."""
    port_state, port_metrics = runs["internlm2-1.8b"]["port"]
    for res in runs[("internlm2-1.8b", (1, 3))]:
        assert_metrics(res["steps"]["metrics"], port_metrics)
    assert_state(runs[("internlm2-1.8b", (1, 3))][0]["steps"]["whole"],
                 port_state)


def test_accumulation_at_1x4(runs):
    """accum_steps=2 with the query heads split over every KV head: the
    step equals the reference's accumulated one."""
    ref_states, ref_metrics = runs["internlm2-1.8b"]["ref"]["accum"]
    ranks = runs[("internlm2-1.8b", (1, 4))]
    for res in ranks:
        assert_metrics(res["accum"]["metrics"], ref_metrics)
    assert_state(ranks[0]["accum"]["whole"], ref_states[-1])


@pytest.mark.parametrize("tag,shape", CELLS, ids=CELL_IDS)
def test_rank_holds_its_shards_alone(runs, tag, shape):
    """A rank's parameters, m and v are exactly its train-mode shards
    (`bridge.train_state_specs`): every leaf at `local_shape` of its
    spec (`wk`/`wv` whole on `model`), no whole copy beside them."""
    tm = runs[tag]["model"]
    mesh = AbstractMesh(("data", "model"), shape)
    specs = bridge.train_state_specs(tm.cfg, mesh)
    wants = {path_name(p): local_shape(t.shape, specs[path_name(p)], mesh)
             for p, t in leaves_with_path(abstract_state(tm))}
    for res in runs[(tag, shape)]:
        shapes, nbytes = res["steps"]["held"]
        assert shapes == wants
        assert nbytes == sum(math.prod(s) * 4 for s in wants.values())


def test_checkpoint_restores_on_another_mesh(runs):
    """The checkpoint saved at (1, 4) (the query heads split over whole
    KV heads) restored at (1, 2) (heads and KV heads split) continues as
    the reference does: its fourth step's metrics and state."""
    ref_states, ref_metrics = runs["internlm2-1.8b"]["ref"]["steps"]
    ranks = runs[("internlm2-1.8b", (1, 2))]
    for res in ranks:
        assert_metrics(res["restored"]["metrics"], ref_metrics[STEPS:])
    assert_state(ranks[0]["restored"]["whole"], ref_states[STEPS])


def test_checkpoint_restores_without_a_mesh(runs):
    """The (1, 4) checkpoint holds whole leaves: restored here with no
    mesh it continues as the reference does."""
    fam = runs["internlm2-1.8b"]
    ref_states, ref_metrics = fam["ref"]["steps"]
    mgr = CheckpointManager(worker.ckpt_dir(str(runs["tmp"])))
    assert mgr.latest_step() == STEPS
    state = mgr.restore(abstract_state(fam["model"]), device="cpu")
    got, metrics = port_steps(fam["model"], state, fam["batches"][STEPS:])
    assert_metrics(metrics, ref_metrics[STEPS:])
    assert_state(got, ref_states[STEPS])


def test_cli_trains_across_a_model_axis_of_4_over_2_kv_heads():
    """`--data 1 --model 4` on internlm2's smoke config (4 heads over 2
    KV heads) spawns its 4 ranks and trains; rank 0 prints each rank's
    bytes and a finite loss at step 10."""
    run = cli("--data", "1", "--model", "4", "--steps", "10")
    assert run.returncode == 0, (run.stdout, run.stderr)
    lines = run.stdout.strip().splitlines()
    assert lines[-1] == "done", run.stdout
    assert sum(line.startswith("rank ") for line in lines) == 4
    steps = [line for line in lines if line.startswith("step ")]
    assert len(steps) == 1 and steps[0].startswith("step    10 loss ")
    assert math.isfinite(float(steps[0].split()[3]))


#: (config, (data, model), the shape a rank meets: "kv" heads and KV
#: heads split, "heads" query heads split over whole KV heads, "whole"
#: no head split); a name ending in "-smoke" is the config's smoke
#: config (internlm2's: 4 heads over 2 KV heads)
SHAPES = (("internlm2-1.8b", (1, 16), "heads"),
          ("qwen3-32b", (1, 16), "heads"),
          ("granite-moe-3b-a800m", (1, 16), "whole"),
          ("llama4-maverick-400b-a17b", (1, 16), "whole"),
          ("whisper-tiny", (1, 4), "whole"),
          ("zamba2-1.2b", (1, 3), "whole"),
          ("xlstm-125m", (1, 8), "whole"),
          ("internlm2-1.8b", (2, 4), "kv"),
          ("internlm2-1.8b-smoke", (1, 4), "heads"),
          ("internlm2-1.8b-smoke", (2, 4), "heads"),
          ("internlm2-1.8b-smoke", (1, 3), "whole"))


def attention_schema(schema):
    """The first dict of attention weights in a schema (by sorted key),
    or None."""
    if "wk" in schema and "wo" in schema:
        return schema
    for k in sorted(schema):
        if isinstance(schema[k], dict):
            found = attention_schema(schema[k])
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("name,shape,kind", SHAPES,
                         ids=[f"{n}-{d}x{m}" for n, (d, m), _ in SHAPES])
def test_the_rules_and_the_rank_agree_on_each_shape(name, shape, kind):
    """At full width (and internlm2's smoke config): the train rule (`param_pspec(..., "train")`) puts
    `model` on `head_dim` of `wk`/`wv` where the axis does not divide
    the KV heads, and the rank holds them whole on `model`
    (`bridge.leaf_spec`) with their FSDP block on `embed` where `data`
    splits; the rank-local config and `TensorParallel.of` count what the
    rank's shards hold: its query heads, or every head, and a recurrent
    block's heads split only where the axis divides them."""
    cfg = tconfigs.get_smoke(name[:-len("-smoke")]) \
        if name.endswith("-smoke") else tconfigs.get(name)
    data, m = shape
    mesh = AbstractMesh(("data", "model"), shape)
    local = cfg.rank_local(m)
    tps = [TensorParallel.of(cfg, m, r, reduce=None, gather=None)
           for r in range(m)]
    assert all(tp.kv_split == (kind == "kv") for tp in tps)
    assert all(tp.heads_split == (kind != "whole") for tp in tps)
    assert all(tp.recurrent_split == (kind == "kv") for tp in tps)
    for k in ("ssm", "xlstm"):
        if getattr(cfg, k) is not None:
            assert getattr(local, k).shards == (m if kind == "kv" else 1)
    schema = Model(cfg).schema()
    attn = attention_schema(schema)
    if attn is None:                      # xlstm: no attention
        mlstm = schema["mlstm"]
        for leaf in ("w_up", "conv_w", "wq", "wi", "y_norm", "w_out"):
            assert "model" in bridge.leaf_spec(mlstm[leaf], mesh, "train")
        assert local.num_heads == cfg.num_heads
        return
    for leaf in ("wk", "wv"):
        p = attn[leaf]
        pspec = param_pspec(p.axes, p.shape, mesh, "train")
        held = bridge.leaf_spec(p, mesh, "train")
        if kind == "kv":
            assert held[p.axes.index("kv_heads")] == "model"
            continue
        assert "model" not in held
        if cfg.head_dim % m == 0:
            assert pspec[p.axes.index("head_dim")] == "model"
        assert local_shape(p.shape, held, AbstractMesh(
            ("data", "model"), (1, m))) == p.shape
        assert held[p.axes.index("embed")] == (
            "data" if data > 1 and cfg.d_model % data == 0 else None)
    wq = local_shape(attn["wq"].shape,
                     bridge.leaf_spec(attn["wq"], mesh, "train"), mesh)
    heads = wq[attn["wq"].axes.index("heads")]
    assert heads == (cfg.num_heads // m if kind != "whole"
                     else cfg.num_heads)
    if kind == "heads":
        assert [tp.heads for tp in tps] == [
            (r * heads, (r + 1) * heads) for r in range(m)]
        assert (local.num_heads, local.kv_heads) == (cfg.num_heads,
                                                     cfg.kv_heads)


def smoke_configs(name):
    """`chip_smoke`'s `get` on the CPU: the float32 smoke configs."""
    return family.family_cfg(name)


@pytest.mark.parametrize("splits", [((1, 4),), ((1, 3), (2, 2))],
                         ids=["heads-split", "heads-whole-and-kv-split"])
def test_phase_19a_on_threads_at_the_smoke_configs(splits):
    """`chip_smoke.py`'s phase 19a on the CPU at the f32 smoke configs (4
    rows of 24 tokens): internlm2's and qwen3-32b's decoder layers and
    granite-moe's (attention and moe blocks) split over the model axis
    as threads, each bound as the meshed train step binds it and taking
    its own backward: at (1, 4) one query head a rank over the 2 whole
    KV heads (granite-moe's 4 experts one a rank), at (1, 3) every head
    whole, at (2, 2) heads and KV heads split with FSDP; each rank's dx
    and weight gradients within the phase's tolerance of its block of
    the unsplit layer's (the phase raises otherwise)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    _, out = chip_smoke.kv_train_split_phase(
        0, device="cpu", get=smoke_configs, rows=4, seq=24, splits=splits)
    assert len(out) == 3 * len(splits)
    assert max(e for o in out for e in o["errors"].values()) \
        <= chip_smoke.KV_SPLIT_TOL


def test_phase_19b_on_threads_at_the_smoke_config():
    """`chip_smoke.py`'s phase 19b on the CPU at internlm2's f32 smoke
    config (2 layers, 4 rows of 16 tokens) over (1, 4): every rank
    calls the meshed `make_train_step` on its own thread with the
    threads' collectives (backward included); its losses,
    grad norms, m and update within the phase's tolerances of the
    unmeshed `make_train_step` (the phase raises otherwise)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    _, numbers = chip_smoke.kv_train_step_phase(
        0, device="cpu", get=smoke_configs, rows=4, seq=16, layers=2,
        model=4)
    assert all(numbers["errors"][k] <= tol
               for k, tol in chip_smoke.KV_STEP_TOL.items())
    assert len(numbers["losses"]) == chip_smoke.KV_STEP_STEPS
