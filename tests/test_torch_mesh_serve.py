"""The port's meshed serve (`ServingEngine(..., mesh=)`) on real
multi-rank gloo meshes on the CPU, against the reference's unmeshed
serve and the port's own.

The internlm2-1.8b smoke config in float32 with the reference's
weights (carried by the bridge, `_torch_serve_ref.smoke_pair`). Four
ranks are spawned once, over a `file://` store in `tmp_path`, and build
the meshes (2, 2), (4, 1) and (1, 2) (the last over ranks 0 and 1) one
after another, serving on each the streams of
`_torch_mesh_worker.CASES` given here (every collective times out
after 60 s, so a rank that goes astray fails the run instead of
hanging it). While they run, this process serves the same streams
unmeshed, through the reference and the port.

The contract is the reference's own mesh contract
(`tests/test_mesh_serve.py`): greedy tokens and terminal statuses
equal the single-device stream, every priced step's bytes are equal,
hit and bound fractions within 0.02 and 0.05. Beside it: each rank's
local pool shape, the model ranks' plans equal step by step, a sampled
stream unchanged by the mesh, commit caps that cut across the lanes of
two data ranks and a poisoned request (in the spilling stream), lanes
the data axis does not divide (replicated) with SLO sheds, and the
serve CLI's `--parity --mesh` in a subprocess.

The single-stream path of the meshed engine (`start`, `generate`,
`run`, `step`: `_torch_mesh_worker.STREAMS`, 2, 3 or 4 lanes, 3 at
(2, 2) where `data` does not divide them) against the port's unmeshed
engine and the reference's: greedy tokens, every StepStats row's bytes
and the collected trace equal, logits within `STREAM_ATOL`, on every
rank; and `serve`, `start` + `generate`, `serve` again on one meshed
engine against the same on the port's unmeshed one.
"""

import dataclasses
import multiprocessing
import os
import pickle
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.sa import SAConfig as JSAConfig  # noqa: E402
from repro.serving import faults as jf  # noqa: E402
from repro.serving import slo as jslo  # noqa: E402
from repro.serving import trace_bridge as jtb  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402

import _torch_mesh_worker as worker  # noqa: E402
from _torch_serve_ref import JAX_H100, smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (data, model) -> the streams its ranks serve
SHAPES = {(2, 2): ("inline", "overlap", "trace", "budget", "sampled"),
          (4, 1): ("recency", "replicated"),
          (1, 2): ("inline", "overlap")}
#: (data, model) -> the single-stream cases its ranks run
#: (`worker.STREAMS`, and `worker.AGAIN`)
STREAM_SHAPES = {(2, 2): ("stream", "stream3", worker.AGAIN),
                 (4, 1): ("stream4",),
                 (1, 2): ("stream", worker.AGAIN)}
#: the streams the reference also serves (it has no sampled stream to
#: compare: its PRNG is another)
REFERENCE = ("inline", "overlap", "recency", "trace", "budget")
#: a meshed stream's logits against the unmeshed streams' (f32; the
#: single-stream tests' tolerance against the reference,
#: `_torch_serve_ref.assert_stream_matches`)
STREAM_ATOL = 2e-5
#: the ranks spawned; a smaller mesh takes the first of them
WORLD = 4
#: seconds to wait for the ranks
JOIN_S = 480


def reference_case(models, name):
    """Case `name` through the reference's unmeshed engine."""
    jm, jp, _, _ = models
    ekw, skw, _, slots = worker.CASES[name]
    eng = JEngine(jm, jp, JConfig(**{**dataclasses.asdict(
        worker.engine_config(**ekw)), "spec": JAX_H100}))
    if ekw.get("overlap_migrations"):
        eng._host_memory_kind = None
    skw = dict(skw)
    if skw.get("faults"):
        skw["faults"] = worker.fault_plane(jf)
    if skw.get("slo"):
        skw["slo"] = worker.slo_tiers(jslo)
    rep = eng.serve(worker.stream(JRequest, name, jm.cfg.vocab),
                    num_slots=slots, **skw)
    out = worker.outcome(eng, rep, fractions=False)
    if ekw.get("trace_telemetry") and not rep.rejected:
        agg = jtb.score_serve(jtb.collect_serve(eng), JAX_H100,
                              sa_cfg=JSAConfig(**worker.SA),
                              report=rep)["aggregate"]
        out["fractions"] = (agg["live_hit_fraction"],
                            agg.get("bound_fraction", 0.0))
    return out


def reference_stream(models, name):
    """Single-stream case `name` through the reference's engine."""
    jm, jp, _, _ = models
    eng = JEngine(jm, jp, JConfig(**{**dataclasses.asdict(
        worker.stream_config()), "spec": JAX_H100}))
    return worker.drive_stream(
        eng, worker.stream_prompts(worker.STREAMS[name], jm.cfg.vocab),
        jnp.asarray, np.asarray, jtb.collect)


def run_ranks(tmp, params):
    """Spawn the `WORLD` ranks over `SHAPES` and `STREAM_SHAPES` and
    wait for them; their exit codes. Ranks still alive after `JOIN_S`
    are killed."""
    ctx = multiprocessing.get_context("spawn")
    plan = [(shape, cases + STREAM_SHAPES[shape])
            for shape, cases in SHAPES.items()]
    ranks = [ctx.Process(
        target=worker.rank_main,
        args=(r, WORLD, str(tmp / "store"), plan, params, str(tmp)))
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
    """{"ref": reference outcomes, "port": the port's unmeshed ones,
    (data, model): [each rank's outcomes, by rank], "whole": the port's
    (model, params)}."""
    models = smoke_pair()
    _, _, tm, tp = models
    tmp = tmp_path_factory.mktemp("mesh")
    params = str(tmp / "params.pt")
    torch.save((tm.cfg, tp), params)
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(
        run_ranks(tmp, params)))
    ranks.start()
    # one thread here too while the ranks run: at the smoke config's
    # sizes more threads only contend with the ranks and the other tests
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = {"ref": {**{name: reference_case(models, name)
                          for name in REFERENCE},
                       **{name: reference_stream(models, name)
                          for name in worker.STREAMS}},
               "port": {name: worker.run_case(name, tm.cfg, tp)
                        for name in (*worker.CASES, *worker.STREAMS,
                                     worker.AGAIN)}}
    finally:
        torch.set_num_threads(threads)
        ranks.join()
    assert codes == [0] * WORLD, codes
    got["whole"] = (tm, tp)
    by_rank = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(WORLD)]
    for (data, model) in SHAPES:
        got[(data, model)] = [res[(data, model)]
                              for res in by_rank[:data * model]]
    return got


PAIRS = [(shape, name) for shape, cases in SHAPES.items() for name in cases]


@pytest.mark.parametrize("shape,name", PAIRS,
                         ids=[f"{d}x{m}-{n}" for (d, m), n in PAIRS])
def test_meshed_stream_equals_the_unmeshed_streams(runs, shape, name):
    """Tokens, statuses (with error codes), events and every priced
    step's bytes equal on every rank: the port's unmeshed serve, and
    the reference's where it serves the case."""
    wants = [runs["port"][name]] + ([runs["ref"][name]]
                                    if name in REFERENCE else [])
    for rank, res in enumerate(runs[shape]):
        got = res[name]
        for want in wants:
            assert got["outputs"] == want["outputs"], (rank, name)
            assert got["statuses"] == want["statuses"], (rank, name)
            assert got["events"] == want["events"], (rank, name)
            assert got["bytes"] == want["bytes"], (rank, name)


def test_the_streams_exercise_what_they_claim(runs):
    """The spilling stream migrates pages, under commit caps below what
    its plans hold on steps whose live rows fall in both data ranks'
    lanes, and a request in it fails poisoned; one request of the
    replicated stream is shed."""
    port = runs["port"]
    assert any(b[2] > 0 for b in port["trace"]["bytes"])
    cap = worker.fault_cap(2)
    cut = [p for p in port["trace"]["plans"]
           if len(set(p[1][p[0] >= 0].tolist())) == 2
           and (p[0] >= 0).sum() > cap]
    assert cut, "no capped step plans rows in both lanes"
    assert ("failed", "poisoned_logits") in \
        port["trace"]["statuses"].values()
    assert ("rejected", "slo_shed") in \
        port["replicated"]["statuses"].values()
    assert runs["ref"]["trace"]["fractions"][0] < 1.0   # it spilled


def test_hit_and_bound_fractions_within_tolerance(runs):
    got = runs[(2, 2)][0]["trace"]["fractions"]
    for want in (runs["ref"]["trace"]["fractions"],
                 runs["port"]["trace"]["fractions"]):
        assert abs(got[0] - want[0]) <= 0.02
        assert abs(got[1] - want[1]) <= 0.05


@pytest.mark.parametrize("shape", list(SHAPES),
                         ids=[f"{d}x{m}" for d, m in SHAPES])
def test_local_pool_shapes(runs, shape):
    """Each rank's pools are [L, B/data, P, T, KH/model, HD]; with lanes
    the data axis does not divide, [L, B, ...] on every rank."""
    data, model = shape
    for res in runs[shape]:
        for name in SHAPES[shape]:
            whole = runs["port"][name]["pool_shape"]
            L, B, P, T, KH, HD = whole
            lanes = B // data if B % data == 0 else B
            assert res[name]["pool_shape"] == (L, lanes, P, T,
                                               KH // model, HD)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)],
                         ids=["2x2", "1x2"])
def test_model_ranks_plan_alike(runs, shape):
    """The model ranks of one data coordinate plan from the same
    all-reduced importance: every plan of every step, and the final
    tables and importance, equal; and each data rank's plans are the
    unmeshed plans' rows of its lanes."""
    ranks = runs[shape]
    data = shape[0]
    for name in SHAPES[shape]:
        whole = runs["port"][name]["plans"]
        by_data = {}
        for res in ranks:
            by_data.setdefault(res["coord"]["data"], []).append(res[name])
        for d, group in by_data.items():
            first = group[0]
            assert len(first["plans"]) == len(whole), name
            for a, w in zip(first["plans"], whole):
                np.testing.assert_array_equal(a, lanes_of(w, d, data))
            for other in group[1:]:
                assert len(other["plans"]) == len(first["plans"])
                for a, b in zip(first["plans"], other["plans"]):
                    np.testing.assert_array_equal(a, b)
                for f, t in first["tables"].items():
                    np.testing.assert_array_equal(other["tables"][f], t)


def lanes_of(plan, d, data, layers=2, lanes=2):
    """The rows of an unmeshed plan ([10, L * B * budget], laid out
    [L, B, budget]) that data rank `d` of `data` plans: its lanes'
    blocks, their lane ids made local."""
    n = lanes // data
    rows = plan.reshape(10, layers, lanes, -1)[:, :, d * n:(d + 1) * n]
    rows = rows.reshape(10, -1).copy()
    for f in (1, 6):                       # pro_batch, dem_batch
        rows[f] = np.where(rows[f] >= 0, rows[f] - d * n, rows[f])
    return rows


@pytest.mark.parametrize("shape", list(SHAPES),
                         ids=[f"{d}x{m}" for d, m in SHAPES])
def test_rank_holds_its_shards_alone(runs, shape):
    """A meshed engine keeps only its rank's weight shards, whether it
    was handed the whole model or the shards cut already
    (`_torch_mesh_worker.PRE_CUT`): its weight bytes are those of
    `bridge.shard_params` at its coordinate, about 1/model of the whole
    plus the leaves held whole."""
    from repro_torch import bridge
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.tree import tree_leaves
    tm, tp = runs["whole"]
    mesh = AbstractMesh(("data", "model"), shape)
    whole = sum(t.nbytes for t in tree_leaves(tp))
    for res in runs[shape]:
        want = sum(t.nbytes for t in tree_leaves(bridge.shard_params(
            tp, tm.cfg, mesh, res["coord"])))
        for name in SHAPES[shape]:
            assert res[name]["param_bytes"] == want, name
        assert want < whole if shape[1] > 1 else want == whole
    assert runs["port"]["inline"]["param_bytes"] == whole


STREAM_PAIRS = [(shape, name) for shape, names in STREAM_SHAPES.items()
                for name in names if name in worker.STREAMS]


@pytest.mark.parametrize("shape,name", STREAM_PAIRS,
                         ids=[f"{d}x{m}-{n}" for (d, m), n in STREAM_PAIRS])
def test_meshed_single_stream_equals_the_unmeshed_streams(runs, shape,
                                                          name):
    """`start`, `generate`, `run` and `step` of a meshed engine, on every
    rank: greedy tokens, every StepStats row's bytes and the collected
    trace ([steps, L, B, P] read sets and placements, and the moves)
    equal the port's unmeshed stream's and the reference's; the start,
    run and step logits, whole on every rank, within `STREAM_ATOL` of
    both. Each rank's tables are its lanes' of the unmeshed stream
    (every lane where `data` does not divide them), its pools
    [L, lanes, P, T, KH/model, HD]."""
    data, model = shape
    port, ref = runs["port"][name], runs["ref"][name]
    assert any(b[1] > 0 for b in ref["bytes"])          # host tier read
    assert any(b[2] > 0 for b in ref["bytes"])          # pages promoted
    B = worker.STREAMS[name]
    n = B // data if B % data == 0 else B
    for rank, res in enumerate(runs[shape]):
        got = res[name]
        for want in (port, ref):
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            assert got["bytes"] == want["bytes"], rank
            for a, b in zip(got["trace"], want["trace"]):
                np.testing.assert_array_equal(a, b)
            for k in ("start", "run", "step"):
                assert got[k].shape == want[k].shape, k
                np.testing.assert_allclose(got[k], want[k],
                                           atol=STREAM_ATOL, err_msg=k)
        lo = res["coord"]["data"] * n if n < B else 0
        for f, t in got["tables"].items():
            np.testing.assert_array_equal(t, np.take(
                port["tables"][f], range(lo, lo + n),
                axis=0 if f == "length" else 1), err_msg=f)
        L, _, P, T, KH, HD = port["pool_shape"]
        assert got["pool_shape"] == (L, n, P, T, KH // model, HD)


@pytest.mark.parametrize("shape", [s for s, names in STREAM_SHAPES.items()
                                   if worker.AGAIN in names],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_serve_start_generate_serve_on_one_meshed_engine(runs, shape):
    """`serve`, then `start` + `generate`, then `serve` again on one
    meshed engine, on every rank: each serve's tokens, statuses, events
    and step bytes, and the stream's tokens and bytes, equal the same
    sequence on the port's unmeshed engine (start logits within
    `STREAM_ATOL`); the stream between leaves the serve as it was."""
    want = runs["port"][worker.AGAIN]
    for part in ("serve", "served again"):
        for key in ("outputs", "statuses", "events", "bytes"):
            assert want[part][key] == runs["port"]["inline"][key], part
    for res in runs[shape]:
        got = res[worker.AGAIN]
        for part in ("serve", "served again"):
            for key in ("outputs", "statuses", "events", "bytes"):
                assert got[part][key] == want[part][key], (part, key)
        np.testing.assert_array_equal(got["stream"]["tokens"],
                                      want["stream"]["tokens"])
        assert got["stream"]["bytes"] == want["stream"]["bytes"]
        np.testing.assert_allclose(got["stream"]["start"],
                                   want["stream"]["start"],
                                   atol=STREAM_ATOL)


def test_sampled_stream_unchanged_by_the_mesh(runs):
    """Sampling keys are per request, so lane sharding leaves a sampled
    stream as it is (checked against the port's unmeshed serve in
    `test_meshed_stream_equals_the_unmeshed_streams`); here, that it
    really sampled."""
    got = runs[(2, 2)][0]["sampled"]["outputs"]
    greedy = runs["port"]["inline"]["outputs"]
    assert got != greedy


def test_cli_mesh_parity_subprocess():
    """`repro_torch.launch.serve --smoke --parity --mesh data=2,model=2
    --device cpu` spawns its 4 ranks and prints MESH PARITY OK."""
    env = dict(os.environ)
    src = os.path.join(REPO, "src")
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--parity", "--mesh", "data=2,model=2", "--device", "cpu",
         "--requests", "3", "--new-tokens", "3", "--batch-slots", "2",
         "--stride", "8"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "MESH PARITY OK" in proc.stdout, proc.stdout
