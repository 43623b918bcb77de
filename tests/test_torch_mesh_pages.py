"""The port's meshed serve across a `model` axis that does not divide the
KV heads, on real gloo meshes on the CPU, against the reference's
unmeshed serve and the port's own: the reference's `pages` KV pool rule
(each rank's pools hold a contiguous 1/model of each tier's slots, every
KV head) and its `none` rule (the pools whole on every rank).

Four ranks are spawned once, over a `file://` store in `tmp_path`
(`_torch_mesh_pages_worker`), and build in turn: (1, 4) on the
internlm2-1.8b smoke config in float32 (4 heads over 2 KV heads: the
`pages` rule, one query head a rank) serving `_torch_mesh_worker`'s
inline, overlap and spilling ("trace": Quest-free, commit caps and a
poisoned request) streams and its single stream (Quest sparsity 0.5 and
trace capture); (1, 3) on the same config (the tiers' 16 and 32 slots
do not divide over 3: the `none` rule; heads, MLP and vocabulary whole)
inline, overlap and the single stream; (1, 4) on the granite-moe smoke
config at capacity factor 0.5 (`_torch_mesh_moe_worker`'s 8-lane
stream, inline and overlap: experts and pages over `model`); and (2, 2)
on a one-KV-head variant of the internlm2 smoke config (the same
`dataclasses.replace(kv_heads=1)` on both packages' configs, its
weights carried by the bridge) inline and the single stream: `pages`
with lanes over `data`. Every collective times out after 60 s. While
they run, this process runs the same cases unmeshed through the
reference and the port.

The contract is the reference's own mesh contract
(`tests/test_mesh_serve.py`): greedy tokens, statuses, events and every
priced step's bytes equal; the single stream's tokens, bytes and trace
equal and its logits within `STREAM_ATOL`; hit and bound fractions
within 0.02 and 0.05. Beside it: each rank's pools at the reference's
local shape (`launch.shardings.local_shape` of `cache_shardings`),
bitwise the unmeshed pools' slots under `none`, under `pages` their
layer 0 bitwise where `data` is 1 (its K/V are products of the
embedding alone) and every layer within `POOL_ATOL` (later layers' K/V
follow activations whose attention merged the ranks' partials in
another order); the tables
(whole on every rank) and every plan equal to the unmeshed ones; plans
whose rows move pages between two ranks' slots. Then `chip_smoke.py`'s
phase 18 at the smoke configs on threads, and the sharding rules'
shards of `wq`/`wk`/`wv`/`wo` under these rules.
"""

import dataclasses
import multiprocessing
import os
import pickle
import sys
import threading
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import trace_bridge as jtb  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.shardings import (  # noqa: E402
    _kv_shard_axis, cache_shardings, local_shape, param_pspec, pool_slots,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from repro_torch.models.transformer import TensorParallel  # noqa: E402

import _torch_mesh_moe_worker as moe_worker  # noqa: E402
import _torch_mesh_pages_worker as pages_worker  # noqa: E402
import _torch_mesh_worker as worker  # noqa: E402
from _torch_serve_ref import (  # noqa: E402
    JAX_H100, engines, smoke_pair,
)
from _torch_serve_ref import outcome as ref_outcome  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (config tag, (data, model), cases): what the ranks run, in order
PLAN = (("dense", (1, 4), ("inline", "overlap", "trace", "stream")),
        ("dense", (1, 3), ("inline", "overlap", "stream")),
        ("moe", (1, 4), moe_worker.MODES),
        ("kv1", (2, 2), ("inline", "stream")))
#: the ranks spawned; a smaller mesh takes the first of them
WORLD = 4
#: seconds to wait for the ranks
JOIN_S = 420
#: a meshed single stream's logits against the unmeshed streams' (f32;
#: `tests/test_torch_mesh_serve.py`'s)
STREAM_ATOL = 2e-5
#: a rank's pools against the unmeshed pools' slots (f32) where they are
#: not bitwise: about twice the largest difference seen on the CPU
#: (3.7e-6 of values up to 4.1, granite-moe's second layer at (1, 4),
#: whose input differs by the order the ranks' partials merged in)
POOL_ATOL = 8e-6


def pairs():
    """{tag: (reference model, its params, port model, its params)}."""
    kv1 = smoke_pair(kv_heads=1)
    moe = dataclasses.replace(
        tconfigs.get_smoke("granite-moe-3b-a800m").moe, capacity_factor=0.5)
    return {"dense": smoke_pair(), "kv1": kv1,
            "moe": smoke_pair("granite-moe-3b-a800m", moe=moe)}


def reference_case(models, tag, case):
    """Case `case` through the reference's unmeshed engine."""
    jm, jp, _, _ = models
    if tag == "moe":
        jeng, _ = engines(models, overlap=case == "overlap",
                          **moe_worker.ENGINE)
        rep = jeng.serve(moe_worker.stream(JRequest, jm.cfg.vocab),
                         num_slots=moe_worker.SLOTS, seed=0)
        return ref_outcome(jeng, rep)
    if case in worker.STREAMS:
        eng = JEngine(jm, jp, JConfig(**{**dataclasses.asdict(
            worker.stream_config()), "spec": JAX_H100}))
        return worker.drive_stream(
            eng, worker.stream_prompts(worker.STREAMS[case], jm.cfg.vocab),
            jnp.asarray, np.asarray, jtb.collect)
    ekw, skw, _, slots = worker.CASES[case]
    eng = JEngine(jm, jp, JConfig(**{**dataclasses.asdict(
        worker.engine_config(**ekw)), "spec": JAX_H100}))
    if ekw.get("overlap_migrations"):
        eng._host_memory_kind = None
    skw = dict(skw)
    if skw.get("faults"):
        from repro.serving import faults as jf
        skw["faults"] = worker.fault_plane(jf)
    rep = eng.serve(worker.stream(JRequest, case, jm.cfg.vocab),
                    num_slots=slots, **skw)
    out = worker.outcome(eng, rep, fractions=False)
    if ekw.get("trace_telemetry"):
        from repro.core.sa import SAConfig as JSAConfig
        agg = jtb.score_serve(jtb.collect_serve(eng), JAX_H100,
                              sa_cfg=JSAConfig(**worker.SA),
                              report=rep)["aggregate"]
        out["fractions"] = (agg["live_hit_fraction"],
                            agg.get("bound_fraction", 0.0))
    return out


def run_ranks(tmp, data_path):
    """Spawn the `WORLD` ranks over `PLAN` and wait; their exit codes.
    Ranks still alive after `JOIN_S` are killed."""
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=pages_worker.rank_main, args=(
        r, WORLD, str(tmp / "store"), PLAN, data_path, str(tmp)))
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
    """{"ref": {(tag, case): the reference's outcome}, "port": {(tag,
    case): the port's unmeshed outcome}, (tag, (data, model)): [each
    rank's outcomes, by rank]}."""
    models = pairs()
    tmp = tmp_path_factory.mktemp("pages")
    data_path = str(tmp / "data.pt")
    torch.save({tag: (m[2].cfg, m[3]) for tag, m in models.items()},
               data_path)
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(
        run_ranks(tmp, data_path)))
    ranks.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases = {(tag, case) for tag, _, names in PLAN for case in names}
        got = {"ref": {k: reference_case(models[k[0]], *k) for k in cases},
               "port": {k: pages_worker.run_case(
                   k[0], models[k[0]][2].cfg, models[k[0]][3], k[1])
                   for k in cases}}
    finally:
        torch.set_num_threads(threads)
        ranks.join()
    assert codes == [0] * WORLD, codes
    by_rank = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
               for r in range(WORLD)]
    for tag, (d, m), _ in PLAN:
        got[(tag, (d, m))] = [res[(tag, (d, m))] for res in by_rank[:d * m]]
    got["cfg"] = {tag: m[2].cfg for tag, m in models.items()}
    return got


SERVES = [(tag, shape, case) for tag, shape, cases in PLAN for case in cases
          if case not in worker.STREAMS]
STREAMS = [(tag, shape, case) for tag, shape, cases in PLAN
           for case in cases if case in worker.STREAMS]


def ids(rows):
    return [f"{t}-{d}x{m}-{c}" for t, (d, m), c in rows]


def rule_of(pools, shape):
    """(a geometry, the KV pool rule at `shape`) of the whole `pools`."""
    L, B, Ph, T, KH, HD = pools["k_hbm"].shape
    geo = SimpleNamespace(kv_heads=KH, hbm_pages=Ph, batch=B,
                          host_pages=pools["k_host"].shape[2])
    return geo, _kv_shard_axis(geo, AbstractMesh(("data", "model"), shape))


def test_the_meshes_take_the_rules_they_claim(runs):
    """(1, 4) and (2, 2) serve under `pages`, (1, 3) under `none`."""
    want = {(1, 4): "pages", (1, 3): "none", (2, 2): "pages"}
    for tag, shape, cases in PLAN:
        _, rule = rule_of(runs["port"][(tag, cases[0])]["pools"], shape)
        assert rule == want[shape], (tag, shape)


@pytest.mark.parametrize("tag,shape,case", SERVES, ids=ids(SERVES))
def test_meshed_serve_equals_the_unmeshed_serves(runs, tag, shape, case):
    """Tokens, statuses (with error codes), events and every priced
    step's bytes equal on every rank: the port's unmeshed serve and the
    reference's."""
    for want in (runs["port"][(tag, case)], runs["ref"][(tag, case)]):
        for rank, res in enumerate(runs[(tag, shape)]):
            got = res[case]
            for key in ("outputs", "statuses", "events", "bytes"):
                assert got[key] == want[key], (rank, key)


@pytest.mark.parametrize("tag,shape,case", STREAMS, ids=ids(STREAMS))
def test_meshed_single_stream_equals_the_unmeshed_streams(runs, tag, shape,
                                                          case):
    """`start`, `generate`, `run` and `step` on every rank: greedy
    tokens, every StepStats row's bytes and the collected trace equal
    the port's unmeshed stream's and the reference's, the logits within
    `STREAM_ATOL`; each rank's tables are its lanes' of the unmeshed
    stream. The stream reads the host tier and promotes pages."""
    port, ref = runs["port"][(tag, case)], runs["ref"][(tag, case)]
    assert any(b[1] > 0 for b in ref["bytes"])
    assert any(b[2] > 0 for b in ref["bytes"])
    data = shape[0]
    B = worker.STREAMS[case]
    n = B // data if B % data == 0 else B
    for res in runs[(tag, shape)]:
        got = res[case]
        for want in (port, ref):
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            assert got["bytes"] == want["bytes"]
            for a, b in zip(got["trace"], want["trace"]):
                np.testing.assert_array_equal(a, b)
            for k in ("start", "run", "step"):
                np.testing.assert_allclose(got[k], want[k],
                                           atol=STREAM_ATOL, err_msg=k)
        lo = res["coord"]["data"] * n if n < B else 0
        for f, t in got["tables"].items():
            np.testing.assert_array_equal(t, np.take(
                port["tables"][f], range(lo, lo + n),
                axis=0 if f == "length" else 1), err_msg=f)


ALL = SERVES + STREAMS


@pytest.mark.parametrize("tag,shape,case", ALL, ids=ids(ALL))
def test_pools_hold_the_rank_slots_at_the_reference_local_shape(
        runs, tag, shape, case):
    """Each rank's pools are `local_shape` of the whole pools under the
    reference's `cache_shardings` (under `pages` [L, B/data, P/model, T,
    KH, HD]: every KV head, a contiguous block of each tier's slots) and
    hold the unmeshed pools' values at its lanes and slots
    (`pool_slots`): bitwise under `none` (every product the unmeshed
    one); under `pages` layer 0 bitwise where the rank runs every lane
    (its K/V come from the embedding alone; a data rank's products over
    fewer lanes may round otherwise) and every layer within
    `POOL_ATOL`."""
    data, m = shape
    whole = runs["port"][(tag, case)]["pools"]
    geo, rule = rule_of(whole, shape)
    mesh = AbstractMesh(("data", "model"), shape)
    spec = cache_shardings(geo, mesh).k_hbm
    B = geo.batch
    n = B // data if B % data == 0 else B
    for res in runs[(tag, shape)]:
        got = res[case]["pools"]
        coord = res["coord"]
        lanes = slice(coord["data"] * n, coord["data"] * n + n) \
            if n < B else slice(None)
        slots = pool_slots(geo, mesh, coord["model"])
        for f, pool in got.items():
            want = whole[f]
            assert pool.shape == local_shape(want.shape, spec, mesh), f
            lo, hi = slots[0 if "hbm" in f else 1]
            want = want[:, lanes, lo:hi]
            if data == 1:
                np.testing.assert_array_equal(pool[0], want[0], err_msg=f)
            if rule == "none":
                np.testing.assert_array_equal(pool, want, err_msg=f)
            else:
                np.testing.assert_allclose(pool, want, rtol=0,
                                           atol=POOL_ATOL, err_msg=f)


DENSE = [(tag, shape, case) for tag, shape, case in SERVES if tag != "moe"]


@pytest.mark.parametrize("tag,shape,case", DENSE, ids=ids(DENSE))
def test_model_ranks_plan_as_the_unmeshed_serve(runs, tag, shape, case):
    """The tables are whole on every model rank, so every decision over
    them is the unmeshed one: each rank's plans, step by step, are the
    unmeshed plans' rows of its lanes, and its final tables and
    importance are its lanes' of the unmeshed serve's."""
    data = shape[0]
    whole = runs["port"][(tag, case)]
    for res in runs[(tag, shape)]:
        got = res[case]
        d = res["coord"]["data"]
        assert len(got["plans"]) == len(whole["plans"])
        for a, w in zip(got["plans"], whole["plans"]):
            want = w if data == 1 else lanes_of(w, d, data)
            np.testing.assert_array_equal(a, want)
        for f, t in got["tables"].items():
            want = whole["tables"][f]
            if data > 1:
                n = want.shape[1] // data
                want = want[:, d * n:(d + 1) * n]
            np.testing.assert_array_equal(t, want, err_msg=f)


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


def test_plans_move_pages_between_ranks(runs):
    """The spilling stream at (1, 4) commits promotions whose host slot
    and HBM slot lie on two ranks (the row exchange of
    `kvcache.migrate`), under commit caps, with a request failing
    poisoned; the moe stream migrates too."""
    port = runs["port"][("dense", "trace")]
    shard = SimpleNamespace(hbm=16 // 4, host=32 // 4)
    crossing = sum(int(((p[0] >= 0) & (p[2] // shard.host
                                      != p[3] // shard.hbm)).sum())
                   for p in port["plans"])
    assert crossing > 0
    assert any(b[2] > 0 for b in port["bytes"])
    assert ("failed", "poisoned_logits") in port["statuses"].values()
    assert sum(b[2] + b[3] for b in runs["port"][("moe", "inline")][
        "bytes"]) > 0


def test_hit_and_bound_fractions_within_tolerance(runs):
    got = runs[("dense", (1, 4))][0]["trace"]["fractions"]
    for want in (runs["ref"][("dense", "trace")]["fractions"],
                 runs["port"][("dense", "trace")]["fractions"]):
        assert abs(got[0] - want[0]) <= 0.02
        assert abs(got[1] - want[1]) <= 0.05


def test_split_layers_on_threads_equal_the_unsplit():
    """`chip_smoke.py`'s phase 18 on the CPU at the f32 smoke configs
    (2 lanes, 16 HBM + 32 host pages, a 300-token `start`): the
    internlm2 smoke layer (one query head a rank) and a 12-over-3-head
    variant of the qwen3 smoke layer (three query heads a rank, two of
    the four ranks' heads straddling two KV heads: K/V repeated to them)
    under `pages` at model = 4, the internlm2 smoke layer under `none`
    at model = 3, the ranks as threads: pools bitwise and tables equal
    after the decode write, the migration, the chunk and `start`, the
    logits within the phase's f32 tolerance (the phase raises
    otherwise), and under `none` exact."""
    sys.path.insert(0, REPO)
    import chip_smoke

    def get(name):
        cfg = tconfigs.get_smoke(name)
        if name == "qwen3-32b":
            cfg = dataclasses.replace(cfg, num_heads=12, kv_heads=3)
        return dataclasses.replace(cfg, dtype=torch.float32,
                                   param_dtype=torch.float32)
    _, rows = chip_smoke.pages_split_phase(
        0, device="cpu", get=get, splits=(
            ("pages", (("internlm2-1.8b", 4), ("qwen3-32b", 4))),
            ("none", (("internlm2-1.8b", 3),))),
        geo_pages=(2, 16, 32), start=(2, 300), chunk=32, chunk_start=120)
    assert [(r["rule"], r["split"]) for r in rows] == [
        ("pages", 4), ("pages", 4), ("none", 3)]
    assert all(all(r["same"].values()) for r in rows)
    assert rows[0]["crossing"] > 0 and rows[0]["zero_partials"] > 0
    assert rows[1]["heads"] == (0, 3)
    assert all(e == 0 for e in rows[2]["errors"].values())
    limit = chip_smoke.PAGES_SPLIT_TOL["f32"]
    assert all(e <= limit[k] for r in rows for k, e in r["errors"].items())


#: (arch, smoke, model axis): a model axis that does not divide the KV
#: heads, at the smoke configs and at full width
SHARD_CASES = [("internlm2-1.8b", True, 4), ("internlm2-1.8b", True, 3),
               ("internlm2-1.8b", False, 16), ("qwen3-32b", False, 16),
               ("llama4-maverick-400b-a17b", False, 16),
               ("granite-moe-3b-a800m", True, 4)]


@pytest.mark.parametrize("name,smoke,model", SHARD_CASES,
                         ids=[f"{n}{'-smoke' if s else ''}-{m}"
                              for n, s, m in SHARD_CASES])
def test_attention_shards_under_pages_and_none(name, smoke, model):
    """`bridge.shard_params` against `param_pspec`'s serve spec, on the
    attention leaves, for a model axis that does not divide the KV
    heads (meta tensors, nothing allocated): `wk`/`wv` whole (the rules
    put `model` on their head_dim, which the rank holds whole), `wq` and
    `wo` split on their heads when the axis divides them (internlm2's 16
    and qwen3's 64 at 16; the smoke configs' 4 at 4) and whole
    otherwise (llama4's 40 at 16, 4 at 3), each leaf at `local_shape` of
    its `leaf_spec`; `TensorParallel.of` names the same query heads
    (`heads`), and `ModelConfig.rank_local` keeps both head counts
    whole."""
    cfg = tconfigs.get_smoke(name) if smoke else tconfigs.get(name)
    mesh = AbstractMesh(("data", "model"), (1, model))
    tmodel = Model(cfg)
    params = abstract_params(tmodel.schema())
    schema = tmodel.schema()["layers"]
    layers = params["layers"]
    if "moe_attn" in layers:
        layers, schema = layers["moe_attn"], schema["moe_attn"]
    divides = cfg.num_heads % model == 0
    for rank in sorted({0, model - 1}):
        coord = {"data": 0, "model": rank}
        got = bridge.shard_params(params, cfg, mesh, coord)["layers"]
        if "moe_attn" in got:
            got = got["moe_attn"]
        tp = TensorParallel.of(cfg, model, rank, None, None)
        assert not tp.kv_split
        per = cfg.num_heads // model
        assert tp.heads == ((rank * per, (rank + 1) * per) if divides
                            else None)
        for leaf in ("wq", "wk", "wv", "wo"):
            p = schema[leaf]
            spec = param_pspec(p.axes, p.shape, mesh, "serve")
            assert "model" not in [s for s, a in zip(spec, p.axes)
                                   if a == "kv_heads"]
            want = local_shape(p.shape, bridge.leaf_spec(p, mesh), mesh)
            assert tuple(got[leaf].shape) == want, leaf
            heads = p.axes.index("heads") if "heads" in p.axes else \
                p.axes.index("kv_heads")
            n = p.shape[heads]
            if leaf in ("wk", "wv") or not divides:
                assert got[leaf] is layers[leaf], leaf
            else:
                assert want[heads] == n // model, leaf
    local = cfg.rank_local(model)
    assert (local.num_heads, local.kv_heads) == (cfg.num_heads,
                                                 cfg.kv_heads)


@pytest.mark.parametrize("hbm,host,model,rule", [
    (64, 208, 16, "pages"), (16, 32, 4, "pages"), (16, 32, 3, "none"),
    (16, 24, 16, "none"), (16, 32, 2, "kv_heads")])
def test_pool_slots_split_the_tiers_as_the_reference_shards_them(
        hbm, host, model, rule):
    """`pool_slots` gives each rank a contiguous block of each tier under
    `pages`, the blocks tiling the tier in rank order at
    `cache_shardings`' local shape; every slot under the other rules."""
    geo = SimpleNamespace(kv_heads=16 if rule == "kv_heads" else 2,
                          hbm_pages=hbm, host_pages=host, batch=1)
    mesh = AbstractMesh(("data", "model"), (1, model))
    assert _kv_shard_axis(geo, mesh) == rule
    spec = cache_shardings(geo, mesh).k_hbm
    got = [pool_slots(geo, mesh, r) for r in range(model)]
    for tier, n in ((0, hbm), (1, host)):
        if rule != "pages":
            assert all(s[tier] == (0, n) for s in got)
            continue
        assert [s[tier] for s in got] == [
            (r * n // model, (r + 1) * n // model) for r in range(model)]
        size = local_shape((1, 1, n, 16, 2, 8), spec, mesh)[2]
        assert all(hi - lo == size for lo, hi in (s[tier] for s in got))
