"""The port's sharding rules (`repro_torch.launch.shardings`) against the
reference's (`repro.launch.shardings`), on meshes of names and sizes
with no devices: jax 0.9's `AbstractMesh(axis_sizes, axis_names)` for
the reference, the port's `AbstractMesh` for the port.

Every leaf of all 11 configs in `serve` and `train` mode, the batch,
cache, policy-state, serve-bundle, recurrent-state and decode-state
specs, `logical_axes`, and the local shape of every leaf that
`bridge.shard_params` cuts. The reference's rules wrap each spec in a
`NamedSharding`; the tests swap that class for a holder of the spec,
so that no sharding is built on a mesh without devices. Specs compare
as tuples of JAX's normalized `PartitionSpec`.
"""

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.tiers import MemorySystemSpec as JSpec  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import policies as jpol  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.tiers import H100  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shardings as tshd  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.transformer import TensorParallel  # noqa: E402
from repro_torch.serving import policies as tpol  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

NAMES = tconfigs.all_arch_names() + ["llama31-8b"]
#: (axis names, sizes): the meshes the rules are held to
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 2)),
          (("data", "model"), (4, 1)), (("data", "model"), (1, 4)),
          (("data", "model"), (8, 2)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
MESH_IDS = ["x".join(map(str, s)) for _, s in MESHES]
#: the reference's policies priced on the port's H100 spec
JAX_H100 = JSpec(**dataclasses.asdict(H100))


@pytest.fixture(autouse=True)
def spec_holders(monkeypatch):
    """The reference's `NamedSharding(mesh, spec)` becomes a holder of
    `spec`: nothing is built on a mesh that has no devices."""
    monkeypatch.setattr(jshd, "NamedSharding",
                        lambda mesh, spec: SimpleNamespace(spec=spec))


def meshes(names, sizes):
    return JMesh(sizes, names), tmesh.AbstractMesh(names, sizes)


def norm(spec):
    """A spec (the port's tuple or a reference PartitionSpec) as the
    tuple of its normalized PartitionSpec."""
    return tuple(spec if isinstance(spec, P) else P(*spec))


def spec_of(x):
    return norm(x.spec if hasattr(x, "spec") else x)


def same_tree(got, want):
    """A tree of port specs against one of reference holders: the same
    leaf paths, each spec equal (a stateless policy's `()` on both)."""
    if want == ():
        assert got == ()
        return
    want_leaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, SimpleNamespace))[0]
    got_leaves = list(spec_leaves(got))
    assert [p for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (_, w), (_, g) in zip(want_leaves, got_leaves):
        assert spec_of(g) == spec_of(w)


def spec_leaves(tree, path=""):
    """(path, spec) of a tree of port specs (a spec is a tuple), with
    paths written as `jax.tree_util.keystr` writes them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k], f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from spec_leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def geo_stub(*, kv_heads=2, hbm_pages=16, host_pages=16, batch=4,
             num_layers=2, max_pages=8):
    return SimpleNamespace(kv_heads=kv_heads, head_dim=16,
                           hbm_pages=hbm_pages, host_pages=host_pages,
                           batch=batch, num_layers=num_layers,
                           max_pages=max_pages)


def leaves(tree, path=()):
    """(path, leaf) of a nested dict whose leaves are tuples (logical
    axes) or tensors, in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("name", NAMES)
def test_logical_axes_equal_the_reference(name):
    for get in ("get", "get_smoke"):
        want = JModel(getattr(jconfigs, get)(name)).logical_axes()
        got = TModel(getattr(tconfigs, get)(name)).logical_axes()
        assert list(leaves(got)) == list(leaves(want))


@pytest.mark.parametrize("names,sizes", MESHES, ids=MESH_IDS)
def test_param_pspec_every_leaf_of_every_config(names, sizes):
    jm, tm = meshes(names, sizes)
    for name in NAMES:
        jmodel = JModel(jconfigs.get(name))
        tmodel = TModel(tconfigs.get(name))
        shapes = dict(leaves(jax.tree.map(
            lambda a: a.shape, jmodel.abstract_params())))
        axes = dict(leaves(jmodel.logical_axes()))
        t_abs = tmodel.schema()
        t_shapes = {p: leaf.shape for p, leaf in leaves(t_abs)}
        assert t_shapes == shapes, name
        for mode in ("serve", "train"):
            t_specs = dict(leaves(tshd.param_shardings(
                tmodel.logical_axes(),
                {k: v for k, v in _abstract(tmodel).items()}, tm, mode)))
            for path, ax in axes.items():
                want = jshd.param_pspec(ax, shapes[path], jm, mode)
                got = tshd.param_pspec(ax, shapes[path], tm, mode)
                assert norm(got) == norm(want), (name, mode, path)
                assert norm(t_specs[path]) == norm(want), (name, mode, path)


def _abstract(tmodel):
    from repro_torch.models.params import abstract_params
    return abstract_params(tmodel.schema())


@pytest.mark.parametrize("names,sizes", MESHES, ids=MESH_IDS)
def test_batch_kv_and_cache_rules(names, sizes):
    jm, tm = meshes(names, sizes)
    for batch in (None, 1, 2, 3, 4, 8, 16, 32, 64, 512):
        assert tshd.batch_axes(tm, batch) == jshd.batch_axes(jm, batch)
        assert norm(tshd.tokens_sharding(tm, batch)) == \
            spec_of(jshd.tokens_sharding(jm, batch))
        for vocab in (256, 92544, 49155):
            assert norm(tshd.logits_sharding(tm, vocab, batch)) == \
                spec_of(jshd.logits_sharding(jm, vocab, batch))
    for kv in (1, 2, 3, 8, 16, 32):
        for hbm, host in ((16, 16), (15, 16), (64, 208), (32, 48)):
            for batch in (1, 3, 4, 8, 32):
                geo = geo_stub(kv_heads=kv, hbm_pages=hbm, host_pages=host,
                               batch=batch)
                assert tshd._kv_shard_axis(geo, tm) == \
                    jshd._kv_shard_axis(geo, jm)
                want = jshd.cache_shardings(geo, jm)
                got = tshd.cache_shardings(geo, tm)
                for f in dataclasses.fields(got):
                    assert norm(getattr(got, f.name)) == \
                        spec_of(getattr(want, f.name)), f.name
    assert norm(tshd.replicated(tm)) == spec_of(jshd.replicated(jm))


@pytest.mark.parametrize("names,sizes", MESHES, ids=MESH_IDS)
def test_policy_and_serve_bundles(names, sizes):
    jm, tm = meshes(names, sizes)
    cfg = SimpleNamespace(promote_thresh=0.02, attention_sparsity=0.5,
                          overlap_migrations=False, spec=JAX_H100)
    tcfg = SimpleNamespace(promote_thresh=0.02, attention_sparsity=0.5,
                           overlap_migrations=False, spec=H100)
    for batch in (1, 3, 4, 8, 32):
        geo = geo_stub(batch=batch, num_layers=3, max_pages=8)
        for name in tpol.policy_names():
            want = jshd.policy_state_shardings(jax.eval_shape(
                lambda: jpol.make_policy(name, cfg=cfg, geo=geo)
                .init_state(geo)), geo, jm)
            got = tshd.policy_state_shardings(
                tpol.make_policy(name, cfg=tcfg, geo=geo).init_state(geo),
                geo, tm)
            same_tree(got, want)
        # a [B] per-lane leaf and a scalar, beside the [L, B, P] one
        state = {"last": torch.zeros(3, batch, 8), "lane":
                 torch.zeros(batch), "bar": torch.zeros(())}
        same_tree(tshd.policy_state_shardings(state, geo, tm),
                  jshd.policy_state_shardings(
                      {k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
                       for k, v in state.items()}, geo, jm))
        want = jshd.serve_shardings(geo, jm)
        got = tshd.serve_shardings(geo, tm)
        assert got.keys() == want.keys()
        for key in ("lane", "lane_kv", "step_lane", "rep"):
            assert norm(got[key]) == spec_of(want[key]), key
        for f in dataclasses.fields(got["cache"]):
            assert norm(getattr(got["cache"], f.name)) == \
                spec_of(getattr(want["cache"], f.name))
        for f in dataclasses.fields(got["plan"]):
            assert norm(getattr(got["plan"], f.name)) == \
                spec_of(getattr(want["plan"], f.name))


def test_indivisible_lanes_replicate():
    tm = tmesh.AbstractMesh(("data", "model"), (2, 2))
    sh = tshd.serve_shardings(geo_stub(batch=3), tm)
    assert sh["lane"] == ((),) and sh["cache"].length == ((),)
    assert tshd.local_shape((3, 5), sh["lane_kv"], tm) == (3, 5)


@pytest.mark.parametrize("names,sizes", MESHES, ids=MESH_IDS)
def test_decode_state_specs_every_family(names, sizes):
    """`state_shardings_for` (and inside it `ssm_state_shardings`) over
    the abstract decode state of every smoke config's family: the cache,
    hybrid's {"ssm", "kv"}, xlstm's recurrent tensors, encdec's
    {"kv", "enc"}."""
    jm, tm = meshes(names, sizes)
    for name in NAMES:
        jmodel = JModel(jconfigs.get_smoke(name))
        tmodel = TModel(tconfigs.get_smoke(name))
        for batch in (2, 4):
            jgeo = jmodel.cache_geometry(batch, 256)
            tgeo = tmodel.cache_geometry(batch, 256)
            jstate = jax.eval_shape(
                lambda: jmodel.init_decode_state(batch, jgeo))
            tstate = tmodel.init_decode_state(batch, tgeo, device="meta")
            if tmodel.cfg.family == "encdec":
                jstate = {"kv": jstate, "enc": jax.ShapeDtypeStruct(
                    (batch, 6, 8), "float32")}
                tstate = {"kv": tstate, "enc": torch.empty(
                    (batch, 6, 8), device="meta")}
            same_tree(tshd.state_shardings_for(tmodel, tstate, tm),
                      jshd.state_shardings_for(jmodel, jstate, jm))


def test_mesh_sizes_and_production_meshes():
    assert tmesh.mesh_axis_sizes(tmesh.AbstractMesh(
        ("data", "model"), (2, 2))) == {"data": 2, "model": 2}
    assert tmesh.mesh_axis_sizes(JMesh((2, 2), ("data", "model"))) == \
        {"data": 2, "model": 2}
    one = tmesh.make_production_mesh()
    two = tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.axis_names(one) == ("data", "model")
    assert tmesh.mesh_axis_sizes(one) == {"data": 16, "model": 16}
    assert tmesh.mesh_axis_sizes(two) == {"pod": 2, "data": 16,
                                          "model": 16}


SHARD_MESHES = [(1, 1), (2, 2), (1, 4), (8, 2), (1, 16)]


@pytest.mark.parametrize("data,model", SHARD_MESHES,
                         ids=[f"{d}x{m}" for d, m in SHARD_MESHES])
def test_shard_params_local_shapes(data, model):
    """`bridge.shard_params`' rule, leaf by leaf, on every dense config
    the axis splits (meta tensors, nothing allocated): a leaf whose
    serve spec puts `model` on heads, kv_heads, mlp or vocab holds
    1/model of that dim at the coordinate's offset, every other leaf is
    whole (the very tensor); and the kept dims are what
    `ModelConfig.rank_local` and `TensorParallel.of` count."""
    tm = tmesh.AbstractMesh(("data", "model"), (data, model))
    for name in NAMES:
        cfg = tconfigs.get(name)
        if cfg.family != "dense" or cfg.kv_heads % model:
            continue
        tmodel = TModel(cfg)
        params = _abstract(tmodel)
        axes = dict(leaves(tmodel.logical_axes()))
        for rank in sorted({0, model - 1}):
            coord = {"data": data - 1, "model": rank}
            got = dict(leaves(bridge.shard_params(params, cfg, tm, coord)))
            local = cfg.rank_local(model)
            tp = TensorParallel.of(cfg, model, rank, None, None)
            for path, leaf in leaves(params):
                ax = axes[path]
                spec = tshd.param_pspec(ax, tuple(leaf.shape), tm, "serve")
                want = tuple(n // model if s == "model" and
                             a in bridge.SPLIT_NAMES else n
                             for n, s, a in zip(leaf.shape, spec, ax))
                assert tuple(got[path].shape) == want, (name, path)
                if want == tuple(leaf.shape):
                    assert got[path] is leaf, (name, path)
            lay = got[("layers", "wq")].shape
            assert lay[2] == local.num_heads
            assert got[("layers", "wk")].shape[2] == local.kv_heads
            assert got[("layers", "w_gate")].shape[2] == local.d_ff
            lo, hi = tp.vocab or (0, cfg.vocab)
            assert got[("embed",)].shape[0] == hi - lo
            assert lo == (rank * (cfg.vocab // model)
                          if tp.vocab is not None else 0)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)],
                         ids=["1x2", "2x2"])
def test_init_shards_draws_the_cut_of_the_whole_model(data, model):
    """`bridge.init_shards` (each leaf cut as it is drawn) gives what
    `shard_params` cuts from the whole model drawn from the same seed,
    bit for bit on the CPU; and `shard_params` keeps leaves already at
    their shard's shape as they are (the meshed engine takes either)."""
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    tm = tmesh.AbstractMesh(("data", "model"), (data, model))
    whole = TModel(cfg).init(0, device="cpu")
    for rank in range(model):
        coord = {"data": data - 1, "model": rank}
        want = dict(leaves(bridge.shard_params(whole, cfg, tm, coord)))
        drawn = bridge.init_shards(cfg, 0, tm, coord, device="cpu")
        got = dict(leaves(drawn))
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert torch.equal(got[path], w), path
        again = dict(leaves(bridge.shard_params(drawn, cfg, tm, coord)))
        assert all(again[p] is got[p] for p in got)
        assert sum(t.nbytes for t in got.values()) < sum(
            t.nbytes for _, t in leaves(whole))


def test_shard_takes_the_coordinate_block():
    tm = tmesh.AbstractMesh(("pod", "data", "model"), (2, 2, 2))
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    assert tshd.local_shape(t.shape, spec, tm) == (2, 3)
    blk = tshd.shard(t, spec, tm, {"pod": 1, "data": 0, "model": 1})
    assert torch.equal(blk, t[4:6, 3:6])
    assert blk.is_contiguous()
    assert tshd.shard(t, (None, None), tm, {"pod": 0, "data": 0,
                                            "model": 0}) is t
