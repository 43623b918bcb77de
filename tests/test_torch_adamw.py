"""The AdamW kernels' CPU side (`kernels/adamw.py`, `kernels.ops`,
`training.optimizer`) and the donated update, on the CPU.

- `adamw_update(..., donate=True)` writes into the given parameters, m
  and v and returns those very tensors, bitwise equal to the pure
  update's, and changes nothing else; the pure update leaves its
  arguments as they were; a norm passed in gives the step of the norm
  computed inside; bf16 parameters with f32 (accumulated) gradients.
- `ops.grad_sumsq` / `ops.adamw_apply` send CPU tensors to the plain
  versions (`kernels/ref.py`) and never to the kernel; the kernel's
  wrappers refuse CPU tensors; the plain versions against the
  reference's `adamw_update` arithmetic (1e-6, as
  tests/test_torch_train.py holds the update).
- The launchers' leaf tables: the packed layouts equal the source's
  `static_assert`ed sizes and constants, and the grid plan gives every
  leaf its share of the blocks.
- Donated train steps (accum_steps 1 and 2) equal pure ones bitwise;
  the train CLI donates its step.
- The dry run: a meta-device train step shows one
  `repro_torch::grad_sumsq` and one `repro_torch::adamw_apply`
  operator, priced by `launch/op_cost.py`'s formulas (the gradients'
  bytes and the sums'; g, p, m, v read and p, m, v written: 22 bytes a
  bf16 parameter), and the donated step adds no new state to the
  activations.

The kernels themselves are held to the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 2e).
"""

import dataclasses
import math
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainState, init_train_state, make_train_step,
)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

SHAPES = {"w": (6, 5), "layers": {"a": (3, 7, 4), "b": (3, 9)},
          "norm": (13,)}


def tree_of(rng, dtype, scale=1.0, positive=False):
    def leaf(shape):
        x = scale * rng.standard_normal(shape)
        return torch.from_numpy(np.abs(x) if positive else x).to(dtype)
    return {"w": leaf(SHAPES["w"]), "norm": leaf(SHAPES["norm"]),
            "layers": {k: leaf(s) for k, s in SHAPES["layers"].items()}}


def case(seed=0, p_dtype=torch.bfloat16, g_dtype=torch.bfloat16, step=2):
    """(grads, a state at `step` with nonzero m and v, params)."""
    rng = np.random.default_rng(seed)
    params = tree_of(rng, p_dtype)
    grads = tree_of(rng, g_dtype, scale=0.3)
    state = topt.AdamWState(step=torch.tensor(step, dtype=torch.int32),
                            m=tree_of(rng, torch.float32, 0.1),
                            v=tree_of(rng, torch.float32, 0.01, True))
    return grads, state, params


def clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)], ids=["bf16", "f32", "bf16-f32grad"])
@pytest.mark.parametrize("lr", [1e-2, None], ids=["lr", "schedule"])
def test_donated_update_is_the_pure_one_in_place(p_dtype, g_dtype, lr):
    grads, state, params = case(p_dtype=p_dtype, g_dtype=g_dtype)
    want_p, want_s = topt.adamw_update(clone(grads), clone(state),
                                       clone(params), lr=lr)
    g_before, step_before = clone(grads), state.step.clone()
    given = [tree_leaves(t) for t in (params, state.m, state.v)]
    ptrs = [[t.data_ptr() for t in leaves] for leaves in given]
    got_p, got_s = topt.adamw_update(grads, state, params, lr=lr,
                                     donate=True)
    assert_equal(got_p, want_p)
    assert_equal(got_s.m, want_s.m)
    assert_equal(got_s.v, want_s.v)
    assert int(got_s.step) == int(want_s.step) == 3
    for leaves, new, old in zip(
            given, (tree_leaves(t) for t in (got_p, got_s.m, got_s.v)),
            ptrs):
        assert all(a is b for a, b in zip(leaves, new, strict=True))
        assert [t.data_ptr() for t in new] == old
    # nothing else changed: the gradients and the old step count
    assert_equal(grads, g_before)
    assert torch.equal(state.step, step_before)


def test_pure_update_leaves_its_arguments_as_they_were():
    grads, state, params = case(seed=1)
    before = clone((grads, state.m, state.v, params))
    step = state.step.clone()
    new_p, new_s = topt.adamw_update(grads, state, params, lr=1e-2)
    assert_equal((grads, state.m, state.v, params), before)
    assert torch.equal(state.step, step)
    assert all(a is not b for a, b in zip(tree_leaves(new_p),
                                          tree_leaves(params)))
    assert not torch.equal(tree_leaves(new_p)[0], tree_leaves(params)[0])


@pytest.mark.parametrize("grad_clip", [1e-3, 1e3], ids=["clip", "no-clip"])
def test_a_norm_passed_in_gives_the_same_step(grad_clip):
    grads, state, params = case(seed=2)
    norm = topt.global_norm(grads)
    a = topt.adamw_update(grads, clone(state), clone(params), lr=1e-2,
                          grad_clip=grad_clip)
    b = topt.adamw_update(grads, clone(state), clone(params), lr=1e-2,
                          grad_clip=grad_clip, gnorm=norm)
    assert_equal(a[0], b[0])
    assert_equal((a[1].m, a[1].v), (b[1].m, b[1].v))


def test_ops_send_cpu_tensors_to_the_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")
    monkeypatch.setattr(kadamw, "grad_sumsq", refuse)
    monkeypatch.setattr(kadamw, "adamw_apply", refuse)
    called = []

    def spy(name):
        plain = getattr(ref, name)

        def run(*args, **kwargs):
            called.append(name)
            return plain(*args, **kwargs)
        monkeypatch.setattr(ref, name, run)
    spy("grad_sumsq_ref")
    spy("adamw_apply_ref")
    before = dict(build.COUNTS)
    grads, state, params = case(seed=3)
    topt.adamw_update(grads, state, params, lr=1e-2, donate=True)
    assert called == ["grad_sumsq_ref", "adamw_apply_ref"]
    assert dict(build.COUNTS) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    g = [torch.zeros(8)]
    with pytest.raises(ValueError, match="card"):
        kadamw.grad_sumsq(g)
    one = torch.ones(())
    with pytest.raises(ValueError, match="card"):
        kadamw.adamw_apply(g, g, g, g, g, g, g, scale=one, lr=1e-3,
                           bc1=one, bc2=one, b1=0.9, b2=0.95, eps=1e-8,
                           weight_decay=0.1)


def test_plain_versions_match_the_reference():
    """One step of `ref.adamw_apply_ref` with the reference's scalars
    against the reference's `adamw_update` (bf16 parameters)."""
    grads, state, params = case(seed=4, step=0)

    def np_tree(tree):
        return jax.tree.map(lambda x: jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32), tree)
    jstate = jopt.AdamWState(step=jnp.asarray(0, jnp.int32),
                             m=np_tree(state.m), v=np_tree(state.v))
    jp, js = jopt.adamw_update(np_tree(grads), jstate, np_tree(params),
                               lr=1e-2)
    sums = ops.grad_sumsq(tree_leaves(grads))
    want = float(jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                              for x in jax.tree.leaves(np_tree(grads)))))
    assert abs(float(torch.sqrt(sums.sum())) - want) <= 1e-6 * want
    tp, ts = topt.adamw_update(grads, state, params, lr=1e-2)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(np.asarray(a.astype(jnp.float32)),
                                   b.float().numpy(), rtol=0, atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(js, key)),
                        tree_leaves(getattr(ts, key))):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=1e-7)


def source_constant(name):
    text = (build.CSRC / "adamw.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_leaf_tables_are_the_launchers_layout():
    text = (build.CSRC / "adamw.cu").read_text()
    sizes = dict(re.findall(r"sizeof\((\w+)\) == (\d+)", text))
    assert kadamw._UPDATE.size == int(sizes["UpdateDesc"])
    assert kadamw._SUM.size == int(sizes["SumDesc"])
    assert kadamw.MAX_LEAVES == source_constant("kMaxLeaves")
    assert kadamw.THREADS == source_constant("kThreads")
    assert kadamw.VEC == source_constant("kVec")
    # the tables ride in the 4 KB of kernel parameters
    assert kadamw._UPDATE.size <= 4096 and kadamw._SUM.size <= 4096
    assert "adamw" in build.SOURCES


def test_grid_plan_shares_the_blocks_among_the_leaves():
    # internlm2-1.8b's leaves at full width, on a card of 132 SMs
    cfg = tconfigs.get("internlm2-1.8b")
    counts = [t.numel() for t in tree_leaves(abstract_params(
        Model(cfg).schema(), cfg.param_dtype))]
    starts = kadamw.plan_blocks(counts, 132)
    blocks = [b - a for a, b in zip(starts, starts[1:])]
    assert starts[0] == 0 and all(b >= 1 for b in blocks)
    target = 132 * kadamw.BLOCKS_PER_SM
    assert target <= starts[-1] <= target + len(counts)
    per = kadamw.THREADS * kadamw.VEC
    for n, b in zip(counts, blocks):
        assert b <= max(1, math.ceil(n / per))
        assert b >= min(math.ceil(n / per), target * n / sum(counts))
    # a tiny tree: one block a leaf, no more than its vectors need
    assert kadamw.plan_blocks([0, 5, 2048 * 3], 132) == [0, 1, 2, 5]


@pytest.mark.parametrize("accum", [1, 2])
def test_donated_train_steps_equal_pure_ones(accum):
    cfg = dataclasses.replace(tconfigs.get_smoke("internlm2-1.8b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = Model(cfg)
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (4, 17)).astype(
        np.int32)) for _ in range(3)]
    runs = {}
    for donate in (False, True):
        state = init_train_state(model, 0, "cpu")
        given = [t.data_ptr() for t in tree_leaves(
            (state.params, state.opt.m, state.opt.v))]
        step = make_train_step(model, lr=1e-3, accum_steps=accum,
                               donate=donate)
        metrics = []
        for toks in batches:
            state, m = step(state, {"tokens": toks})
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        held = [t.data_ptr() for t in tree_leaves(
            (state.params, state.opt.m, state.opt.v))]
        assert (held == given) == donate
        runs[donate] = (metrics, state)
    assert runs[True][0] == runs[False][0]
    assert_equal(runs[True][1], runs[False][1])


def test_train_cli_donates_its_step(monkeypatch, capsys):
    from repro_torch.launch import train as cli
    seen = []
    real = cli.make_train_step

    def spy(*args, **kwargs):
        seen.append(kwargs.get("donate"))
        return real(*args, **kwargs)
    monkeypatch.setattr(cli, "make_train_step", spy)
    assert cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                     "--seq", "16", "--batch", "2"]) == 0
    assert seen == [True]
    assert capsys.readouterr().out.strip().endswith("done")


def priced_kernels(monkeypatch):
    """Each hand-written kernel operator's (name, FLOPs, bytes) as
    `OpCost` prices it, in call order."""
    seen = []
    for name, price in list(op_cost.KERNELS.items()):
        def record(args, out, _name=name, _price=price):
            flops, nbytes = _price(args, out)
            seen.append((_name.split("::")[1], flops, nbytes))
            return flops, nbytes
        monkeypatch.setitem(op_cost.KERNELS, name, record)
    return seen


@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-3b-a800m"])
def test_meta_train_step_counts_the_fused_update(name, monkeypatch):
    cfg = dataclasses.replace(tconfigs.get(name), num_layers=2)
    model = Model(cfg)
    params = abstract_params(model.schema(), cfg.param_dtype)
    n = sum(t.numel() for t in tree_leaves(params))
    tokens = torch.empty((1, 65), dtype=torch.int32, device="meta")
    peaks = {}
    for donate in (False, True):
        seen = priced_kernels(monkeypatch)
        state = TrainState(params=params, opt=topt.adamw_init(params))
        with op_cost.OpCost() as cost:
            make_train_step(model, donate=donate)(state, {"tokens": tokens})
        opt = [s for s in seen if s[0] in ("grad_sumsq", "adamw_apply")]
        assert [s[0] for s in opt] == ["grad_sumsq", "adamw_apply"]
        assert cost.kernels["grad_sumsq"] == cost.kernels["adamw_apply"] == 1
        leaves = len(tree_leaves(params))
        assert opt[0][1:] == (2 * n, 2 * n + 4 * leaves)   # bf16 gradients
        assert opt[1][1:] == (op_cost.ADAMW_FLOPS * n, 22 * n)
        peaks[donate] = cost.peak
        monkeypatch.undo()
    # the pure update's new parameters, m and v (10 bytes a bf16
    # parameter) are alive beside the gradients (2) at its end; the
    # donated one writes in place, and its peak is the backward's
    assert peaks[False] >= 12 * n
    assert peaks[True] <= peaks[False] - 8 * n
