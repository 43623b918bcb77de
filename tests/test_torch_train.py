"""The port's training path against the reference's, on the CPU, in
float32 smoke configs with the same weights (bridge):

- `loss_fn` and its gradients against `jax.value_and_grad` of the
  reference's `loss_fn`, one config of each family (dense, moe, vlm,
  encdec, hybrid, xlstm): loss within 1e-5 relative, every gradient
  leaf within 1e-4 of that leaf's largest gradient (1e-8 absolute at
  least: the sLSTM gate bias `bi` has a gradient that is zero in exact
  arithmetic and ~1e-9 noise on both sides);
- `forward_hidden` against the reference's for every family (2e-5, as
  `Model.forward` in test_torch_forward.py);
- three `make_train_step` steps on internlm2's smoke config, both from
  the reference's `init_train_state`, the port's step pure and donated
  (`donate=True`: in place): losses and grad norms within
  1e-5 relative, params within 1e-4 (a tenth of lr = 1e-3: AdamW's
  m / sqrt(v) turns f32 noise in near-zero gradients into differences
  of up to a few percent of one step), m and v within 1e-6; and
  `accum_steps=2` against the full batch;
- `adamw_update` (with the clip active and idle, pure and donated),
  `cosine_schedule` and the global norm against the reference's on
  random trees;
- `remat` on and off give equal losses and gradients.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import loss_fn as jloss  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainState, loss_fn, make_train_step, value_and_grad,
)
from repro_torch.tree import (  # noqa: E402
    leaves_with_path, tree_leaves, tree_map, tree_unflatten,
)

from _torch_serve_ref import smoke_pair  # noqa: E402
from test_torch_forward import FORWARD_FAMILIES  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401


def batch(cfg, seed, B=2, S=17):
    """Tokens [B, S] and the family's extra input, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    key = {"vlm": "patch_embeds", "encdec": "frame_embeds"}.get(cfg.family)
    extra = None if key is None else {key: rng.standard_normal(
        (B, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32)}
    return toks, extra


def as_jax(extra):
    return None if extra is None else {k: jnp.asarray(v)
                                       for k, v in extra.items()}


def as_torch(extra):
    return None if extra is None else {k: torch.from_numpy(v)
                                       for k, v in extra.items()}


def assert_grads_close(got, want, rel=1e-4, floor=1e-8):
    """Leaf by leaf, in the reference's leaf order."""
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = list(leaves_with_path(got))
    assert len(gl) == len(wl)
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= max(rel * np.abs(w).max(), floor), (path, err)


@pytest.mark.parametrize("name", FORWARD_FAMILIES)
def test_loss_and_grads_match_reference(name):
    jm, jp, tm, tp = smoke_pair(name)
    toks, extra = batch(tm.cfg, 5)
    f = jax.jit(jax.value_and_grad(
        lambda p, t, e: jloss(jm, p, t, extra=e)))
    want_loss, want_grads = f(jp, jnp.asarray(toks), as_jax(extra))
    loss, grads = value_and_grad(tm, tp, torch.from_numpy(toks),
                                 as_torch(extra))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    assert_grads_close(grads, want_grads)
    # the parameters were not touched
    for p in tree_leaves(tp):
        assert not p.requires_grad and p.grad is None


@pytest.mark.parametrize("name", FORWARD_FAMILIES)
def test_forward_hidden_matches_reference(name):
    jm, jp, tm, tp = smoke_pair(name)
    toks, extra = batch(tm.cfg, 8)
    want = np.asarray(jm.forward_hidden(jp, jnp.asarray(toks),
                                        extra=as_jax(extra)))
    got = tm.forward_hidden(tp, torch.from_numpy(toks), extra=as_torch(extra))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("name", FORWARD_FAMILIES)
def test_remat_gives_equal_values(name):
    """Checkpointed blocks recompute what they dropped: `forward_hidden`
    gives the same hidden states with remat on and off, and the
    gradients of a function of them agree to f32 rounding."""
    _, _, tm, tp = smoke_pair(name)
    toks, extra = batch(tm.cfg, 9)
    t = torch.from_numpy(toks)
    w = torch.from_numpy(np.random.default_rng(10).standard_normal(
        tm.cfg.d_model).astype(np.float32))
    out = {}
    for remat in (True, False):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
        h = tm.forward_hidden(tree_unflatten(tp, leaves), t, as_torch(extra),
                              remat=remat)
        out[remat] = (h.detach(), torch.autograd.grad(
            (h @ w).square().sum(), leaves, allow_unused=True))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def states(seed=0):
    """(reference model, its TrainState, port model, its TrainState):
    internlm2's smoke config, one `init_train_state` of the reference."""
    jm, _, tm, _ = smoke_pair("internlm2-1.8b")
    js = jinit(jm, jax.random.key(seed))
    ts = bridge.train_state_from_jax(jax.device_get(js.params),
                                     jax.device_get(js.opt), tm.cfg,
                                     device="cpu")
    return jm, js, tm, ts


def max_err(jtree, ttree):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)))


@pytest.mark.parametrize("accum,donate", [
    pytest.param(1, False, id="1"), pytest.param(2, False, id="2"),
    pytest.param(1, True, id="1-donated"),
    pytest.param(2, True, id="2-donated")])
def test_three_train_steps_match_reference(accum, donate):
    jm, js, tm, ts = states()
    jstep = jax.jit(jmake(jm, lr=1e-3, accum_steps=accum))
    tstep = make_train_step(tm, lr=1e-3, accum_steps=accum, donate=donate)
    rng = np.random.default_rng(3)
    for i in range(3):
        toks = rng.integers(0, tm.cfg.vocab, (4, 33)).astype(np.int32)
        js, jmet = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * abs(
                float(jmet[k])), (i, k)
        assert int(tmet["step"]) == int(jmet["step"]) == i + 1
        assert max_err(js.params, ts.params) <= 1e-4
        assert max_err(js.opt.m, ts.opt.m) <= 1e-6
        assert max_err(js.opt.v, ts.opt.v) <= 1e-6


def test_accumulation_matches_the_full_batch():
    """Two micro-batches of 2 against one batch of 4: the same mean
    loss, and one AdamW step from the same f32 gradient."""
    _, _, tm, ts = states()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tm.cfg.vocab, (4, 33)).astype(np.int32))
    full, mfull = make_train_step(tm, lr=1e-3)(ts, {"tokens": toks})
    acc, macc = make_train_step(tm, lr=1e-3, accum_steps=2)(
        ts, {"tokens": toks})
    assert abs(float(macc["loss"]) - float(mfull["loss"])) <= 1e-6
    assert abs(float(macc["grad_norm"]) - float(mfull["grad_norm"])) \
        <= 1e-5 * float(mfull["grad_norm"])
    for a, b in zip(tree_leaves(acc.params), tree_leaves(full.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def random_tree(rng, scale):
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": {"x": (scale * rng.standard_normal((7,))).astype(
                np.float32)}}


@pytest.mark.parametrize("scale,donate", [        # clip idle / active
    pytest.param(1e-3, False, id="0.001"), pytest.param(10.0, False, id="10.0"),
    pytest.param(1e-3, True, id="0.001-donated"),
    pytest.param(10.0, True, id="10.0-donated")])
def test_adamw_update_matches_reference(scale, donate):
    """The pure update, and the donated one (in place on copies of the
    state, which the step at lr None would otherwise have consumed)."""
    rng = np.random.default_rng(11)
    params = random_tree(rng, 1.0)
    jstate = jopt.adamw_init(jax.tree.map(jnp.asarray, params))
    tstate = topt.adamw_init(jax.tree.map(torch.from_numpy, params))
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    for step in range(3):
        g = random_tree(rng, scale)
        for lr in (None, 1e-2):
            if lr is None and step:
                continue
            jp2, jstate2 = jopt.adamw_update(jax.tree.map(jnp.asarray, g),
                                             jstate, jp, lr=lr)
            given = (tstate, tp)
            if donate:          # copies, which the update writes into
                given = (topt.AdamWState(step=tstate.step,
                                         m=tree_map(torch.clone, tstate.m),
                                         v=tree_map(torch.clone, tstate.v)),
                         tree_map(torch.clone, tp))
            tp2, tstate2 = topt.adamw_update(
                jax.tree.map(torch.from_numpy, g), *given, lr=lr,
                donate=donate)
            assert max_err(jp2, tp2) <= 1e-6
            assert max_err(jstate2.m, tstate2.m) <= 1e-7
            assert max_err(jstate2.v, tstate2.v) <= 1e-7
            assert int(tstate2.step) == int(jstate2.step)
        jp, jstate, tp, tstate = jp2, jstate2, tp2, tstate2
        want = float(jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(x)))
                                  for x in jax.tree.leaves(g))))
        got = float(topt.global_norm(jax.tree.map(torch.from_numpy, g)))
        assert abs(got - want) <= 1e-6 * want


def test_adamw_update_takes_a_schedule():
    """An `lr` function of the new step matches the reference given that
    function's value at each step."""
    rng = np.random.default_rng(12)
    params = random_tree(rng, 1.0)
    kw = dict(peak_lr=1e-2, warmup=2, total=6)
    jstate = jopt.adamw_init(jax.tree.map(jnp.asarray, params))
    tstate = topt.adamw_init(jax.tree.map(torch.from_numpy, params))
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    for _ in range(4):
        g = random_tree(rng, 1.0)
        jp, jstate = jopt.adamw_update(
            jax.tree.map(jnp.asarray, g), jstate, jp,
            lr=jopt.cosine_schedule(jstate.step + 1, **kw))
        tp, tstate = topt.adamw_update(
            jax.tree.map(torch.from_numpy, g), tstate, tp,
            lr=lambda step: topt.cosine_schedule(step, **kw))
        assert max_err(jp, tp) <= 1e-6
        assert max_err(jstate.m, tstate.m) <= 1e-7


def test_cosine_schedule_matches_reference():
    steps = np.array([0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000],
                     np.int32)
    for kw in ({}, dict(peak_lr=1e-3, warmup=10, total=200, min_frac=0.0)):
        want = np.asarray(jopt.cosine_schedule(jnp.asarray(steps), **kw))
        got = topt.cosine_schedule(torch.from_numpy(steps), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_train_state_round_trips_through_the_bridge():
    _, js, tm, ts = states()
    params, opt = bridge.train_state_to_numpy(ts)
    assert max_err(js.params, jax.tree.map(torch.from_numpy, params)) == 0
    assert int(opt["step"]) == 0 and isinstance(ts, TrainState)
    back = bridge.train_state_from_jax(params, opt, tm.cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_loss_ignores_the_vlm_patches_and_chunks_exactly():
    """The chunked loss equals one unembedding of the whole sequence;
    the vlm loss runs over the text tail only."""
    _, _, tm, tp = smoke_pair("internvl2-2b")
    toks, extra = batch(tm.cfg, 12, S=23)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        one = loss_fn(tm, tp, t, extra=as_torch(extra))
        chunked = loss_fn(tm, tp, t, extra=as_torch(extra), logit_chunk=5)
        logits = tm.forward(tp, t[:, :-1], extra=as_torch(extra))[
            :, -(toks.shape[1] - 1):].float()
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), t[:, 1:].reshape(-1).long())
    torch.testing.assert_close(one, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(chunked, want, rtol=1e-6, atol=0)

