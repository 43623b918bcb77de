"""The xlstm family (xlstm-125m) in the port, against the reference on
the CPU: the smoke config in float32, the same weights (bridge), inputs
drawn with numpy from a seed.

xlstm stacks mLSTM blocks (matrix memory; a chunked max-plus forward
and a recurrent decode step) with an sLSTM block every `slstm_every`-th
(scalar memory, sequential). It has no KV cache: its decode state is
eight stacked f32 recurrent tensors, its prefill replays one decode
step per prompt token (as the reference's does, eagerly, so the
prompts here stay short), and the paged engine has nothing to place.

Tolerances: each layer function (chunked and padded mLSTM forward,
mLSTM decode, sLSTM forward and decode) within 1e-5 of the
reference's; the chunked mLSTM within the reference tests' 1e-4 of its
own sequential oracle; prefill + decode steps: logits within 2e-5,
greedy tokens exact, the state within 1e-5.
What the port refuses: `serve()` and chunked prefill (as the
reference), a Quest mask (as the reference), and `step`/`run`/
`generate` (ValueError, where the reference fails on a missing cache).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import xlstm as jx  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

from _torch_serve_ref import (  # noqa: E402
    assert_refuses_serve, engines, model_steps, smoke_pair, state_numpy,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

NAME = "xlstm-125m"


@pytest.fixture(scope="module")
def models():
    return smoke_pair(NAME)


@pytest.fixture(scope="module")
def prompts(models):
    rng = np.random.default_rng(12)
    return rng.integers(0, models[2].cfg.vocab, (2, 20)).astype(np.int32)


def block(models, kind):
    """Block 0 of `kind` ("mlstm" or "slstm") on both sides."""
    jm, jp, tm, tp = models
    return (jax.tree.map(lambda a: a[0], jp[kind]),
            tfm.layers_of(tp[kind])[0])


def hidden(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("S", [37, 40], ids=["padded", "whole-chunks"])
def test_mlstm_forward_layer_matches_reference(models, S):
    """Chunk 8: S=37 pads the last chunk (input gate NEG, no decay)."""
    jm, _, tm, _ = models
    jlp, tlp = block(models, "mlstm")
    h = hidden((2, S, tm.cfg.d_model), S)
    got = tx.mlstm_forward_layer(torch.from_numpy(h), tlp, tm.cfg)
    close(got.numpy(), jx.mlstm_forward_layer(jnp.asarray(h), jlp, jm.cfg))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("S", [37, 40], ids=["padded", "whole-chunks"])
def test_mlstm_chunked_matches_sequential_oracle(models, S):
    """The chunked max-plus form against the port's sequential
    recurrence (1e-4, as the reference's own test), and that oracle
    against the reference's (1e-5)."""
    jm, _, tm, _ = models
    jlp, tlp = block(models, "mlstm")
    h = torch.from_numpy(hidden((2, S, tm.cfg.d_model), 200 + S))
    seq = tx.mlstm_forward_layer_ref(h, tlp, tm.cfg)
    close(tx.mlstm_forward_layer(h, tlp, tm.cfg).numpy(), seq.numpy(), 1e-4)
    close(seq.numpy(), jx.mlstm_forward_layer_ref(jnp.asarray(h.numpy()),
                                                  jlp, jm.cfg))


def test_mlstm_decode_layer_matches_reference(models):
    jm, _, tm, _ = models
    jlp, tlp = block(models, "mlstm")
    cfg = tm.cfg
    inner = cfg.xlstm.expand * cfg.d_model
    H = cfg.num_heads
    P = inner // H
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    state = (rng.standard_normal((2, H, P, P)).astype(np.float32),
             rng.standard_normal((2, H, P)).astype(np.float32),
             rng.standard_normal((2, H)).astype(np.float32),
             rng.standard_normal((2, cfg.xlstm.conv_width - 1,
                                  inner)).astype(np.float32))
    want_out, want = jx.mlstm_decode_layer(
        jnp.asarray(h), jlp, jm.cfg, tuple(map(jnp.asarray, state)))
    got_out, got = tx.mlstm_decode_layer(
        torch.from_numpy(h), tlp, cfg, tuple(map(torch.from_numpy, state)))
    close(got_out.numpy(), want_out, what="out")
    for g, w, name in zip(got, want, ("C", "n", "m", "conv")):
        close(g.numpy(), w, what=name)


def test_slstm_forward_and_decode_match_reference(models):
    """The forward's loop over time against the reference's scan, and
    one decode step from a drawn state (the max-plus stabiliser m
    finite and the NEG start in the forward)."""
    jm, _, tm, _ = models
    jlp, tlp = block(models, "slstm")
    cfg = tm.cfg
    h = hidden((2, 23, cfg.d_model), 7)
    close(tx.slstm_forward_layer(torch.from_numpy(h), tlp, cfg).numpy(),
          jx.slstm_forward_layer(jnp.asarray(h), jlp, jm.cfg))
    P = cfg.d_model // cfg.num_heads
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    state = tuple(rng.standard_normal((2, cfg.num_heads, P)).astype(
        np.float32) for _ in range(4))
    want_out, want = jx.slstm_decode_layer(jnp.asarray(x), jlp, jm.cfg,
                                           tuple(map(jnp.asarray, state)))
    got_out, got = tx.slstm_decode_layer(torch.from_numpy(x), tlp, cfg,
                                         tuple(map(torch.from_numpy, state)))
    close(got_out.numpy(), want_out, what="out")
    for g, w, name in zip(got, want, ("c", "n", "m", "h")):
        close(g.numpy(), w, what=name)


def test_prefill_and_decode_match_reference(models, prompts):
    """A 20-token prefill (20 replayed decode steps on each side), then 6
    decode steps."""
    state = model_steps(models, prompts, 6)
    assert set(state) == {"m_C", "m_n", "m_m", "m_conv", "s_c", "s_n",
                          "s_m", "s_h"}
    assert all(t.dtype == torch.float32 for t in state.values())


def test_forward_agrees_with_replayed_prefill(models, prompts):
    """The reference's own oracle for the family: the chunked forward's
    last logits are the replayed prefill's."""
    _, _, tm, tp = models
    toks = torch.from_numpy(prompts)
    logits, _ = tm.prefill(tp, toks, tm.cache_geometry(2, 512))
    close(tm.forward(tp, toks)[:, -1].numpy(), logits.numpy(), 1e-4)


def test_state_crosses_the_bridge(models, prompts):
    """cache_from_numpy / cache_to_numpy carry the flat recurrent state,
    f32 whatever the pools' dtype."""
    jm, jp, _, _ = models
    _, js = jm.prefill(jp, jnp.asarray(prompts[:, :4]),
                       jm.cache_geometry(2, 512))
    want = state_numpy(js)
    state = bridge.cache_from_numpy(want, device="cpu",
                                    pool_dtype=torch.bfloat16)
    assert set(state) == set(want)
    assert all(t.dtype == torch.float32 for t in state.values())
    got = bridge.cache_to_numpy(state)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_start_runs_and_stepping_the_engine_is_refused(models, prompts):
    """`start` prefills and returns the reference's logits; `step`,
    `run` and `generate` raise ValueError naming the family and
    `Model.decode_step` (the reference's fail with KeyError: 'kv')."""
    jeng, teng = engines(models, max_context=512)
    want = jeng.start(jnp.asarray(prompts[:, :8]))
    got = teng.start(torch.from_numpy(prompts[:, :8]))
    close(got.numpy(), want, 2e-5)
    tok = got.argmax(-1).to(torch.int32)
    for call in (lambda: teng.step(tok), lambda: teng.run(tok[None]),
                 lambda: teng.generate(tok, 2)):
        with pytest.raises(ValueError, match="'xlstm'.*Model.decode_step"):
            call()
    with pytest.raises(KeyError):
        jeng.generate(jnp.asarray(tok.numpy()), 2)


def test_quest_mask_is_refused(models, prompts):
    """A logical page mask needs a paged cache; the family has none (the
    reference's ValueError)."""
    jm, jp, tm, tp = models
    js = jm.init_decode_state(2)
    ts = tm.init_decode_state(2, device="cpu")
    mask = np.ones((1, 2, 4), bool)
    with pytest.raises(ValueError) as want:
        jm.decode_step(jp, js, jnp.asarray(prompts[:, 0]),
                       logical_page_mask=jnp.asarray(mask))
    with pytest.raises(ValueError) as got:
        tm.decode_step(tp, ts, torch.from_numpy(prompts[:, 0]),
                       logical_page_mask=torch.from_numpy(mask))
    assert str(got.value) == str(want.value)


def test_serve_and_chunked_prefill_refuse_the_family(models, prompts):
    assert_refuses_serve(models, prompts)
