"""The hybrid family (zamba2-1.2b) in the port, against the reference on
the CPU: the smoke config in float32, the same weights (bridge), inputs
drawn with numpy from a seed.

zamba2 is a stack of Mamba2 blocks with one weight-shared attention +
MLP block after every `attn_every`-th of them; only those sites own KV
pages, so its cache has fewer layers than the model (2 of 4 in the
smoke config, 2 of 38 at full width). Its decode state is
{"ssm": {"s", "conv"}, "kv": the sites' paged cache}.

Tolerances: one Mamba2 layer (chunked forward with and without chunk
padding, its end state, the recurrent decode step) within 1e-5 of the
reference's; the chunked form within the reference tests' 1e-4 of its
own sequential oracle; prefill + 4 decode steps over both tiers:
logits within 2e-5, greedy tokens and integer cache state exact, the
sites' pools within 3e-5 and the Mamba2 state within 3e-5 plus 1e-5 of
its magnitude. Those last two are wider than one layer's 1e-5: the
last site's K/V and the deep layers' state come after four Mamba2
blocks and an attention site whose f32 sums the two sides take in
other orders, and the gap grows with depth (the first layer's state
agrees within ~1.2e-6, the third's within ~1.3e-5 on values up to
~7; the pools within ~1.8e-5); `start` + `generate(8)` under `static`,
`importance` and Quest sparsity 0.5: tokens and StepStats bytes
equal, `score_headroom` within 1e-12. Also what the port
refuses, as the reference does or where the reference fails: `serve()`
and chunked prefill, a prompt shorter than conv_width - 1, and the ssm
family's prefill.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

from _torch_serve_ref import (  # noqa: E402
    assert_refuses_serve, assert_stream_matches, model_steps, smoke_pair,
    state_numpy,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

NAME = "zamba2-1.2b"
#: the tolerances of the pools and the recurrent state after the whole
#: stack (see the module docstring)
DEEP = dict(pool_atol=3e-5, state_rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    return smoke_pair(NAME)


@pytest.fixture(scope="module")
def prompts(models):
    rng = np.random.default_rng(11)
    return rng.integers(0, models[2].cfg.vocab, (2, 300)).astype(np.int32)


def layer_pair(models, l=1):
    """Mamba2 layer l's weights on both sides."""
    jm, jp, tm, tp = models
    return (jax.tree.map(lambda a: a[l], jp["mamba"]),
            tfm.layers_of(tp["mamba"])[l])


def hidden(S, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, S, d)).astype(np.float32)


@pytest.mark.parametrize("S", [37, 40], ids=["padded", "whole-chunks"])
def test_mamba2_forward_layer_matches_reference(models, S):
    """Chunk 8: S=37 pads the last chunk, S=40 fills five."""
    jm, _, tm, _ = models
    jlp, tlp = layer_pair(models)
    h = hidden(S, tm.cfg.d_model, S)
    want, (ws, wc) = jssm.mamba2_forward_layer(jnp.asarray(h), jlp, jm.cfg,
                                               return_state=True)
    got, (gs, gc) = tssm.mamba2_forward_layer(torch.from_numpy(h), tlp,
                                              tm.cfg, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5)
    assert gs.dtype == gc.dtype == torch.float32


@pytest.mark.parametrize("S", [37, 40], ids=["padded", "whole-chunks"])
def test_mamba2_chunked_matches_sequential_oracle(models, S):
    """The chunked SSD against the port's sequential recurrence (1e-4,
    as the reference's own test), and that oracle against the
    reference's (1e-5)."""
    jm, _, tm, _ = models
    jlp, tlp = layer_pair(models, 2)
    h = torch.from_numpy(hidden(S, tm.cfg.d_model, 100 + S))
    seq = tssm.mamba2_forward_layer_ref(h, tlp, tm.cfg)
    np.testing.assert_allclose(
        tssm.mamba2_forward_layer(h, tlp, tm.cfg).numpy(), seq.numpy(),
        atol=1e-4)
    want = jssm.mamba2_forward_layer_ref(jnp.asarray(h.numpy()), jlp,
                                         jm.cfg)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), atol=1e-5)


def test_mamba2_decode_layer_matches_reference(models):
    jm, _, tm, _ = models
    jlp, tlp = layer_pair(models)
    cfg = tm.cfg
    inner = cfg.ssm.expand * cfg.d_model
    H, N = cfg.num_heads, cfg.ssm.state_dim
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    s = rng.standard_normal((2, H, N, inner // H)).astype(np.float32)
    conv = rng.standard_normal(
        (2, cfg.ssm.conv_width - 1, inner + 2 * N)).astype(np.float32)
    want = jssm.mamba2_decode_layer(*map(jnp.asarray, (h,)), jlp, jm.cfg,
                                    jnp.asarray(s), jnp.asarray(conv))
    got = tssm.mamba2_decode_layer(torch.from_numpy(h), tlp, cfg,
                                   torch.from_numpy(s),
                                   torch.from_numpy(conv))
    for g, w, name in zip(got, want, ("out", "s", "conv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


def test_prefill_and_decode_match_reference(models, prompts):
    """300-token prompts in a 512-token context: the sites' pages spill
    into the host tier, and both tiers are read every step."""
    state = model_steps(models, prompts, 4, **DEEP)
    assert set(state) == {"ssm", "kv"}
    cfg = models[2].cfg
    assert tuple(state["ssm"]["s"].shape)[:2] == (cfg.num_layers, 2)
    assert state["kv"].k_hbm.shape[0] == len(cfg.attention_layer_ids()) \
        == 2 < cfg.num_layers
    assert state["kv"].length.tolist() == [300 + 4] * 2
    assert int(state["kv"].host_owner.ge(0).sum()) > 0


def test_shortest_prompt_matches_reference(models, prompts):
    """conv_width - 1 = 3 tokens, the shortest prompt that fills the
    conv state."""
    model_steps(models, prompts[:, :3], 2, **DEEP)


def test_prompt_shorter_than_the_conv_state_is_refused(models, prompts):
    """The reference's slice of a 2-token prompt wraps around and gives a
    conv state of the wrong size, on which its next decode step fails;
    the port refuses the prompt at prefill."""
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="conv_width - 1 = 3"):
        tm.prefill(tp, torch.from_numpy(prompts[:, :2]),
                   tm.cache_geometry(2, 512))
    logits = tm.forward(tp, torch.from_numpy(prompts[:, :2]))
    assert tuple(logits.shape) == (2, 2, tm.cfg.vocab)


def test_state_crosses_the_bridge(models, prompts):
    """cache_from_numpy / cache_to_numpy carry {"ssm": {"s", "conv"},
    "kv"}; the recurrent state stays f32."""
    jm, jp, _, _ = models
    _, js = jm.prefill(jp, jnp.asarray(prompts), jm.cache_geometry(2, 512))
    want = state_numpy(js)
    state = bridge.cache_from_numpy(want, device="cpu",
                                    pool_dtype=torch.bfloat16)
    assert set(state) == {"ssm", "kv"}
    assert state["ssm"]["s"].dtype == torch.float32
    assert state["kv"].k_hbm.dtype == torch.bfloat16
    got = bridge.cache_to_numpy(state)
    for k in ("s", "conv"):
        np.testing.assert_array_equal(got["ssm"][k], want["ssm"][k])
    np.testing.assert_array_equal(got["kv"]["page_table"],
                                  want["kv"]["page_table"])


@pytest.mark.parametrize("policy, sparsity", [("static", 0.0),
                                              ("importance", 0.0),
                                              ("importance", 0.5)],
                         ids=["static", "importance", "importance-quest"])
def test_start_generate_match_reference(models, prompts, policy, sparsity):
    assert_stream_matches(models, prompts, None, policy,
                          attention_sparsity=sparsity)


def test_serve_and_chunked_prefill_refuse_the_family(models, prompts):
    assert_refuses_serve(models, prompts)


def test_ssm_family_forward_and_decode_match_reference(models, prompts):
    """The ssm family is the hybrid stack with no attention site
    (attn_every = 0): no shared block, a decode state of the Mamba2
    state alone, a refused Quest mask, and no prefill, as in the
    reference."""
    jm, jp, tm, tp = models

    def ssm(cfg):
        return dataclasses.replace(cfg, family="ssm", ssm=dataclasses.replace(
            cfg.ssm, attn_every=0))
    jm, tm = JModel(ssm(jm.cfg)), TModel(ssm(tm.cfg))
    jp = {k: v for k, v in jp.items() if k != "shared_attn"}
    tp = {k: v for k, v in tp.items() if k != "shared_attn"}
    assert tm.cfg.attention_layer_ids() == ()
    assert set(tm.schema()) == set(jm.schema()) == set(tp)
    toks = prompts[:, :20]
    np.testing.assert_allclose(
        tm.forward(tp, torch.from_numpy(toks)).numpy(),
        np.asarray(jm.forward(jp, jnp.asarray(toks))), atol=2e-5)
    js = jm.init_decode_state(2)
    ts = tm.init_decode_state(2, device="cpu")
    for t in range(3):
        jl, js = jm.decode_step(jp, js, jnp.asarray(toks[:, t]))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    assert set(ts) == {"ssm"}
    np.testing.assert_allclose(ts["ssm"]["s"].numpy(),
                               np.asarray(js["ssm"]["s"]), atol=1e-5)
    with pytest.raises(ValueError, match="needs a paged KV cache"):
        tm.decode_step(tp, ts, torch.from_numpy(toks[:, 0]),
                       logical_page_mask=torch.ones(1, 2, 4, dtype=bool))
    geo = tm.cache_geometry(2, 512)
    assert geo.num_layers == jm.cache_geometry(2, 512).num_layers == 1
    with pytest.raises(ValueError) as want:
        jm.prefill(jp, jnp.asarray(toks), jm.cache_geometry(2, 512))
    with pytest.raises(ValueError) as got:
        tm.prefill(tp, torch.from_numpy(toks), geo)
    assert str(got.value) == str(want.value)
