"""The encdec family (whisper-tiny) in the port, against the reference
on the CPU: the smoke config in float32, same weights (bridge), the
frame embeddings (the stubbed conv frontend's output) drawn with numpy.

Whisper runs what no dense config does: LayerNorm with bias, a GELU
MLP (the tanh approximation, `jax.nn.gelu`'s default), learned
positions, non-causal encoder attention over the frames, G = 1, and a
decode state {"kv": the decoder's paged self-attention cache, "enc":
the encoder output} whose cross-attention is recomputed from "enc"
every step, as the reference does. Prefill and 4 decode steps: logits
within 2e-5, greedy tokens and integer state exact; `start(prompts,
extra=...)` + `generate(8)` under `static` and `importance`: tokens
and StepStats bytes equal, `score_headroom` within 1e-12 (the cache's
pages only). `serve()` and chunked prefill refuse the family, as the
reference's.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

from _torch_serve_ref import (  # noqa: E402
    assert_refuses_serve, assert_stream_matches, model_steps, smoke_pair,
    state_numpy,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

NAME = "whisper-tiny"


@pytest.fixture(scope="module")
def models():
    return smoke_pair(NAME)


@pytest.fixture(scope="module")
def inputs(models):
    cfg = models[2].cfg
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab, (2, 300)).astype(np.int32)
    frames = rng.standard_normal(
        (2, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32)
    return prompts, {"frame_embeds": frames}


def test_layer_norm_and_gelu_match_reference():
    """GELU is `jax.nn.gelu`'s default, the tanh approximation, which
    differs from the exact erf form by up to ~5e-4 near |x| = 2."""
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((3, 7, 64))).astype(np.float32)
    w, b = rng.standard_normal((2, 64)).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(
        tl.layer_norm(T(x), T(w), T(b)).numpy(),
        np.asarray(jl.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))), atol=2e-6)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(tl.gelu(T(x)).numpy(), want, atol=2e-6)
    exact = torch.nn.functional.gelu(T(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4       # not the erf form
    wi = rng.standard_normal((64, 96)).astype(np.float32)
    wo = rng.standard_normal((96, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tl.gelu_mlp(T(x), T(wi), T(wo)).numpy(),
        np.asarray(jl.gelu_mlp(*map(jnp.asarray, (x, wi, wo)))), rtol=1e-5,
        atol=1e-4)


def test_prefill_and_decode_match_reference(models, inputs):
    prompts, extra = inputs
    state = model_steps(models, prompts, 4, extra=extra)
    assert set(state) == {"kv", "enc"}
    assert tuple(state["enc"].shape) == extra["frame_embeds"].shape
    assert state["kv"].length.tolist() == [300 + 4] * 2
    assert int(state["kv"].host_owner.ge(0).sum()) > 0


def test_state_crosses_the_bridge(models, inputs):
    """cache_from_numpy / cache_to_numpy carry the {"kv", "enc"} state."""
    jm, jp, _, _ = models
    prompts, extra = inputs
    _, js = jm.prefill(jp, jnp.asarray(prompts), jm.cache_geometry(2, 512),
                       extra={k: jnp.asarray(v) for k, v in extra.items()})
    want = state_numpy(js)
    state = bridge.cache_from_numpy(want, device="cpu")
    assert set(state) == {"kv", "enc"}
    got = bridge.cache_to_numpy(state)
    np.testing.assert_array_equal(got["enc"], want["enc"])
    for name, arr in want["kv"].items():
        np.testing.assert_array_equal(got["kv"][name], arr, err_msg=name)


@pytest.mark.parametrize("policy", ["static", "importance"])
def test_start_generate_match_reference(models, inputs, policy):
    prompts, extra = inputs
    assert_stream_matches(models, prompts, extra, policy)


def test_serve_and_chunked_prefill_refuse_the_family(models, inputs):
    assert_refuses_serve(models, inputs[0])
