"""The vlm family (internvl2-2b) in the port, against the reference on
the CPU: the smoke config in float32, same weights (bridge), the patch
embeddings (the stubbed vision frontend's output) drawn with numpy.

The prompt is the patch embeddings followed by the token embeddings,
so the cache holds 16 + 300 positions and spills into the host tier.
Prefill and 4 decode steps: logits within 2e-5, greedy tokens and
integer state exact. `ServingEngine.start(prompts, extra=...)` +
`generate(8)` under `static` and `importance`: tokens and StepStats
bytes equal to the reference engine's, and `score_headroom` over the
captured trace (only the cache's pages are scored) within 1e-12.
`serve()` and chunked prefill refuse the family, as the reference's.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_ref import (  # noqa: E402
    assert_refuses_serve, assert_stream_matches, model_steps, smoke_pair,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

NAME = "internvl2-2b"


@pytest.fixture(scope="module")
def models():
    return smoke_pair(NAME)


@pytest.fixture(scope="module")
def inputs(models):
    cfg = models[2].cfg
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab, (2, 300)).astype(np.int32)
    patches = rng.standard_normal(
        (2, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32)
    return prompts, {"patch_embeds": patches}


def test_prefill_and_decode_match_reference(models, inputs):
    prompts, extra = inputs
    state = model_steps(models, prompts, 4, extra=extra)
    n = models[2].cfg.frontend.num_embeddings
    assert state.length.tolist() == [n + 300 + 4] * 2     # patches count
    assert int(state.host_owner.ge(0).sum()) > 0


@pytest.mark.parametrize("policy", ["static", "importance"])
def test_start_generate_match_reference(models, inputs, policy):
    prompts, extra = inputs
    assert_stream_matches(models, prompts, extra, policy)


def test_serve_and_chunked_prefill_refuse_the_family(models, inputs):
    assert_refuses_serve(models, inputs[0])
