"""The reference's other dense configs in the port, against the
reference on the CPU: llama31-8b (the paper's own model), granite-8b,
qwen3-32b (qk RMSNorm) and stablelm-12b, by their smoke configs in
float32 with the same weights (carried by the bridge), plus a narrow
model at stablelm's head_dim 160 so the plain versions of both kernels
see D = 160 here. Whole-prompt prefill and 4 decode steps: logits within
2e-5 (matmul summation order), greedy tokens and integer cache state
exact. A 300-token prompt at `max_context=512` spills into the host
tier. Also the registry, which mirrors the reference's.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

from _torch_serve_ref import model_steps, smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

DENSE = ["llama31-8b", "granite-8b", "qwen3-32b", "stablelm-12b"]
PROMPT = 300


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, 256, (2, PROMPT)).astype(
        np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_reference(name, prompts):
    models = smoke_pair(name)
    state = model_steps(models, prompts, 4)
    assert int(state.host_owner.ge(0).sum()) > 0          # spilled
    assert models[2].cfg.qk_norm == (name == "qwen3-32b")


def test_head_dim_160_matches_reference(prompts):
    """stablelm's head_dim 160 at a narrow width (2 layers, d_model 64,
    4 heads over 2): the plain paged and flash versions at D = 160.
    Pools within 1e-4, not 1e-5: the reference's compiled prefill
    computes RoPE's sines and cosines of angles up to 300 rad to within
    ~2e-5 (its eager `apply_rope` and the port agree to 1e-6); the
    logits hold 2e-5."""
    models = smoke_pair("stablelm-12b", head_dim=160)
    assert models[2].cfg.head_dim == 160
    model_steps(models, prompts, 4, pool_atol=1e-4)


@pytest.mark.parametrize("name", DENSE)
def test_published_widths(name):
    """The port's CONFIG is the reference's, field by field."""
    t, j = tconfigs.get(name), jconfigs.get(name)
    for field in ("name", "family", "num_layers", "d_model", "num_heads",
                  "kv_heads", "d_ff", "vocab", "head_dim", "qk_norm",
                  "rope_theta", "norm_eps", "tie_embeddings",
                  "kv_page_tokens", "eos_id"):
        assert getattr(t, field) == getattr(j, field), field
    TModel(t)                       # a family the port takes


def test_registry_mirrors_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs.all_arch_names() == jconfigs.all_arch_names()
    assert "llama31_8b" not in tconfigs.ARCH_IDS
    assert tconfigs.get("llama31-8b").name == "llama31-8b"
    # every architecture is ported, the recurrent ones with their family
    for name in tconfigs.ARCH_IDS + ["llama31-8b"]:
        for get in ("get", "get_smoke"):
            cfg = getattr(tconfigs, get)(name)
            assert cfg.family == getattr(jconfigs, get)(name).family
            TModel(cfg)
