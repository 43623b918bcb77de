"""Every family and every config of the reference in the port, on the
CPU: `Model.forward` (logits at every position) of each family's smoke
config in float32, same weights (bridge), against the reference's
within 2e-5; and each of the reference's eleven configs, published and
smoke, built by the port with the reference's numbers, parameter
shapes and cache layers.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import FAMILIES  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

from _torch_serve_ref import smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401


#: a smoke config of each family with a config (ssm has none: the
#: hybrid tests build it from zamba2's)
FORWARD_FAMILIES = ("internlm2-1.8b", "granite-moe-3b-a800m", "internvl2-2b",
                    "whisper-tiny", "zamba2-1.2b", "xlstm-125m")


def test_every_family_has_a_forward_case():
    fams = {tconfigs.get_smoke(n).family for n in FORWARD_FAMILIES}
    assert fams == set(FAMILIES) - {"ssm"}


@pytest.mark.parametrize("name", FORWARD_FAMILIES)
def test_forward_matches_reference(name):
    """Logits at every position, for every family."""
    jm, jp, tm, tp = smoke_pair(name)
    cfg = tm.cfg
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab, (2, 19)).astype(np.int32)
    key = {"vlm": "patch_embeds", "encdec": "frame_embeds"}.get(cfg.family)
    extra = None if key is None else {key: rng.standard_normal(
        (2, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32)}
    want = np.asarray(jm.forward(jp, jnp.asarray(toks), extra=None
                                 if extra is None else {
                                     key: jnp.asarray(extra[key])}))
    got = tm.forward(tp, torch.from_numpy(toks), extra=None
                     if extra is None else {key: torch.from_numpy(
                         extra[key])}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def leaf_shapes(schema):
    return {k: leaf_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in schema.items()}


@pytest.mark.parametrize("name", jconfigs.all_arch_names() + ["llama31-8b"])
def test_every_config_is_ported(name):
    """All eleven of the reference's configs (its ten architecture ids
    and the paper's own llama31-8b, reachable through an alias) build
    in the port, with the reference's numbers, and the port's model
    accepts each with the reference's parameter shapes and cache
    layers."""
    for get in ("get", "get_smoke"):
        want = getattr(jconfigs, get)(name)
        got = getattr(tconfigs, get)(name)
        for f in dataclasses.fields(got):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(got, f.name) == getattr(want, f.name) \
                    or str(getattr(got, f.name)) == str(
                        getattr(want, f.name)), (get, f.name)
        assert got.attention_layer_ids() == want.attention_layer_ids()
        assert leaf_shapes(TModel(got).schema()) == \
            leaf_shapes(JModel(want).schema())
        geo = dataclasses.asdict(TModel(got).cache_geometry(2, 512))
        ref = dataclasses.asdict(JModel(want).cache_geometry(2, 512))
        assert {k: v for k, v in geo.items() if k != "dtype"} == \
            {k: v for k, v in ref.items() if k != "dtype"}
    assert set(tconfigs.all_arch_names()) == set(jconfigs.all_arch_names())
