"""The moe family of the port (`models/moe.py`, `Model` of family
"moe") against the reference, on the CPU, in float32 with the same
weights (carried by the bridge).

  * `moe_ffn` within 1e-5 (absolute) of the reference's on
    granite-smoke (top-2 of 4), llama4-smoke (top-1, interleave 2,
    shared expert), a padded-expert config (6 experts padded to 8), a
    token stream that pads its last group, and a capacity so small that
    most choices drop; the dispatch masks equal the reference's exactly
    and the combine weights within 1e-6 (captured from the reference's
    two dispatch products).
  * `decode_step` with 8 lanes, some inactive (their rows route and
    consume capacity as in the reference; their pools end the step as
    they began) and `prefill_chunk` with idle lanes and padding slots:
    active lanes' logits within 1e-4 and the cache equal (pools within
    1e-5, tables exact), on a drop-heavy config where routing the wrong
    rows would change them.
  * `start` + greedy `generate`: logits within 1e-4, tokens and
    StepStats equal.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kvcache.paged import init_cache as jinit  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import control as jctl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.tiers import H100  # noqa: E402
from repro_torch.kvcache.paged import init_cache as tinit  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import control as tctl  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

from _torch_serve_ref import JAX_H100, smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

FFN_ATOL = 1e-5
LOGIT_ATOL = 1e-4
GRANITE = "granite-moe-3b-a800m"
LLAMA4 = "llama4-maverick-400b-a17b"


def moe_override(name, **kw):
    return {"moe": dataclasses.replace(tconfigs.get_smoke(name).moe, **kw)}


#: id -> (arch, MoEConfig overrides, tokens [B, S])
FFN_CASES = {
    "granite": (GRANITE, {}, (2, 24)),
    "llama4": (LLAMA4, {}, (2, 24)),
    "padded_experts": (GRANITE, dict(num_experts=6, pad_experts_to=8),
                       (2, 24)),
    "group_pads": (GRANITE, dict(group_size=20), (2, 24)),
    "drops": (LLAMA4, dict(capacity_factor=0.25), (3, 16)),
}


class Capture:
    """Stands in for `jax.numpy` inside the reference's moe module and
    keeps the first operand of each einsum by its spec."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kw):
        self.seen.setdefault(spec, operands[0])
        return jnp.einsum(spec, *operands, **kw)


def first_moe_layer(params, cfg):
    layers = params["layers"]
    if cfg.moe.interleave == 2:
        layers = layers["moe"]
    return {k: v[0] for k, v in layers.items()}


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_reference(case, monkeypatch):
    name, moe_kw, (B, S) = FFN_CASES[case]
    jm, jp, tm, tp = smoke_pair(
        name, **(moe_override(name, **moe_kw) if moe_kw else {}))
    cfg_t, cfg_j = tm.cfg, jm.cfg
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg_t.d_model)).astype(np.float32)
    cap = Capture()
    monkeypatch.setattr(jmoe, "jnp", cap)
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), first_moe_layer(jp, cfg_j),
                                   cfg_j))
    monkeypatch.undo()
    lp = first_moe_layer(tp, cfg_t)
    got = tmoe.moe_ffn(torch.from_numpy(x), lp, cfg_t)
    np.testing.assert_allclose(got.numpy(), want, atol=FFN_ATOL)
    # the routing itself, on the reference's grouping
    T = B * S
    group = min(T, cfg_t.moe.group_size)
    pad = (-T) % group
    xt = torch.nn.functional.pad(torch.from_numpy(x).reshape(T, -1),
                                 (0, 0, 0, pad))
    dispatch, combine = tmoe.route(xt.reshape(-1, group, cfg_t.d_model),
                                   lp["router"], cfg_t)
    np.testing.assert_array_equal(dispatch.float().numpy(),
                                  np.asarray(cap.seen["gsec,gsd->gecd"]))
    np.testing.assert_allclose(combine.numpy(),
                               np.asarray(cap.seen["gsec,gecd->gsd"]),
                               atol=1e-6)
    E_pad, C = cfg_t.moe.num_experts_padded, tmoe.capacity(cfg_t, group)
    assert dispatch.shape == (T // group + (pad > 0), group, E_pad, C)
    # padded experts are never routed to
    assert not dispatch[:, :, cfg_t.moe.num_experts:].any()
    if case == "drops":
        routed = dispatch.sum(dim=(2, 3))[:, :T]
        assert (routed.flatten()[:T] == 0).any()     # some rows dropped


def test_ties_break_toward_the_lower_expert():
    """Equal router probabilities pick the lower expert index first, as
    `jax.lax.top_k` does."""
    cfg = tconfigs.get_smoke(GRANITE)
    cfg = dataclasses.replace(cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    xg = torch.ones((1, 3, cfg.d_model))
    router = torch.zeros((cfg.d_model, cfg.moe.num_experts))
    dispatch, combine = tmoe.route(xg, router, cfg)
    chosen = dispatch.any(dim=-1)[0]                 # [s, E]
    assert chosen[:, :cfg.moe.top_k].all()
    assert not chosen[:, cfg.moe.top_k:].any()


# --------------------------------------------------------------------------- #
# the model's decode step and prefill chunk
# --------------------------------------------------------------------------- #

#: drop-heavy variants: decode groups 8 lanes into capacity 4
MODEL_CASES = {
    "granite": (GRANITE, dict(capacity_factor=0.5)),
    "llama4": (LLAMA4, dict(capacity_factor=0.5)),
}


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def moe_models(request):
    name, kw = MODEL_CASES[request.param]
    return smoke_pair(name, **moe_override(name, **kw))


INT_FIELDS = ("page_table", "hbm_owner", "host_owner", "length")


def fields(cache):
    return {f.name: np.asarray(getattr(cache, f.name))
            for f in dataclasses.fields(cache)}


def assert_cache(got, want):
    """Tables exact, pools within 1e-5."""
    got = bridge.cache_to_numpy(got)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("k_hbm", "v_hbm", "k_host", "v_host"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   err_msg=name)


def prefill_both(models, B=8, S=40, ctx=256):
    jm, jp, tm, tp = models
    prompts = np.random.default_rng(7).integers(0, 256, (B, S))
    jl, jc = jm.prefill(jp, jnp.asarray(prompts, jnp.int32),
                        jm.cache_geometry(B, ctx))
    tl, tc = tm.prefill(tp, torch.from_numpy(prompts),
                        tm.cache_geometry(B, ctx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    return jl, jc, tl, tc


def test_decode_step_with_inactive_lanes(moe_models):
    """Lanes 1, 4, 5 inactive: the reference's step (decode, then
    `lane_merge`) against the port's `active=` step, three steps."""
    jm, jp, tm, tp = moe_models
    jl, jc, tl, tc = prefill_both(moe_models)
    active = np.array([1, 0, 1, 1, 0, 0, 1, 1], bool)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        before = bridge.cache_to_numpy(tc)
        jl2, jc2 = jm.decode_step(jp, jc, jnp.asarray(tok))
        jc = jctl.lane_merge(jc, jc2, jnp.asarray(active))
        tl2, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                  active=torch.from_numpy(active))
        np.testing.assert_allclose(tl2.numpy()[active],
                                   np.asarray(jl2)[active], atol=LOGIT_ATOL)
        # pools: active lanes as the reference's, inactive as before
        after = bridge.cache_to_numpy(tc2)
        for name in ("k_hbm", "v_hbm", "k_host", "v_host"):
            np.testing.assert_allclose(after[name][:, active],
                                       np.asarray(getattr(jc, name))[:,
                                                                     active],
                                       atol=1e-5, err_msg=name)
            np.testing.assert_array_equal(after[name][:, ~active],
                                          before[name][:, ~active])
        # the engine merges the inactive lanes' tables back
        tc = tctl.lane_merge(bridge.cache_from_numpy(before, device="cpu"), tc2,
                             torch.from_numpy(active))
        assert_cache(tc, fields(jc))
        tok = np.where(active, np.asarray(jnp.argmax(jl2, -1)), tok) \
            .astype(np.int32)


def test_prefill_chunk_with_idle_lanes(moe_models):
    """Chunks of 32 at lane offsets with lanes idle (n_valid 0) and
    padding slots; the chunks cross into the host tier (ctx 512: 16
    HBM pages of 16 tokens per lane)."""
    jm, jp, tm, tp = moe_models
    B, C, P = 8, 32, 300
    prompts = np.random.default_rng(9).integers(0, 256, (B, P))
    jc = jinit(jm.cache_geometry(B, 512))
    tc = tinit(tm.cache_geometry(B, 512), device="cpu")
    prog = np.zeros(B, np.int32)
    plen = np.array([300, 40, 280, 0, 120, 300, 13, 200], np.int32)
    for step in range(11):
        n_val = np.minimum(plen - prog, C).clip(0).astype(np.int32)
        if step % 5 == 2:
            n_val[::3] = 0
        idx = np.clip(prog[:, None] + np.arange(C), 0, P - 1)
        toks = np.take_along_axis(prompts, idx, axis=1).astype(np.int32)
        if not n_val.any():
            continue
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks),
                                  jnp.asarray(prog), jnp.asarray(n_val))
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(prog),
                                  torch.from_numpy(n_val))
        for b in range(B):
            np.testing.assert_allclose(tl[b, :n_val[b]].numpy(),
                                       np.asarray(jl)[b, :n_val[b]],
                                       atol=LOGIT_ATOL)
        assert_cache(tc, fields(jc))
        prog = prog + n_val
    assert int(tc.host_owner.ge(0).sum()) > 0


def test_start_generate_matches_reference(moe_models):
    from repro.serving.engine import EngineConfig as JConfig
    from repro.serving.engine import ServingEngine as JEngine
    jm, jp, tm, tp = moe_models
    prompt = np.random.default_rng(4).integers(0, 256, (8, 300))
    cfg = dict(max_context=512, policy="importance", telemetry_stride=4,
               attention_sparsity=0.5, promote_thresh=1e-4)
    jeng = JEngine(jm, jp, JConfig(spec=JAX_H100, **cfg))
    jlog = jeng.start(jnp.asarray(prompt, jnp.int32))
    jtok = jeng.generate(jnp.argmax(jlog, -1).astype(jnp.int32), 6)
    teng = ServingEngine(tm, tp, EngineConfig(spec=H100, **cfg),
                         device="cpu")
    tlog = teng.start(torch.from_numpy(prompt))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL)
    ttok = teng.generate(tlog.argmax(-1).to(torch.int32), 6)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert [dataclasses.astuple(s)[1:5] for s in teng.stats] == \
        [dataclasses.astuple(s)[1:5] for s in jeng.stats]
    assert sum(s.e_read for s in teng.stats) > 0
    assert sum(s.m_in for s in teng.stats) > 0


def test_schema_and_params_cross_the_bridge():
    """Both interleaves: the port's schema has the reference's tree and
    shapes, and its own init fills it from one generator."""
    for name in (GRANITE, LLAMA4):
        jm, jp, tm, tp = smoke_pair(name)
        jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
        tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
        assert jshapes == tshapes
        own = tm.init(0, device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), own) == tshapes
        again = tm.init(0, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(own), jax.tree.leaves(again)))
        cfg = tconfigs.get(name)
        assert cfg.family == "moe" and cfg.moe is not None
