"""The port's dense model against the reference: whole-prompt prefill,
paged decode steps and chunked prefill on the internlm2-1.8b smoke
config in float32, with the same weights (carried by the bridge).

`max_context=512` gives 16 HBM pages per lane, so the 300-token prompt
spills into the host tier. Logits agree within 1e-4 (different matmul
summation order); integer cache state matches exactly.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

LOGIT_ATOL = 1e-4
INT_FIELDS = ("page_table", "hbm_owner", "host_owner", "length")
PROMPT = 300


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jconfigs.get_smoke("internlm2-1.8b"),
                               dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("internlm2-1.8b"),
                               dtype=torch.float32, param_dtype=torch.float32)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = bridge.params_from_jax(jax.device_get(jp), tcfg,
                                device="cpu")
    return jm, jp, TModel(tcfg), tp


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (2, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(models, prompts):
    """Reference prefill then three decode steps, computed once."""
    jm, jp, _, _ = models
    geo = jm.cache_geometry(2, 512)
    logits, cache = jm.prefill(jp, jnp.asarray(prompts), geo)
    steps = [(np.asarray(logits), bridge_fields(cache))]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(3):
        logits, cache = jm.decode_step(jp, cache, tok, use_pallas=False)
        steps.append((np.asarray(logits), bridge_fields(cache)))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return steps


def bridge_fields(cache):
    return {f.name: np.asarray(getattr(cache, f.name))
            for f in dataclasses.fields(cache)}


def _assert_cache(got, want, pool_atol=1e-5):
    got = bridge.cache_to_numpy(got)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("k_hbm", "v_hbm", "k_host", "v_host"):
        np.testing.assert_allclose(got[name], want[name], atol=pool_atol,
                                   err_msg=name)
    np.testing.assert_allclose(got["importance"], want["importance"],
                               atol=1e-5)


def test_prefill_and_decode_match_reference(models, prompts, reference):
    _, _, tm, tp = models
    geo = tm.cache_geometry(2, 512)
    assert geo.hbm_pages * geo.page_tokens < PROMPT   # spills to the host
    logits, cache = tm.prefill(tp, torch.from_numpy(prompts), geo)
    np.testing.assert_allclose(logits.numpy(), reference[0][0],
                               atol=LOGIT_ATOL)
    _assert_cache(cache, reference[0][1])
    # teacher-force the reference's greedy tokens
    tok = torch.from_numpy(reference[0][0].argmax(-1).astype(np.int32))
    for want_logits, want_cache in reference[1:]:
        logits, cache = tm.decode_step(tp, cache, tok)
        np.testing.assert_allclose(logits.numpy(), want_logits,
                                   atol=LOGIT_ATOL)
        _assert_cache(cache, want_cache)
        tok = torch.from_numpy(want_logits.argmax(-1).astype(np.int32))
    assert int(cache.host_owner.ge(0).sum()) > 0


def test_prefill_chunk_matches_reference(models, prompts):
    """Chunks of 64 tokens at lane offsets, lane 1 lagging behind and
    idle for one chunk; the chunks cross into the host tier."""
    jm, jp, tm, tp = models
    jgeo, tgeo = jm.cache_geometry(2, 512), tm.cache_geometry(2, 512)
    from repro.kvcache.paged import init_cache as jinit
    from repro_torch.kvcache.paged import init_cache as tinit
    jc, tc = jinit(jgeo), tinit(tgeo, device="cpu")
    C = 64
    prog = np.zeros(2, np.int32)
    for step in range(6):
        n_val = np.minimum(PROMPT - prog, C).astype(np.int32)
        if step == 2:
            n_val[1] = 0
        idx = np.clip(prog[:, None] + np.arange(C), 0, PROMPT - 1)
        toks = np.take_along_axis(prompts, idx, axis=1).astype(np.int32)
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks),
                                  jnp.asarray(prog), jnp.asarray(n_val))
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(prog),
                                  torch.from_numpy(n_val))
        for b in range(2):
            np.testing.assert_allclose(tl[b, :n_val[b]].numpy(),
                                       np.asarray(jl)[b, :n_val[b]],
                                       atol=LOGIT_ATOL)
        _assert_cache(tc, bridge_fields(jc))
        prog = prog + n_val
    assert int(tc.host_owner.ge(0).sum()) > 0


@pytest.mark.parametrize("slack", [0, 1, 40])
def test_prefill_chunk_bounded_read_matches_reference(models, prompts,
                                                      slack):
    """The serve loop passes a host-side bound on every lane's slice
    end (`end`), and the prefill plane reads only the slots below it —
    exactly at the end, a token past it, and a page and more past it,
    with the slices crossing into the host tier: the reference's logits
    and cache, as with the unbounded read."""
    jm, jp, tm, tp = models
    jgeo, tgeo = jm.cache_geometry(2, 512), tm.cache_geometry(2, 512)
    from repro.kvcache.paged import init_cache as jinit
    from repro_torch.kvcache.paged import init_cache as tinit
    jc, tc = jinit(jgeo), tinit(tgeo, device="cpu")
    C = 48
    prog = np.array([0, 20], np.int32)
    for step in range(7):
        n_val = np.minimum(PROMPT - prog, C).astype(np.int32)
        if step == 3:
            n_val[0] = 0
        idx = np.clip(prog[:, None] + np.arange(C), 0, PROMPT - 1)
        toks = np.take_along_axis(prompts, idx, axis=1).astype(np.int32)
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks),
                                  jnp.asarray(prog), jnp.asarray(n_val))
        end = int((prog + n_val).max()) + slack
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(prog),
                                  torch.from_numpy(n_val), end)
        for b in range(2):
            np.testing.assert_allclose(tl[b, :n_val[b]].numpy(),
                                       np.asarray(jl)[b, :n_val[b]],
                                       atol=LOGIT_ATOL)
        _assert_cache(tc, bridge_fields(jc))
        prog = prog + n_val
    assert int(tc.host_owner.ge(0).sum()) > 0


@pytest.mark.parametrize("budget", [7, 32])
def test_chunked_prefill_equals_whole_prompt(models, prompts, budget):
    """Inside the port: any chunk budget lands the same cache as the
    whole-prompt prefill, and the last chunk's last logits are the
    prefill's (atol 1e-5: chunking changes matmul shapes only)."""
    _, _, tm, tp = models
    geo = tm.cache_geometry(2, 512)
    want_logits, want = tm.prefill(tp, torch.from_numpy(prompts), geo)
    from repro_torch.kvcache.paged import init_cache
    cache = init_cache(geo, device="cpu")
    prog = torch.zeros(2, dtype=torch.int32)
    toks = torch.from_numpy(prompts)
    last = None
    while int(prog.min()) < PROMPT:
        n_val = (PROMPT - prog).clamp(0, budget).to(torch.int32)
        idx = (prog[:, None] + torch.arange(budget)).clamp(0, PROMPT - 1)
        logits, cache = tm.prefill_chunk(tp, cache,
                                         torch.gather(toks, 1, idx),
                                         prog, n_val)
        last = logits[torch.arange(2), (n_val - 1).clamp_min(0)]
        prog = prog + n_val
    np.testing.assert_allclose(last.numpy(), want_logits.numpy(), atol=1e-5)
    got, exp = bridge.cache_to_numpy(cache), bridge.cache_to_numpy(want)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name], exp[name], err_msg=name)
    for name in ("k_hbm", "v_hbm", "k_host", "v_host"):
        np.testing.assert_allclose(got[name], exp[name], atol=1e-5)


def test_layers_match_reference():
    """rms_norm, apply_rope, swiglu, repeat_kv and prefix_chunk_attention
    on the same inputs."""
    from repro.models import layers as jl
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 400], [7, 8, 9, 10, 11]], np.int32)
    T = torch.from_numpy
    np.testing.assert_allclose(
        tlayers.rms_norm(T(x), T(w)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(
        tlayers.apply_rope(T(x), T(pos)).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5)
    wg, wu = [rng.standard_normal((16, 24)).astype(np.float32)
              for _ in range(2)]
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.swiglu(T(x), T(wg), T(wu), T(wd)).numpy(),
        np.asarray(jl.swiglu(*[jnp.asarray(a) for a in (x, wg, wu, wd)])),
        atol=1e-4)
    kv = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tlayers.repeat_kv(T(kv), 2).numpy(),
        np.asarray(jl.repeat_kv(jnp.asarray(kv), 2)))
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = tlayers.repeat_kv(T(kv), 2).numpy()
    v = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    qpos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 11]], np.int32)
    np.testing.assert_allclose(
        tlayers.prefix_chunk_attention(T(q), T(k), T(v), T(qpos)).numpy(),
        np.asarray(jl.prefix_chunk_attention(
            *[jnp.asarray(a) for a in (q, k, v, qpos)])), atol=1e-5)
    # the chunked full-sequence path equals the naive one
    a = tlayers.flash_attention_chunked(T(q), T(k[:, :5]), T(v[:, :5]),
                                        k_chunk=2)
    b = tlayers.naive_attention(T(q), T(k[:, :5]), T(v[:, :5]))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_init_params_is_seeded_and_shaped(models):
    jm, jp, tm, _ = models
    a = tm.init(3, device="cpu")
    b = tm.init(3, device="cpu")
    ref = jax.tree_util.tree_map(lambda x: x.shape, jax.device_get(jp))

    def walk(t, r):
        for key in r:
            if isinstance(r[key], dict):
                walk(t[key], r[key])
            else:
                assert tuple(t[key].shape) == tuple(r[key]), key
    walk(a, ref)
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], tm.init(4, device="cpu")
                           ["layers"]["wq"])
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.1)


def test_entry_points_refuse_a_silent_cpu_fallback(models):
    """Every entry point that makes tensors runs on the card unless told
    otherwise: without a card, leaving the device out raises."""
    _, jp, tm, tp = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.kvcache.migrate import MigrationPlan
    from repro_torch.kvcache.paged import init_cache
    from repro_torch.models.params import init_params
    geo = tm.cache_geometry(2, 64)
    fields = bridge.cache_to_numpy(init_cache(geo, device="cpu"))
    calls = {
        "Model.init": lambda: tm.init(0),
        "init_params": lambda: init_params(tm.schema(), torch.Generator()),
        "init_cache": lambda: init_cache(geo),
        "Model.init_decode_state": lambda: tm.init_decode_state(2, geo),
        "to_torch": lambda: bridge.to_torch(np.zeros(3, np.float32)),
        "params_from_jax": lambda: bridge.params_from_jax(
            jax.device_get(jp), tm.cfg),
        "cache_from_numpy": lambda: bridge.cache_from_numpy(fields),
        "MigrationPlan.empty": lambda: MigrationPlan.empty(4),
        "MigrationPlan.build": lambda: MigrationPlan.build(4, [], []),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
            pytest.fail(f"{name} ran without a card")


@pytest.mark.parametrize("limit", [0, None], ids=["sliced", "whole"])
@pytest.mark.parametrize("shape", [(3, 8, 16), (4, 5, 3, 16), (3, 5, 3)])
def test_init_params_sliced_draw_is_the_whole_draw(shape, limit,
                                                   monkeypatch):
    """A stacked leaf past the size limit (here 0 bytes) is drawn one
    slice of its leading axis at a time (a slice of 16k values; else
    whole): on the CPU the same tensor as one draw of the whole leaf
    from the same generator, as under the limit."""
    from repro_torch.models import params
    from repro_torch.models.params import Param, init_params
    if limit is not None:
        monkeypatch.setattr(params, "SLICED_DRAW_BYTES", limit)
    gen = torch.Generator()
    gen.manual_seed(11)
    got = init_params({"a": Param(shape, fan_in_axes=(1,)),
                       "b": Param((6, 16))}, gen, torch.float32, "cpu")
    gen.manual_seed(11)
    want_a = torch.randn(shape, generator=gen) * (1.0 / shape[1] ** 0.5)
    want_b = torch.randn((6, 16), generator=gen) * (1.0 / 6 ** 0.5)
    assert torch.equal(got["a"], want_a)
    assert torch.equal(got["b"], want_b)       # the draw order is kept
