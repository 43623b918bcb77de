"""The fused drive mode: `run`, `generate` and each `serve` chunk as one
chunk function of `telemetry_stride` steps that a CUDA graph can hold.

  * The chunks run on the meta device, where a host sync or a
    data-dependent shape raises: the serve chunk in inline and overlap
    mode under every policy with the fault rows and trace capture on,
    sampled with a prefill budget and EOS, the same of both moe smoke
    configs (granite: top-2 of 4; llama4: interleave 2, a shared
    expert) over a bounded prefill plane, and the run/generate chunks
    of every family with a paged cache (every family `run` drives).
  * `run` and `generate` equal the same steps taken one `step()` at a
    time on the CPU: logits bitwise, integer state exactly (the
    reference's own invariant between its fused and eager modes).
  * The fixed-shape `commit_tables` (every row computes its target, the
    dropped ones write a spare element) against the reference's commit
    on random plans with out-of-range and sentinel rows.
  * The sampler: reproducible per request, independent of its batch
    company, and within top-k / top-p.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.kvcache import migrate as jmig  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.tiers import H100  # noqa: E402
from repro_torch.kvcache import migrate as tmig  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig, ServingEngine, prefill_buckets, prefill_plane,
    serve_graph_bound, step_buckets,
)
from repro_torch.serving.policies import policy_names  # noqa: E402
from repro_torch.serving.sampling import (  # noqa: E402
    SamplingConfig, inverse_cdf, lane_key, make_sampler,
)

META = torch.device("meta")
B, STRIDE = 2, 4


def meta_engine(name="internlm2-1.8b", **kw):
    model = Model(tconfigs.get_smoke(name))
    params = abstract_params(model.schema(), model.cfg.param_dtype)
    return ServingEngine(model, params, EngineConfig(
        spec=H100, max_context=256, telemetry_stride=STRIDE, **kw),
        device=META)


def serve_chunk_on_meta(eng, sampling=SamplingConfig(), pages=None):
    """One serve chunk of `eng` on the meta device, its prefill plane
    over `pages` (default: every page) on every step."""
    geo = eng.model.cache_geometry(B, eng.cfg.max_context,
                                   hbm_fraction=eng.cfg.hbm_fraction)
    eng._setup(geo)
    a = eng._bind_serve_arena(geo, STRIDE)
    rows = eng._serve_chunk(a, STRIDE, (pages or geo.max_pages, STRIDE),
                            make_sampler(sampling))
    assert rows["emitted"].shape == (STRIDE, B)
    assert rows["base"].shape == (STRIDE, 4)
    if eng.cfg.trace_telemetry:
        assert rows["access"].shape == (STRIDE,) + a["cache"].page_table.shape
    return rows


@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
@pytest.mark.parametrize("policy", policy_names())
def test_serve_chunk_has_no_host_sync(policy, overlap):
    """Every policy, both modes, trace capture on: the chunk reads no
    device value on the host (the fault rows are always in it)."""
    eng = meta_engine(policy=policy, overlap_migrations=overlap,
                      attention_sparsity=0.5 if policy == "quest" else 0.0,
                      trace_telemetry=True, prefill_chunk=16)
    serve_chunk_on_meta(eng)


def test_sampled_budgeted_serve_chunk_has_no_host_sync():
    eng = meta_engine(policy="importance", prefill_budget=24, eos_id=3,
                      prefill_chunk=16)
    serve_chunk_on_meta(eng, SamplingConfig(temperature=0.8, top_k=5,
                                            top_p=0.9))


MOE_ARCHS = {"granite": "granite-moe-3b-a800m",
             "llama4": "llama4-maverick-400b-a17b"}


@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
@pytest.mark.parametrize("arch", list(MOE_ARCHS))
def test_moe_serve_chunk_has_no_host_sync(arch, overlap):
    """The moe family's serve chunk (every lane's rows routed in the
    decode and the prefill plane, the decode's put-back rows), both
    modes, trace capture on, the fault rows in it, over a prefill plane
    of half the pages (its bucket bounds every row's position)."""
    eng = meta_engine(MOE_ARCHS[arch], policy="importance",
                      overlap_migrations=overlap, trace_telemetry=True,
                      prefill_chunk=16)
    serve_chunk_on_meta(eng, pages=prefill_buckets(
        eng.model.cache_geometry(B, eng.cfg.max_context).max_pages)[-2])


@pytest.mark.parametrize("arch", list(MOE_ARCHS))
def test_sampled_budgeted_moe_serve_chunk_has_no_host_sync(arch):
    eng = meta_engine(MOE_ARCHS[arch], policy="importance",
                      prefill_budget=24, eos_id=3, prefill_chunk=16)
    serve_chunk_on_meta(eng, SamplingConfig(temperature=0.8, top_k=5,
                                            top_p=0.9))


@pytest.mark.parametrize("stride", [1, 4, 5, 16])
def test_prefill_plane_steps_come_from_its_buckets(stride):
    """The prefill plane runs the steps its slowest lane needs, rounded
    up to one of at most 4 step buckets, over the pages those steps
    reach; a serve's graph count is bounded by the bucket counts."""
    buckets = step_buckets(stride)
    assert len(buckets) <= 4 and buckets[-1] == stride
    assert list(buckets) == sorted(set(buckets))
    chunk, page_tokens, max_pages = 16, 8, 40
    rng = np.random.default_rng(stride)
    for _ in range(50):
        n = 3
        prompt = rng.integers(1, max_pages * page_tokens, n)
        view = SimpleNamespace(active=rng.random(n) < 0.8, prompt_len=prompt,
                               prefilled=np.minimum(
                                   rng.integers(0, prompt.max(), n), prompt))
        pages, steps = prefill_plane(view, stride, chunk, page_tokens,
                                     max_pages, budgeted=False)
        pf = view.active & (view.prefilled < view.prompt_len)
        if not pf.any():
            assert (pages, steps) == (0, 0)
            continue
        need = (-(-(prompt - view.prefilled)[pf] // chunk)).max()
        assert steps in buckets and steps >= min(need, stride)
        assert not [b for b in buckets if need <= b < steps]
        end = np.minimum(view.prefilled[pf] + steps * chunk, prompt[pf]).max()
        assert pages in prefill_buckets(max_pages)
        assert pages * page_tokens >= min(end, max_pages * page_tokens)
    geo = SimpleNamespace(max_pages=max_pages)
    assert serve_graph_bound(geo, stride) == \
        1 + len(buckets) * len(prefill_buckets(max_pages))


STREAM_ARCHS = {"dense": "internlm2-1.8b", "moe": "granite-moe-3b-a800m",
                "vlm": "internvl2-2b", "encdec": "whisper-tiny",
                "hybrid": "zamba2-1.2b"}


@pytest.mark.parametrize("name", tconfigs.all_arch_names())
def test_every_family_run_drives_is_checked_here(name):
    """`run`/`generate` capture every family they drive: a family whose
    decode state holds a paged cache is one of STREAM_ARCHS', checked
    below; any other raises before its first chunk."""
    eng = meta_engine(name, policy="importance")
    model = eng.model
    geo = model.cache_geometry(B, eng.cfg.max_context)
    state = model.init_decode_state(B, geo, device=META)
    paged = isinstance(state, tpaged.PagedKVCache) or "kv" in state
    assert paged == (model.cfg.family in STREAM_ARCHS)
    if not paged:
        eng.state = state
        with pytest.raises(ValueError, match="no paged"):
            eng.run(torch.zeros((STRIDE, B), dtype=torch.int32))
        with pytest.raises(ValueError, match="no paged"):
            eng.generate(torch.zeros((B,), dtype=torch.int32), STRIDE)


@pytest.mark.parametrize("family", sorted(STREAM_ARCHS))
def test_stream_chunks_have_no_host_sync(family):
    """run and generate chunks of each family `run`/`generate` capture."""
    eng = meta_engine(STREAM_ARCHS[family], policy="importance")
    model = eng.model
    geo = model.cache_geometry(B, eng.cfg.max_context)
    state = model.init_decode_state(B, geo, device=META)
    if family == "encdec":
        state = {"kv": state, "enc": torch.empty(
            (B, model.cfg.frontend.num_embeddings, model.cfg.d_model),
            dtype=model.cfg.dtype, device=META)}
    eng.state = state
    eng._setup(geo)
    a = eng._bind_stream_arena(B)
    logits, stats = eng._stream_chunk(a, STRIDE, "run")
    assert logits.shape == (STRIDE, B, model.cfg.vocab)
    toks, stats = eng._stream_chunk(a, STRIDE, "generate")
    assert toks.shape == (STRIDE, B) and stats[0].shape == (STRIDE, 4)


# --- run / generate against step() on the CPU -----------------------------

@pytest.fixture(scope="module")
def f32_model():
    cfg = dataclasses.replace(tconfigs.get_smoke("internlm2-1.8b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = Model(cfg)
    return model, model.init(0, device="cpu")


def _int_state(eng):
    c = eng.state
    return [getattr(c, f).clone() for f in ("page_table", "hbm_owner",
                                             "host_owner", "length")]


@pytest.mark.parametrize("policy", ["importance", "recency", "quest"])
def test_run_and_generate_equal_steps(f32_model, policy):
    """K = 2 strides + 3 steps: `run` (two full chunks and a short one)
    and `generate` give the logits, tokens, integer state and StepStats
    of K `step()` calls from the same start, bitwise."""
    model, params = f32_model
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, model.cfg.vocab, (2, 150)),
                             dtype=torch.int32)
    ecfg = EngineConfig(spec=H100, max_context=256, policy=policy,
                        attention_sparsity=0.5 if policy == "quest" else 0.0,
                        promote_thresh=1e-4, telemetry_stride=STRIDE,
                        trace_telemetry=True)
    K = 2 * STRIDE + 3

    def engine():
        eng = ServingEngine(model, params, ecfg, device="cpu")
        return eng, eng.start(prompt).argmax(-1).to(torch.int32)

    eager, tok = engine()
    step_logits, step_toks = [], []
    for _ in range(K):
        logits = eager.step(tok)
        tok = logits.argmax(-1).to(torch.int32)
        step_logits.append(logits)
        step_toks.append(tok)
    step_logits = torch.stack(step_logits)

    fused, first = engine()
    got = fused.generate(first, K)
    assert torch.equal(got, torch.stack(step_toks))
    for a, b in zip(_int_state(fused), _int_state(eager)):
        assert torch.equal(a, b)
    assert fused.stats == eager.stats
    assert len(fused._trace_log) == 3

    fused, first = engine()
    feed = torch.cat([first[None], torch.stack(step_toks)[:-1]])
    logits = fused.run(feed)
    assert torch.equal(logits, step_logits)
    for a, b in zip(_int_state(fused), _int_state(eager)):
        assert torch.equal(a, b)
    assert torch.equal(fused.state.importance, eager.state.importance)
    assert fused.stats == eager.stats
    assert fused.steps_run == K


# --- the fixed-shape commit against the reference's ------------------------

L, PH, PE, T = 2, 4, 6, 4
MAXP = PH + PE


def _caches(rng):
    """The same cache on both sides: random tables, small pools."""
    jgeo = jpaged.CacheGeometry(num_layers=L, batch=B, page_tokens=T,
                                hbm_pages=PH, host_pages=PE, kv_heads=1,
                                head_dim=8, dtype=jnp.float32)
    tgeo = tpaged.CacheGeometry(num_layers=L, batch=B, page_tokens=T,
                                hbm_pages=PH, host_pages=PE, kv_heads=1,
                                head_dim=8, dtype=torch.float32)
    arrays = {
        "k_hbm": rng.standard_normal((L, B, PH, T, 1, 8)),
        "v_hbm": rng.standard_normal((L, B, PH, T, 1, 8)),
        "k_host": rng.standard_normal((L, B, PE, T, 1, 8)),
        "v_host": rng.standard_normal((L, B, PE, T, 1, 8)),
        "page_table": rng.integers(-1, MAXP, (L, B, MAXP)),
        "hbm_owner": rng.integers(-1, MAXP, (L, B, PH)),
        "host_owner": rng.integers(-1, MAXP, (L, B, PE)),
        "length": rng.integers(0, MAXP * T, (B,)),
        "importance": rng.random((L, B, MAXP))}
    arrays = {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
              for k, v in arrays.items()}
    jc = jpaged.init_cache(jgeo)
    jc = dataclasses.replace(jc, **{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    tc = bridge.cache_from_numpy(arrays, device="cpu")
    return jc, tc


def _plan_rows(rng, m, src_bound):
    """`m` rows of (layer, batch, src, dst, logical): sentinel rows
    (layer -1), layers and lanes past the end (dropped), negative lanes
    (clamped to 0), and targets (dst, logical) up to three times past
    their bound (dropped). Every target is unique across rows, so no
    two rows race for one element; a live row's source is in range, as
    every planner's is (the reference clamps it, the port drops it)."""
    def col(lo, hi, unique=False):
        if unique:
            return rng.permutation(np.arange(lo, hi))[:m]
        return rng.integers(lo, hi, m)
    rows = np.stack([col(-1, L + 1), col(-1, B + 1), col(0, src_bound),
                     col(0, 3 * MAXP, True), col(0, 3 * MAXP, True)], axis=1)
    rows[rng.random(m) < 0.25] = -1          # whole sentinel rows
    return rows.astype(np.int32)


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), m=st.integers(0, 12))
def test_commit_tables_match_the_reference(seed, m):
    rng = np.random.default_rng(seed)
    jc, tc = _caches(rng)
    cap = 12
    rows = [np.full((cap, 5), -1, np.int32) for _ in range(2)]
    for half, src_bound in zip(rows, (PE, PH)):
        half[:m] = _plan_rows(rng, m, src_bound)
    jplan = jmig.MigrationPlan(*[jnp.asarray(h[:, i]) for h in rows
                                 for i in range(5)])
    tplan = tmig.MigrationPlan(*[torch.as_tensor(h[:, i].copy())
                                 for h in rows for i in range(5)])
    want = jmig.apply_migrations(jc, jplan)
    got = tmig.commit_tables(tc, tplan)
    for name in ("page_table", "hbm_owner", "host_owner"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# --- the sampler ------------------------------------------------------------

def test_sampler_is_independent_of_batch_company():
    """A lane's draw depends on its logits, key and counter only."""
    rng = np.random.default_rng(0)
    logits = torch.as_tensor(rng.standard_normal((6, 50)),
                             dtype=torch.float32)
    keys = torch.as_tensor(np.stack([lane_key(3, r) for r in range(6)]))
    counter = torch.as_tensor(rng.integers(1, 40, 6), dtype=torch.int32)
    sample = make_sampler(SamplingConfig(temperature=0.9, top_k=10,
                                         top_p=0.95))
    batch = sample(logits, keys, counter)
    alone = torch.cat([sample(logits[i:i + 1], keys[i:i + 1],
                              counter[i:i + 1]) for i in range(6)])
    assert torch.equal(batch, alone)
    assert torch.equal(batch, sample(logits, keys, counter))
    perm = torch.as_tensor([3, 0, 5, 1, 4, 2])
    assert torch.equal(sample(logits[perm], keys[perm], counter[perm]),
                       batch[perm])


@pytest.mark.parametrize("top_k, top_p", [(5, 1.0), (0, 0.5), (7, 0.8)])
def test_sampler_keeps_to_top_k_and_top_p(top_k, top_p):
    """Over many counters every draw lies in the top-k and nucleus sets,
    and the draws follow the filtered distribution."""
    rng = np.random.default_rng(1)
    V, n = 40, 4000
    row = torch.as_tensor(rng.standard_normal(V) * 2, dtype=torch.float32)
    cfg = SamplingConfig(temperature=0.7, top_k=top_k, top_p=top_p)
    toks = make_sampler(cfg)(
        row.expand(n, V), torch.as_tensor(lane_key(0, 9)).expand(n, 2),
        torch.arange(n))
    probs = torch.softmax(row / 0.7, -1).double()
    order = torch.argsort(probs, descending=True)
    keep = torch.zeros(V, dtype=torch.bool)
    k = top_k if top_k else V
    cum_before = torch.cumsum(probs[order], 0) - probs[order]
    keep[order[:k][cum_before[:k] < top_p]] = True
    assert bool(keep[toks.long()].all())
    want = torch.where(keep, probs, 0.0)
    want = want / want.sum()
    freq = torch.bincount(toks.long(), minlength=V).double() / n
    assert float((freq - want).abs().max()) < 0.03


def test_inverse_cdf_never_picks_a_zero_probability_token():
    probs = torch.tensor([[0.0, 0.5, 0.5, 0.0], [0.0, 0.0, 1.0, 0.0]])
    for u in (0.0, 0.4999, 0.5, 1.0 - 2 ** -52):
        got = inverse_cdf(probs, torch.full((2,), u, dtype=torch.float64))
        assert bool((probs[torch.arange(2), got.long()] > 0).all())


def test_sampled_serve_is_reproducible_per_request(f32_model):
    """The same request gets the same sampled tokens whether it is
    served first with one companion or later beside another, from one
    key per (seed, rid)."""
    model, params = f32_model
    rng = np.random.default_rng(2)
    from repro_torch.serving.scheduler import Request
    prompts = [rng.integers(0, model.cfg.vocab, (n,)) for n in (40, 24, 56)]
    ecfg = EngineConfig(spec=H100, max_context=256, telemetry_stride=4,
                        prefill_chunk=16)
    sampling = SamplingConfig(temperature=0.9, top_k=40)

    def serve(rids, seed=5):
        eng = ServingEngine(model, params, ecfg, device="cpu")
        rep = eng.serve([Request(rid=r, prompt=prompts[r],
                                 max_new_tokens=10) for r in rids],
                        num_slots=2, sampling=sampling, seed=seed)
        return {r.rid: list(r.output) for r in rep}

    one = serve([0, 1])
    other = serve([2, 0])
    assert one[0] == other[0]
    assert len(one[0]) == 10
    assert serve([0, 1], seed=6)[0] != one[0]
