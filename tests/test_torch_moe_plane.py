"""The moe family's bounded prefill plane, on the CPU.

A moe model's routing groups every row of a prefill chunk — idle lanes,
decoding lanes and padding slots included — so the plane's page bucket
(`engine.prefill_plane(..., all_lanes=True)`) must hold the position of
every row, not only the prefilling lanes' real tokens. A row at position
p sees the keys at slots p and before, so reading the first `end` slots
of each lane gives the whole pools' values to every row below `end`.

  * The bounded chunk (`Model.prefill_chunk(..., end=)` at the plane's
    bucket) against the reference's whole-pool `Model.prefill_chunk`
    (f32, capacity factor 0.5 so choices drop, granite-smoke and
    llama4-smoke), two steps of a plane, lanes in every state:
    prefilling into the host tier, prefilling from the start and
    mid-prompt, decoding at a long context over migrated pages and at a
    short one, idle with a stale count over an old request's pages, and
    never bound. Every row's logits within LOGIT_ATOL (the padding and
    idle rows too: they route), the tables exact, the pools within
    POOL_ATOL; and the port's whole-pool chunk gives the bounded one's
    values exactly. The plane reads fewer pages than the pools hold,
    and more than the dense rule would.
  * The page bucket of random views, chunk sizes, strides and budgets
    holds the largest position any row reaches over the plane's steps,
    simulated step by step as the serve chunk advances its lanes (the
    token bucket included).

The serve parity against the reference runs the bounded plane in
`test_torch_moe_serve.py`, which also checks that its planes read fewer
pages than the pools hold.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.kvcache import paged as jpaged  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kvcache.paged import NO_SLOT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    prefill_buckets, prefill_plane, step_buckets,
)

from _torch_serve_ref import smoke_pair  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5
ARCHS = {"granite": "granite-moe-3b-a800m",
         "llama4": "llama4-maverick-400b-a17b"}
CTX, C, STEPS = 1024, 32, 2

#: lane -> (state, prefilled, prompt_len, cached tokens): the chunk's
#: rows start at `prefilled`; the cache holds `cached` tokens
LANES = (
    ("prefilling into the host tier", 240, 300, 240),
    ("prefilling from the start", 0, 40, 0),
    ("decoding at a long context", 600, 600, 700),
    ("idle, a stale count", 350, 350, 0),
    ("never bound", 0, 0, 0),
    ("prefilling mid-prompt", 96, 700, 96),
    ("decoding at a short context", 20, 20, 40),
    ("prefilling its last slice", 180, 190, 180),
)
ACTIVE = np.array([True, True, True, False, False, True, True, True])


@pytest.fixture(scope="module", params=list(ARCHS))
def models(request):
    name = ARCHS[request.param]
    moe = dataclasses.replace(tconfigs.get_smoke(name).moe,
                              capacity_factor=0.5)
    return smoke_pair(name, moe=moe)


def lane_cache(geo, rng):
    """The cache of `LANES` as numpy: every lane's pools hold stale
    values (an earlier stream's) but the never-bound lane's zeros; a
    prefilling lane's pages at static placement, a decoding lane's over
    a random choice of slots of both tiers (migrated), an idle lane's
    tables released."""
    L, B, T = geo.num_layers, geo.batch, geo.page_tokens
    Ph, Pe = geo.hbm_pages, geo.host_pages
    row = (T, geo.kv_heads, geo.head_dim)
    pools = {name: rng.standard_normal((L, B, n) + row).astype(np.float32)
             for name, n in (("k_hbm", Ph), ("v_hbm", Ph),
                             ("k_host", Pe), ("v_host", Pe))}
    table = np.full((L, B, geo.max_pages), NO_SLOT, np.int32)
    owner = np.full((L, B, Ph + Pe), NO_SLOT, np.int32)
    length = np.zeros((B,), np.int32)
    for b, (state, _, _, cached) in enumerate(LANES):
        if state == "never bound":
            for pool in pools.values():
                pool[:, b] = 0.0
        n = -(-cached // T)
        length[b] = cached
        for l in range(L):
            slots = rng.choice(Ph + Pe, n, replace=False) \
                if state.startswith("decoding") else np.arange(n)
            table[l, b, :n] = slots
            owner[l, b, slots] = np.arange(n)
    return {**pools, "page_table": table, "hbm_owner": owner[..., :Ph],
            "host_owner": owner[..., Ph:], "length": length,
            "importance": rng.random((L, B, geo.max_pages)).astype(
                np.float32)}


def plane_view():
    return SimpleNamespace(
        active=ACTIVE, prefilled=np.array([s[1] for s in LANES], np.int32),
        prompt_len=np.array([s[2] for s in LANES], np.int32))


def test_the_plane_reads_fewer_pages_and_more_than_the_dense_rule():
    geo = Model(tconfigs.get_smoke(ARCHS["granite"])).cache_geometry(
        len(LANES), CTX)
    args = (plane_view(), STEPS, C, geo.page_tokens, geo.max_pages, False)
    pages, steps = prefill_plane(*args, all_lanes=True)
    dense, _ = prefill_plane(*args)
    assert steps == STEPS
    # the long decoding lane's rows reach 631: 40 pages, bucket 64 of 80
    assert (dense, pages, geo.max_pages) == (32, 64, 80)


def test_bounded_chunk_matches_the_whole_pool_reference(models):
    """Two steps of a plane at the bucket `prefill_plane` gives, against
    the reference's whole-pool chunk and the port's own."""
    jm, jp, tm, tp = models
    geo = tm.cache_geometry(len(LANES), CTX)
    view = plane_view()
    pages, steps = prefill_plane(view, STEPS, C, geo.page_tokens,
                                 geo.max_pages, False, all_lanes=True)
    assert pages < geo.max_pages
    end = pages * geo.page_tokens
    rng = np.random.default_rng(3)
    arrays = lane_cache(geo, rng)
    jc = jpaged.PagedKVCache(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tc = bridge.cache_from_numpy(arrays, device="cpu")
    whole = bridge.cache_from_numpy(arrays, device="cpu")
    prompts = rng.integers(0, tm.cfg.vocab, (len(LANES), 704))
    prog, plen = view.prefilled.copy(), view.prompt_len
    for step in range(steps):
        pf = ACTIVE & (prog < plen)
        n_val = np.where(pf, np.clip(plen - prog, 0, C), 0).astype(np.int32)
        idx = np.clip(prog[:, None] + np.arange(C), 0, prompts.shape[1] - 1)
        toks = np.take_along_axis(prompts, idx, 1).astype(np.int32)
        # every row of every lane lies below the plane's end
        assert (prog + C).max() <= end
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks),
                                  jnp.asarray(prog), jnp.asarray(n_val))
        inputs = [torch.from_numpy(x) for x in (toks, prog, n_val)]
        tl, tc = tm.prefill_chunk(tp, tc, *inputs, end=end)
        wl, whole = tm.prefill_chunk(tp, whole, *inputs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        got, want = bridge.cache_to_numpy(tc), bridge.cache_to_numpy(whole)
        ref = {f.name: np.asarray(getattr(jc, f.name))
               for f in dataclasses.fields(jc)}
        for name, value in got.items():
            np.testing.assert_array_equal(value, want[name], err_msg=name)
            if value.dtype.kind == "i":
                np.testing.assert_array_equal(value, ref[name], err_msg=name)
            else:
                np.testing.assert_allclose(value, ref[name], atol=POOL_ATOL,
                                           err_msg=name)
        assert torch.equal(tl, wl)
        prog = prog + n_val
    # the chunk wrote into the host tier (lane 0 crossed 256 tokens)
    assert (bridge.cache_to_numpy(tc)["host_owner"][:, 0] >= 0).any()


def max_row_position(view, steps, chunk, budget, credits):
    """The largest position any row of the plane reaches: the serve
    chunk's lane progress simulated over the plane's `steps` (`budget`:
    the per-step token bucket or None; `credits`: the bucket's carried
    tokens), each lane's rows at its progress and the `chunk` - 1
    positions after it."""
    prog = view.prefilled.copy()
    top = 0
    for _ in range(steps):
        top = max(top, int(prog.max()) + chunk - 1)
        pf = view.active & (prog < view.prompt_len)
        n_val = np.where(pf, np.clip(view.prompt_len - prog, 0, chunk), 0)
        if budget is not None:
            credits = min(credits + budget, len(prog) * chunk)
            if credits >= n_val.sum():
                credits -= int(n_val.sum())
            else:
                n_val = 0 * n_val
        prog = prog + n_val
    return top


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_moe_page_bucket_holds_every_row(data):
    """Random views (lanes active or not, any progress and prompt
    length), chunks, strides, page sizes and budgets: the moe bucket's
    tokens cover the largest row position + 1 (capped at the pools'),
    and cover the dense bucket's."""
    n = data.draw(st.integers(1, 8))
    page_tokens = data.draw(st.sampled_from([4, 8, 16]))
    max_pages = data.draw(st.integers(2, 96))
    max_tokens = max_pages * page_tokens
    chunk = data.draw(st.integers(1, 48))
    stride = data.draw(st.integers(1, 20))
    budget = data.draw(st.one_of(st.none(), st.integers(1, 4 * chunk)))
    credits = data.draw(st.integers(0, n * chunk))
    plen = np.array(data.draw(st.lists(st.integers(0, max_tokens), min_size=n,
                                       max_size=n)), np.int32)
    prefilled = np.array([data.draw(st.integers(0, int(p))) for p in plen],
                         np.int32)
    active = np.array(data.draw(st.lists(st.booleans(), min_size=n,
                                         max_size=n)))
    view = SimpleNamespace(active=active, prefilled=prefilled,
                           prompt_len=plen)
    args = (view, stride, chunk, page_tokens, max_pages, budget is not None)
    pages, steps = prefill_plane(*args, all_lanes=True)
    if not (active & (prefilled < plen)).any():
        assert (pages, steps) == (0, 0)
        return
    assert pages in prefill_buckets(max_pages) and steps in \
        step_buckets(stride)
    top = max_row_position(view, steps, chunk, budget, credits)
    assert pages * page_tokens >= min(top + 1, max_tokens)
    assert pages >= prefill_plane(*args)[0]

