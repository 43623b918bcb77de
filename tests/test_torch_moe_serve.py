"""`ServingEngine.serve()` of the moe family against the reference, on
the CPU: granite-smoke (top-2 of 4) and llama4-smoke (top-1,
interleave 2, shared expert), both with capacity factor 0.5 so that
decode (8 lanes in one routing group, capacity 4 per expert) and the
prefill chunks (all 8 x 16 slots in one group) drop choices — where
routing other rows than the reference's would change an active lane's
tokens. Float32, the same weights, both sides priced on the port's
H100 spec; 10 greedy requests through 8 slots (lanes reused, idle lanes
at the tail), prompts spilling into the host tier, inline and in
overlap mode: tokens, statuses and every StepStats row exactly equal
(modeled latencies within 1e-12 relative). The port's prefill plane
reads the pages that hold every row's position, fewer than the pools
hold once the lanes are past their longest prompts' slices; the
reference reads the whole pools.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402

from _torch_serve_ref import (  # noqa: E402
    assert_same, engines, outcome, requests, smoke_pair,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = {"granite": "granite-moe-3b-a800m",
         "llama4": "llama4-maverick-400b-a17b"}


@pytest.fixture(scope="module", params=list(ARCHS))
def models(request):
    name = ARCHS[request.param]
    moe = dataclasses.replace(tconfigs.get_smoke(name).moe,
                              capacity_factor=0.5)
    return smoke_pair(name, moe=moe)


def stream(vocab):
    rng = np.random.default_rng(21)
    lens = (300, 40, 280, 20, 150, 64, 260, 33, 90, 17)
    return [rng.integers(0, vocab, (n,)) for n in lens]


@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
def test_moe_serve_matches_reference(models, overlap):
    kw = dict(max_context=512, policy="importance", prefill_chunk=16,
              telemetry_stride=8, promote_thresh=1e-4)
    jeng, teng = engines(models, overlap=overlap, **kw)
    prompts = stream(models[2].cfg.vocab)
    jrep = jeng.serve(requests(JRequest, prompts, 10), num_slots=8, seed=0)
    trep = teng.serve(requests(Request, prompts, 10), num_slots=8, seed=0)
    got = outcome(teng, trep)
    assert_same(got, outcome(jeng, jrep))
    assert set(trep.statuses.values()) == {"ok"}
    assert all(len(o) == 10 for o in got["outputs"].values())
    assert sum(b[1] for b in got["bytes"]) > 0           # host tier read
    assert sum(b[2] + b[3] for b in got["bytes"]) > 0    # pages migrated
    planes = [c["prefill_pages"] for c in teng.chunk_log
              if c["prefill_steps"]]
    assert min(planes) < teng.geo.max_pages              # a bounded plane
