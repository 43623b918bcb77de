"""`ServingEngine.serve()` of the port against the reference on the CPU.

The internlm2-1.8b smoke config in float32 with the same weights
(carried by the bridge), `max_context=512` (16 HBM pages per lane, so
the 300- and 280-token prompts spill into the host tier), and four
requests through two slots, so lanes are released and re-admitted.
Greedy tokens, terminal statuses (rejections included) and every
priced `StepStats` row must equal the reference's exactly; both sides
price on the port's H100 spec. Sampled streams differ between the two
PRNGs and are checked within the port only.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.tiers import MemorySystemSpec as JSpec  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.tiers import H100  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingConfig  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

PROMPTS = (300, 40, 280, 20)
BUDGET = 12
POLICIES = ("static", "importance", "recency", "cost_aware", "quest")
#: the reference priced on the same spec, so modeled latencies compare
JAX_H100 = JSpec(**dataclasses.asdict(H100))


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
    return [rng.integers(0, 256, (n,)) for n in PROMPTS]


def engine_kw(policy, eos_id=None):
    return dict(max_context=512, policy=policy, prefill_chunk=32,
                telemetry_stride=8, eos_id=eos_id)


def stream(cls, prompts, rejects=False):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=BUDGET)
            for i, p in enumerate(prompts)]
    if rejects:     # the three rejection paths of submit
        reqs += [cls(rid=4, prompt=prompts[1], max_new_tokens=0),
                 cls(rid=5, prompt=np.zeros(760, np.int64),
                     max_new_tokens=BUDGET),
                 cls(rid=6, prompt=None, max_new_tokens=4)]
    return reqs


def outcome(eng, rep):
    """What must match: tokens, statuses with error codes, EOS counts,
    and every priced telemetry row."""
    reqs = list(rep.completed) + list(rep.rejected)
    return {
        "outputs": {r.rid: list(r.output) for r in reqs},
        "statuses": {r.rid: (r.status, r.error.code if r.error else None)
                     for r in reqs},
        "eos": dict(rep.eos),
        "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats],
        "latency": [s.modeled_latency_s for s in eng.stats],
    }


@pytest.fixture(scope="module")
def reference(models, prompts):
    """The reference's runs, computed once: one per policy, and an
    importance run with EOS and rejected requests. The config's EOS id
    (2) is never emitted by these random weights, so the EOS run stops
    on the 4th greedy token of request 0, which the stream does emit."""
    jm, jp, _, _ = models
    runs = {}
    for policy in POLICIES:
        eng = JEngine(jm, jp, JConfig(spec=JAX_H100, **engine_kw(policy)))
        runs[policy] = outcome(eng, eng.serve(stream(JRequest, prompts),
                                              num_slots=2))
    eos = runs["static"]["outputs"][0][3]
    eng = JEngine(jm, jp, JConfig(spec=JAX_H100,
                                  **engine_kw("importance", eos)))
    runs["eos"] = outcome(eng, eng.serve(stream(JRequest, prompts, True),
                                         num_slots=2))
    runs["eos_id"] = eos
    return runs


def port_run(models, prompts, policy, eos_id=None, rejects=False):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, EngineConfig(spec=H100,
                                             **engine_kw(policy, eos_id)),
                        device="cpu")
    return outcome(eng, eng.serve(stream(Request, prompts, rejects),
                                  num_slots=2))


def assert_same(got, want):
    assert got["statuses"] == want["statuses"]
    assert got["outputs"] == want["outputs"]
    assert got["eos"] == want["eos"]
    assert got["bytes"] == want["bytes"]
    np.testing.assert_allclose(got["latency"], want["latency"], rtol=1e-12)


@pytest.mark.parametrize("policy", POLICIES)
def test_serve_matches_reference(models, prompts, reference, policy):
    got = port_run(models, prompts, policy)
    assert_same(got, reference[policy])
    assert set(got["statuses"].values()) == {("ok", None)}
    assert all(len(o) == BUDGET for o in got["outputs"].values())
    assert sum(row[1] for row in got["bytes"]) > 0       # host tier read
    migrated = sum(row[2] + row[3] for row in got["bytes"])
    if policy in ("static", "importance"):
        assert (migrated > 0) == (policy == "importance")


def test_eos_and_rejections_match_reference(models, prompts, reference):
    got = port_run(models, prompts, "importance", reference["eos_id"],
                   rejects=True)
    assert_same(got, reference["eos"])
    assert got["eos"]["eos_stops"] > 0
    assert got["outputs"][0][-1] == reference["eos_id"]
    assert len(got["outputs"][0]) == 4
    assert got["statuses"][4] == ("rejected", "zero_budget")
    assert got["statuses"][5] == ("rejected", "infeasible_context")
    assert got["statuses"][6] == ("rejected", "empty_prompt")


def test_generate_matches_reference(models, prompts):
    """The single-stream entry points: `start` (whole-prompt prefill)
    then `generate`, greedy, on a prompt that spills to the host tier."""
    jm, jp, tm, tp = models
    prompt = np.stack([prompts[0], prompts[2][:1].repeat(300)])
    cfg = engine_kw("importance")
    jeng = JEngine(jm, jp, JConfig(spec=JAX_H100, **cfg))
    jlog = jeng.start(jnp.asarray(prompt, jnp.int32))
    jtok = jeng.generate(jnp.argmax(jlog, -1).astype(jnp.int32), 6)
    teng = ServingEngine(tm, tp, EngineConfig(spec=H100, **cfg),
                         device="cpu")
    tlog = teng.start(torch.from_numpy(prompt))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    ttok = teng.generate(tlog.argmax(-1).to(torch.int32), 6)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert len(teng.stats) == len(jeng.stats) == 6
    np.testing.assert_allclose(
        [dataclasses.astuple(s) for s in teng.stats],
        [dataclasses.astuple(s) for s in jeng.stats], rtol=1e-12)
    assert sum(s.e_read for s in teng.stats) > 0


def test_sampled_streams_are_reproducible(models, prompts):
    """Within the port: the same seed gives the same sampled tokens, and
    another seed other tokens."""
    _, _, tm, tp = models
    sampling = SamplingConfig(temperature=0.9, top_k=40, top_p=0.95)

    def run(seed):
        eng = ServingEngine(tm, tp, EngineConfig(spec=H100,
                                                 **engine_kw("importance")),
                            device="cpu")
        rep = eng.serve(stream(Request, prompts), num_slots=2,
                        sampling=sampling, seed=seed)
        return {r.rid: list(r.output) for r in rep}

    first = run(7)
    assert all(len(o) == BUDGET for o in first.values())
    assert run(7) == first
    assert run(8) != first


@pytest.mark.parametrize("ask", ["dryrun"])
def test_later_slices_raise(models, prompts, ask):
    """What the port once left out of the mesh now runs as itself: the
    dry run's twin-pod record counts the rank-local step (internlm2's
    decode under the 'pages' KV pool rule at a 16-way model axis) with
    its collectives, and names nothing as unmeasured."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("internlm2-1.8b", "decode_32k", "multi")
    assert rec["status"] == "ok"
    assert rec["bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"]["by_axis"]["model"] > 0
    assert rec["memory"]["activation_bytes"] > 0
    assert rec["kernels"]["paged_attention"] == 2 * 24
    assert "unmeasured" not in rec
