"""The single-stream path of the port — `start` (whole-prompt prefill),
`generate` and `run` — under all five placement policies, against the
reference on the CPU.

The internlm2-1.8b smoke config in float32 with the same weights
(carried by the bridge), `max_context=512` (16 HBM pages per lane, so
the 300-token prompts spill into the host tier), Quest sparsity 0.5 and
trace capture on, both sides priced on the port's H100 spec. Greedy
tokens, every priced `StepStats` row and the captured `_trace_log`
arrays must equal the reference's exactly; logits agree within 1e-4
(the two frameworks sum in different orders).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.placement.cost_aware import \
    hysteresis_thresholds as j_thresholds  # noqa: E402
from repro.core.tiers import GH200 as J_GH200  # noqa: E402
from repro.core.tiers import MemorySystemSpec as JSpec  # noqa: E402
from repro.kvcache.paged import IMPORTANCE_EMA  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.tiers import GH200, H100  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serving import policies  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

POLICIES = ["static", "importance", "recency", "cost_aware", "quest"]
STEPS = 12
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
def prompt():
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, (2, 300)).astype(np.int32)


def engine_kw(policy):
    return dict(max_context=512, policy=policy, telemetry_stride=8,
                attention_sparsity=0.5, promote_thresh=1e-4,
                trace_telemetry=True)


def drive(eng, start, to_np):
    """start, generate STEPS greedy tokens, then start again and run
    the tokens generate fed itself, teacher-forced."""
    log0 = start()
    first = log0.argmax(-1)
    toks = eng.generate(first.astype(jnp.int32) if isinstance(first, jax.Array)
                        else first.to(torch.int32), STEPS)
    gen_trace = list(eng._trace_log)
    gen_state = eng._pstate
    fed = np.concatenate([to_np(first)[None], to_np(toks)[:-1]]).astype(
        np.int32)
    start()
    logits = eng.run(jnp.asarray(fed) if isinstance(first, jax.Array)
                     else torch.from_numpy(fed))
    return {
        "start_logits": to_np(log0), "tokens": to_np(toks),
        "run_logits": to_np(logits),
        "stats": [dataclasses.astuple(s) for s in eng.stats],
        "gen_trace": [tuple(np.asarray(a) for a in c) for c in gen_trace],
        "run_trace": [tuple(np.asarray(a) for a in c)
                      for c in eng._trace_log],
        "state": {k: to_np(v) for k, v in gen_state.items()}
        if isinstance(gen_state, dict) else {},
        "summary": eng.summary(),
    }


@pytest.fixture(scope="module")
def reference(models, prompt):
    jm, jp, _, _ = models
    runs = {}

    def get(policy):
        if policy not in runs:
            eng = JEngine(jm, jp, JConfig(spec=JAX_H100, **engine_kw(policy)))
            runs[policy] = drive(eng, lambda: eng.start(jnp.asarray(prompt)),
                                 np.asarray)
        return runs[policy]
    return get


def port(models, prompt, policy):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, EngineConfig(spec=H100, **engine_kw(policy)),
                        device="cpu")
    return drive(eng, lambda: eng.start(torch.from_numpy(prompt)),
                 lambda t: t.numpy())


@pytest.mark.parametrize("policy", POLICIES)
def test_single_stream_matches_reference(models, prompt, reference, policy):
    got, want = port(models, prompt, policy), reference(policy)
    np.testing.assert_allclose(got["start_logits"], want["start_logits"],
                               atol=1e-4)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["run_logits"], want["run_logits"],
                               atol=1e-4)
    # run replays generate's stream: its argmax is what generate emitted
    np.testing.assert_array_equal(got["run_logits"].argmax(-1),
                                  got["tokens"])
    assert len(got["stats"]) == len(want["stats"]) == 2 * STEPS
    np.testing.assert_allclose(got["stats"], want["stats"], rtol=1e-12)
    for key in ("gen_trace", "run_trace"):
        assert len(got[key]) == len(want[key]) == 2      # stride 8, 12 steps
        for g, w in zip(got[key], want[key]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert sum(row[2] for row in got["stats"]) > 0       # host tier read
    migrated = sum(row[3] + row[4] for row in got["stats"])
    assert (migrated > 0) == (policy != "static")


def test_recency_state_matches_reference(models, prompt, reference):
    got, want = port(models, prompt, "recency"), reference("recency")
    assert set(got["state"]) == {"last", "step"}
    np.testing.assert_array_equal(got["state"]["last"], want["state"]["last"])
    assert int(got["state"]["step"]) == int(want["state"]["step"]) == STEPS


def test_start_keeps_stats_as_the_reference_does(models, prompt):
    """`start; generate(4); start; generate(4)` holds 8 StepStats on both
    sides, and `summary()` covers both streams; the trace restarts."""
    jm, jp, tm, tp = models
    kw = engine_kw("importance")
    jeng = JEngine(jm, jp, JConfig(spec=JAX_H100, **kw))
    teng = ServingEngine(tm, tp, EngineConfig(spec=H100, **kw), device="cpu")
    for _ in range(2):
        jlog = jeng.start(jnp.asarray(prompt))
        jeng.generate(jnp.argmax(jlog, -1).astype(jnp.int32), 4)
        tlog = teng.start(torch.from_numpy(prompt))
        teng.generate(tlog.argmax(-1).to(torch.int32), 4)
    assert len(teng.stats) == len(jeng.stats) == 8
    np.testing.assert_allclose([dataclasses.astuple(s) for s in teng.stats],
                               [dataclasses.astuple(s) for s in jeng.stats],
                               rtol=1e-12)
    got, want = teng.summary(), jeng.summary()
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=1e-12)
    assert sum(c[0].shape[0] for c in teng._trace_log) == 4


def test_empty_generate_and_run_stay_on_the_engine_device(models, prompt):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, EngineConfig(**engine_kw("quest")),
                        device="cpu")
    log = eng.start(torch.from_numpy(prompt))
    toks = eng.generate(log.argmax(-1), 0)
    assert toks.shape == (0, 2) and toks.dtype == torch.int32
    assert toks.device == eng.device
    logits = eng.run(torch.zeros((0, 2), dtype=torch.int32))
    assert logits.shape == (0, 2, tm.cfg.vocab)
    assert logits.device == eng.device
    assert eng.stats == [] and eng._trace_log == []


@pytest.mark.parametrize("spec,jspec", [(H100, JAX_H100), (GH200, J_GH200)],
                         ids=["h100", "gh200"])
def test_cost_aware_thresholds_are_float32_scalars(spec, jspec):
    """The payback bars are 0-dim float32 tensors equal to the
    reference's `jnp.float32` values, re-derived by `recalibrate`."""
    geo = TModel(tconfigs.get_smoke("internlm2-1.8b")).cache_geometry(1, 512)
    pol = policies.make_policy("cost_aware",
                               cfg=EngineConfig(spec=H100), geo=geo)
    state = pol.recalibrate(pol.init_state(geo), spec)
    want = j_thresholds(jspec, 1.0 / IMPORTANCE_EMA, pol.demote_ratio)
    for key, w in zip(("t_promote", "t_demote"), want):
        t = state[key]
        assert t.dtype == torch.float32 and t.dim() == 0
        assert t.item() == float(jnp.float32(w))


def test_every_reference_policy_is_registered():
    from repro.serving.policies import policy_names as j_names
    assert policies.policy_names() == j_names() == tuple(sorted(POLICIES))
