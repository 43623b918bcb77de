"""The port's trace bridge and its copy of the placement simulator
against the reference, on the CPU.

Each policy drives one single-stream `start` + `generate` with trace
capture on both sides (the f32 smoke config, same weights, Quest
sparsity 0.5, priced on the port's H100 spec). The port's
`score_headroom` on its own stream must equal the reference's on the
reference's stream within 1e-12 with the same `SAConfig` (both run the
same numpy arithmetic on equal records); the copied simulator policies
must replay a synthetic trace exactly as the reference's do.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import experiment as jexp  # noqa: E402
from repro.core import sa as jsa  # noqa: E402
from repro.core import traces as jtraces  # noqa: E402
from repro.core.latency_model import StepTraffic as JTraffic  # noqa: E402
from repro.core.placement import POLICIES as J_POLICIES  # noqa: E402
from repro.core.tiers import MemorySystemSpec as JSpec  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving import trace_bridge as jtb  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import experiment as texp  # noqa: E402
from repro_torch.core import sa as tsa  # noqa: E402
from repro_torch.core import traces as ttraces  # noqa: E402
from repro_torch.core.latency_model import StepTraffic  # noqa: E402
from repro_torch.core.placement import POLICIES  # noqa: E402
from repro_torch.core.tiers import H100  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serving import trace_bridge as ttb  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ENGINE_POLICIES = ["static", "importance", "recency", "cost_aware", "quest"]
JAX_H100 = JSpec(**dataclasses.asdict(H100))
#: the CI settings of benchmarks/perf_engine.py's policy sweep
SA = dict(max_evaluations=12, iters_per_level=4, seed=0)


@pytest.fixture(scope="module")
def streams():
    """policy -> (port engine, reference engine), each after start +
    generate(12) with trace capture."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("internlm2-1.8b"),
                               dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("internlm2-1.8b"),
                               dtype=torch.float32, param_dtype=torch.float32)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = TModel(tcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    prompt = np.random.default_rng(2).integers(0, 256, (2, 300)).astype(
        np.int32)
    runs = {}

    def get(policy):
        if policy not in runs:
            kw = dict(max_context=512, policy=policy, telemetry_stride=8,
                      attention_sparsity=0.5, promote_thresh=1e-4,
                      trace_telemetry=True)
            jeng = JEngine(jm, jp, JConfig(spec=JAX_H100, **kw))
            log = jeng.start(jnp.asarray(prompt))
            jeng.generate(jnp.argmax(log, -1).astype(jnp.int32), 12)
            teng = ServingEngine(tm, tp, EngineConfig(spec=H100, **kw),
                                 device="cpu")
            log = teng.start(torch.from_numpy(prompt))
            teng.generate(log.argmax(-1).to(torch.int32), 12)
            runs[policy] = (teng, jeng)
        return runs[policy]
    return get


@pytest.mark.parametrize("policy", ENGINE_POLICIES)
def test_score_headroom_matches_reference(streams, policy):
    teng, jeng = streams(policy)
    got = ttb.score_headroom(ttb.collect(teng), H100,
                             sa_cfg=tsa.SAConfig(**SA))
    want = jtb.score_headroom(jtb.collect(jeng), JAX_H100,
                              sa_cfg=jsa.SAConfig(**SA))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-12), key
    assert np.isfinite(list(got.values())).all()
    assert 0.0 < got["live_hit_fraction"] < 1.0          # host tier read
    assert got["sa_total_s"] <= got["static_total_s"] * 1.001


@pytest.mark.parametrize("policy", ["static", "quest"])
def test_collect_matches_reference(streams, policy):
    teng, jeng = streams(policy)
    got, want = ttb.collect(teng), jtb.collect(jeng)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    assert got.access.dtype == bool and got.tier.dtype == np.int8
    assert got.num_steps == 12 and got.num_layers == teng.geo.num_layers
    for layer in range(got.num_layers):
        tr, jtr = ttb.layer_trace(got, layer), jtb.layer_trace(want, layer)
        np.testing.assert_array_equal(tr.access, jtr.access)
        np.testing.assert_array_equal(tr.page_born, jtr.page_born)
        assert tr.sparsity == jtr.sparsity
        for a, b in zip(ttb.layer_migrations(got, layer),
                        jtb.layer_migrations(want, layer)):
            np.testing.assert_array_equal(a, b)
    live, jlive = ttb.live_traffic(got), jtb.live_traffic(want)
    for f in dataclasses.fields(jlive):
        np.testing.assert_array_equal(getattr(live, f.name),
                                      getattr(jlive, f.name))
    assert ttb.hit_fraction(got) == jtb.hit_fraction(want)


def test_collect_needs_a_captured_trace():
    class Bare:
        _trace_log = []
    with pytest.raises(ValueError, match="trace_telemetry"):
        ttb.collect(Bare())


@pytest.mark.parametrize("name", sorted(J_POLICIES))
def test_simulator_policy_matches_reference(name):
    """`run_strategy` of every copied simulator policy replays one
    synthetic trace to the reference's per-step traffic and total."""
    assert sorted(POLICIES) == sorted(J_POLICIES)
    kw = dict(page_tokens=16, sparsity=0.5, variation=0.4, seed=3)
    tr = ttraces.synthetic_trace(512, 48, **kw)
    jtr = jtraces.synthetic_trace(512, 48, **kw)
    np.testing.assert_array_equal(tr.access, jtr.access)
    wl = dict(bytes_per_token_layer=2 * 8 * 128 * 2, num_layers=4)
    budget = 12 * 16 * wl["bytes_per_token_layer"]
    got = texp.run_strategy(name, tr, H100, texp.Workload(**wl), budget,
                            sa_cfg=tsa.SAConfig(**SA))
    want = jexp.run_strategy(name, jtr, JAX_H100, jexp.Workload(**wl),
                             budget, sa_cfg=jsa.SAConfig(**SA))
    assert got.policy == want.policy
    assert got.total_latency_s == want.total_latency_s
    for f in dataclasses.fields(want.step_traffic):
        np.testing.assert_array_equal(getattr(got.step_traffic, f.name),
                                      getattr(want.step_traffic, f.name))


def test_step_traffic_sum_and_page_counts_match_reference():
    rng = np.random.default_rng(0)
    counts = {k: rng.integers(0, 9, 5) for k in
              ("n_hbm_read", "n_dram_read", "n_promote", "n_demote")}
    writes = dict(h_write=rng.random(5), e_write=rng.random(5))
    got = StepTraffic.from_page_counts(**counts, page_bytes=4096, **writes)
    want = JTraffic.from_page_counts(**counts, page_bytes=4096, **writes)
    got, want = got + got, want + want
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name))
