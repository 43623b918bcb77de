"""Shared set-up of the port's serve tests against the reference: the
same smoke model on both sides (float32, weights carried by the
bridge), engines priced on the port's H100 spec, and what two serve
runs must agree on. Imported by `tests/test_torch_*.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core.tiers import MemorySystemSpec as JSpec
from repro.models.model import Model as JModel
from repro.serving.engine import EngineConfig as JConfig
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.core.tiers import H100
from repro_torch.models.model import Model as TModel
from repro_torch.serving.engine import EngineConfig, ServingEngine

#: the reference priced on the same spec, so modeled latencies compare
JAX_H100 = JSpec(**dataclasses.asdict(H100))


def smoke_pair(name="internlm2-1.8b", **overrides):
    """(reference model, its params, port model, its params): the smoke
    config of `name` in float32 (with `overrides` applied to both), one
    set of weights from the reference's init."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), dtype=jnp.float32,
                               param_dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(tconfigs.get_smoke(name), dtype=torch.float32,
                               param_dtype=torch.float32, **overrides)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = bridge.params_from_jax(jax.device_get(jp), tcfg,
                                device="cpu")
    return jm, jp, TModel(tcfg), tp


def engines(models, overlap=False, **kw):
    """(reference engine, port engine on the CPU) with the same config;
    the reference's overlap serve runs on the CPU only with its pinned
    host placement switched off on the instance."""
    jm, jp, tm, tp = models
    jeng = JEngine(jm, jp, JConfig(spec=JAX_H100, overlap_migrations=overlap,
                                   **kw))
    if overlap:
        jeng._host_memory_kind = None
    teng = ServingEngine(tm, tp, EngineConfig(spec=H100,
                                              overlap_migrations=overlap,
                                              **kw), device="cpu")
    return jeng, teng


def requests(cls, prompts, budget, **kw):
    """One request per prompt, rid = its index."""
    return [cls(rid=i, prompt=p, max_new_tokens=budget, **kw)
            for i, p in enumerate(prompts)]


def outcome(eng, rep):
    """What two runs of one stream must agree on: tokens, statuses with
    error codes, the events (an SLO shed's reason aside), and every
    priced telemetry row."""
    reqs = list(rep.completed) + list(rep.rejected)
    return {
        "outputs": {r.rid: list(r.output) for r in reqs},
        "statuses": {r.rid: (r.status, r.error.code if r.error else None)
                     for r in reqs},
        # an SLO shed's reason prints its wall-clock projection
        "events": [{k: v for k, v in e.items()
                    if not (e["kind"] == "slo_shed" and k == "reason")}
                   for e in rep.events],
        "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats],
        "latency": [s.modeled_latency_s for s in eng.stats],
    }


def assert_same(got, want):
    """Exact on everything but the modeled latencies (1e-12 relative)."""
    assert got["statuses"] == want["statuses"]
    assert got["outputs"] == want["outputs"]
    assert got["events"] == want["events"]
    assert got["bytes"] == want["bytes"]
    np.testing.assert_allclose(got["latency"], want["latency"], rtol=1e-12)


# --- the single-stream path and the model's steps, both sides ------------

INT_FIELDS = ("page_table", "hbm_owner", "host_owner", "length")
POOL_FIELDS = ("k_hbm", "v_hbm", "k_host", "v_host")


def state_numpy(state):
    """A reference decode state (a cache, or a dict state: encdec's
    {"kv", "enc"}, hybrid's {"ssm": {"s", "conv"}, "kv"}, xlstm's
    recurrent tensors) as the numpy dicts `bridge.cache_to_numpy` gives
    for the port's."""
    if isinstance(state, dict):
        return {k: state_numpy(v) if isinstance(v, dict)
                or dataclasses.is_dataclass(v) else np.asarray(v)
                for k, v in state.items()}
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def assert_state(got, want, atol=1e-5, state_rtol=1e-7):
    """A port decode state against a reference one (`state_numpy`): the
    same keys; a cache's integer fields exact, its pools and importance
    within `atol`; every other array (the encoder output, recurrent
    state) within `atol` plus `state_rtol` of its magnitude."""
    assert_numpy_state(bridge.cache_to_numpy(got), want, atol, state_rtol)


def assert_numpy_state(got, want, atol, rtol, where=""):
    assert got.keys() == want.keys(), where
    if "page_table" in want:
        for name in INT_FIELDS:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=where + name)
        for name in POOL_FIELDS + ("importance",):
            np.testing.assert_allclose(got[name], want[name], atol=atol,
                                       err_msg=where + name)
        return
    for k, w in want.items():
        if isinstance(w, dict):
            assert_numpy_state(got[k], w, atol, rtol, f"{where}{k}.")
        else:
            np.testing.assert_allclose(got[k], w, atol=atol, rtol=rtol,
                                       err_msg=where + k)


def model_steps(models, prompts, steps, extra=None, max_context=512,
                atol=2e-5, pool_atol=1e-5, state_rtol=1e-7):
    """Whole-prompt prefill then `steps` decode steps of the port and the
    reference on the same inputs (`extra`: numpy arrays), each step fed
    the reference's greedy token: logits within `atol`, greedy tokens
    equal, integer state exact, pools within `pool_atol`, the other
    state arrays within `pool_atol` plus `state_rtol` of their
    magnitude. Returns the port's last state."""
    jm, jp, tm, tp = models
    jx = None if extra is None else {k: jnp.asarray(v)
                                     for k, v in extra.items()}
    tx = None if extra is None else {k: torch.from_numpy(v)
                                     for k, v in extra.items()}
    jl, js = jm.prefill(jp, jnp.asarray(prompts),
                        jm.cache_geometry(prompts.shape[0], max_context),
                        extra=jx)
    tl, ts = tm.prefill(tp, torch.from_numpy(prompts),
                        tm.cache_geometry(prompts.shape[0], max_context),
                        extra=tx)
    for step in range(steps + 1):
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, atol=atol,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      want.argmax(-1))
        assert_state(ts, state_numpy(js), pool_atol, state_rtol)
        if step == steps:
            return ts
        tok = want.argmax(-1).astype(np.int32)
        jl, js = jm.decode_step(jp, js, jnp.asarray(tok), use_pallas=False)
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(tok))


def stream_pair(models, prompts, steps, extra=None, **kw):
    """`start` + `generate(steps)` of one prompt batch on both sides with
    the same engine config (`extra`: numpy arrays). Returns (port
    engine, reference engine, {"tokens", "bytes", "logits"} of each)."""
    jeng, teng = engines(models, **kw)
    jx = None if extra is None else {k: jnp.asarray(v)
                                     for k, v in extra.items()}
    jl = jeng.start(jnp.asarray(prompts), extra=jx)
    jt = jeng.generate(jnp.argmax(jl, -1).astype(jnp.int32), steps)
    tl = teng.start(torch.from_numpy(prompts), extra=extra)
    tt = teng.generate(tl.argmax(-1).to(torch.int32), steps)

    def run(eng, logits, toks):
        return {"tokens": np.asarray(toks).tolist(),
                "logits": np.asarray(logits),
                "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out)
                          for s in eng.stats]}
    return teng, jeng, run(teng, tl.numpy(), tt.numpy()), \
        run(jeng, jl, jt)


def assert_stream_matches(models, prompts, extra, policy, **kw):
    """`start(extra=...)` + `generate(8)` with trace capture, 512-token
    context, on both sides (`kw`: more of the engine config, the same
    on both): start logits within 2e-5, tokens and StepStats bytes
    equal, the host tier read, and `score_headroom` over the captured
    traces (the cache's pages) within 1e-12."""
    from repro.core import sa as jsa
    from repro.serving import trace_bridge as jtb
    from repro_torch.core import sa as tsa
    from repro_torch.serving import trace_bridge as ttb
    teng, jeng, got, want = stream_pair(
        models, prompts, 8, extra=extra, max_context=512, policy=policy,
        telemetry_stride=4, trace_telemetry=True, **kw)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=2e-5)
    assert got["tokens"] == want["tokens"]
    assert got["bytes"] == want["bytes"]
    assert any(b[1] > 0 for b in got["bytes"])            # host tier read
    sa = dict(max_evaluations=12, iters_per_level=4, seed=0)
    score = ttb.score_headroom(ttb.collect(teng), H100,
                               sa_cfg=tsa.SAConfig(**sa))
    ref = jtb.score_headroom(jtb.collect(jeng), JAX_H100,
                             sa_cfg=jsa.SAConfig(**sa))
    assert score.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(score[key], ref[key], rtol=1e-12,
                                   atol=1e-12, err_msg=key)


def assert_refuses_serve(models, prompts):
    """`serve()` and chunked prefill raise NotImplementedError with the
    reference's messages (the vlm and encdec families)."""
    import pytest
    from repro.serving.scheduler import Request as JRequest
    from repro_torch.serving.scheduler import Request
    jeng, teng = engines(models, max_context=512)
    with pytest.raises(NotImplementedError) as want:
        jeng.serve([JRequest(rid=0, prompt=prompts[0], max_new_tokens=4)])
    with pytest.raises(NotImplementedError) as got:
        teng.serve([Request(rid=0, prompt=prompts[0], max_new_tokens=4)])
    assert str(got.value) == str(want.value)
    jm, jp, tm, tp = models
    z = np.zeros(2, np.int32)
    with pytest.raises(NotImplementedError) as want:
        jm.prefill_chunk(jp, None, jnp.asarray(prompts[:, :8]),
                         jnp.asarray(z), jnp.asarray(z))
    with pytest.raises(NotImplementedError) as got:
        tm.prefill_chunk(tp, None, torch.from_numpy(prompts[:, :8]),
                         torch.from_numpy(z), torch.from_numpy(z))
    assert str(got.value) == str(want.value)
