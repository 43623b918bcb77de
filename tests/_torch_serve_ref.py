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
    tp = bridge.params_from_jax(jax.device_get(jp), tcfg)
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
