"""Rank processes of the port's meshed-serve tests
(`tests/test_torch_mesh_serve.py`): spawned processes on the CPU, one a
rank, joined over gloo through a `file://` store, building one
(`data`, `model`) mesh after another, each serving the streams it is
given on `ServingEngine(..., mesh=)` and pickling what it saw. Every collective
fails after `TIMEOUT_S`, so a rank that goes astray fails the run
instead of hanging it. Imports no JAX: the ranks start from a fresh
interpreter.

The streams (`CASES`) are the reference's own mesh tests' (five
requests of 32-64 tokens through 2 lanes at a 160-token context; three
of 272-288 tokens at 512 with Quest sparsity 0.5 and trace capture),
with commit caps and a poisoned request in the spilling one, plus a
sampled stream, and 3 lanes that a data axis of 4 does not divide
(replicated on every rank) with SLO sheds.

The single-stream cases (`STREAMS`): `start` on 2, 3 or 4 prompts of
`STREAM_PROMPT` tokens (past the HBM tier), `generate`, a second
`start` and a teacher-forced `run` over the generated tokens, then one
`step`, with Quest sparsity and trace capture (`drive_stream`, which
the tests also run on the reference's engine); and `AGAIN`: `serve`,
`start` + `generate`, then `serve` again on one engine.
"""

import dataclasses
import datetime
import math
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.core.sa import SAConfig
from repro_torch.core.tiers import H100
from repro_torch.launch.mesh import make_test_mesh, mesh_coordinate
from repro_torch.models.model import Model
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import faults as tf
from repro_torch.serving import slo as tslo
from repro_torch.serving import trace_bridge
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.sampling import SamplingConfig
from repro_torch.tree import tree_leaves

#: seconds a collective waits before it fails
TIMEOUT_S = 60
SA = dict(max_evaluations=6, iters_per_level=2, seed=0)


def short_requests(cls, vocab, n=5, base=32, tiers=False):
    """The reference's mesh stream: n prompts of 32, 48, 64 tokens,
    budgets 5 and 6; with `tiers`, the last request is "interactive"
    (TTFT target 0: shed while queued), the others "batch" (never
    shed)."""
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(0, vocab, (base + 16 * (i % 3),)),
                max_new_tokens=5 + (i % 2),
                **({"tier": "interactive" if i == n - 1 else "batch"}
                   if tiers else {}))
            for i in range(n)]


def long_requests(cls, vocab):
    """The reference's spilling stream: prompts of 272 and 288 tokens
    (past the 16-page HBM pool at a 512-token context)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, (272 + 16 * (i % 2),))
               for i in range(3)]
    return [cls(rid=i, prompt=p, max_new_tokens=4 + (i % 2))
            for i, p in enumerate(prompts)]


#: the streams a meshed engine is handed its rank's weight shards for,
#: cut before it is built (the others: the whole model's)
PRE_CUT = ("sampled",)
#: name -> (engine config keywords, serve keywords, stream, slots)
CASES = {
    "inline": (dict(), dict(), "short", 2),
    "overlap": (dict(overlap_migrations=True), dict(), "short", 2),
    "recency": (dict(policy="recency"), dict(), "short", 4),
    # 3 lanes over a data axis of 4: every rank holds every lane; with
    # SLO sheds
    "replicated": (dict(), dict(slo="tiers"), "short_tiers", 3),
    # with commit caps and a poisoned request
    "trace": (dict(max_context=512, attention_sparsity=0.5,
                   trace_telemetry=True), dict(faults="plane"), "long", 2),
    # a prefill budget under what the two lanes ask for at once: the
    # bucket's credits must reach the whole stream's demand
    "budget": (dict(prefill_budget=40), dict(), "short", 2),
    "sampled": (dict(), dict(sampling=SamplingConfig(temperature=0.9,
                                                     top_k=16), seed=7),
                "short", 2),
}


def engine_config(**kw) -> EngineConfig:
    """The reference mesh tests' engine, priced on the H100 spec."""
    base = dict(max_context=160, hbm_fraction=0.25, policy="importance",
                attention_sparsity=0.0, spec=H100, promote_thresh=1e-4,
                telemetry_stride=8, prefill_chunk=32)
    base.update(kw)
    return EngineConfig(**base)


#: the share of a plan's capacity each step may commit under the faults
COMMIT_FRAC = 0.25


def fault_plane(mod):
    """Commit caps at `COMMIT_FRAC` of the plan's capacity from step 0,
    and a poisoned request (rid 1) from step 11: of `mod` (the port's
    faults module, or the reference's)."""
    return mod.FaultPlane(
        migration=(mod.MigrationFault(start=0, stop=1000,
                                      commit_frac=COMMIT_FRAC),),
        poison=(mod.PoisonFault(rid=1, step=11),))


def fault_cap(lanes, layers=2, budget=1) -> int:
    """The rows a step may commit under `fault_plane` (the smoke
    config's 2 layers, a budget of one row a layer and lane at a 512-token
    context)."""
    return math.ceil(COMMIT_FRAC * layers * lanes * budget)


def slo_tiers(mod):
    """TTFT target 0 for "interactive" (shed while queued) and infinity
    for "batch": no shed depends on the clock."""
    inf = float("inf")
    return mod.SLOPolicy({"interactive": mod.SLOTarget(0.0, inf),
                          "batch": mod.SLOTarget(inf, inf)})


def stream(cls, name, vocab):
    kind = CASES[name][2]
    if kind == "long":
        return long_requests(cls, vocab)
    return short_requests(cls, vocab, tiers=kind == "short_tiers")


def serve_kwargs(name):
    kw = dict(CASES[name][1])
    if kw.get("faults") == "plane":
        kw["faults"] = fault_plane(tf)
    if kw.get("slo") == "tiers":
        kw["slo"] = slo_tiers(tslo)
    return kw


#: a paged cache's pools
POOLS = ("k_hbm", "v_hbm", "k_host", "v_host")


def pools_of(state):
    """The four pools of a decode state's cache as numpy (the port's
    engine's or the reference's)."""
    return {f: np.array(getattr(state, f)) for f in POOLS}


def outcome(eng, rep, plans=None, fractions=True):
    """What a served stream is judged by (numpy and plain Python); with
    `fractions`, the port's scores of a traced stream (a port engine's)."""
    reqs = list(rep.completed) + list(rep.rejected)
    out = {
        "outputs": {r.rid: list(r.output) for r in reqs},
        "statuses": {r.rid: (r.status, r.error.code if r.error else None)
                     for r in reqs},
        "events": [{k: v for k, v in e.items()
                    if not (e["kind"] == "slo_shed" and k == "reason")}
                   for e in rep.events],
        "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats],
        "pool_shape": tuple(eng.state.k_hbm.shape),
        "pools": pools_of(eng.state),
        "param_bytes": sum(t.nbytes for t in tree_leaves(eng.params)),
        "tables": {f: np.array(getattr(eng.state, f))
                   for f in ("page_table", "hbm_owner", "host_owner",
                             "importance")},
        "plans": plans,
    }
    if fractions and eng.cfg.trace_telemetry:
        agg = trace_bridge.score_serve(
            trace_bridge.collect_serve(eng), H100, sa_cfg=SAConfig(**SA),
            report=rep)["aggregate"]
        out["fractions"] = (agg["live_hit_fraction"],
                            agg.get("bound_fraction", 0.0))
    return out


def serve_case(name, model, params, mesh=None, device="cpu"):
    """Serve case `name` (see `CASES`), recording every plan the policy
    returns (its rows, stacked), on `mesh` when given."""
    from repro_torch.serving.scheduler import Request
    plans = []
    real = engine_mod.make_policy

    def recording(policy, *, cfg, geo):
        pol = real(policy, cfg=cfg, geo=geo)
        plan = pol.plan

        def rec(*a, **k):
            res = plan(*a, **k)
            plans.append(torch.stack([getattr(res[0], f.name) for f in
                                      dataclasses.fields(res[0])])
                         .cpu().numpy().copy())
            return res
        pol.plan = rec
        return pol
    engine_mod.make_policy = recording
    try:
        ekw, _, _, slots = CASES[name]
        eng = ServingEngine(model, params, engine_config(**ekw),
                            mesh=mesh, device=device)
        rep = eng.serve(stream(Request, name, model.cfg.vocab),
                        num_slots=slots, **serve_kwargs(name))
    finally:
        engine_mod.make_policy = real
    return outcome(eng, rep, plans,
                   fractions=mesh is None or dist.get_rank() == 0)


#: the single-stream cases: name -> lanes
STREAMS = {"stream": 2, "stream3": 3, "stream4": 4}
#: the serve -> start + generate -> serve case on one engine
AGAIN = "again"
#: prompt tokens of a single stream (19 pages, past the 16-page HBM
#: tier of a 512-token context) and its generate, run lengths
STREAM_PROMPT, GEN, RUN = 300, 12, 8


def stream_config(**kw):
    """The single stream's engine: a 512-token context, Quest sparsity
    0.5, trace capture and chunks of 4 steps (so generate and run span
    several)."""
    return engine_config(max_context=512, attention_sparsity=0.5,
                         trace_telemetry=True, telemetry_stride=4, **kw)


def stream_prompts(lanes, vocab, length=STREAM_PROMPT):
    return np.random.default_rng(9).integers(
        0, vocab, (lanes, length)).astype(np.int32)


def drive_stream(eng, prompts, asarray, numpy, collect, steps=(GEN, RUN)):
    """`start(prompts)`, `generate(GEN)` from its greedy token, the
    trace (`collect(eng)`), then `start` again, `run` teacher-forced over
    the first `RUN` tokens generate fed itself and one `step` with the
    next: the logits, tokens, every StepStats row's bytes, the trace and
    the rank's integer tables. `asarray` and `numpy` carry arrays into
    and out of the engine (the port's or the reference's)."""
    gen, run = steps
    logits = numpy(eng.start(asarray(prompts)))
    first = logits.argmax(-1).astype(np.int32)
    tokens = numpy(eng.generate(asarray(first), gen)).astype(np.int32)
    rec = collect(eng)
    trace = (np.asarray(rec.access), np.asarray(rec.tier),
             np.asarray(rec.moves))
    eng.start(asarray(prompts))
    fed = np.concatenate([first[None], tokens[:run - 1]])
    return {
        "start": logits, "tokens": tokens,
        "run": numpy(eng.run(asarray(fed))),
        "step": numpy(eng.step(asarray(tokens[run - 1]))),
        "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats],
        "trace": trace,
        "tables": {f: np.array(getattr(eng.state, f))
                   for f in ("page_table", "hbm_owner", "host_owner",
                             "length")},
        "pool_shape": tuple(eng.state.k_hbm.shape),
        "pools": pools_of(eng.state),
    }


def stream_case(name, model, params, mesh=None):
    """Single-stream case `name` (a key of `STREAMS`) on the port's
    engine, on `mesh` when given."""
    eng = ServingEngine(model, params, stream_config(), mesh=mesh,
                        device="cpu")
    return drive_stream(
        eng, stream_prompts(STREAMS[name], model.cfg.vocab),
        torch.from_numpy, lambda t: t.numpy(), trace_bridge.collect)


def again_case(eng, serve, prompts, judge):
    """`serve(eng)` (a served stream's report), `start(prompts)` +
    `generate(GEN)`, then `serve(eng)` again, on the one engine `eng`:
    each serve's `judge(eng, report)`, and the stream's start logits,
    tokens and step bytes."""
    out = {"serve": judge(eng, serve(eng))}
    logits = eng.start(torch.from_numpy(prompts))
    tokens = eng.generate(logits.argmax(-1).to(torch.int32), GEN)
    out["stream"] = {"start": logits.numpy(), "tokens": tokens.numpy(),
                     "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out)
                               for s in eng.stats]}
    out["served again"] = judge(eng, serve(eng))
    return out


def run_case(name, cfg, params, mesh=None):
    """Serve case, single-stream case or `AGAIN` `name` on the port's
    engine (`mesh` when given)."""
    if name in STREAMS:
        return stream_case(name, Model(cfg), params, mesh)
    if name == AGAIN:
        from repro_torch.serving.scheduler import Request
        eng = ServingEngine(Model(cfg), params, engine_config(), mesh=mesh,
                            device="cpu")
        return again_case(
            eng, lambda e: e.serve(stream(Request, "inline", cfg.vocab),
                                   num_slots=2),
            stream_prompts(2, cfg.vocab),
            lambda e, rep: outcome(e, rep, fractions=False))
    given = bridge.shard_params(params, cfg, mesh, mesh_coordinate(mesh)) \
        if mesh is not None and name in PRE_CUT else params
    return serve_case(name, Model(cfg), given, mesh)


def rank_main(rank, world, store, plan, params_path, out_dir):
    """One rank: join the gloo group of `world` ranks, then for each
    ((data, model), cases) of `plan` build that mesh over the first
    data x model ranks (the others take part in building it and serve
    nothing) and serve `cases` on it; pickle {(data, model): {"coord",
    case: outcome}} to out_dir/rank{rank}.pkl. One thread a rank: the
    ranks share the host's cores."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import AXES
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        cfg, params = torch.load(params_path, weights_only=False)
        res = {}
        for (data, model), cases in plan:
            n = data * model
            mesh = make_test_mesh(data, model) if n == world else \
                DeviceMesh("cpu", torch.arange(n).reshape(data, model),
                           mesh_dim_names=AXES)
            if rank >= n:
                continue
            res[(data, model)] = out = {"coord": mesh_coordinate(mesh)}
            for name in cases:
                out[name] = run_case(name, cfg, params, mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
