"""End-to-end serving driver on the PyTorch/CUDA port: batched requests
through the two-tier paged KV cache with dynamic placement.

Pipeline: train a small model briefly (so generations aren't pure
noise) -> prefill a prompt -> decode under EVERY registered placement
policy (static / importance / recency / cost_aware / quest) with
Quest-style sparsity, scoring each against the paper's SA upper bound
through the live-telemetry simulator bridge — then
`ServingEngine.serve`: a mixed-length request stream continuously
batched with sampling and serve-stream trace capture, so every request
comes back with its own attributed hit/bound fractions and the stream
reports its aggregate headroom.

On the card (the default) training runs the flash kernel forward and
backward, prefill the flash kernel, decode the paged-attention kernel
and every token write the row-copy kernel.

Run:  PYTHONPATH=src python examples/torch_serve_two_tier.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.sa import SAConfig
from repro_torch.core.tiers import GH200
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models.model import Model
from repro_torch.serving import trace_bridge
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.policies import policy_names
from repro_torch.serving.sampling import SamplingConfig
from repro_torch.serving.scheduler import Request
from repro_torch.training.train_step import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_smoke("internlm2-1.8b")
    model = Model(cfg)

    # --- brief training so the model has actual structure ----------------
    state = init_train_state(model, 0, device)
    step = make_train_step(model, lr=5e-3)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=64,
                                        global_batch=8))
    for i in range(30):
        state, metrics = step(state, {"tokens": torch.as_tensor(
            corpus.batch(0, i)["tokens"], device=device)})
    print(f"trained 30 steps, loss {float(metrics['loss']):.3f}")

    # --- the policy plane: every registered policy, scored live against
    # the SA upper bound by the telemetry bridge -------------------------
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(corpus.batch(0, 99)["tokens"][:1, :64],
                              device=device)
    sa_cfg = SAConfig(max_evaluations=16, iters_per_level=4, seed=0)
    for policy in policy_names():
        # max_context 384 -> a 16-page HBM pool + 16 host pages: the
        # 320-token stream below spills past HBM without overrunning
        # the cache
        eng = ServingEngine(model, state.params, EngineConfig(
            max_context=384, hbm_fraction=0.25, policy=policy,
            attention_sparsity=0.6, spec=GH200, promote_thresh=0.005,
            trace_telemetry=True), device=device)
        eng.start(prompts)
        # decode far enough that the stream spills past the 16-page HBM
        # pool and placement decisions actually bite
        tok = torch.argmax(eng.step(prompts[:, -1]), -1).to(torch.int32)
        eng.generate(tok, 255)
        score = trace_bridge.score_headroom(
            trace_bridge.collect(eng), GH200, sa_cfg=sa_cfg)
        s = eng.summary()
        print(f"policy={policy:11s} modeled {s['modeled_tokens_per_s']:12.0f}"
              f" tok/s  hit={score['live_hit_fraction']:.2f}"
              f"  of-SA-bound={score['bound_fraction']:.2f}"
              f"  migrated={s['migrated_bytes'] / 1e6:.1f}MB")

    # --- continuous batching: a live request stream through serve(),
    # with serve-stream trace capture + per-request attribution --------
    eng = ServingEngine(model, state.params, EngineConfig(
        max_context=256, hbm_fraction=0.25, policy="importance",
        attention_sparsity=0.5, spec=GH200, promote_thresh=0.005,
        telemetry_stride=8, trace_telemetry=True), device=device)
    # 272-304-token prompts spill past the 16-page (256-token) per-lane
    # HBM pool, so per-request placement quality actually varies
    stream = [Request(rid=rid,
                      prompt=rng.integers(0, cfg.vocab,
                                          (272 + 16 * (rid % 3),)),
                      max_new_tokens=8 + 4 * (rid % 3))
              for rid in range(10)]
    done = eng.serve(stream, num_slots=4,
                     sampling=SamplingConfig(temperature=0.8, top_k=50),
                     seed=0)
    waits = [r.started_step - r.arrived_step for r in done]
    total = sum(len(r.output) for r in done)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"serve: {len(done)} requests, {total} sampled tokens on {where}, "
          f"mean admission wait {np.mean(waits):.1f} steps, "
          f"pages balanced="
          f"{eng.batcher.free_pages == eng.batcher.total_pages}")
    if done.ttft:
        print(f"  ttft p50={done.ttft['p50'] * 1e3:.1f}ms "
              f"p95={done.ttft['p95'] * 1e3:.1f}ms   "
              f"tpot p50={done.tpot['p50'] * 1e3:.2f}ms "
              f"p95={done.tpot['p95'] * 1e3:.2f}ms")
    first = min(done, key=lambda r: r.rid)
    print(f"  rid=0 sampled: {first.output}")

    # the serve-trace bridge: stitch each request's decode stream out
    # of the shared batch and score it (and the aggregate) against the
    # SA bound — placement quality per request, under real lane churn
    rec = trace_bridge.collect_serve(eng)
    trace_bridge.score_serve(rec, GH200, sa_cfg=sa_cfg, report=done)
    agg = done.headroom
    print(f"  stream headroom: hit={agg['live_hit_fraction']:.2f} "
          f"of-SA-bound={agg['bound_fraction']:.2f} over "
          f"{agg['requests']:.0f} requests / {agg['decode_steps']:.0f} "
          f"decode steps")
    for rid in sorted(done.request_scores):
        sc = done.request_scores[rid]
        print(f"    rid={rid:2d} hit={sc['hit_fraction']:.2f} "
              f"of-SA-bound={sc['bound_fraction']:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
