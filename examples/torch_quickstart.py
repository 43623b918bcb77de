"""Quickstart on the PyTorch/CUDA port: reproduce the paper's core
result in ~1 minute on the host, with the port's own simulator
(`repro_torch.core`, numpy; no device is used).

Builds a clustered attention trace (LLaMA-3.1-8B byte accounting, GH200
memory system), scores all five placement strategies from the paper
plus our two extras, and prints the speedup table. Expected output:
SA-guided several-x faster than Static, approaching Unlimited-HBM.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""

from repro_torch.core.experiment import Workload, run_all
from repro_torch.core.sa import SAConfig
from repro_torch.core.tiers import GH200
from repro_torch.core.traces import synthetic_trace


def main():
    trace = synthetic_trace(
        prompt_len=30_000,   # ~30k-token LongBench-style prompt
        decode_len=1_000,    # decoded tokens (reduced from 10k for speed)
        sparsity=0.75,       # attention sparsity
        variation=0.3,       # token-importance drift
        seed=0)
    wl = Workload.llama31_8b()
    budget = 0.25 * (trace.prompt_len + trace.decode_len) \
        * wl.bytes_per_token_layer * wl.num_layers

    print(f"trace: {trace.num_pages} KV pages, {trace.num_steps} decode "
          f"steps, realized sparsity {trace.sparsity:.2f}")
    print(f"HBM KV budget: {budget / 1e9:.2f} GB "
          f"({0.25:.0%} of total KV)\n")

    results = run_all(
        trace, GH200, wl, budget,
        strategies=("unlimited", "static", "reactive", "quest", "sa",
                    "belady", "cost_aware"),
        sa_cfg=SAConfig(max_evaluations=80, seed=0))

    static = results["static"]
    print(f"{'strategy':24s} {'tokens/s':>10s} {'vs static':>10s} "
          f"{'HBM hit':>8s} {'migrated':>10s}")
    for name, r in results.items():
        print(f"{r.policy:24s} {r.tokens_per_s:10.1f} "
              f"{static.total_latency_s / r.total_latency_s:9.2f}x "
              f"{r.hbm_hit_rate:8.2f} {r.migrated_bytes / 1e9:8.1f}GB")

    sa = results["sa"]
    print(f"\nSA-guided upper bound: "
          f"{static.total_latency_s / sa.total_latency_s:.2f}x static "
          f"(paper: 4-5x typical, up to 5.87x)")


if __name__ == "__main__":
    main()
