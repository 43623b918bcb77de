"""Roofline terms of the dry run (the port of the reference's
`launch/roofline.py`, same keys and formulas).

Three terms per (arch x shape x mesh) cell — all in seconds:

  compute    = FLOPs      / peak_FLOP/s    [H100: 989 TFLOP/s bf16]
  memory     = bytes      / HBM_bw         [H100: 3.35 TB/s]
  collective = coll_bytes / link_bw        [H100: NVLink; 0 bytes on
                                             one card]

FLOPs and bytes are `launch.op_cost`'s count of the cell's step (see
there for what they include). Also derives MODEL_FLOPS = 6*N*D
(training) or 2*N*D (inference; N the active parameters for moe) and
the usefulness ratio MODEL_FLOPS / counted FLOPs.

The reference parses collective bytes out of XLA's optimized HLO
(`collective_bytes_of_hlo`); the port has no HLO. A one-card run has no
collective; a twin-pod (`multi`) record's are those its rank-local step
called, counted as that function counts them
(`launch.op_cost.CountingRank`: a result's bytes, an all-reduce
twice), and priced, as the reference prices every axis, at one link
bandwidth (`ici_bw`: the H100's NVLink).
"""

from __future__ import annotations

import json
from typing import List

from repro_torch.core.tiers import H100_CHIP

RESULTS = "build/dryrun_results.jsonl"


def roofline_terms(rec: dict, chip=H100_CHIP) -> dict:
    """rec: one dry-run record -> roofline terms (seconds).

    flops/bytes/collectives are per-device costs of the cell's step."""
    n = rec["devices"]
    flops = rec["flops_per_device"]
    bytes_acc = rec["bytes_per_device"]
    coll = rec["collective_bytes_per_device"]["total"]
    compute_s = flops / chip.peak_flops_bf16
    memory_s = bytes_acc / chip.hbm_bw
    collective_s = coll / chip.ici_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]

    # MODEL_FLOPS: 6ND for training, 2ND per generated/processed token
    # for inference (forward only)
    n_active = rec["active_params"]
    tokens = rec["batch"] * (rec["seq"] if rec["kind"] != "decode" else 1)
    mult = 6 if rec["kind"] == "train" else 2
    model_flops = mult * n_active * tokens
    useful = (model_flops / n) / flops if flops > 0 else 0.0

    bound_s = max(compute_s, memory_s, collective_s)
    roofline_fraction = (model_flops / (n * chip.peak_flops_bf16)) / bound_s \
        if bound_s > 0 else 0.0

    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops": flops,
        "useful_flops_ratio": useful,
        "roofline_fraction": roofline_fraction,
    }


def load_results(path: str = RESULTS) -> List[dict]:
    """Load dry-run records, keeping the last one per (arch, shape, mesh)."""
    dedup = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                r = json.loads(line)
                dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return list(dedup.values())


def table(path: str = RESULTS, chip=H100_CHIP) -> str:
    """Render the roofline terms of every cell as an aligned text table."""
    rows = []
    header = (f"{'arch':26s} {'shape':12s} {'mesh':6s} {'dom':10s} "
              f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
              f"{'useful':>7s} {'roofl%':>7s}")
    rows.append(header)
    rows.append("-" * len(header))
    for r in sorted(load_results(path),
                    key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r.get("status") != "ok":
            rows.append(f"{r['arch']:26s} {r['shape']:12s} "
                        f"{r.get('mesh', '-'):6s} {r['status'].upper()}"
                        + (f" ({r.get('reason', '')[:60]})"
                           if r.get("reason") else ""))
            continue
        t = roofline_terms(r, chip)
        rows.append(
            f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} "
            f"{t['dominant']:10s} {t['compute_s']:10.2e} "
            f"{t['memory_s']:10.2e} {t['collective_s']:10.2e} "
            f"{t['useful_flops_ratio']:7.2f} "
            f"{100 * t['roofline_fraction']:6.1f}%")
    return "\n".join(rows)


if __name__ == "__main__":
    import sys
    print(table(sys.argv[1] if len(sys.argv) > 1 else RESULTS))
