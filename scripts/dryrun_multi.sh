#!/usr/bin/env bash
# The dry run's twin-pod records of every cell, then their roofline table.
#
# Runs `python -m repro_torch.launch.dryrun --mesh multi` (one subprocess
# a cell, each counting one card's rank-local step with its collectives on
# the meta device: host only, no card), prints the sweep's wall time and
# its `fail` records, then `python -m repro_torch.launch.roofline` over the
# results: compute, memory and collective terms of every multi record,
# modeled on the H100's datasheet peaks.
#
#   bash scripts/dryrun_multi.sh [RESULTS]    # default build/dryrun_results.jsonl
#
# A result file that exists is appended to (the roofline keeps the last
# record of each cell). xlstm-125m's train_4k and prefill_32k replay its
# sLSTM per token and take minutes each.
set -euo pipefail
cd "$(dirname "$0")/.."
out=${1:-build/dryrun_results.jsonl}
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
start=$(date +%s)
python -m repro_torch.launch.dryrun --mesh multi --out "$out"
echo "sweep: $(( $(date +%s) - start )) s wall"
echo "fail records: $(grep -c '"status": "fail"' "$out" || true)"
python -m repro_torch.launch.roofline "$out"
