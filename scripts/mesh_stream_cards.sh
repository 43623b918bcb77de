#!/usr/bin/env bash
# The single-stream path of a meshed engine across four cards under
# torchrun (scripts/mesh_stream.py): `start` of 4 prompts of 2304 tokens,
# then generate(64) twice (captured, then replayed), random bf16 weights,
# each rank holding only its shards; each output line stamped with the
# host clock (so a rank's exit can be timed against rank 0's "done").
# Run from the root of a checkout on a host with four cards:
#
#   bash scripts/mesh_stream_cards.sh   # qwen3-32b at data=1,model=4, then
#                                       # llama31-8b at data=2,model=2
#
# The kernels are built once first, so the ranks do not build them at
# once. Rank 0 prints the start wall time, ms per generated step and
# tokens/s, and every rank's weight, KV pool and peak bytes; for
# llama31-8b it then holds the meshed stream against an unmeshed engine
# on its own card (start logits, greedy tokens up to a near tie).
set -u
export PYTHONPATH=src OMP_NUM_THREADS=4
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stamp() { while IFS= read -r l; do printf '%s %s\n' "$(date +%s.%N)" "$l"; done; }
run() {   # arch data model
  echo "=== $1 data=$2 model=$3 start $(date +%s.%N)"
  timeout 900 python -m torch.distributed.run --standalone \
    --nproc-per-node $(($2 * $3)) scripts/mesh_stream.py --arch "$1" \
    --data "$2" --model "$3" 2>&1 | stamp
  echo "=== rc=${PIPESTATUS[0]} end $(date +%s.%N)"
}
python -c "from repro_torch.kernels import build; build.build_all()" \
  > /dev/null
run qwen3-32b 1 4
run llama31-8b 2 2
