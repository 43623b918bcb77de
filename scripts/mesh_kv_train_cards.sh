#!/usr/bin/env bash
# Training across a `model` axis that does not divide the KV heads, on
# cards under torchrun, each output line stamped with the host clock (so
# a rank's exit can be timed against rank 0's "done"). Run from the root
# of a checkout on a host with four cards:
#
#   bash scripts/mesh_kv_train_cards.sh
#
# 1. internlm2-1.8b at full width on three cards, data=1,model=3 (16
#    heads and 8 KV heads over 3: heads and MLP whole on every rank, the
#    vocabulary split): 10 steps of the train CLI (B=8 x S=512), the
#    entry point a user runs, which prints every rank's bytes and peak
#    and one average ms a step over its 10 steps, the first included;
#    then 3 steps of scripts/mesh_family_step.py, the run that holds the
#    steps: rank 0 takes them again unmeshed on its card and holds the
#    losses, grad norms and each leaf's m to them (CHECK OK), and prints
#    each step's ms;
# 2. whisper-tiny on four cards, data=1,model=4 (6 heads over 4: heads
#    whole, the MLP split; 1500 frame embeddings): 10 steps of
#    scripts/mesh_family_step.py, held the same way.
#
# The kernels are built once first, so the ranks do not build them at
# once.
set -u
export PYTHONPATH=src OMP_NUM_THREADS=4
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stamp() { while IFS= read -r l; do printf '%s %s\n' "$(date +%s.%N)" "$l"; done; }
launch() {   # label ranks [arguments]
  local label=$1 ranks=$2
  shift 2
  echo "=== $label start $(date +%s.%N)"
  timeout 900 python -m torch.distributed.run --standalone \
    --nproc-per-node "$ranks" "$@" 2>&1 | stamp
  echo "=== $label rc=${PIPESTATUS[0]} end $(date +%s.%N)"
}
python -c "from repro_torch.kernels import build; build.build_all()" \
  > /dev/null
launch "train cli internlm2-1.8b data=1 model=3" 3 \
  -m repro_torch.launch.train --arch internlm2-1.8b --data 1 --model 3 \
  --seq 513 --batch 8 --steps 10 --lr 1e-4
launch "check internlm2-1.8b data=1 model=3" 3 scripts/mesh_family_step.py \
  --arch internlm2-1.8b --data 1 --model 3 --steps 3
launch "check whisper-tiny data=1 model=4" 4 scripts/mesh_family_step.py \
  --arch whisper-tiny --data 1 --model 4 --steps 10
