#!/usr/bin/env bash
# The train CLI across four cards under torchrun, at internlm2-1.8b's
# full width (B=8 x S=512 tokens a step; `families`: zamba2-1.2b's and
# whisper-tiny's), each output line stamped with
# the host clock (so a rank's exit can be timed against rank 0's
# "done"). Run from the root of a checkout on a host with four cards:
#
#   bash scripts/mesh_train_cards.sh ckpt    # data=2,model=2: 10 steps and
#                                            # a checkpoint; then data=1,
#                                            # model=4 auto-resumes it, 2
#                                            # more steps and a checkpoint
#   bash scripts/mesh_train_cards.sh steps   # 20 steps at each mesh, the
#                                            # kernels built first, no
#                                            # checkpoint (ms per step)
#   bash scripts/mesh_train_cards.sh families  # zamba2-1.2b (hybrid) at
#                                            # data=2,model=2: 10 steps of
#                                            # the train CLI; whisper-tiny
#                                            # (encdec, 1500 frame
#                                            # embeddings) at data=1,
#                                            # model=2 on two of the cards:
#                                            # 10 steps of
#                                            # scripts/mesh_family_step.py
#                                            # (the CLI feeds no frames)
set -u
export PYTHONPATH=src OMP_NUM_THREADS=4
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stamp() { while IFS= read -r l; do printf '%s %s\n' "$(date +%s.%N)" "$l"; done; }
run() {   # data model steps [more arguments]
  local data=$1 model=$2 steps=$3
  shift 3
  echo "=== data=$data model=$model steps=$steps start $(date +%s.%N)"
  timeout 1000 python -m torch.distributed.run --standalone \
    --nproc-per-node $((data * model)) -m repro_torch.launch.train \
    --arch "${ARCH:-internlm2-1.8b}" --data "$data" --model "$model" \
    --seq 513 --batch 8 --steps "$steps" "$@" 2>&1 | stamp
  echo "=== rc=${PIPESTATUS[0]} end $(date +%s.%N)"
}
case "${1:-}" in
  ckpt)
    ck=$(mktemp -d)
    run 2 2 10 --ckpt-every 100 --ckpt-dir "$ck"
    run 1 4 12 --ckpt-every 100 --ckpt-dir "$ck"
    ls "$ck"; du -sh "$ck"; rm -rf "$ck" ;;
  steps)
    python -c "from repro_torch.kernels import build; build.build_all()" \
      > /dev/null
    run 2 2 20
    run 1 4 20 ;;
  families)
    python -c "from repro_torch.kernels import build; build.build_all()" \
      > /dev/null
    ARCH=zamba2-1.2b run 2 2 10
    echo "=== whisper-tiny data=1 model=2 start $(date +%s.%N)"
    timeout 600 python -m torch.distributed.run --standalone \
      --nproc-per-node 2 scripts/mesh_family_step.py --arch whisper-tiny \
      --data 1 --model 2 --steps 10 2>&1 | stamp
    echo "=== rc=${PIPESTATUS[0]} end $(date +%s.%N)" ;;
  *) echo "usage: $0 ckpt|steps|families" >&2; exit 2 ;;
esac
