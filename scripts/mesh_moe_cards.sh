#!/usr/bin/env bash
# The moe family across four cards under torchrun, at
# granite-moe-3b-a800m's full width (48 padded experts split over
# `model`), each output line stamped with the host clock (so a rank's
# exit can be timed against rank 0's last line). Run from the root of a
# checkout on a host with four cards:
#
#   bash scripts/mesh_moe_cards.sh serve   # the serve CLI at data=1,
#                                          # model=4 and data=2, model=2:
#                                          # 8 requests of 1024-1056
#                                          # prompt tokens, 32-36 new,
#                                          # through 8 lanes
#   bash scripts/mesh_moe_cards.sh train   # the train CLI at data=2,
#                                          # model=2: 10 steps of B=8 x
#                                          # S=512, no checkpoint
#   bash scripts/mesh_moe_cards.sh all     # both
#
# The kernels are built once first, so the ranks do not build them at
# once. Rank 0 prints its weight bytes beside the whole model's (the
# serve CLI) or every rank's weight, m/v and peak bytes (the train CLI).
set -u
export PYTHONPATH=src OMP_NUM_THREADS=4
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stamp() { while IFS= read -r l; do printf '%s %s\n' "$(date +%s.%N)" "$l"; done; }
launch() {   # label module [arguments]
  local label=$1 module=$2
  shift 2
  echo "=== $label start $(date +%s.%N)"
  timeout 900 python -m torch.distributed.run --standalone \
    --nproc-per-node 4 -m "$module" --arch granite-moe-3b-a800m "$@" 2>&1 \
    | stamp
  echo "=== $label rc=${PIPESTATUS[0]} end $(date +%s.%N)"
}
serve() {   # data model
  launch "serve data=$1 model=$2" repro_torch.launch.serve \
    --mesh "data=$1,model=$2" --requests 8 --prompt-len 1024 \
    --new-tokens 32 --batch-slots 8 --stride 16
}
train() {   # data model steps
  launch "train data=$1 model=$2 steps=$3" repro_torch.launch.train \
    --data "$1" --model "$2" --seq 513 --batch 8 --steps "$3"
}
python -c "from repro_torch.kernels import build; build.build_all()" \
  > /dev/null
case "${1:-}" in
  serve) serve 1 4; serve 2 2 ;;
  train) train 2 2 10 ;;
  all) serve 1 4; serve 2 2; train 2 2 10 ;;
  *) echo "usage: $0 serve|train|all" >&2; exit 2 ;;
esac
