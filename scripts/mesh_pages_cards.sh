#!/usr/bin/env bash
# Serving across a `model` axis that does not divide the KV heads, on
# cards under torchrun (the reference's `pages` and `none` KV pool
# rules), each output line stamped with the host clock (so a rank's
# exit can be timed against rank 0's last line). Run from the root of a
# checkout on a host with four cards:
#
#   bash scripts/mesh_pages_cards.sh
#
# 1. the serve CLI on the internlm2 smoke config (2 KV heads) at
#    data=1,model=4 with --parity: the `pages` rule (each rank's pools a
#    quarter of each tier's slots), rank 0 holding the meshed stream to
#    an unmeshed engine on its card (MESH PARITY OK);
# 2. internlm2-1.8b at full width on three cards, data=1,model=3 (8 KV
#    heads and 16 heads over 3: the `none` rule, pools and heads whole,
#    the vocabulary split), through scripts/mesh_stream.py: `start` of 4
#    prompts of 2304 tokens and generate(64) twice (captured, then
#    replayed); rank 0 then holds the stream against an unmeshed engine
#    on its card after the group is gone.
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
launch "serve cli smoke parity data=1 model=4" 4 -m repro_torch.launch.serve \
  --smoke --parity --mesh data=1,model=4 --requests 3 --new-tokens 3 \
  --batch-slots 2 --stride 8
launch "stream internlm2-1.8b data=1 model=3" 3 scripts/mesh_stream.py \
  --arch internlm2-1.8b --data 1 --model 3
