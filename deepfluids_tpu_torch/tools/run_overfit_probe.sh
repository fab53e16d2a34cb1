#!/bin/bash
# The matched-data overfit probe through the port's modules on the CUDA card
# (the JAX package's record is run smoke_overfit_m_ovfm in BENCHMARKS.jsonl):
# two matched smoke_pos21_size5 scenes of 200 frames generated by the port's
# datagen, the flagship generator trained 30 016 steps on them with the l2
# recipe of BENCHMARKS.md from the device cache (holdout off), then eval_run
# on 64 samples.  Each stage prints its wall time; the records go to the
# .jsonl named by the first argument.
#   bash deepfluids_tpu_torch/tools/run_overfit_probe.sh [out.jsonl]
set -eu
cd "$(dirname "$0")/../.."
OUT=${1:-BENCHMARKS_torch.jsonl}
DS=smoke_pos21_size5_m
RUN=logs/${DS}_ovfm
if [ -e "$RUN" ]; then
  echo "$RUN exists: move it away first" >&2
  exit 1
fi

stage() {
  local name=$1 t0
  shift
  t0=$(date +%s.%N)
  "$@"
  echo "=== $name wall $(awk "BEGIN {print $(date +%s.%N) - $t0}") s"
}

stage datagen python -m deepfluids_tpu_torch.tools.regen_all --only "$DS" \
  --num-a 2 --num-b 1 --out "$OUT"
stage train python -m deepfluids_tpu_torch.main --is_train true \
  --dataset "$DS" --loss_norm l2 --relative_loss true --beta1 0.9 \
  --lr_max 2e-4 --max_step 30016 --device_data_cache true \
  --eval_holdout_scenes 0 --tag ovfm
stage eval python -m deepfluids_tpu_torch.tools.eval_run "$RUN" 64 \
  "matched-data overfit probe" --out "$OUT"
