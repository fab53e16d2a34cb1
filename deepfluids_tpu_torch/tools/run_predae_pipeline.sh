#!/bin/bash
# The prediction-aware autoencoder pipeline (--ae_pred_w) on the smoke_mov
# family, through the port's modules on the CUDA card (counterpart of the
# JAX package's tools/run_predae_pipeline.sh, the same stages and flags):
# AE (pair batches + co-trained predictor) -> recon evals -> encode code64p ->
# predictability probe -> integrator on the new codes -> 400-step holdout eval.
# Run from anywhere: bash deepfluids_tpu_torch/tools/run_predae_pipeline.sh
set -u
cd "$(dirname "$0")/../.."
PY="python -m deepfluids_tpu_torch.main"
AE=logs/smoke_mov200_f400_m_aez64p

echo "=== AE pred train start $(date +%T)"
python -m deepfluids_tpu_torch.tools.supervise --restart_on any --max_restarts 10 -- \
  --arch ae --dataset smoke_mov200_f400_m --z_num 64 --loss_norm l2 --beta1 0.9 \
  --eval_holdout_scenes 5 --steps_per_call 16 --device_data_cache true \
  --ae_pred_w 1.0 --watchdog_secs 300 --tag aez64p 2>/dev/null
echo "=== AE done rc=$? $(date +%T)"

echo "=== AE eval holdout $(date +%T)"
timeout 3600 python -m deepfluids_tpu_torch.tools.eval_run $AE 128 \
  "r5 prediction-aware AE z=64 pred_w=1 (holdout recon)" 2>/dev/null
echo "=== AE eval train pool $(date +%T)"
timeout 3600 python -m deepfluids_tpu_torch.tools.eval_run $AE 128 \
  "r5 prediction-aware AE z=64 pred_w=1 (train pool)" --pool train 2>/dev/null

echo "=== encode start $(date +%T)"
timeout 7200 $PY --arch ae --is_train false --dataset smoke_mov200_f400_m \
  --load_path $AE --code_suffix p 2>/dev/null
echo "=== encode done rc=$? $(date +%T)"

echo "=== probe on code64p $(date +%T)"
timeout 1800 python -m deepfluids_tpu_torch.tools.latent_predictability data/smoke_mov200_f400_m 64 5 p \
  "r5 pred-aware AE codes: H=1" 2>/dev/null
timeout 1800 python -m deepfluids_tpu_torch.tools.latent_predictability data/smoke_mov200_f400_m 64 5 p \
  --history 4 "r5 pred-aware AE codes: H=4" 2>/dev/null

echo "=== nn train start $(date +%T)"
python -m deepfluids_tpu_torch.tools.supervise --restart_on any --max_restarts 10 -- \
  --arch nn --dataset smoke_mov200_f400_m --z_num 64 --w_num 60 --nn_noise 0.03 \
  --eval_holdout_scenes 5 --code_suffix p --ae_load_path $AE --watchdog_secs 300 --tag nnz64p 2>/dev/null
echo "=== nn done rc=$? $(date +%T)"

echo "=== nn eval $(date +%T)"
timeout 5400 python -m deepfluids_tpu_torch.tools.eval_run logs/smoke_mov200_f400_m_nnz64p 5 \
  "r5 integrator on prediction-aware codes (H=1, w=60, noise .03)" --profile_scenes 5 2>/dev/null
echo "=== pipeline done $(date +%T)"
