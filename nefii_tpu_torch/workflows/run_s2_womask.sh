#!/usr/bin/env bash
# Step 2 without masks: NeuS geometry import + gamma 2.2
# usage: ./run_s2_womask.sh thin_cube <neus_ckpt.pth> [flags...]
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENE=${1:-thin_cube}
GEOMETRY_NEUS=${2:?"pass the NeuS checkpoint (.pth with sdf_network_fine)"}

$LAUNCH -m nefii_tpu_torch.training.exp_runner \
  --conf "$REPO/confs/conf_neus.conf" \
  --data_split_dir "$DATA_PATH/$SCENE/train/" \
  --data_split_dir_test "$DATA_PATH/$SCENE/test/" \
  --exps_folder_name "$SAVE_PATH" \
  --expname "05_unknow_$SCENE" \
  --nepoch 2000 \
  --max_niter 200001 \
  --gamma 2.2 \
  --wo_mask \
  --batch_size 1 \
  --roughness_warmup 5000 \
  --coordinate_type blender \
  --memory_capacity_level 15 \
  --secondary_batch_size 1024 \
  --secondary_train_interval 10 \
  --freeze_geometry \
  --geometry_neus "$GEOMETRY_NEUS" \
  --device cuda \
  "${@:3}" \
 2>&1 | tee "run_s2_womask_$SCENE.log"
