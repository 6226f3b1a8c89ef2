#!/usr/bin/env bash
# Step 2: material + environment light with masks
# usage: ./run_s2_wmask.sh robot <geometry_ckpt_dir_or_pth> [flags...]
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENE=${1:-robot}
GEOMETRY=${2:?"pass the Step-1 geometry checkpoint (dir or .pth)"}

$LAUNCH -m nefii_tpu_torch.training.exp_runner \
  --conf "$REPO/confs/conf.conf" \
  --data_split_dir "$DATA_PATH/$SCENE/train/" \
  --data_split_dir_test "$DATA_PATH/$SCENE/test/" \
  --exps_folder_name "$SAVE_PATH" \
  --expname "00_s2_unknow_$SCENE" \
  --nepoch 2000 \
  --max_niter 200001 \
  --gamma 1.0 \
  --batch_size 1 \
  --roughness_warmup 5000 \
  --coordinate_type blender \
  --secondary_batch_size 1024 \
  --secondary_train_interval 10 \
  --freeze_geometry \
  --geometry "$GEOMETRY" \
  --memory_capacity_level 18 \
  --device cuda \
  "${@:3}" \
 2>&1 | tee "run_s2_$SCENE.log"
