#!/usr/bin/env bash
# Step 1: SDF geometry from a mesh
# usage: ./run_s1.sh robot toy_robot.obj [flags...]
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENE=${1:-robot}
OBJ=${2:-$SCENE.obj}

$LAUNCH -m nefii_tpu_torch.training.geometry_runner \
  --conf "$REPO/confs/sdf.conf" \
  --mesh_path "$DATA_PATH/$SCENE/$OBJ" \
  --exps_folder_name "$SAVE_PATH" \
  --expname "01_s1_sdf_$SCENE" \
  --batch_size 16384 \
  --max_niter 800000 \
  --not_scale_to_unit \
  --device cuda \
  "${@:3}" \
 2>&1 | tee "run_s1_$SCENE.log"
