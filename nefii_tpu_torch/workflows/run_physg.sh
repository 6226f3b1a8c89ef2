#!/usr/bin/env bash
# PhySG baseline: closed-form SG shading with global materials
# usage: ./run_physg.sh robot [<geometry_ckpt> [flags...]]  ("" for no geometry)
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENE=${1:-robot}
GEOMETRY=${2:-}

ARGS=()
[ -n "$GEOMETRY" ] && ARGS+=(--freeze_geometry --geometry "$GEOMETRY")
$LAUNCH -m nefii_tpu_torch.training.exp_runner \
  --conf "$REPO/confs/physg.conf" \
  --data_split_dir "$DATA_PATH/$SCENE/train/" \
  --data_split_dir_test "$DATA_PATH/$SCENE/test/" \
  --exps_folder_name "$SAVE_PATH" \
  --expname "physg_$SCENE" \
  --nepoch 2000 \
  --max_niter 150001 \
  --gamma 1.0 \
  --batch_size 1 \
  "${ARGS[@]}" \
  --device cuda \
  "${@:3}" \
 2>&1 | tee "run_physg_$SCENE.log"
