#!/usr/bin/env bash
# Novel-view decomposition rendering with 256-ray anti-aliasing
# usage: ./render.sh robot <expdir> [timestamp [flags...]]
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENE=${1:-robot}
EXPDIR=${2:?"pass the Step-2 experiment dir"}
TIMESTAMP=${3:-latest}

"$PYTHON" -u -m nefii_tpu_torch.scripts.render \
  --conf "$REPO/confs/conf.conf" \
  --data_split_dir "$DATA_PATH/$SCENE/test/" \
  --old_expdir "$EXPDIR" \
  --timestamp "$TIMESTAMP" \
  --gamma 1.0 \
  --coordinate_type blender \
  --memory_capacity_level 18 \
  --num_rays 256 \
  --device cuda \
  "${@:4}" \
 2>&1 | tee "render_$SCENE.log"
