#!/usr/bin/env bash
# Render a PhySG-baseline experiment
# usage: ./render_physg.sh robot <expdir> [timestamp [flags...]]
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENE=${1:-robot}
EXPDIR=${2:?"pass the experiment dir"}
"$PYTHON" -u -m nefii_tpu_torch.scripts.render \
  --conf "$REPO/confs/physg.conf" \
  --data_split_dir "$DATA_PATH/$SCENE/test/" \
  --old_expdir "$EXPDIR" \
  --timestamp "${3:-latest}" \
  --num_rays -1 \
  --device cuda \
  "${@:4}" \
 2>&1 | tee "render_physg_$SCENE.log"
