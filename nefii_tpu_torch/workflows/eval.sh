#!/usr/bin/env bash
# Decomposition metrics vs ground truth
# usage: ./eval.sh robot <render_dir> [flags...]
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENE=${1:-robot}
RENDER_DIR=${2:?"pass the render output dir"}

"$PYTHON" -u -m nefii_tpu_torch.scripts.evaluate "$RENDER_DIR" "$DATA_PATH/$SCENE/test/" \
  --device cuda "${@:3}"
