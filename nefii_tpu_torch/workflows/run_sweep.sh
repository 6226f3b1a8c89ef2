#!/usr/bin/env bash
# Multi-scene training sweep (masked scenes). Each run starts one process
# per card under torchrun (NPROC, default: the cards nvidia-smi lists), each
# training its share of the ray batch.
# usage: ./run_sweep.sh "robot hotdog coffee fruit" <geometry_root> [flags...]
set -eo pipefail
source "$(dirname "$0")/common.sh"
SCENES=${1:-"robot hotdog coffee fruit"}
GEOM_ROOT=${2:?"pass the root dir containing <scene> Step-1 checkpoints"}
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}

for SCENE in $SCENES; do
  echo "=== training $SCENE on $NPROC card(s) ==="
  LAUNCH="torchrun --standalone --nproc_per_node=$NPROC" \
    "$(dirname "$0")/run_s2_wmask.sh" "$SCENE" "$GEOM_ROOT/$SCENE" "${@:3}"
done
