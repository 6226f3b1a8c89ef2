#!/usr/bin/env bash
# Convert a NeuS dataset (cameras_sphere.npz) into a NeFII scene dir
# usage: ./neus2nefii.sh <neus_scene_dir> <out_scene_dir> [neus|netease]
# (numpy on the host: the converter takes no --device)
set -eo pipefail
source "$(dirname "$0")/common.sh"
"$PYTHON" -m nefii_tpu_torch.scripts.converters neus2physg "${1:?src}" "${2:?dst}" "${3:-neus}" \
  "${@:4}"
