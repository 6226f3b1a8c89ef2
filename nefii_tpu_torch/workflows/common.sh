# Shared configuration for the port's workflow scripts.
# Override via environment: DATA_PATH, SAVE_PATH, REPO, PYTHON, LAUNCH.
REPO=${REPO:-$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)}
DATA_PATH=${DATA_PATH:-/data/datasets/nefii/ds_physg}
SAVE_PATH=${SAVE_PATH:-exps}
PYTHON=${PYTHON:-python}
# how a training run starts: one process, or torchrun (run_sweep.sh)
LAUNCH=${LAUNCH:-$PYTHON -u}
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
