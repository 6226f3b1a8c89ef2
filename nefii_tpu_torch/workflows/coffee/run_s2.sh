#!/usr/bin/env bash
exec "$(dirname "$0")/../run_s2_wmask.sh" coffee "$@"
