#!/usr/bin/env bash
exec "$(dirname "$0")/../run_s1.sh" coffee "$@"
