#!/usr/bin/env bash
exec "$(dirname "$0")/../render.sh" coffee "$@"
