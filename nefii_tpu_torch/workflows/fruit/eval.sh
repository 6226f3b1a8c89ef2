#!/usr/bin/env bash
exec "$(dirname "$0")/../eval.sh" fruit "$@"
