#!/usr/bin/env bash
# Committed suite runner (the reference locks its suite in with GitHub
# Actions, .github/workflows/CI.yml; this is the one-command local
# equivalent and the entry the CI workflow calls).
#
# The conftest already defaults to CPU + 8 virtual devices + f64; this
# script pins the platform before the interpreter starts.
set -euo pipefail
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu
export PYTHONPATH="$(pwd)${PYTHONPATH:+:$PYTHONPATH}"
exec python -m pytest tests/ -q "$@"
