#!/bin/bash
# Test runner: the CPU backend (the tile kernel runs in the Pallas
# interpreter where a test asks for it).
cd "$(dirname "$0")/.." || exit 1
exec env JAX_PLATFORMS=cpu python -m pytest tests/ "$@"
