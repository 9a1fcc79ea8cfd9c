#!/bin/sh
# Build + run everything (the reference's run.sh analog: compile shaders ->
# build -> run; here: install package -> build native lib -> generate a
# dataset if absent -> run the full battery).
set -e

IMAGE="${1:-Animations/CornellBox/Animation01_LDR_0003.png}"

pip install -e . --no-build-isolation --no-deps -q
make -C native -s

if [ ! -f "$IMAGE" ]; then
    echo "generating synthetic dataset (reference dataset is external)..."
    python tools/make_dataset.py "$(dirname "$IMAGE")" --frames 10 --size 240x320
fi

idf-denoise "$IMAGE"
