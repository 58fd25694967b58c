#!/usr/bin/env bash
# Fetch the public pretrained AlexNet weights (bvlc_alexnet.npy) that the
# port's DCNN weight import reads (models/alexnet.py, load_bvlc_weights;
# the port's copy of video_learning_tpu/models/get_alexnet_weights.sh,
# same public source).  Point a pipeline's `weights_file` at the file,
# and pin it with `python -m video_learning_tpu_torch.tools.validate_pretrained`.
# Usage: get_alexnet_weights.sh [out.npy]
set -euo pipefail
URL="https://www.cs.toronto.edu/~guerzhoy/tf_alexnet/bvlc_alexnet.npy"
OUT="${1:-bvlc_alexnet.npy}"
echo "Downloading $URL -> $OUT"
curl -L -o "$OUT" "$URL" || wget -O "$OUT" "$URL"
