#!/usr/bin/env bash
# Batch spectrogram extraction: runs the port's extractor over every wav
# under a directory (the port's copy of
# video_learning_tpu/audio/extract_spectrograms.sh).
# Usage: extract_spectrograms.sh <wav_dir> <out_dir>
set -euo pipefail
WAV_DIR="${1:?wav dir}"; OUT_DIR="${2:?out dir}"
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
find "$WAV_DIR" -name '*.wav' -print0 | xargs -0 \
  env PYTHONPATH="$REPO" python3 -m video_learning_tpu_torch.audio.spectrograms "$OUT_DIR"
