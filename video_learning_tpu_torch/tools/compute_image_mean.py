"""Mean-image computation over a packed record file.

The port's copy of ``video_learning_tpu/tools/compute_image_mean.py``:
streams every frame, accumulates the pixel mean, and writes (a) the
pickled mean image, (b) a PNG preview where PIL is installed (skipped
otherwise), (c) the 3-scalar per-channel means in the format the
``mean_image`` dataset config expects.  (a) and (c) are always written.

Usage: python -m video_learning_tpu_torch.tools.compute_image_mean <file>
"""

import os
import pickle
import sys

import numpy as np

from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def compute_mean(record_path):
    reader = records.RecordReader(record_path)
    total = None
    count = 0
    for kind, data, _ in reader:
        if kind != records.KIND_IMAGE:
            error("Non-image record in %s" % record_path)
        if total is None:
            total = np.zeros(data.shape, np.float64)
        total += data
        count += 1
    reader.close()
    if not count:
        error("Empty record file %s" % record_path)
    return total / count, count


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: compute_image_mean <file.tfrecord>")
    record_path = argv[-1]
    mean, count = compute_mean(record_path)
    base = record_path + ".mean"
    with open(base + ".pickle", "wb") as f:
        pickle.dump(mean, f)
    try:
        from PIL import Image
        Image.fromarray(mean.astype(np.uint8)).save(base + ".png")
    except Exception:
        pass
    channel_means = mean.reshape(-1, mean.shape[-1]).mean(axis=0)
    with open(base + ".txt", "w") as f:
        f.write(" ".join("%f" % m for m in channel_means) + "\n")
    info("Mean over %d frames: per-channel %s (written to %s.*)"
         % (count, channel_means.tolist(), os.path.basename(base)))
    return channel_means


if __name__ == "__main__":
    main()
