"""Quick look into saved validation logits: the argmax run-length
encoding and the predicted-class histogram.

The port's counterpart of ``video_learning_tpu/tools/view_logits_info.py``
(host numpy, the same lines).

Usage: python -m video_learning_tpu_torch.tools.view_logits_info
           <logits.pickle>
"""


import itertools
import pickle
import sys
from collections import Counter

import numpy as np

from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def view(logits_path):
    with open(logits_path, "rb") as f:
        logits = np.asarray(pickle.load(f))
    amax = np.argmax(logits, axis=1)
    rle = [(k, len(list(g))) for k, g in itertools.groupby(amax)]
    hist = Counter(amax.tolist())
    info("%d logits rows, %d classes" % (logits.shape[0], logits.shape[1]))
    info("argmax RLE (class, runlength): %s"
         % (rle[:50] + (["..."] if len(rle) > 50 else [])))
    for cls, n in hist.most_common():
        info("class %4d predicted %6d times" % (cls, n))
    return {"rle": rle, "histogram": dict(hist)}


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: view_logits_info <logits.pickle>")
    return view(argv[-1])


if __name__ == "__main__":
    main()
