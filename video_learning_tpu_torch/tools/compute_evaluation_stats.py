"""Macro / micro precision, recall and F1 from saved validation logits
and ground truth.

The port's counterpart of
``video_learning_tpu/tools/compute_evaluation_stats.py`` (host numpy, the
same lines).

Usage:
  python -m video_learning_tpu_torch.tools.compute_evaluation_stats \\
      <logits.pickle> <gt_paths_file> <num_classes>
"""


import pickle
import sys

import numpy as np

from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def prf1(predictions, labels, num_classes):
    """Per-class + macro/micro precision, recall, F1."""
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    for c in range(num_classes):
        tp[c] = np.sum((predictions == c) & (labels == c))
        fp[c] = np.sum((predictions == c) & (labels != c))
        fn[c] = np.sum((predictions != c) & (labels == c))

    def safe_div(a, b):
        return np.where(b > 0, a / np.maximum(b, 1), 0.0)

    prec = safe_div(tp, tp + fp)
    rec = safe_div(tp, tp + fn)
    f1 = safe_div(2 * prec * rec, prec + rec)
    micro_p = tp.sum() / max(tp.sum() + fp.sum(), 1)
    micro_r = tp.sum() / max(tp.sum() + fn.sum(), 1)
    micro_f = (2 * micro_p * micro_r / (micro_p + micro_r)
               if micro_p + micro_r > 0 else 0.0)
    return {
        "per_class": {"precision": prec.tolist(), "recall": rec.tolist(),
                      "f1": f1.tolist()},
        "macro": {"precision": float(prec.mean()),
                  "recall": float(rec.mean()), "f1": float(f1.mean())},
        "micro": {"precision": float(micro_p), "recall": float(micro_r),
                  "f1": float(micro_f)},
        "accuracy": float(np.mean(predictions == labels)),
    }


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 4:
        error("Usage: compute_evaluation_stats <logits.pickle> "
              "<gt_paths_file> <num_classes>")
    with open(argv[-3], "rb") as f:
        logits = np.asarray(pickle.load(f))
    labels = []
    with open(argv[-2]) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                labels.append(int(parts[1]))
    num_classes = int(argv[-1])
    if len(logits) != len(labels):
        error("%d logits vs %d labels" % (len(logits), len(labels)))
    stats = prf1(np.argmax(logits, 1), labels, num_classes)
    info("accuracy: %.4f" % stats["accuracy"])
    for level in ("macro", "micro"):
        info("%s P/R/F1: %.4f / %.4f / %.4f"
             % (level, stats[level]["precision"], stats[level]["recall"],
                stats[level]["f1"]))
    return stats


if __name__ == "__main__":
    main()
