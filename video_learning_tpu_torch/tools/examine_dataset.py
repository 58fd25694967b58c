"""Dataset statistics: label distribution and chance accuracies.

The port's counterpart of ``video_learning_tpu/tools/examine_dataset.py``:
reads a ``path label...`` list file and reports per-class counts, the
majority-class (ZeroR) accuracy and the uniform-chance accuracy.

Usage: python -m video_learning_tpu_torch.tools.examine_dataset <paths_file>
"""


import sys
from collections import Counter

from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def examine(paths_file):
    labels = []
    with open(paths_file) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                labels.append(int(parts[1]))
    if not labels:
        error("No labeled items in %s" % paths_file)
    hist = Counter(labels)
    total = len(labels)
    info("%d items, %d classes" % (total, len(hist)))
    for cls, n in sorted(hist.items()):
        info("class %4d : %6d items (%5.2f%%)" % (cls, n, 100 * n / total))
    majority = hist.most_common(1)[0]
    stats = {
        "items": total,
        "classes": len(hist),
        "majority_class": majority[0],
        "zeror_accuracy": majority[1] / total,
        "uniform_chance": 1.0 / len(hist),
    }
    info("ZeroR (majority) accuracy: %.4f; uniform chance: %.4f"
         % (stats["zeror_accuracy"], stats["uniform_chance"]))
    return stats


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: examine_dataset <paths_file>")
    return examine(argv[-1])


if __name__ == "__main__":
    main()
