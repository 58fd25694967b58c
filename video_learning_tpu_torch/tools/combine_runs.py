"""Multi-run validation ensembling with amean / gmean / softmax /
weighted modes.

The port's counterpart of ``video_learning_tpu/tools/combine_runs.py``:
one label per item from a packed record file and its run-length encoded
``.size`` sidecar (the port's ``data/records.py``), each run's chunked
validation logits (the ``validation_logits*`` files of its folder in
chunk order), and the ensemble accuracies of the arithmetic mean, the
geometric mean (when no logit is negative), the mean of per-run
softmaxes and the leave-one-heavier weighted averages.

Usage:
  python -m video_learning_tpu_torch.tools.combine_runs run1/ run2/ ... \\
      --data-path packed_file --num-classes N
"""


import argparse
import os
import pickle
import re

import numpy as np

from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def load_labels(data_path):
    """One label per item from the packed records, taking each video's
    first frame's label and skipping cpi*fpc records per item."""
    record_file = data_path if data_path.endswith(".tfrecord") \
        else data_path + ".tfrecord"
    meta = records.read_size_file(record_file + ".size")
    cpi = meta["cpi"]
    fpc = meta["fpc"] or 1
    reader = records.RecordReader(record_file)
    labels = []
    cursor = 0
    if cpi is None:  # image mode: one record per item
        for i in range(meta["items"]):
            labels.append(_scalar(reader.read_at(i)[2]))
    else:
        for nclips in cpi:
            labels.append(_scalar(reader.read_at(cursor)[2]))
            cursor += nclips * fpc
    reader.close()
    info("Aggregated %d item labels (fpc=%s)" % (len(labels), fpc))
    return np.asarray(labels)


def _scalar(label):
    return int(label[0] if isinstance(label, list) else label)


def load_run_logits(source_path, num_classes):
    """A run folder (chunked validation_logits files, sorted) or a single
    pickle (only files a validation run wrote: a pickle can run code)."""
    if os.path.isdir(source_path):
        def chunk_key(name):
            # numeric ordering for '.part_<N>' suffixes (lexicographic
            # order would scramble part_10 before part_2)
            m = re.search(r"\.part_(\d+)$", name)
            return (0, int(m.group(1))) if m else (1, name)

        val_files = sorted(
            (f for f in os.listdir(source_path)
             if f.startswith("validation_logits") and
             os.path.isfile(os.path.join(source_path, f))),
            key=chunk_key)
        run_logits = np.zeros([0, num_classes], np.float32)
        for valfile in val_files:
            with open(os.path.join(source_path, valfile), "rb") as f:
                run_logits = np.vstack((run_logits, pickle.load(f)))
        return run_logits
    with open(source_path, "rb") as f:
        return np.asarray(pickle.load(f))


def ensemble_accuracies(logits_per_run, labels):
    """{mode: accuracy} for amean/gmean/softmax/weighted ensembles."""
    def acc(logits):
        return float(np.mean(np.argmax(logits, 1) == labels))

    out = {"amean": acc(np.mean(logits_per_run, axis=0))}
    if not np.any(np.asarray(logits_per_run) < 0):
        gmean = np.prod(logits_per_run, axis=0) ** (
            1.0 / len(logits_per_run))
        out["gmean"] = acc(gmean)
    sm = [np.exp(l - np.max(l, axis=1, keepdims=True)) for l in
          logits_per_run]
    sm = [l / np.sum(l, axis=1, keepdims=True) for l in sm]
    out["softmax_amean"] = acc(np.mean(sm, axis=0))
    n = len(logits_per_run)
    if n > 1:
        w_eq = 1.0 / n
        big_w, other_w = 2 * w_eq, (1 - 2 * w_eq) / (n - 1)
        for i in range(n):
            weights = [other_w] * n
            weights[i] = big_w
            combined = sum(l * w for l, w in zip(logits_per_run, weights))
            out["weighted_favor_%d" % i] = acc(combined)
    return out


def combine(run_folders, data_path, num_classes):
    labels = load_labels(data_path)
    logits_per_run, per_run_acc = [], []
    for source in run_folders:
        if not os.path.exists(source):
            error("%s does not exist" % source)
        run_logits = load_run_logits(source, num_classes)
        if len(run_logits) != len(labels):
            error("Run %s has %d logits but %d labels"
                  % (source, len(run_logits), len(labels)))
        local = float(np.mean(np.argmax(run_logits, 1) == labels))
        info("Run [%s] local accuracy %.5f"
             % (os.path.basename(source.rstrip("/")), local))
        logits_per_run.append(run_logits)
        per_run_acc.append(local)
    results = ensemble_accuracies(logits_per_run, labels)
    results["mean_of_run_accuracies"] = float(np.mean(per_run_acc))
    for k, v in results.items():
        info("%s: %.5f" % (k, v))
    return results


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("run_folders", nargs="+")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--num-classes", type=int, required=True)
    args = parser.parse_args(argv)
    return combine(args.run_folders, args.data_path, args.num_classes)


if __name__ == "__main__":
    main()
