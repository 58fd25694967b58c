"""Packed-data auditing: stream a record file, histogram shapes and
labels, and cross-check the record count against the ``.size`` sidecar.

The port's copy of ``video_learning_tpu/tools/check_serialized_data.py``.

Usage: python -m video_learning_tpu_torch.tools.check_serialized_data <file>
"""

import sys
from collections import Counter

from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def check(record_path):
    reader = records.RecordReader(record_path, verify=True)
    shape_hist = Counter()
    label_hist = Counter()
    count = 0
    for kind, data, label in reader:
        shape_hist[tuple(data.shape)] += 1
        key = tuple(label) if isinstance(label, list) else label
        label_hist[key] += 1
        count += 1
    reader.close()
    info("Read %d records from %s" % (count, record_path))
    for shape, n in shape_hist.most_common():
        info("shape %s : %d records" % (shape, n))
    info("%d distinct label values" % len(label_hist))

    meta = records.read_size_file(record_path + ".size")
    expected = meta["items"]
    if meta["type"] == defs.input_mode.video:
        expected = sum(meta["cpi"]) * meta["fpc"]
    status = "OK" if expected == count else "MISMATCH"
    info(".size cross-check: expected %d records, found %d -> %s"
         % (expected, count, status))
    if expected != count:
        error("Record count does not match the .size sidecar")
    return {"count": count, "shapes": dict(shape_hist),
            "labels": len(label_hist)}


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: check_serialized_data <file.tfrecord>")
    return check(argv[-1])


if __name__ == "__main__":
    main()
