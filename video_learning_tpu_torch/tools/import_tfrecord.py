"""Migrate TFRecord files of the original TensorFlow serializer into the
VLR container.

The port's counterpart of ``video_learning_tpu/tools/import_tfrecord.py``:
proto Examples with height / width / depth / label / image_raw or
dimension / label / vector_raw become VLR records (the port's
``data/records.py``), and the ``.size`` sidecar, whose format is the
same, is copied beside them.  Decoding the protos needs TensorFlow,
imported only here; without it the tool raises, as the JAX tool does.

Usage:
  python -m video_learning_tpu_torch.tools.import_tfrecord <in.tfrecord> \\
      [out.tfrecord]   (default: <in>.vlr.tfrecord)
"""


import os
import shutil
import sys

import numpy as np

from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def _tf_example_iterator(path):
    try:
        import tensorflow as tf
    except ImportError:
        error("TensorFlow is required to decode reference TFRecord files "
              "(pip-installable separately; the framework itself does not "
              "depend on it).")
    from tensorflow.core.example import example_pb2
    for raw in tf.data.TFRecordDataset(path).as_numpy_iterator():
        example = example_pb2.Example()
        example.ParseFromString(raw)
        yield example.features.feature


def convert(in_path, out_path=None):
    """Returns (out_path, record_count)."""
    if out_path is None:
        base = in_path[:-len(".tfrecord")] if in_path.endswith(".tfrecord") \
            else in_path
        out_path = base + ".vlr.tfrecord"
    from video_learning_tpu_torch.utils import FrameworkError

    def _convert_one(feature, writer):
        labels = list(feature["label"].int64_list.value)
        if "image_raw" in feature:
            h = int(feature["height"].int64_list.value[0])
            w = int(feature["width"].int64_list.value[0])
            d = int(feature["depth"].int64_list.value[0])
            img = np.frombuffer(
                feature["image_raw"].bytes_list.value[0],
                np.uint8).reshape(h, w, d)
            writer.write(records.encode_image_example(img, labels))
        elif "vector_raw" in feature:
            vec = np.frombuffer(
                feature["vector_raw"].bytes_list.value[0], np.float32)
            dim = int(feature["dimension"].int64_list.value[0])
            if dim != len(vec):
                error("Vector length %d != stored dimension %d"
                      % (len(vec), dim))
            writer.write(records.encode_vector_example(vec, labels))
        else:
            error("Unrecognized example schema in %s" % in_path)

    count = 0
    try:
        with records.RecordWriter(out_path) as writer:
            try:
                for feature in _tf_example_iterator(in_path):
                    _convert_one(feature, writer)
                    count += 1
            except FrameworkError:
                raise
            except Exception as ex:
                error("Conversion of %s failed after %d records: %s"
                      % (in_path, count, ex))
    except BaseException:
        # never leave a truncated output masquerading as a converted set
        for suffix in ("", ".idx"):
            if os.path.exists(out_path + suffix):
                os.remove(out_path + suffix)
        raise
    # the .size sidecar format is identical — carry it over
    if os.path.exists(in_path + ".size"):
        shutil.copyfile(in_path + ".size", out_path + ".size")
    info("Converted %d records: %s -> %s" % (count, in_path, out_path))
    return out_path, count


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: import_tfrecord <in.tfrecord> [out]")
    out = argv[2] if len(argv) > 2 else None
    return convert(argv[1], out)


if __name__ == "__main__":
    main()
