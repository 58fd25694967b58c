"""Export a VLR container to the TFRecord format of TensorFlow tooling.

The port's counterpart of ``video_learning_tpu/tools/export_tfrecord.py``,
and the reverse of ``tools/import_tfrecord``: proto Examples with the
schema of the original TensorFlow serializer (height / width / depth /
label / image_raw for images, dimension / label / vector_raw for
vectors), the same bytes as the JAX tool writes for the same file.

The Example proto is hand-encoded (the schema is four fixed message
types).  The TFRecord framing (a length and masked-CRC32C header per
record) goes through TensorFlow's writer where ``tensorflow`` can be
imported, as the JAX tool does, and otherwise through the pure-Python
framing below; the two write the same bytes.

Usage:
  python -m video_learning_tpu_torch.tools.export_tfrecord \\
      <in.tfrecord (VLR)> [out.tfrecord]   (default: <in>.tf.tfrecord)
"""


import os
import shutil
import struct
import sys

import numpy as np

from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.utils import ensure_console_logging, error, info

# ------------------------------------------------------- protobuf encoding
# Wire format only needs varints + length-delimited fields for:
#   Example{ features:1 }  Features{ feature:1 map<string,Feature> }
#   Feature{ bytes_list:1 | float_list:2 | int64_list:3 }
#   BytesList{ value:1 }  FloatList{ value:1 packed }  Int64List{ value:1 packed }


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire_type):
    return _varint((field << 3) | wire_type)


def _len_delimited(field, payload):
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int64_feature(values):
    packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
    return _len_delimited(3, _len_delimited(1, packed))


def _bytes_feature(value):
    return _len_delimited(1, _len_delimited(1, value))


def encode_example(feature_map):
    """feature_map: {name: encoded Feature message bytes}."""
    features = b"".join(
        _len_delimited(1, _len_delimited(1, name.encode("utf-8")) +
                       _len_delimited(2, feat))
        for name, feat in sorted(feature_map.items()))
    return _len_delimited(1, features)


# -------------------------------------------------------- TFRecord framing
def _crc32c_tables(n=8):
    """Slice-by-N CRC32C tables (Castagnoli, reflected).  Plain-int
    tables: per-byte numpy scalar indexing made the original formulation
    ~50x slower (0.15s per 230KB frame — hours for a real dataset)."""
    poly = 0x82F63B78
    t0 = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        t0.append(crc)
    tables = [t0]
    for k in range(1, n):
        prev = tables[k - 1]
        tables.append([(prev[i] >> 8) ^ t0[prev[i] & 0xFF]
                       for i in range(256)])
    return tables


_CRC_TABLES = _crc32c_tables()


def _crc32c(data):
    t = _CRC_TABLES
    crc = 0xFFFFFFFF
    mv = memoryview(data)
    n8 = len(mv) - (len(mv) % 8)
    for i in range(0, n8, 8):
        b0, b1, b2, b3, b4, b5, b6, b7 = mv[i:i + 8]
        crc = (t[7][(crc ^ b0) & 0xFF] ^ t[6][((crc >> 8) ^ b1) & 0xFF] ^
               t[5][((crc >> 16) ^ b2) & 0xFF] ^
               t[4][((crc >> 24) ^ b3) & 0xFF] ^
               t[3][b4] ^ t[2][b5] ^ t[1][b6] ^ t[0][b7])
    for b in mv[n8:]:
        crc = (crc >> 8) ^ t[0][(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def write_tfrecord(fh, payload):
    header = struct.pack("<Q", len(payload))
    fh.write(header)
    fh.write(struct.pack("<I", _masked_crc(header)))
    fh.write(payload)
    fh.write(struct.pack("<I", _masked_crc(payload)))


# ----------------------------------------------------------------- convert
def _writer(fh):
    """Prefer TensorFlow's C++ TFRecordWriter when importable (the
    export target is TF tooling anyway); fall back to the pure-Python
    framing above.  Returns (write(payload), close())."""
    try:
        import tensorflow as tf
        fh.close()
        w = tf.io.TFRecordWriter(fh.name)
        return w.write, w.close
    except ImportError:
        return (lambda payload: write_tfrecord(fh, payload)), fh.close


def convert(in_path, out_path=None):
    """Returns (out_path, record_count)."""
    if out_path is None:
        base = in_path[:-len(".tfrecord")] if in_path.endswith(".tfrecord") \
            else in_path
        out_path = base + ".tf.tfrecord"
    count = 0
    reader = records.RecordReader(in_path)
    tmp = out_path + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            write, close = _writer(fh)
            for i in range(len(reader)):
                kind, data, labels = reader.read_at(i)
                if np.isscalar(labels):
                    labels = [labels]
                if kind == records.KIND_IMAGE:
                    feats = {
                        "height": _int64_feature([data.shape[0]]),
                        "width": _int64_feature([data.shape[1]]),
                        "depth": _int64_feature([data.shape[2]]),
                        "label": _int64_feature(labels),
                        "image_raw": _bytes_feature(data.tobytes()),
                    }
                else:
                    feats = {
                        "dimension": _int64_feature([data.shape[0]]),
                        "label": _int64_feature(labels),
                        "vector_raw": _bytes_feature(
                            data.astype(np.float32).tobytes()),
                    }
                write(encode_example(feats))
                count += 1
            close()
        os.replace(tmp, out_path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    finally:
        reader.close()
    if os.path.exists(in_path + ".size"):
        shutil.copyfile(in_path + ".size", out_path + ".size")
    info("Exported %d records: %s -> %s" % (count, in_path, out_path))
    return out_path, count


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: export_tfrecord <in (VLR)> [out.tfrecord]")
    out = argv[2] if len(argv) > 2 else None
    return convert(argv[1], out)


if __name__ == "__main__":
    main()
