"""Packed record container: the port's copy of
``video_learning_tpu/data/records.py``, byte for byte the same format.

On-disk layout (little-endian):

    file      := magic "VLR1" , record*
    record    := u32 payload_len , u32 crc32(payload) , payload
    payload   := u8 kind , body
    image body  (kind=0) := u16 h , u16 w , u16 d , u16 nlab , i32*nlab , u8[h*w*d]
    vector body (kind=1) := u32 dim ,        u16 nlab , i32*nlab , f32[dim]

Sidecars:
    <file>.idx  : u64 byte-offset of every record (O(1) seek)
    <file>.size : text metadata: items / type / cpi (run-length encoded) /
                  fpc / labelcount

``data/native_io.py`` reads the same files in bulk through the C++
reader; this module is the portable implementation and the writer.
"""

import ast
import itertools
import os
import shutil
import struct
import zlib

import numpy as np

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.utils import error, read_file_dict, warning

MAGIC = b"VLR1"
KIND_IMAGE = 0
KIND_VECTOR = 1

_HDR = struct.Struct("<II")          # payload_len, crc32
_IMG = struct.Struct("<BHHHH")       # kind, h, w, d, nlab
_VEC = struct.Struct("<BIH")         # kind, dim, nlab


# ------------------------------------------------------------------ encode
def encode_image_example(image, labels):
    """Encode a HxWxD uint8 image + int label list into a record payload."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3:
        error("encode_image_example expects HxWxD, got shape %s"
              % (image.shape,))
    labels = _norm_labels(labels)
    h, w, d = image.shape
    head = _IMG.pack(KIND_IMAGE, h, w, d, len(labels))
    return head + labels.tobytes() + image.tobytes()


def encode_vector_example(vector, labels):
    """Encode a float32 feature vector + labels."""
    vector = np.ascontiguousarray(vector, dtype=np.float32)
    if vector.ndim != 1:
        error("encode_vector_example expects a 1-D vector")
    labels = _norm_labels(labels)
    head = _VEC.pack(KIND_VECTOR, vector.shape[0], len(labels))
    return head + labels.tobytes() + vector.tobytes()


def _norm_labels(labels):
    if not isinstance(labels, (list, tuple, np.ndarray)):
        labels = [labels]
    return np.asarray([int(x) for x in labels], dtype=np.int32)


# ------------------------------------------------------------------ decode
def decode_example(payload):
    """Decode one record payload.

    Returns (kind, data, labels): data is a HxWxD uint8 array for images
    or a 1-D float32 array for vectors; labels is a list of ints, or a
    single int when the record has one label.
    """
    kind = payload[0]
    if kind == KIND_IMAGE:
        _, h, w, d, nlab = _IMG.unpack_from(payload, 0)
        off = _IMG.size
        labels = np.frombuffer(payload, np.int32, nlab, off)
        off += 4 * nlab
        image = np.frombuffer(payload, np.uint8, h * w * d, off)
        data = image.reshape(h, w, d)
    elif kind == KIND_VECTOR:
        _, dim, nlab = _VEC.unpack_from(payload, 0)
        off = _VEC.size
        labels = np.frombuffer(payload, np.int32, nlab, off)
        off += 4 * nlab
        data = np.frombuffer(payload, np.float32, dim, off)
    else:
        error("Unknown record kind: %d" % kind)
    labels = labels.tolist()
    if len(labels) == 1:
        labels = labels[0]
    return kind, data, labels


# ------------------------------------------------------------------ writer
class RecordWriter:
    """Append-only record writer; writes the .idx offset sidecar on
    close."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offsets = []
        self._pos = len(MAGIC)

    def write(self, payload):
        self._offsets.append(self._pos)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(_HDR.pack(len(payload), crc))
        self._f.write(payload)
        self._pos += _HDR.size + len(payload)

    def close(self):
        self._f.close()
        np.asarray(self._offsets, dtype=np.uint64).tofile(self.path + ".idx")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------------ reader
class RecordReader:
    """Random-access + sequential reader over a record file.

    Uses the .idx sidecar when it is consistent with the data file;
    otherwise scans once to rebuild the offsets.  ``verify`` checks each
    payload's CRC.
    """

    def __init__(self, path, verify=False):
        if not os.path.exists(path):
            error("Record file does not exist: %s" % path)
        self.path = path
        self.verify = verify
        self._f = open(path, "rb")
        magic = self._f.read(len(MAGIC))
        if magic != MAGIC:
            self._f.close()
            error("Bad record file magic in %s" % path)
        idx_path = path + ".idx"
        self._offsets = None
        if os.path.exists(idx_path):
            offsets = np.fromfile(idx_path, dtype=np.uint64)
            if self._index_consistent(offsets):
                self._offsets = offsets
            else:
                warning("Stale/corrupt index sidecar %s; rescanning %s"
                        % (idx_path, path))
        if self._offsets is None:
            self._offsets = self._scan_offsets()
        self._cursor = 0

    def _index_consistent(self, offsets):
        """The last offset's header and payload lie within the file (a
        killed packer can leave a sidecar from an earlier run)."""
        if len(offsets) == 0:
            return False
        size = os.fstat(self._f.fileno()).st_size
        last = int(offsets[-1])
        if last + _HDR.size > size:
            return False
        self._f.seek(last)
        length, _ = _HDR.unpack(self._f.read(_HDR.size))
        return last + _HDR.size + length <= size

    def _scan_offsets(self):
        offsets = []
        pos = len(MAGIC)
        size = os.fstat(self._f.fileno()).st_size
        while pos + _HDR.size <= size:
            offsets.append(pos)
            self._f.seek(pos)
            length, _ = _HDR.unpack(self._f.read(_HDR.size))
            pos += _HDR.size + length
        return np.asarray(offsets, dtype=np.uint64)

    def __len__(self):
        return len(self._offsets)

    def seek(self, index):
        """Position the sequential cursor at record ``index`` (O(1))."""
        if index < 0 or index > len(self):
            error("Seek out of range: %d / %d" % (index, len(self)))
        self._cursor = index

    def tell(self):
        return self._cursor

    def read_at(self, index):
        """Read + decode the record at an absolute index."""
        return decode_example(self._payload_at(index))

    def _payload_at(self, index):
        off = int(self._offsets[index])
        self._f.seek(off)
        length, crc = _HDR.unpack(self._f.read(_HDR.size))
        payload = self._f.read(length)
        if len(payload) != length:
            error("Truncated record %d in %s" % (index, self.path))
        if self.verify and (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            error("CRC mismatch at record %d in %s" % (index, self.path))
        return payload

    def __next__(self):
        if self._cursor >= len(self):
            raise StopIteration
        rec = self.read_at(self._cursor)
        self._cursor += 1
        return rec

    def __iter__(self):
        return self

    def read_batch(self, start, count):
        """Decode ``count`` consecutive records starting at ``start``."""
        return [self.read_at(i) for i in range(start, start + count)]

    def close(self):
        self._f.close()


# ---------------------------------------------------------- concatenation
def concatenate(shard_paths, out_path, remove_shards=False):
    """Concatenate record shard files into one, merging their offset
    indexes (records are self-contained: a byte-level append with the
    offsets shifted)."""
    offsets = []
    with open(out_path, "wb") as out:
        out.write(MAGIC)
        pos = len(MAGIC)
        for shard in shard_paths:
            shard_offsets = np.fromfile(shard + ".idx", dtype=np.uint64)
            with open(shard, "rb") as f:
                if f.read(len(MAGIC)) != MAGIC:
                    error("Bad shard magic in %s" % shard)
                copied = os.fstat(f.fileno()).st_size - len(MAGIC)
                # chunked: a shard can be many GB
                shutil.copyfileobj(f, out, length=16 * 1024 * 1024)
            offsets.append(shard_offsets - len(MAGIC) + pos)
            pos += copied
    np.concatenate(offsets).astype(np.uint64).tofile(out_path + ".idx")
    if remove_shards:
        for shard in shard_paths:
            os.remove(shard)
            os.remove(shard + ".idx")


# ------------------------------------------------------------ size sidecar
def write_size_file(num_items, clips_per_item, outfile, mode, max_num_labels,
                    num_frames_per_clip):
    """Write the ``.size`` metadata sidecar: items / type / run-length
    encoded cpi / fpc / labelcount."""
    if mode == defs.input_mode.image:
        num_frames_per_clip = None
    with open(outfile + ".size", "w") as f:
        f.write("items\t%d\n" % num_items)
        f.write("type\t%s\n" % mode)
        if clips_per_item is not None:
            cpv_str = [(len(list(g)), k)
                       for k, g in itertools.groupby(clips_per_item)]
        else:
            cpv_str = str(clips_per_item)
        f.write("cpi\t%s\n" % cpv_str)
        f.write("fpc\t%s\n" % str(num_frames_per_clip))
        f.write("labelcount\t%s\n" % str(max_num_labels))


def read_size_file(size_path):
    """Parse a ``.size`` sidecar, expanding the run-length encoded cpi.
    Returns a dict with keys items / type / cpi / fpc / labelcount."""
    raw = read_file_dict(size_path)
    out = {"items": int(raw["items"]), "type": raw["type"]}
    cpv = ast.literal_eval(raw["cpi"]) if raw["cpi"] != "None" else None
    if isinstance(cpv, list) and cpv and isinstance(cpv[0], tuple):
        cpv = [item for num, item in cpv for _ in range(num)]
    out["cpi"] = cpv
    out["fpc"] = (None if raw["fpc"] == "None" else int(raw["fpc"]))
    out["labelcount"] = int(raw["labelcount"])
    if isinstance(cpv, list) and len(cpv) != out["items"]:
        error("Read %d items but got cpv list of size %d"
              % (out["items"], len(cpv)))
    return out
