"""ctypes binding to the native (C++) record reader.

The port's copy of ``video_learning_tpu/data/native_io.py`` with its own
build: ``native/vlrecords.cpp`` is compiled by the host C++ compiler
(``$CXX``, else ``g++``/``c++``) with the flags of ``native/Makefile``
into the port's git-ignored ``video_learning_tpu_torch/build/``, at first
use, never at import, and never into ``native/``.  The library's name
carries a hash of the source, the flags and the compiler's resolved
``-march=native`` target, so a changed source, or a build directory
carried to a machine with another CPU, builds anew.  When there is no
compiler, or the build fails, ``get_library`` returns None and the
datasets read through the Python reader (``data/records.py``).

The native path mmaps the record file and decodes whole batches with one
memcpy per frame.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from video_learning_tpu_torch.utils import info, warning

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "vlrecords.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib = None
_lib_tried = False
lib_path = None         # the library this process loaded, if any


def _compiler():
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _target_id(cxx):
    """What ``-march=native`` resolves to on this machine (the enabled
    target options the compiler reports), or the host name where the
    compiler cannot say."""
    try:
        res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout:
            return res.stdout
    except (OSError, subprocess.SubprocessError):
        pass
    return platform.node()


def build():
    """Compile the reader if the cached library is stale; returns its
    path, or None when there is no compiler or the build fails."""
    cxx = _compiler()
    if cxx is None:
        warning("No C++ compiler ($CXX, g++, c++); the native record "
                "reader is unavailable")
        return None
    if not os.path.exists(SOURCE):
        warning("Native reader source %s is missing" % SOURCE)
        return None
    h = hashlib.sha256(" ".join([cxx] + CXXFLAGS).encode())
    h.update(_target_id(cxx).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "libvlrecords_%s.so"
                        % h.hexdigest()[:16])
    if os.path.exists(path):
        return path
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        cmd = [cxx] + CXXFLAGS + ["-o", out, SOURCE]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.SubprocessError) as ex:
            warning("Native record reader build failed: %s" % ex)
            return None
        if res.returncode:
            warning("Native record reader build failed:\n%s\n%s"
                    % (" ".join(cmd), res.stderr))
            return None
        os.replace(out, path)       # atomic: concurrent builds
    info("Built the native record reader %s" % path)
    return path


def get_library():
    """Load (building if needed) the native library; None on failure."""
    global _lib, _lib_tried, lib_path
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as ex:
            warning("Could not load native record library: %s" % ex)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.vlr_open.restype = ctypes.c_void_p
        lib.vlr_open.argtypes = [ctypes.c_char_p]
        lib.vlr_close.argtypes = [ctypes.c_void_p]
        lib.vlr_count.restype = ctypes.c_int64
        lib.vlr_count.argtypes = [ctypes.c_void_p]
        lib.vlr_read_images.restype = ctypes.c_int
        lib.vlr_read_images.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), i32p, i32p, ctypes.c_int32,
            ctypes.c_int]
        lib.vlr_read_vectors.restype = ctypes.c_int
        lib.vlr_read_vectors.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), i32p, i32p, ctypes.c_int32,
            ctypes.c_int]
        lib.vlr_read_images_at.restype = ctypes.c_int
        lib.vlr_read_images_at.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), i32p, i32p, ctypes.c_int32,
            ctypes.c_int]
        lib.vlr_read_vectors_at.restype = ctypes.c_int
        lib.vlr_read_vectors_at.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), i32p, i32p, ctypes.c_int32,
            ctypes.c_int]
        lib.vlr_record_info.restype = ctypes.c_int
        lib.vlr_record_info.argtypes = [ctypes.c_void_p, ctypes.c_int64] + \
            [i32p] * 5
        _lib, lib_path = lib, path
        info("Native record reader loaded from %s" % path)
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeReader:
    """Batch-oriented reader over the native library."""

    def __init__(self, path, verify=False):
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.vlr_open(path.encode())
        if not self._h:
            raise RuntimeError("vlr_open failed for %s" % path)
        self.path = path
        self.verify = 1 if verify else 0

    def __len__(self):
        return int(self._lib.vlr_count(self._h))

    def record_info(self, index):
        vals = [ctypes.c_int32() for _ in range(5)]
        rc = self._lib.vlr_record_info(self._h, index,
                                       *[ctypes.byref(v) for v in vals])
        if rc != 0:
            raise RuntimeError("vlr_record_info rc=%d" % rc)
        kind, h, w, d, nlab = (v.value for v in vals)
        return kind, h, w, d, nlab

    @staticmethod
    def _image_buffers(count, h, w, d, max_labels, out):
        """Caller-provided (pixels, labels, nlab) buffers, checked, or
        fresh ones.  Reused buffers skip the page faults of a fresh
        allocation per batch (``data/dataset.py`` keeps a ring)."""
        if out is not None:
            pixels, labels, nlab = out
            if pixels.shape != (count, h, w, d) or \
                    pixels.dtype != np.uint8 or \
                    not pixels.flags.c_contiguous:
                raise ValueError("bad pixels buffer for reuse")
            if labels.shape != (count, max_labels) or \
                    labels.dtype != np.int32 or \
                    not labels.flags.c_contiguous:
                raise ValueError("bad labels buffer for reuse")
            if nlab.shape != (count,) or nlab.dtype != np.int32 or \
                    not nlab.flags.c_contiguous:
                raise ValueError("bad nlab buffer for reuse")
            return pixels, labels, nlab
        return (np.empty((count, h, w, d), np.uint8),
                np.empty((count, max_labels), np.int32),
                np.empty((count,), np.int32))

    def read_images(self, start, count, shape, max_labels=1, out=None):
        """Decode count consecutive image records.  Returns
        (pixels (count, h, w, d) uint8, labels (count, max_labels) int32
        with -1 padding, nlab (count,) int32); ``out`` optionally
        provides those buffers for reuse."""
        h, w, d = (int(x) for x in shape)
        pixels, labels, nlab = self._image_buffers(count, h, w, d,
                                                   max_labels, out)
        rc = self._lib.vlr_read_images(
            self._h, start, count, h, w, d, _ptr(pixels, ctypes.c_uint8),
            _ptr(labels, ctypes.c_int32), _ptr(nlab, ctypes.c_int32),
            max_labels, self.verify)
        if rc == -6:
            # a record carries more labels than the buffer: retry once
            # with a buffer sized to the data
            widest = self._widest_label_row(start, count)
            if widest > max_labels:
                return self.read_images(start, count, shape,
                                        max_labels=widest)
        if rc != 0:
            raise RuntimeError("vlr_read_images rc=%d" % rc)
        return pixels, labels, nlab

    def read_images_at(self, indices, shape, max_labels=1, out=None):
        """Gather-decode image records at explicit ``indices`` (any order;
        the shuffled-epoch read path).  Same returns as read_images."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        count = len(idx)
        h, w, d = (int(x) for x in shape)
        pixels, labels, nlab = self._image_buffers(count, h, w, d,
                                                   max_labels, out)
        rc = self._lib.vlr_read_images_at(
            self._h, _ptr(idx, ctypes.c_int64), count, h, w, d,
            _ptr(pixels, ctypes.c_uint8), _ptr(labels, ctypes.c_int32),
            _ptr(nlab, ctypes.c_int32), max_labels, self.verify)
        if rc == -6:
            widest = max(self.record_info(int(i))[4] for i in idx)
            if widest > max_labels:
                return self.read_images_at(idx, shape, max_labels=widest)
        if rc != 0:
            raise RuntimeError("vlr_read_images_at rc=%d" % rc)
        return pixels, labels, nlab

    def read_vectors_at(self, indices, dim, max_labels=1):
        """Gather-decode vector records at explicit ``indices``."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        count = len(idx)
        values = np.empty((count, dim), np.float32)
        labels = np.empty((count, max_labels), np.int32)
        nlab = np.empty((count,), np.int32)
        rc = self._lib.vlr_read_vectors_at(
            self._h, _ptr(idx, ctypes.c_int64), count, dim,
            _ptr(values, ctypes.c_float), _ptr(labels, ctypes.c_int32),
            _ptr(nlab, ctypes.c_int32), max_labels, self.verify)
        if rc == -6:
            widest = max(self.record_info(int(i))[4] for i in idx)
            if widest > max_labels:
                return self.read_vectors_at(idx, dim, max_labels=widest)
        if rc != 0:
            raise RuntimeError("vlr_read_vectors_at rc=%d" % rc)
        return values, labels, nlab

    def _widest_label_row(self, start, count):
        return max(self.record_info(start + i)[4] for i in range(count))

    def read_vectors(self, start, count, dim, max_labels=1):
        values = np.empty((count, dim), np.float32)
        labels = np.empty((count, max_labels), np.int32)
        nlab = np.empty((count,), np.int32)
        rc = self._lib.vlr_read_vectors(
            self._h, start, count, dim, _ptr(values, ctypes.c_float),
            _ptr(labels, ctypes.c_int32), _ptr(nlab, ctypes.c_int32),
            max_labels, self.verify)
        if rc == -6:
            widest = self._widest_label_row(start, count)
            if widest > max_labels:
                return self.read_vectors(start, count, dim,
                                         max_labels=widest)
        if rc != 0:
            raise RuntimeError("vlr_read_vectors rc=%d" % rc)
        return values, labels, nlab

    def close(self):
        if self._h:
            self._lib.vlr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
