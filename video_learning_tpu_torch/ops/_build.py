"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``.
The sources are compiled in parallel (one ``nvcc -c`` each, all started
together) and linked once.  The library lands in
``video_learning_tpu_torch/build/`` (git-ignored) under a name that
carries a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads the cached library.  The build happens at first
use, never at import.  There is no fallback: a failed build raises.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from video_learning_tpu_torch.utils import error, info

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None    # wall time of the build this process ran (or 0.0)


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    error("nvcc not found (PATH or /usr/local/cuda/bin); the port's CUDA "
          "kernels are built from source at first use")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        error("no CUDA sources under %s" % CSRC)
    return srcs


def _digest(srcs):
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if the cached library is stale; returns its
    path."""
    global build_seconds
    srcs = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, "libvlt_kernels_%s.so"
                            % _digest(srcs))
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc] + ARCH_FLAGS + CFLAGS + ["-c", src, "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for cmd, _, p in procs:
            out, _ = p.communicate()
            if p.returncode:
                failures.append("%s\n%s" % (" ".join(cmd),
                                            out.decode(errors="replace")))
        if failures:
            error("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp_lib] + \
            [obj for _, obj, _ in procs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if res.returncode:
            error("nvcc link failed:\n%s\n%s"
                  % (" ".join(cmd), res.stdout.decode(errors="replace")))
        os.replace(tmp_lib, lib_path)     # atomic: concurrent builds
    build_seconds = time.monotonic() - t0
    info("Built %s in %.1f s" % (lib_path, build_seconds))
    return lib_path


def library():
    """The loaded kernel library (built on first call), with every entry
    point's ``argtypes`` and ``restype`` declared."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_float)
            lib.vlt_lrn_fwd.argtypes = [ptr, ptr, i64, i32, i32, i32, f32,
                                        f32, f32, ctypes.POINTER(i32), ptr]
            lib.vlt_lrn_fwd.restype = i32
            lib.vlt_lstm_step.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                          i32, i32, i32, i32, i32, i32, ptr]
            lib.vlt_lstm_step.restype = i32
            lib.vlt_lstm_step_max_clusters.argtypes = [i32] * 5
            lib.vlt_lstm_step_max_clusters.restype = i32
            lib.vlt_lrn_bwd.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32,
                                        f32, f32, f32, f32,
                                        ctypes.POINTER(i32), ptr]
            lib.vlt_lrn_bwd.restype = i32
            for fn in (lib.vlt_conv1_dw, lib.vlt_conv1_dw_shifted):
                fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32,
                               i32, i32, i32, i64, i32, ptr]
                fn.restype = i32
            lib.vlt_error_string.argtypes = [i32]
            lib.vlt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc, what):
    """Raise on a nonzero ``cudaGetLastError()`` code from a launch."""
    if rc:
        name = library().vlt_error_string(rc).decode(errors="replace")
        error("%s launch failed: cudaError %d (%s)" % (what, rc, name))
