"""Checkpoint inspection: list or print the tensors of an npz checkpoint.

The port's counterpart of ``video_learning_tpu/tools/inspect_checkpoint.py``:
the same lines for the same file, over ``checkpoint.load_flat`` (npz, JAX
names, conv weights HWIO, as either package writes them).

Usage: python -m video_learning_tpu_torch.tools.inspect_checkpoint ckpt
           [name | --all]
"""

import sys

import numpy as np

from video_learning_tpu_torch.checkpoint import (get_checkpoint_tensor_names,
                                                 load_flat)
from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def print_tensors_in_checkpoint(path, tensor_name=None, all_tensors=False):
    flat = load_flat(path)
    if tensor_name:
        if tensor_name not in flat:
            error("Tensor [%s] not in checkpoint %s" % (tensor_name, path))
        info("%s:\n%s" % (tensor_name, np.asarray(flat[tensor_name])))
        return
    for name in sorted(flat):
        leaf = flat[name]
        shape = getattr(leaf, "shape", "scalar")
        dtype = getattr(leaf, "dtype", type(leaf).__name__)
        if all_tensors:
            info("%s %s %s:\n%s" % (name, shape, dtype, leaf))
        else:
            info("%s  shape=%s dtype=%s" % (name, shape, dtype))


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: inspect_checkpoint <ckpt> [tensor_name|--all]")
    path = argv[1]
    tensor = None
    all_tensors = False
    if len(argv) > 2:
        if argv[2] == "--all":
            all_tensors = True
        else:
            tensor = argv[2]
    print_tensors_in_checkpoint(path, tensor, all_tensors)


__all__ = ["get_checkpoint_tensor_names", "print_tensors_in_checkpoint"]

if __name__ == "__main__":
    main()
