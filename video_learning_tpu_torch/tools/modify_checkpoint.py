"""Offline checkpoint surgery: delete, rename, regex-rename or create
variables of an npz checkpoint, carrying its ``.snap`` sidecar along.

The port's counterpart of ``video_learning_tpu/tools/modify_checkpoint.py``:
the same operations in the same order, and an output npz equal to the JAX
tool's array for array.  Either package restores the result.

Usage:
  python -m video_learning_tpu_torch.tools.modify_checkpoint <in> <out> \\
      [--delete NAME]... [--rename OLD NEW]... [--regex-rename PAT REPL]... \\
      [--create NAME SHAPE]...
"""

import argparse
import os
import re
import shutil

import numpy as np

from video_learning_tpu_torch.checkpoint import load_flat
from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def modify(in_path, out_path, deletes=(), renames=(), regex_renames=(),
           creates=()):
    flat = load_flat(in_path)
    for name in deletes:
        if name not in flat:
            error("Cannot delete missing variable [%s]" % name)
        del flat[name]
        info("Deleted [%s]" % name)
    for old, new in renames:
        if old not in flat:
            error("Cannot rename missing variable [%s]" % old)
        if new in flat:
            error("Rename target [%s] already exists" % new)
        flat[new] = flat.pop(old)
        info("Renamed [%s] -> [%s]" % (old, new))
    for pattern, repl in regex_renames:
        compiled = re.compile(pattern)
        for name in list(flat):
            new = compiled.sub(repl, name)
            if new != name:
                if new in flat:
                    error("Regex-rename target [%s] already exists" % new)
                flat[new] = flat.pop(name)
                info("Renamed [%s] -> [%s]" % (name, new))
    for name, shape_str in creates:
        if name in flat:
            error("Create target [%s] already exists" % name)
        shape = tuple(int(x) for x in shape_str.split(",") if x)
        flat[name] = np.zeros(shape, np.float32)
        info("Created [%s] with shape %s" % (name, shape))
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
    os.replace(tmp, out_path)
    snap = in_path + ".snap"
    if os.path.exists(snap):
        shutil.copyfile(snap, out_path + ".snap")
    info("Wrote modified checkpoint to %s" % out_path)
    return flat


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--delete", action="append", default=[])
    parser.add_argument("--rename", nargs=2, action="append", default=[])
    parser.add_argument("--regex-rename", nargs=2, action="append",
                        default=[])
    parser.add_argument("--create", nargs=2, action="append", default=[])
    args = parser.parse_args(argv)
    return modify(args.input, args.output, args.delete, args.rename,
                  args.regex_rename, args.create)


if __name__ == "__main__":
    main()
