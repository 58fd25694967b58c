"""Post-process extracted spectrogram or frame folders: flatten one
directory level (move every subfolder's children into the base folder and
remove the emptied subfolders) and strip a trailing media extension
(``.avi`` by default) from the names.

The port's counterpart of ``video_learning_tpu/audio/postproc_folders.py``:
every collision is found before anything moves, so a failed run leaves
the tree as it was.

Usage:
  python -m video_learning_tpu_torch.audio.postproc_folders <base_dir> \\
      [--strip-ext .avi] [--no-flatten]
"""


import argparse
import os

from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def flatten_one_level(base_dir):
    """Move every child of every subdirectory of base_dir into base_dir,
    then remove the emptied subdirectories.

    All collisions (against existing base-dir entries AND duplicate child
    names across subfolders) are detected BEFORE any rename happens, so a
    failed run never leaves the tree half-flattened."""
    pending = []             # (src, dst) in execution order
    seen = {e: "<base>" for e in os.listdir(base_dir)}
    conflicts = []
    for entry in sorted(os.listdir(base_dir)):
        sub = os.path.join(base_dir, entry)
        if not os.path.isdir(sub):
            continue
        for child in sorted(os.listdir(sub)):
            if child in seen:
                conflicts.append("[%s] from [%s] collides with [%s]"
                                 % (child, entry, seen[child]))
            else:
                seen[child] = entry
            pending.append((os.path.join(sub, child),
                            os.path.join(base_dir, child)))
        pending.append((sub, None))  # rmdir marker after its children
        # only now does the subfolder's own name free up (rmdir runs
        # after its children moved; later subfolders may reuse the name)
        seen.pop(entry, None)
    if conflicts:
        error("Flatten collisions (no files were moved): %s"
              % "; ".join(conflicts))
    moved = 0
    for src, dst in pending:
        if dst is None:
            os.rmdir(src)
        else:
            os.rename(src, dst)
            moved += 1
    info("Flattened %d entries into %s" % (moved, base_dir))
    return moved


def strip_extension(base_dir, ext=".avi"):
    """Rename folders (and files) ending in ``ext`` to drop the suffix."""
    renamed = 0
    for entry in sorted(os.listdir(base_dir)):
        if not entry.lower().endswith(ext.lower()):
            continue
        src = os.path.join(base_dir, entry)
        dst = os.path.join(base_dir, entry[: -len(ext)])
        if os.path.exists(dst):
            error("Rename collision: [%s] already exists" % dst)
        os.rename(src, dst)
        renamed += 1
    info("Stripped [%s] from %d names in %s" % (ext, renamed, base_dir))
    return renamed


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("base_dir")
    parser.add_argument("--strip-ext", default=".avi")
    parser.add_argument("--no-flatten", action="store_true")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.base_dir):
        error("Not a directory: %s" % args.base_dir)
    if not args.no_flatten:
        flatten_one_level(args.base_dir)
    if args.strip_ext:
        strip_extension(args.base_dir, args.strip_ext)


if __name__ == "__main__":
    main()
