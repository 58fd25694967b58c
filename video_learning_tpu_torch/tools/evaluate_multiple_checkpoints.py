"""Multi-checkpoint evaluation: run the val phase against every
(filtered) checkpoint of a training run and collect the accuracy files.

The port's counterpart of
``video_learning_tpu/tools/evaluate_multiple_checkpoints.py``: it lists
the run's checkpoints (or a folder's), keeps the epochs that ``--only`` /
``--omit`` select, writes a val-phase copy of the run config resuming
each checkpoint, runs the port's ``run_task`` on it (in this process, or
with ``--subprocess`` as ``python -m video_learning_tpu_torch.run_task``),
and reads back the top-1 ``accuracy_*`` file it wrote.

The run config is read as ``config.py`` reads it: JSON, or YAML through
PyYAML imported only for a file that is not JSON; each checkpoint's copy
is written as JSON (``eval_ckpt_<i>.json``, which YAML readers read too)
into the run folder.  The evaluation runs on the card unless
``--device cpu`` (``device="cpu"``) asks for the CPU.

Usage:
  python -m video_learning_tpu_torch.tools.evaluate_multiple_checkpoints \\
      <config.json|yml> [--checkpoints-dir DIR] [--only E ...] \\
      [--omit E ...] [--subprocess] [--device cuda|cpu]
"""

import argparse
import json
import os
import re
import subprocess
import sys

from video_learning_tpu_torch.config import load_documents
from video_learning_tpu_torch.utils import (ensure_console_logging, error,
                                            get_run_checkpoints, info,
                                            resolve_device, warning)


def checkpoint_epoch(path):
    """Parse the epoch index out of a checkpoint name
    (names look like <ts>_ep_E_btch_B_gs_G.ckpt)."""
    m = re.search(r"_ep_(\d+)_", os.path.basename(path))
    return int(m.group(1)) if m else None


def filter_checkpoints(ckpts, only=None, omit=None):
    out = []
    for c in ckpts:
        ep = checkpoint_epoch(c)
        if only and (ep is None or ep not in only):
            continue
        if omit and ep is not None and ep in omit:
            continue
        out.append(c)
    return out


def rewrite_config(config_path, checkpoint, out_path):
    """Val-phase copy of the config resuming ``checkpoint``, as JSON."""
    docs = load_documents(config_path)
    run = docs["run"]
    run["phase"] = "defs.phase.val"
    run["resume_file"] = checkpoint
    for dataobj in run.get("data", {}).values():
        if dataobj.get("phase", "").endswith("train"):
            dataobj["phase"] = "defs.phase.val"
    with open(out_path, "w") as f:
        json.dump(docs, f, indent=1)
    return out_path


def evaluate(config_path, checkpoints_dir=None, only=None, omit=None,
             use_subprocess=False, device="cuda"):
    """{checkpoint basename: top-1 accuracy (None where none was
    written)} of the val phase of ``config_path`` resumed from each
    checkpoint, on ``device``."""
    resolve_device(device)
    run_folder = load_documents(config_path)["run"]["run_folder"]
    if checkpoints_dir:
        ckpts = sorted(
            os.path.join(checkpoints_dir, x)
            for x in os.listdir(checkpoints_dir) if x.endswith(".ckpt"))
    else:
        ckpts = get_run_checkpoints(run_folder)
    ckpts = filter_checkpoints(ckpts, only, omit)
    if not ckpts:
        error("No checkpoints to evaluate.")
    info("Evaluating %d checkpoints" % len(ckpts))

    results = {}
    for i, ckpt in enumerate(ckpts):
        info("Checkpoint %d/%d: %s" % (i + 1, len(ckpts), ckpt))
        cfg_i = os.path.join(run_folder, "eval_ckpt_%d.json" % i)
        rewrite_config(config_path, ckpt, cfg_i)
        before = set(f for f in os.listdir(run_folder)
                     if f.startswith("accuracy_"))
        if use_subprocess:
            ret = subprocess.run([sys.executable, "-m",
                                  "video_learning_tpu_torch.run_task", cfg_i,
                                  "--device", str(device)])
            if ret.returncode != 0:
                warning("run_task failed for %s" % ckpt)
                continue
        else:
            from video_learning_tpu_torch import run_task
            run_task.main(cfg_i, device=device)
        after = set(f for f in os.listdir(run_folder)
                    if f.startswith("accuracy_"))
        # run_task rewrites the same accuracy_<run_id> file per run, so
        # prefer newly created files and fall back to the most recently
        # modified one; the top-k files (accuracy_top<k>_<run_id>) must
        # not shadow the top-1 file
        candidates = list(new) if (new := after - before) else list(after)
        primary = [f for f in candidates
                   if not f.startswith("accuracy_top")]
        candidates = primary or candidates
        acc = None
        if candidates:
            newest = max(candidates, key=lambda f: os.path.getmtime(
                os.path.join(run_folder, f)))
            with open(os.path.join(run_folder, newest)) as fh:
                acc = float(fh.read().strip())
        results[os.path.basename(ckpt)] = acc
        info("Checkpoint %s accuracy: %s" % (os.path.basename(ckpt), acc))
    info("All checkpoint accuracies: %s" % results)
    return results


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--checkpoints-dir")
    parser.add_argument("--only", nargs="+", type=int)
    parser.add_argument("--omit", nargs="+", type=int)
    parser.add_argument("--subprocess", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on "
                             "the CPU)")
    args = parser.parse_args(argv)
    return evaluate(args.config, args.checkpoints_dir, args.only,
                    args.omit, args.subprocess, args.device)


if __name__ == "__main__":
    main()
