"""Validate every checkpoint in a folder.

The port's counterpart of
``video_learning_tpu/tools/validate_checkpoints.py``: the
checkpoints-folder form of ``evaluate_multiple_checkpoints``, on the card
unless ``--device cpu``.

Usage:
  python -m video_learning_tpu_torch.tools.validate_checkpoints \\
      <config.json|yml> <checkpoints_dir> [--subprocess] [--device cuda|cpu]
"""

import argparse

from video_learning_tpu_torch.tools.evaluate_multiple_checkpoints import \
    evaluate
from video_learning_tpu_torch.utils import ensure_console_logging


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("checkpoints_dir")
    parser.add_argument("--subprocess", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on "
                             "the CPU)")
    args = parser.parse_args(argv)
    return evaluate(args.config, checkpoints_dir=args.checkpoints_dir,
                    use_subprocess=args.subprocess, device=args.device)


if __name__ == "__main__":
    main()
