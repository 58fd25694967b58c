"""LR-schedule projection: the decayed learning rate of every batch of a
run, without training.

The port's counterpart of ``video_learning_tpu/tools/lr_calc.py``: the
same exp / staircase / cosine x interval / drops schedule, from the
port's ``train.precompute_learning_rates`` (what ``Train`` runs), and the
same lines.

Usage:
  python -m video_learning_tpu_torch.tools.lr_calc --base-lr 0.01 \\
      --num-batches 100 --epochs 10 \\
      --decay defs.decay.exp defs.periodicity.drops 10 0.5 [--every N]
"""

import argparse
from types import SimpleNamespace

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.utils import ensure_console_logging, info


def project(base_lr, num_batches, epochs, decay, every=1):
    from video_learning_tpu_torch.train import precompute_learning_rates

    settings = SimpleNamespace(
        train=SimpleNamespace(base_lr=base_lr, epochs=epochs,
                              lr_decay=decay),
        run_folder=None, run_id="lr_calc")
    lrs = precompute_learning_rates(settings, num_batches)
    for i in range(0, len(lrs), every):
        info("step %6d (epoch %3d): lr %.8f"
             % (i, i // num_batches + 1, lrs[i]))
    info("distinct values: %d; final lr %.8f"
         % (len(set(lrs)), lrs[-1]))
    return lrs


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-lr", type=float, required=True)
    parser.add_argument("--num-batches", type=int, required=True)
    parser.add_argument("--epochs", type=int, required=True)
    parser.add_argument("--decay", nargs="+", required=True,
                        help="strategy scheme freq factor [offset]")
    parser.add_argument("--every", type=int, default=1)
    args = parser.parse_args(argv)
    decay = [defs.check(args.decay[0], defs.decay),
             defs.check(args.decay[1], defs.periodicity),
             int(args.decay[2]), float(args.decay[3])]
    if len(args.decay) > 4:
        decay.append(int(args.decay[4]))
    return project(args.base_lr, args.num_batches, args.epochs, decay,
                   args.every)


if __name__ == "__main__":
    main()
