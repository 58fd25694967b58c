"""Metrics viewer: summarize a run's JSONL step metrics in the terminal.

The port's counterpart of ``video_learning_tpu/tools/plot_metrics.py``:
``run_task`` streams per-step scalars to
``<run_folder>/<tensorboard_folder>/<phase>/metrics_<run_id>.jsonl``
(``observe.MetricsWriter``); this prints each key's first, last, min and
max and a sparkline of its values (text, no matplotlib).

Usage: python -m video_learning_tpu_torch.tools.plot_metrics <metrics.jsonl>
           [--key loss] [--width 60]
"""


import argparse
import json

from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def sparkline(values, width=60):
    if not values:
        return ""
    if len(values) > width:
        stride = len(values) / width
        values = [values[int(i * stride)] for i in range(width)]
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    blocks = "▁▂▃▄▅▆▇█"
    return "".join(blocks[int((v - lo) / span * (len(blocks) - 1))]
                   for v in values)


def summarize(path, key=None, width=60):
    rows = load(path)
    if not rows:
        error("No metrics in %s" % path)
    keys = [k for k in rows[-1] if k not in ("step", "time")]
    if key:
        keys = [key]
    info("%d steps (%d..%d)" % (len(rows), rows[0]["step"],
                                rows[-1]["step"]))
    out = {}
    for k in keys:
        values = [r[k] for r in rows if k in r and
                  isinstance(r[k], (int, float))]
        if not values:
            continue
        out[k] = {"first": values[0], "last": values[-1],
                  "min": min(values), "max": max(values)}
        info("%-12s first %10.5f  last %10.5f  min %10.5f  max %10.5f"
             % (k, values[0], values[-1], min(values), max(values)))
        info("%-12s %s" % ("", sparkline(values, width)))
    return out


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("metrics_file")
    parser.add_argument("--key")
    parser.add_argument("--width", type=int, default=60)
    args = parser.parse_args(argv)
    return summarize(args.metrics_file, args.key, args.width)


if __name__ == "__main__":
    main()
