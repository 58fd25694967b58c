"""The spread of a set of runs, as the bounds are set from it.

    python3 lrcn_bench/spread.py RESULTS...

Each file holds a run's output (its last JSON line is the result).  For
every metric: the runs, the median, the first and third quartiles of
``statistics.quantiles(values, n=4)`` and the spread, their distance as
a share of the median.
"""

import json
import statistics
import sys


def result_of(path):
    """The last JSON object line of a run's output."""
    with open(path) as f:
        lines = [l for l in f.read().splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def spread(values):
    """(median, q1, q3, (q3 - q1) / median)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / med


def table(results):
    by = {}
    for r in results:
        for name, m in r["metrics"].items():
            by.setdefault(name, []).append(m["value"])
    return {name: (len(v),) + spread(v) for name, v in by.items()
            if len(v) >= 2}


def main(argv):
    rows = table([result_of(p) for p in argv])
    for name, (n, med, q1, q3, share) in sorted(rows.items()):
        print("%-22s n=%d median %.6g q1 %.6g q3 %.6g spread %.4f%%"
              % (name, n, med, q1, q3, 100 * share))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
