"""Run one benchmark cell once and print its result line.

    python3 lrcn_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Needs a CUDA card (exits 2 with no result
without one, or with fewer than the cell asks for).  The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``, each number the check compared with its limit; the last
lines of standard error repeat the checks.  Exits 3 with no result if a
forbidden module (JAX, its libraries, or the JAX package) is loaded once
the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches live in the checkout, at a fixed path
CACHE = os.path.join(ROOT, ".lrcn_bench_cache")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(CACHE, "torch")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from lrcn_bench import harness
    spec = harness.load_spec()
    entry, cfg, traffic, limits = harness.resolve(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print("no result: the cell needs %d CUDA card(s); this machine "
              "has %d" % (entry["chips"], torch.cuda.device_count()
                          if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    logging.getLogger("vlt").setLevel(logging.WARNING)
    result, lines, cell = harness.run(
        args.workload, cfg, traffic, limits, spec, args.seed, args.seconds,
        bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print("no result: forbidden modules loaded: %s" % loaded,
              file=sys.stderr)
        return 3
    print("card: %s" % harness.gpu_line(), file=sys.stderr)
    print("setup phases: %s" % json.dumps(
        {"start": cell.started - T_START, **cell.phases}), file=sys.stderr)
    print("read: %s" % json.dumps(cell.read), file=sys.stderr)
    if getattr(cell, "detail", None):
        print("detail: %s" % json.dumps(cell.detail), file=sys.stderr)
    print(json.dumps(result), flush=True)
    sys.stderr.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
