#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA GPU, in turns.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--out results.json]

Each directory holds a checkout of the repository (``git archive`` of a
commit, unpacked into a git-ignored directory).  The script runs one
child process per turn, in the order parent, change, change, parent; a
child imports that checkout's ``chip_smoke.py`` and package (each builds
its own kernels) and measures, with ``chip_smoke``'s own cases and
timers:

- ``conv1_dw_shifted`` and ``conv1_dw`` at 2048 frames of 227x227x3,
  bf16 (phase 2's ``conv1_dw_case``: kernel, plain version, library call,
  bound);
- the LRN forward at both AlexNet sites at 2048 frames (the training
  step) and 512 frames (the 32-clip serving forward), bf16
  (``lrn_case``);
- the 128-clip bf16 training step, eager and graphed, and the bf16
  serving forward at buckets 1, 8 and 32 (phase 11's ``time_training``
  and ``time_serving``).

It prints each turn's numbers, then one JSON line with every turn.
"""

import argparse
import json
import os
import subprocess
import sys

# the child, run with a checkout as its working directory and first
# entry of sys.path
CHILD = r"""
import json
import torch
import chip_smoke as cs
from video_learning_tpu_torch.ops import _build
from video_learning_tpu_torch.ops import conv1_dw as c1

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.library()
cs.install_meter()
gen = torch.Generator(device="cuda").manual_seed(0)
out = {"gpu": cs.gpu_line()}
for fn in (c1.conv1_dw_shifted, c1.conv1_dw):
    out[fn.__name__] = cs.conv1_dw_case(fn, 2048, torch.bfloat16, gen,
                                        graph_plain=False)
    torch.cuda.empty_cache()
out["lrn"] = [cs.lrn_case(n, *site, torch.bfloat16, gen)
              for n in (cs.TRAIN_CLIPS * cs.FPC, cs.SERVE_CLIPS * cs.FPC)
              for site in cs.LRN_SITES]
torch.cuda.empty_cache()
results = {}
cs.time_training(results)
cs.time_serving(results)
out["train"] = results["graphs_train_step"]
out["serving"] = results["graphs_serving"]
print("AB_JSON " + json.dumps(out, default=str), flush=True)
"""


def turn(name, folder):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(folder))
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          cwd=os.path.abspath(folder), env=env,
                          capture_output=True, text=True)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("AB_JSON ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError("%s (%s) failed with exit code %d"
                           % (name, folder, proc.returncode))
    result = json.loads(lines[-1][len("AB_JSON "):])
    result["turn"] = name
    return result


def summary(r):
    lrn = ", ".join("%s %.4f ms (%.0f%%)"
                    % (tuple(c["shape"]), c["ms"],
                       100 * c["bound_ms"] / c["ms"]) for c in r["lrn"])
    serving = ", ".join("%s: %.2f ms" % (k, v["graphed_ms"])
                        for k, v in r["serving"].items())
    return ("%-6s conv1_dw_shifted %.3f ms, conv1_dw %.3f ms (bound %.3f); "
            "lrn %s; step graphed %.2f ms, eager %.2f ms; serving graphed "
            "%s" % (r["turn"], r["conv1_dw_shifted"]["ms"],
                    r["conv1_dw"]["ms"], r["conv1_dw"]["bound_ms"], lrn,
                    r["train"]["graphed_ms"], r["train"]["eager_ms"],
                    serving))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--out", help="also write every turn here as JSON")
    args = parser.parse_args(argv)
    turns = []
    for name in ("parent", "change", "change", "parent"):
        folder = args.parent if name == "parent" else args.change
        turns.append(turn(name, folder))
        print(summary(turns[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(turns, f, indent=1)
    print(json.dumps({"turns": [
        {"turn": r["turn"], "gpu": r["gpu"],
         "conv1_dw_shifted_ms": r["conv1_dw_shifted"]["ms"],
         "conv1_dw_ms": r["conv1_dw"]["ms"],
         "lrn_ms": [c["ms"] for c in r["lrn"]],
         "train_graphed_ms": r["train"]["graphed_ms"],
         "train_eager_ms": r["train"]["eager_ms"],
         "serving_graphed_ms": {k: v["graphed_ms"]
                                for k, v in r["serving"].items()}}
        for r in turns]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
