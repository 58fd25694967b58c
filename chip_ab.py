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
- ``lstm_step`` at the main path's four shapes, (32, 256) and (128,
  256) (the classifier's serving forward and training step), (64, 512)
  and (256, 512) (the greedy and beam-4 caption decodes of 64 items),
  float32 (phase 2's ``lstm_case``), and the same launches with L2
  flushed between them (a 64 MiB write each time: what a launch costs
  when Wh is not in L2);
- the graphed greedy and beam-4 decodes of 64 items with lstm_step's
  microseconds a launch inside them (phase 11's ``time_captioning``,
  which also times greedy at 1, 8 and 32 items and the caption step);
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
from video_learning_tpu_torch.ops import lstm_step as ls

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
LSTM_SHAPES = ((32, 256), (128, 256), (64, 512), (256, 512))
out["lstm_step"] = [cs.lstm_case(n, gen, hidden) for n, hidden in LSTM_SHAPES]
flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
for case in out["lstm_step"]:
    n, hidden = case["batch"], case["hidden"]
    x = [torch.randn(s, generator=gen, device="cuda") * 0.1
         for s in ((n, 4 * hidden), (n, hidden), (n, hidden),
                   (hidden, 4 * hidden), (4 * hidden,))]

    def cold():
        flush.fill_(1)
        ls.lstm_step(*x)

    case["cold_ms"] = cs.cuda_ms(cold, iters=20) - \
        cs.cuda_ms(lambda: flush.fill_(1), iters=20)
del flush
torch.cuda.empty_cache()
results = {}
model_bf16, _, params = cs.caption_params()
cs.time_captioning(model_bf16, params, results)
out["decode"] = {k: results["graphs_decode"][k] for k in ("greedy_64",
                                                         "beam_64")}
del params, model_bf16
torch.cuda.empty_cache()
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
    lstm = ", ".join("(%d, %d) %.2f us (L2 flushed %.2f)"
                     % (c["batch"], c["hidden"], c["ms"] * 1e3,
                        c["cold_ms"] * 1e3) for c in r["lstm_step"])
    decode = ", ".join("%s %.2f ms, %.2f us a lstm_step"
                       % (k, 1e3 / v["graphed_captions_per_s"] * 64,
                          v.get("lstm_step_us_per_launch", float("nan")))
                       for k, v in r["decode"].items())
    serving = ", ".join("%s: %.2f ms" % (k, v["graphed_ms"])
                        for k, v in r["serving"].items())
    return ("%-6s conv1_dw_shifted %.3f ms, conv1_dw %.3f ms (bound %.3f); "
            "lrn %s; lstm_step %s; graphed decodes of 64: %s; step graphed "
            "%.2f ms, eager %.2f ms; serving graphed %s"
            % (r["turn"], r["conv1_dw_shifted"]["ms"], r["conv1_dw"]["ms"],
               r["conv1_dw"]["bound_ms"], lrn, lstm, decode,
               r["train"]["graphed_ms"], r["train"]["eager_ms"], serving))


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
         "lstm_step_ms": [c["ms"] for c in r["lstm_step"]],
         "lstm_step_cold_ms": [c["cold_ms"] for c in r["lstm_step"]],
         "decode_lstm_step_us": {k: v.get("lstm_step_us_per_launch")
                                 for k, v in r["decode"].items()},
         "decode_captions_per_s": {k: v["graphed_captions_per_s"]
                                   for k, v in r["decode"].items()},
         "train_graphed_ms": r["train"]["graphed_ms"],
         "train_eager_ms": r["train"]["eager_ms"],
         "serving_graphed_ms": {k: v["graphed_ms"]
                                for k, v in r["serving"].items()}}
        for r in turns]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
