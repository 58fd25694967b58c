"""The readings that the check's limits are set from, for one cell, over
many seeds in one process: the program's own, its control's, and those
of planted faults.

    python3 lrcn_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --as program|control|unchanged|half_batch|altered [--seconds 2]

``program`` runs the cell as ``run.py`` does, with a short window.
``control``: a serving cell runs the program's own int8 path
(``quantize="int8"``), one precision below the configuration's bf16; a
training cell puts the reference computed in float8 (``fake_fp8``) in
the program's place and reads it against the float32 reference.  The faults
are ``faults.py``'s, planted in the program.  One JSON line a seed on
standard output: the seed, what ran, and each number the check compares.
The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from lrcn_bench import faults, harness, workload  # noqa: E402
from lrcn_bench.reference import lrcn as ref  # noqa: E402


def train_control(cfg, traffic, seed, device):
    """(control's numbers, program's numbers, each one's detail) of a
    training cell: the float8 reference's steps, each from the state its
    own step before left, and the program's, each against the float32
    reference's steps from the same states."""
    cell = workload.TrainCell(cfg, traffic, seed, torch.device(device))
    cell.setup()
    cell.release()
    lr = cfg["train"]["base_lr"]
    state, starts, losses, p_after = workload._cpu(cell.p0), [], [], []
    for k in range(workload.CHECK_STEPS):
        starts.append(state)
        loss, clipped = cell.reference_step(k, state, rnd=ref.fake_fp8)
        losses.append(loss)
        state = {n: state[n] - lr * clipped[n].cpu() for n in state}
        p_after.append(state)
    control = cell.numbers(losses, p_after, starts, cell.reference(starts))
    detail = {"control": cell.detail}
    starts = cell.starts()
    program = cell.numbers(cell.losses, cell.p_after, starts,
                           cell.reference(starts))
    detail["program"] = cell.detail
    return control, program, detail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="mode", default="program",
                    choices=["program", "control"] + sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.getLogger("vlt").setLevel(logging.WARNING)
    spec = harness.load_spec()
    _, cfg, traffic, limits = harness.resolve(spec, args.workload)
    print(json.dumps({"card": harness.gpu_line()}), flush=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        line = {"seed": seed, "as": args.mode}
        if args.mode == "control" and traffic["kind"] == "train":
            line["checks"], line["program"], line["detail"] = \
                train_control(cfg, traffic, seed, args.device)
        else:
            fault = (faults.FAULTS[args.mode]() if args.mode in faults.FAULTS
                     else contextlib.nullcontext())
            with fault:
                result, _, cell = harness.run(
                    args.workload, cfg, traffic, limits, spec, seed,
                    args.seconds, False, args.device, time.monotonic(),
                    quantize="int8" if args.mode == "control" else None)
            line["checks"] = cell.read
            line["metrics"] = {n: m["value"]
                               for n, m in result["metrics"].items()}
            if getattr(cell, "detail", None):
                line["detail"] = cell.detail
        line["seconds"] = time.monotonic() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
