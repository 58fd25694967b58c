"""mfu.train: the model FLOPs of the traced steps (forward, input and
weight gradients from the configuration's shapes, conv1 without an input
gradient, nothing recomputed) over the traced window, as a share of the
card's dense bf16 peak."""

from lrcn_bench import counts


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    flops = counts.train_step_flops(run.cfg, run.items) * run.calls
    return 100.0 * flops / run.window_s / counts.PEAK_OPS_PER_S["bfloat16"]
