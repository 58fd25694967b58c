"""Step-time decomposition of the flagship training step, on the card.

The port's counterpart of ``video_learning_tpu/tools/profile_ablation.py``:
the same rows under the same names, each stage of the benchmark training
step timed on its own at the benchmark shapes (128 clips x 16 frames of
240x320 uint8, crop 227, bf16; float32 on the CPU): preprocess, AlexNet
forward to fc7, forward+backward, forward+backward with LRN as the
identity, LRN alone at its two sites, and the 2x256 LSTM's
forward+backward; ``--per-layer`` gives the cumulative forward+backward
cost of each AlexNet stage and the deltas between them.  The stages run
the port's own modules, so on the card they go through its kernels: LRN
forward (``lrn``) and backward (``lrn_bwd``), conv1's weight gradient
(``conv1_dw_shifted``, through ``alexnet.Conv1Function``, also in
``--per-layer``) and the LSTM cell (``lstm_step``).

Timing: CUDA events around ``--inner`` back-to-back eager calls, after
one warm-up call; a row is the median of ``--reps`` such samples divided
by ``--inner`` (``--per-layer``: the least of ``--reps`` single calls,
as the JAX tool takes).  On the CPU the host clock takes the events'
place.  Eager calls, not CUDA-graph replays, so that each wrapper counts
the launches of every call: each row carries the kernel launches per
call of its stage.

Usage: python -m video_learning_tpu_torch.tools.profile_ablation
           [--batch-clips 128] [--fpc 16] [--inner 10] [--reps 3]
           [--per-layer] [--device cuda|cpu]
"""

import argparse
import statistics
import time

import numpy as np

RAW_HW, CROP = (240, 320), 227
LAYER_NAMES = ["conv1", "lrn1", "pool1", "conv2", "lrn2", "pool2",
               "conv3", "conv4", "conv5", "fc6", "fc7"]


def _launch_counts():
    from video_learning_tpu_torch.ops import conv1_dw, lrn, lstm_step
    return {"lrn": lrn.lrn.launches, "lrn_bwd": lrn.lrn_backward.launches,
            "lstm_step": lstm_step.lstm_step.launches,
            "conv1_dw": conv1_dw.conv1_dw.launches,
            "conv1_dw_shifted": conv1_dw.conv1_dw_shifted.launches}


def _samples(fn, device, inner, reps):
    """(seconds per call of each of ``reps`` samples of ``inner`` calls,
    {kernel: launches per call}) after one warm-up call."""
    import torch
    before = _launch_counts()
    fn()
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3 / inner)
        else:
            tic = time.perf_counter()
            for _ in range(inner):
                fn()
            out.append((time.perf_counter() - tic) / inner)
    calls = 1 + inner * reps
    launches = {k: (n - before[k]) / calls
                for k, n in _launch_counts().items() if n != before[k]}
    return out, launches


def _grad_fn(loss_fn, params, x):
    """A call computing d loss_fn(params, x) / d params (x needs none;
    a parameter that the loss does not reach gets no gradient)."""
    import torch

    from video_learning_tpu_torch.checkpoint import flatten_tree
    leaves = [p.requires_grad_() for p in flatten_tree(params).values()]

    def run():
        return torch.autograd.grad(loss_fn(params, x), leaves,
                                   allow_unused=True)

    return run


def _setup(args):
    import torch

    from video_learning_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    dt = torch.float32 if device.type == "cpu" else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    return device, dt, gen


def per_layer(args):
    """Cumulative forward+backward cost of each AlexNet stage at the
    benchmark shapes; successive deltas attribute time to single layers.
    Returns [(name, cumulative s, delta s, {kernel: launches per call})]."""
    import torch
    import torch.nn.functional as F

    from video_learning_tpu_torch.models import alexnet
    from video_learning_tpu_torch.models.layers import (
        conv_apply, fc_apply, flat_dim, local_response_normalization,
        max_pool)

    device, dt, gen = _setup(args)
    N = args.batch_clips * args.fpc
    params = alexnet.init(torch.Generator().manual_seed(0), 101, "fc7",
                          device=device)
    x0 = torch.randn((N, CROP, CROP, 3), generator=gen, device=device)

    def stack(upto):
        def f(p, x):
            for n, stage in enumerate(LAYER_NAMES, start=1):
                if stage == "conv1":
                    x = alexnet.Conv1Function.apply(
                        x.to(dt), p["conv1"]["w"].to(dt), p["conv1"]["b"],
                        "shifted")
                elif stage.startswith("conv"):
                    _, _, _, _, st, g = alexnet._CONV_SPECS[stage]
                    x = conv_apply(p[stage], x, (st, st), "SAME", groups=g,
                                   relu=True, compute_dtype=dt)
                elif stage.startswith("lrn"):
                    x = local_response_normalization(x)
                elif stage.startswith("pool"):
                    x = max_pool(x, (3, 3), (2, 2), "VALID")
                else:
                    if stage == "fc6":
                        x = max_pool(x, (3, 3), (2, 2), "VALID")
                        x = x.reshape(x.shape[0], flat_dim(x.shape[1:]))
                    x = F.relu(fc_apply(p[stage], x, dt))
                if n == upto:
                    return x
            return x
        return f

    rows = []
    prev = 0.0
    for i, name in enumerate(LAYER_NAMES, start=1):
        f = stack(i)
        run = _grad_fn(lambda p, x: f(p, x).to(torch.float32).sum() / N,
                       params, x0)
        ts, launches = _samples(run, device, 1, args.reps)
        t = min(ts)
        print("%-6s cum %7.1f ms  delta %7.1f ms"
              % (name, t * 1e3, (t - prev) * 1e3), flush=True)
        rows.append((name, t, t - prev, launches))
        prev = t
    return rows


def stages(args):
    """The stage decomposition: [(row name, s per call, {kernel: launches
    per call})] in the JAX tool's order and under its names."""
    import torch

    from video_learning_tpu_torch.data.imgproc import ImageProcessor
    from video_learning_tpu_torch.defs import defs
    from video_learning_tpu_torch.models import alexnet
    from video_learning_tpu_torch.models import lstm as lstm_mod
    from video_learning_tpu_torch.models.layers import \
        local_response_normalization as lrn
    from video_learning_tpu_torch.ops.preprocess import make_preprocessor

    device, dt, gen = _setup(args)
    B, F = args.batch_clips, args.fpc
    N = B * F
    rng = np.random.RandomState(0)
    rows = []

    def report(name, fn, note=""):
        ts, launches = _samples(fn, device, args.inner, args.reps)
        sec = statistics.median(ts)
        rows.append((name, sec, launches))
        print("%-28s %8.2f ms   %s" % (name, sec * 1e3, note), flush=True)

    # ---- device preprocessing: crop + mean + mirror on raw uint8
    proc = ImageProcessor(
        [defs.imgproc.rand_crop, defs.imgproc.sub_mean,
         defs.imgproc.rand_mirror],
        RAW_HW + (3,), (CROP, CROP, 3), [104.0, 117.0, 123.0])
    pre = make_preprocessor(proc, device=device)
    raw = torch.randint(0, 256, (N,) + RAW_HW + (3,), generator=gen,
                        device=device, dtype=torch.uint8)
    pp = np.zeros((N, 3), np.int32)
    pp[:, 0] = rng.randint(0, RAW_HW[0] - CROP + 1, N)
    pp[:, 1] = rng.randint(0, RAW_HW[1] - CROP + 1, N)
    pp[:, 2] = rng.randint(0, 2, N)
    pp = torch.as_tensor(pp, device=device)
    with torch.no_grad():
        report("preprocess (crop+mean+mir)", lambda: pre(raw, pp),
               "uint8 (%d,240,320,3) -> f32 227" % N)
    del raw

    # ---- AlexNet forward at fc7, then forward+backward
    ax_params = alexnet.init(torch.Generator().manual_seed(0), 101, "fc7",
                             device=device)
    frames = torch.randn((N, CROP, CROP, 3), generator=gen, device=device)

    def ax_fwd(p, x):
        return alexnet.apply(p, x, "fc7", compute_dtype=dt)

    def ax_loss(p, x):
        return ax_fwd(p, x).to(torch.float32).sum() / N

    with torch.no_grad():
        report("alexnet fwd (fc7)", lambda: ax_fwd(ax_params, frames))
    report("alexnet fwd+bwd", _grad_fn(ax_loss, ax_params, frames))

    # ---- AlexNet fwd+bwd without LRN (alexnet calls this module name)
    orig_lrn = alexnet.local_response_normalization
    alexnet.local_response_normalization = lambda x, *a, **k: x
    try:
        report("alexnet fwd+bwd, LRN=id",
               _grad_fn(ax_loss, ax_params, frames),
               "LRN cost = delta vs previous row")
    finally:
        alexnet.local_response_normalization = orig_lrn
    del frames

    # ---- LRN alone at its two sites (conv1/conv2 outputs)
    for shape in ((N, 57, 57, 96), (N, 28, 28, 256)):
        act = torch.randn(shape, generator=gen, device=device).to(dt)
        with torch.no_grad():
            report("lrn %s" % (shape,), lambda: lrn(act))
        del act

    # ---- LSTM classifier fwd+bwd on (B*F, 4096) frames-first
    l_params = lstm_mod.init(torch.Generator().manual_seed(1), 4096, 256, 2,
                             device=device)
    seq = torch.randn((N, 4096), generator=gen, device=device)
    lens = torch.full((B,), F, dtype=torch.int32, device=device)

    def lstm_loss(p, s):
        outs, _ = lstm_mod.evaluate_sequence(p, s, 256, F, lengths=lens,
                                             compute_dtype=dt)
        return outs.to(torch.float32).sum() / B

    report("lstm 2x256 fwd+bwd", _grad_fn(lstm_loss, l_params, seq))

    print("-" * 64)
    step_ms = (rows[0][1] + rows[2][1] + rows[-1][1]) * 1e3
    print("approx step (pre + alexnet-grad + lstm-grad): "
          "%.2f ms -> %.1f clips/s (chip_smoke.py phase 5 measures the "
          "real step)" % (step_ms, B / (step_ms / 1e3)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-clips", type=int, default=128)
    ap.add_argument("--fpc", type=int, default=16)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the "
                         "CPU, in float32)")
    ap.add_argument("--per-layer", action="store_true",
                    help="cumulative per-layer fwd+bwd deltas instead of "
                         "the stage decomposition")
    args = ap.parse_args(argv)
    if args.per_layer:
        return per_layer(args)
    return stages(args)


if __name__ == "__main__":
    main()
