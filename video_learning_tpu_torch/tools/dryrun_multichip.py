"""Multi-rank dry run: one data x model training step and the evaluation,
int8 and caption programs over a mesh of ranks, on tiny shapes.

The port's counterpart of ``__graft_entry__.dryrun_multichip``:

  python -m video_learning_tpu_torch.tools.dryrun_multichip 4 \\
      [--device cuda | cuda:0 | cpu]

starts n ranks on this machine over gloo, on the cards by default (a
card a rank; ``cuda:0`` puts every rank on card 0) and on the CPU only
with ``--device cpu``: without a card the default raises, as every
entry point of the port does.  The ranks are arranged as (data=n/2,
model=2) where n is even, else (data=n, model=1), as the JAX dry run
arranges its devices.  Each rank runs what the JAX dry run runs, with
the flagship of ``flagship.py`` (67x67 frames, fpc 4, 16 classes, 2x256
LSTM, bf16):

* one training step with ``accum_steps`` 2 and EMA (2 clips per data
  rank), after checking that the model axis split the wide kernels;
* the evaluation forward of the trained weights, then its int8 and
  int8_static forwards, each held to JAX's falsifiable check: the int8
  logits differ from the float ones (quantization did something) by
  less than half the logit scale (it did not break them);
* a captioner's training step and its greedy decode (fpc 1).

It prints one line in the JAX dry run's format, with the global shapes.
"""

import argparse

import numpy as np

from video_learning_tpu_torch.utils import (ensure_console_logging, error,
                                            resolve_device)


def _deltas(mesh, logits, quantized):
    """max |int8 - float| over every rank's rows (and the logit scale)."""
    import torch
    delta = torch.tensor([float(np.abs(quantized - logits).max())])
    scale = torch.tensor([float(np.abs(logits).max()) + 1e-9])
    return float(mesh.world_max(delta)), float(mesh.world_max(scale))


def rank_main(device, data, model_par):
    """One rank's dry run on a (data, model_par) mesh; returns its
    numbers."""
    import sys

    import torch

    from video_learning_tpu_torch.config import ValOpts
    from video_learning_tpu_torch.flagship import caption_feed, flagship
    from video_learning_tpu_torch.parallel.mesh import make_mesh, shard_feed
    from video_learning_tpu_torch.train import Train
    from video_learning_tpu_torch.val import Validation

    mesh = make_mesh({"data": data, "model": model_par})
    per_rank = 2
    settings, model = flagship()
    settings.mesh_shape = mesh.shape
    settings.train.batch_size = per_rank
    settings.train.accum_steps = 2
    settings.train.ema_decay = 0.9
    engine = Train(settings, settings.feeder, model, seed=0, device=device,
                   mesh=mesh)
    if model_par > 1:
        split = {n: tuple(p.shape) for n, p in engine._flat.items()
                 if n in engine._split}
        whole = model.param_shapes()
        if not split or any(split[n] == whole[n] for n in split):
            error("expected model-axis sharded kernels, got %s" % split)

    clips, fpc, image = per_rank * data, 4, 67
    rs = np.random.RandomState(0)
    feed = {"frames_main_input": rs.randn(clips * fpc, image, image, 3)
            .astype(np.float32),
            "labels": np.eye(settings.num_classes, dtype=np.int32)[
                np.arange(clips) % settings.num_classes]}
    local = shard_feed(feed, mesh)
    metrics = engine.run_step(local)
    if not np.isfinite(metrics["loss"]):
        error("dry run loss is not finite: %s" % metrics)
    if not all(bool(torch.isfinite(e).all()) for e in engine.ema.values()):
        error("dry run EMA is not finite")

    settings.val = ValOpts()
    params = engine.eval_params()
    val = Validation(settings, model, device=device, mesh=mesh)
    logits = val.run_forward(params, local)
    if logits.shape != (per_rank, settings.num_classes) or \
            not np.all(np.isfinite(logits)):
        error("dry run logits: shape %s, finite %s"
              % (logits.shape, np.all(np.isfinite(logits))))
    deltas = {}
    for mode in ("int8", "int8_static"):
        settings.val.quantize = mode
        out = Validation(settings, model, device=device,
                         mesh=mesh).run_forward(params, local)
        if out.shape != logits.shape or not np.all(np.isfinite(out)):
            error("%s logits: shape %s" % (mode, out.shape))
        delta, scale = _deltas(mesh, logits, out)
        if not delta > 0.0:
            error("%s forward returned logits bit-identical to the float "
                  "ones: quantization silently did nothing" % mode)
        if not delta < 0.5 * scale:
            error("%s delta %.4g exceeds 50%% of the logit scale %.4g"
                  % (mode, delta, scale))
        deltas[mode] = delta

    cap_settings, cap_model = flagship(caption=True, fpc=1)
    cap_settings.mesh_shape = mesh.shape
    cap_settings.train.batch_size = clips
    cap_feed = caption_feed(cap_settings, cap_model)
    cap_settings.train.batch_size = per_rank
    cap_settings.train.accum_steps = 2
    cap_engine = Train(cap_settings, cap_settings.feeder, cap_model, seed=0,
                       device=device, mesh=mesh)
    cap_metrics = cap_engine.run_step(shard_feed(cap_feed, mesh))
    if not np.isfinite(cap_metrics["loss"]):
        error("dry run caption loss is not finite: %s" % cap_metrics)
    cap_settings.val = ValOpts()
    words = Validation(cap_settings, cap_model, device=device,
                       mesh=mesh).run_forward(
        cap_engine.eval_params(),
        shard_feed({"frames_main_input": cap_feed["frames_main_input"]},
                   mesh), decode=True)
    T = cap_model.caption_dataset.max_sequence_length
    if words.shape != (per_rank, T) or words.dtype.kind != "i" or \
            not np.all((words >= 0) & (words < cap_settings.num_classes)):
        error("dry run decode: %s %s" % (words.shape, words.dtype))
    return {"mesh": [data, model_par], "loss": metrics["loss"],
            "val_logits": [clips, settings.num_classes],
            "int8_delta": deltas["int8"],
            "int8_static_delta": deltas["int8_static"],
            "caption_loss": cap_metrics["loss"],
            "caption_decode": [clips, T],
            "jax_loaded": any(m.split(".")[0] in ("jax", "video_learning_tpu")
                              for m in sys.modules)}


def dryrun_multichip(n_devices, device="cuda", timeout=600):
    """Run the dry run as ``n_devices`` ranks on ``device`` (the card
    unless ``device="cpu"``); returns (and prints) the JAX-format line.
    Raises if any rank fails or disagrees."""
    from video_learning_tpu_torch.parallel import launch
    resolve_device(device)
    n = int(n_devices)
    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    data = n // model_par
    results = launch.run(n, "video_learning_tpu_torch.tools."
                            "dryrun_multichip:rank_main",
                         {"data": data, "model_par": model_par},
                         device=device, backend="gloo", timeout=timeout,
                         threads=2)
    for r, res in enumerate(results):
        if res["jax_loaded"]:
            error("rank %d imported JAX or the JAX package" % r)
        for key in ("loss", "caption_loss", "int8_delta",
                    "int8_static_delta"):
            if res[key] != results[0][key]:
                error("rank %d's %s %r differs from rank 0's %r"
                      % (r, key, res[key], results[0][key]))
    res = results[0]
    line = ("dryrun_multichip OK: mesh=(data=%d, model=%d) loss=%.4f "
            "val_logits=%s int8_delta=%.4g int8_static_delta=%.4g "
            "caption_loss=%.4f caption_decode=%s"
            % (data, model_par, res["loss"], tuple(res["val_logits"]),
               res["int8_delta"], res["int8_static_delta"],
               res["caption_loss"], tuple(res["caption_decode"])))
    print(line, flush=True)
    return line


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser(
        description="A data x model dry run over n ranks (gloo).")
    parser.add_argument("n_devices", type=int, help="number of ranks")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: a card a rank), cuda:0 (every "
                             "rank on card 0) or cpu")
    parser.add_argument("--timeout", type=float, default=600)
    args = parser.parse_args(argv)
    return dryrun_multichip(args.n_devices, args.device, args.timeout)


if __name__ == "__main__":
    main()
