"""Serving export: a trained checkpoint as a self-contained serving
artifact.

The port's copy of the export side of
``video_learning_tpu/tools/export_serving.py``.  The run config and the
checkpoint go through the production chain of ``tools/infer``
(``build_serving_context``): dummy media of the configured raw geometry
are packed, one real batch travels the serialize -> feed -> pad chain,
``Validation.build_serving_fn`` takes the exported signature (input
names, shapes, dtypes) from it, and a ``serving.ServingModule`` over the
requested buckets, with the restored (optionally EMA) parameters and the
optional int8 quantization, is saved as the artifact:

  python -m video_learning_tpu_torch.tools.export_serving run_config.json \\
      --out model.zip [--checkpoint latest|PATH|none] \\
      [--batch-items 8 | 1,8,32] [--fpc N] [--cpv N] \\
      [--int8 | --int8-static] [--ema] [--workdir DIR] [--selftest] \\
      [--device cpu]

  # consumer side
  from video_learning_tpu_torch.serving import load
  module = load("model.zip")          # on the GPU; device="cpu" here
  logits = module(frames_uint8, proc_params)   # names/shapes in .meta

A captioner's artifact decodes: it returns (B, T) int32 word indices and
its meta carries the vocabulary (``ServingModule.captions``).  The meta
records ``ema`` (whether EMA weights were baked in) and ``run_id``.

``--int8-static`` calibrates the static activation scales on the
signature batch.  The dummy media are random frames from
``np.random.RandomState(0)``, as in the JAX package, but written as
lossless binary .ppm files (read without PIL) where the JAX package
writes JPEG; their shapes alone fix the signature, but an
``--int8-static`` artifact's scales therefore come from lossless frames
where JAX's come from JPEG-decoded ones.  Validate such scales with
``tools/infer --int8-static`` on representative media.

``--mesh data=N[,model=M]`` exports inside a torch.distributed group of
N x M ranks (start every rank with ``python -m torch.distributed.run
--nproc-per-node N*M -m video_learning_tpu_torch.tools.export_serving
...``): the run config's ``mesh_shape`` is replaced by it, every rank
builds the module over that mesh, a bucket whose input rows the data
axis does not divide is refused, the meta records ``mesh`` and global
rank 0 alone writes the artifact, which ``serving.load`` serves in a
group of the same shape.  ``--platforms`` (JAX lowering targets) is
refused.
"""

import argparse
import os
import shutil
import tempfile

import numpy as np

from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.serving import load
from video_learning_tpu_torch.utils import (ensure_console_logging, error,
                                            info, warning)


def write_ppm(path, rgb):
    """An (H, W, 3) uint8 RGB array as a binary P6 file."""
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def _dummy_media(workdir, dcfg, kind, fpc, cpv, n_items):
    """``n_items`` dummy media items at the config's raw geometry, as
    .ppm files: only their shapes matter (they fix the exported
    signature).  Video folders carry enough frames for the clip sampler
    to draw ``cpv`` distinct clips."""
    from video_learning_tpu_torch.parse_opts import parse_seq

    raw_shape = dcfg.get("raw_image_shape") or dcfg.get("image_shape")
    if raw_shape is None:
        error("Config dataset needs raw_image_shape or image_shape to "
              "synthesize the export signature batch")
    h, w = [int(v) for v in parse_seq(str(raw_shape))[:2]]
    rng = np.random.RandomState(0)
    fpc = max(fpc or 1, 1)
    n_frames = fpc * (max(cpv or 1, 1) + 1)
    media = []
    for i in range(n_items):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        if kind == "video":
            vdir = os.path.join(workdir, "export_vid%d" % i)
            os.makedirs(vdir, exist_ok=True)
            for f in range(n_frames):
                write_ppm(os.path.join(vdir, "f_%04d.ppm" % f), img)
            media.append(vdir)
        else:
            p = os.path.join(workdir, "export_im%d.ppm" % i)
            write_ppm(p, img)
            media.append(p)
    return media


def export(config_file, out, checkpoint="latest", batch_items=None,
           fpc=None, cpv=None, workdir=None, int8=False, use_ema=False,
           device="cuda", platforms=None, mesh_shape=None):
    """Export the serving module of a run config and checkpoint to
    ``out``; returns its meta.  ``batch_items`` is a batch size in items
    or a list of them (buckets: each call runs at the smallest that
    holds it).  Runs on ``device``, the GPU unless given "cpu".
    ``mesh_shape`` ({"data": N, "model": M}) exports over a mesh of
    ranks (module docstring); every rank calls ``export``."""
    from video_learning_tpu_torch.batching import BatchGeometry
    from video_learning_tpu_torch.config import load_document
    from video_learning_tpu_torch.serving import ServingModule, serving_model
    from video_learning_tpu_torch.tools.infer import (_main_dataset_cfg,
                                                      _training_fpc_cpv,
                                                      build_serving_context,
                                                      next_val_feed)

    if mesh_shape:
        mesh_shape = {k: int(v) for k, v in dict(mesh_shape).items()}
        need = mesh_shape.get("data", 1) * mesh_shape.get("model", 1)
        size, rank = mesh_mod.world()
        if need != size:
            error("--mesh %s exports over a torch.distributed group of %d "
                  "ranks, but this process is in a world of %d: start the "
                  "ranks with python -m torch.distributed.run "
                  "--nproc-per-node %d" % (mesh_shape, need, size, need))
        if need == 1:
            mesh_shape = None
        elif workdir is not None:
            # every rank packs its own signature batch
            workdir = os.path.join(workdir, "rank%d" % rank)
    if platforms:
        error("--platforms names JAX lowering targets; the port's "
              "artifact holds parameters and a model spec and runs on "
              "any torch device (serving.load(path, device=...))")
    owns_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="vlt_export_")
    os.makedirs(workdir, exist_ok=True)
    try:
        _, dcfg = _main_dataset_cfg(load_document(config_file, "run"))
        size_file = str(dcfg.get("data_path")) + ".tfrecord.size"
        t_fpc, t_cpv = _training_fpc_cpv(size_file)
        kind = "video" if (fpc or t_fpc or 0) > 1 or (cpv or 0) > 0 \
            else "image"
        use_fpc = fpc or t_fpc

        buckets = sorted(set(int(b) for b in batch_items)) \
            if isinstance(batch_items, (list, tuple)) else \
            [int(batch_items or 8)]
        if not buckets:
            error("batch_items needs at least one batch size")
        if buckets[0] < 1:
            error("batch sizes must be >= 1 (got %s)" % buckets)
        media = _dummy_media(workdir, dcfg, kind, use_fpc, cpv or t_cpv,
                             buckets[-1])
        settings, feeder, model, params, val, kind = \
            build_serving_context(config_file, media, checkpoint,
                                  fpc, cpv, workdir,
                                  batch_size=buckets[-1], int8=int8,
                                  use_ema=use_ema, device=device,
                                  mesh_shape=mesh_shape)
        is_caption = model.caption_dataset is not None
        quantize = settings.val.quantize
        if int8 == "static":
            warning("int8-static export calibrates activation scales on "
                    "the synthetic signature batch; for production-"
                    "fidelity scales validate with tools/infer "
                    "--int8-static on representative media")

        # one real batch through the production chain fixes the
        # exported signature (names, shapes, dtypes, order)
        if not feeder.loop():
            error("Internal: export signature batch produced no feed")
        feed, _, _ = next_val_feed(feeder, model, BatchGeometry())
        _, names, specs = val.build_serving_fn(params, feed,
                                               decode=is_caption)
        module = ServingModule(
            serving_model(settings, model), params, batch_items=buckets,
            device=device,
            quantize=quantize,
            act_ranges=val.act_ranges if quantize == "int8_static"
            else None,
            ema=settings.serving_ema, run_id=settings.run_id,
            mesh=val.mesh)
        got = [(i["name"], tuple(i["shape"]), i["dtype"])
               for i in module.meta["inputs"]]
        want = [(n, tuple(s[0]), s[1]) for n, s in zip(names, specs)]
        if got != want:
            error("The serving module's inputs %s differ from the "
                  "signature batch's %s" % (got, want))
        if mesh_mod.is_primary():
            module.save(out)
        val.mesh.barrier()
        info("Exported serving artifact: %s (%.1f MB, buckets=%s, "
             "inputs=%s, quantize=%s, ema=%s)"
             % (out, os.path.getsize(out) / 1e6, buckets, names, quantize,
                module.meta["ema"]))
        return module.meta
    finally:
        if owns_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser(
        description="Export a trained checkpoint as a self-contained "
                    "serving artifact.")
    parser.add_argument("config", help="the run's JSON (or YAML) config")
    parser.add_argument("--out", required=True, help="output artifact path")
    parser.add_argument("--checkpoint", default="latest",
                        help="'latest', a checkpoint path, or 'none'")
    parser.add_argument("--batch-items", default="8",
                        help="batch size in items; a comma list (e.g. "
                             "1,8,32) gives buckets, and calls run at the "
                             "smallest that fits")
    parser.add_argument("--fpc", type=int,
                        help="frames per clip (default: training .size)")
    parser.add_argument("--cpv", type=int, help="clips per item")
    parser.add_argument("--int8", action="store_true",
                        help="the w8a8-quantized serving forward")
    parser.add_argument("--int8-static", action="store_true",
                        help="int8 with static activation scales "
                             "calibrated on the export signature batch")
    parser.add_argument("--ema", action="store_true",
                        help="bake the EMA shadow weights from an "
                             "ema_decay training run")
    parser.add_argument("--platforms",
                        help="JAX lowering targets: refused by the port")
    parser.add_argument("--mesh",
                        help="export a multi-device artifact, e.g. "
                             "'data=4,model=2', inside a torch.distributed "
                             "group of that many ranks")
    parser.add_argument("--workdir",
                        help="keep the signature-batch workdir here")
    parser.add_argument("--selftest", action="store_true",
                        help="reload the artifact and run zeros through "
                             "it after exporting")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on "
                             "the CPU)")
    args = parser.parse_args(argv)
    try:
        batch_items = [int(b) for b in
                       str(args.batch_items).split(",") if b.strip()]
    except ValueError:
        error("--batch-items expects an int or comma list; got %r"
              % args.batch_items)
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = {k.strip(): int(v) for k, v in
                          (kv.split("=") for kv in args.mesh.split(","))}
        except ValueError:
            error("--mesh expects 'data=N[,model=M]'; got %r" % args.mesh)
    device = (mesh_mod.init_distributed(args.device) if mesh_shape
              else args.device)
    int8 = "static" if args.int8_static else args.int8
    meta = export(args.config, args.out, checkpoint=args.checkpoint,
                  batch_items=batch_items, fpc=args.fpc, cpv=args.cpv,
                  workdir=args.workdir, int8=int8, use_ema=args.ema,
                  device=device, platforms=args.platforms,
                  mesh_shape=mesh_shape)
    if args.selftest:
        out = load(args.out, device=device).warmup()
        info("Selftest OK: output %s %s" % (out.shape, out.dtype))
    return meta


if __name__ == "__main__":
    main()
