"""Inference on raw media with a trained checkpoint.

The port's copy of ``video_learning_tpu/tools/infer.py``.  It answers
"run my trained model on THESE files" through the production chain: the
offline packer (``data/serialize.py``) decodes, resizes and clips the
media into a temporary record set with dummy labels, the val pipeline
feeds it, the checkpoint restores through the name-mapped loader, and
``Validation`` runs the evaluation forward or caption decode, so
inference cannot drift from evaluation.

Usage:
  python -m video_learning_tpu_torch.tools.infer run_config.json \\
      --media img1.ppm img2.ppm            # images
  python -m video_learning_tpu_torch.tools.infer run_config.json \\
      --media frames_dir1/ frames_dir2/    # video frame folders
      [--checkpoint latest|/path/ckpt|none] [--topk 5] [--classes map.txt]
      [--fpc N] [--cpv N] [--out results.json] [--workdir DIR]
      [--batch-size N] [--int8 | --int8-static] [--ema] [--device cpu]

The run config is the one the model was trained with (JSON, or YAML
where PyYAML is installed): the network DAG, image shapes, mean image
and (for captioners) the captioning document are read from it; the
train-time augmentations are replaced by the deterministic val chain
(rand_crop -> center_crop, rand_mirror dropped), and video items always
get late avg clip fusion.  ``--classes`` takes a ``classname index`` map
file.  For video folders, frames per clip and clips per item default to
the packed training set's ``.size`` sidecar (else ``--fpc``, and 1
clip); a captioner's decode length comes from the config, else from that
sidecar.  ``--checkpoint none`` runs fresh parameters (smoke mode).  The
rewritten run config (``infer_run.json``) and the pack config
(``pack.json``) are written as JSON into the work folder.  Output: one
JSON row per media item with either the top-k ``[class, probability]``
pairs or the decoded caption.  Runs on the GPU unless ``--device cpu``.
"""

import argparse
import json
import logging
import os
import shutil
import tempfile

import numpy as np

from video_learning_tpu_torch.tools.combine_logits import load_class_map
from video_learning_tpu_torch.utils import (ensure_console_logging, error,
                                            info, warning)


def _media_kind(paths):
    # existence first: a mistyped folder path must report "not found",
    # not a misleading mixed-kinds error
    for p in paths:
        if not os.path.exists(p):
            error("Media not found: %s" % p)
    kinds = {"video" if os.path.isdir(p) else "image" for p in paths}
    if len(kinds) != 1:
        error("Mix of image files and frame folders in --media; run the "
              "tool once per media kind")
    return kinds.pop()


def _main_dataset_cfg(run_cfg):
    data = run_cfg.get("data")
    if not data:
        error("Run config has no data: section")
    if len(data) > 1:
        error("Inference supports configs with exactly one dataset; "
              "found %d" % len(data))
    mains = [(name, d) for name, d in data.items()
             if d.get("tag") == "defs.dataset_tag.main"]
    if not mains:
        error("The config's dataset is not tagged defs.dataset_tag.main; "
              "inference needs a main-tagged dataset")
    return mains[0]


def _training_fpc_cpv(size_file):
    """Frames per clip and clips per item the model was trained with,
    from the packed training set's .size sidecar when it exists."""
    from video_learning_tpu_torch.data import records
    if os.path.exists(size_file):
        meta = records.read_size_file(size_file)
        cpi = meta["cpi"]
        cpv = cpi[0] if isinstance(cpi, list) and cpi else \
            (cpi if isinstance(cpi, int) else 1)
        return meta["fpc"] or 1, cpv or 1
    return None, None


def _val_imgproc(imgproc):
    out = []
    for op in imgproc or []:
        if op == "defs.imgproc.rand_crop":
            op = "defs.imgproc.center_crop"
        if op == "defs.imgproc.rand_mirror":
            continue
        if op not in out:
            out.append(op)
    return out


def _stage_media(workdir, media):
    """The packer's list-file format is space-delimited ``path label...``,
    so a media path containing whitespace would be cut at its first
    space: stage a space-free symlink (keeping the extension, which
    drives image/video mode inference)."""
    staged = []
    link_dir = None
    for i, p in enumerate(media):
        p = os.path.abspath(p)
        if not any(c.isspace() for c in p):
            staged.append(p)
            continue
        if link_dir is None:
            link_dir = os.path.join(workdir, "staged")
            os.makedirs(link_dir, exist_ok=True)
        link = os.path.join(link_dir,
                            "item_%05d%s" % (i, os.path.splitext(p)[1]))
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(p, link)
        staged.append(link)
    return staged


def _pack_media(workdir, media, kind, dcfg, fpc, cpv):
    """Serialize the media into a temporary record set with dummy labels,
    through the production packer.  Returns the paths file."""
    from video_learning_tpu_torch.data import serialize as ser
    media = _stage_media(workdir, media)
    if kind == "image":
        # the packer infers image-vs-video mode from the first path's
        # suffix against frame_format: a .ppm fed to a jpg-trained config
        # must still pack as an image, so the format follows the media
        frame_format = os.path.splitext(media[0])[1][1:]
        if not frame_format:
            error("Image media needs a file extension (the packer infers "
                  "image-vs-video mode from it): %s" % media[0])
    else:
        frame_format = dcfg.get("frame_format", "jpg")
    paths_file = os.path.join(workdir, "media.infer")
    with open(paths_file, "w") as f:
        for p in media:
            f.write("%s 0\n" % p)
    ser_cfg = {"serialize": {
        "output_folder": None,
        "path_prepend_folder": None,
        "input_files": [paths_file],
        "run_id": "infer_pack",
        "num_threads": 2,
        "num_items_per_thread": 16,
        "raw_image_shape": dcfg.get("raw_image_shape"),
        "clip_offset_or_num": cpv if kind == "video" else 1,
        "num_frames_per_clip": fpc if kind == "video" else 1,
        "clipframe_mode": "defs.clipframe_mode.rand_clips"
                          if kind == "video"
                          else "defs.clipframe_mode.iterative",
        "generation_error": "defs.generation_error.abort",
        "do_shuffle": False,
        "do_serialize": True,
        "do_validate": False,
        "validate_pcnt": 0,
        "frame_format": frame_format,
        "logging_level": "logging.INFO",
        "log_folder": workdir,
        "seed": 0,
    }}
    cfg_path = os.path.join(workdir, "pack.json")
    with open(cfg_path, "w") as f:
        json.dump(ser_cfg, f, indent=1)
    ser.main(["serialize", cfg_path])
    return paths_file


def _softmax(logits):
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def build_serving_context(config_file, media, checkpoint="latest",
                          fpc=None, cpv=None, workdir=None,
                          batch_size=None, int8=False, use_ema=False,
                          device="cuda", mesh_shape=None):
    """Pack ``media`` and build the serving stack of a training run
    config on ``device`` (the GPU unless given "cpu"): (settings, feeder,
    model, restored params, Validation, media kind).  Shared by the
    inference CLI and the exporter (``tools/export_serving``), so neither
    can drift from the pack -> feed -> restore -> forward chain.  The
    caller owns ``workdir`` (it must exist).  ``settings.serving_ema``
    records whether EMA weights were restored.  ``mesh_shape`` replaces
    the run config's (the exporter's ``--mesh``)."""
    from video_learning_tpu_torch import checkpoint as ckpt_mod
    from video_learning_tpu_torch.config import Settings, load_documents
    from video_learning_tpu_torch.data import records
    from video_learning_tpu_torch.models.pipeline import Model
    from video_learning_tpu_torch.utils import resolve_device
    from video_learning_tpu_torch.val import Validation

    device = resolve_device(device)
    docs = load_documents(config_file)
    if "run" not in docs:
        error("Config %s has no run: document" % config_file)
    run_cfg = docs["run"]
    kind = _media_kind(media)
    name, dcfg = _main_dataset_cfg(run_cfg)
    # the packed training set's sidecar (fpc/cpv and caption length the
    # model was trained with), resolved before dcfg is rewritten
    train_size_file = str(dcfg.get("data_path")) + ".tfrecord.size"

    if kind == "video":
        t_fpc, t_cpv = _training_fpc_cpv(train_size_file)
        fpc = fpc or t_fpc
        cpv = cpv or t_cpv or 1
        if not fpc:
            error("Cannot determine frames-per-clip for video media: "
                  "no .size sidecar next to the training data_path; "
                  "pass --fpc")
        info("Video inference: %d clip(s) x %d frame(s) per item"
             % (cpv, fpc))
    paths_file = _pack_media(workdir, media, kind, dcfg, fpc, cpv)

    # rewrite the run document for a resumed, deterministic val pass
    # over the packed media
    run_cfg = dict(run_cfg)
    if "captioning" in run_cfg and \
            not run_cfg["captioning"].get("caption_max_length"):
        # the packed media carries dummy 1-token labels; without a
        # configured cap the decode length would shrink to 1, so the
        # training set's caption length carries over
        if os.path.exists(train_size_file):
            run_cfg["captioning"] = dict(run_cfg["captioning"])
            run_cfg["captioning"]["caption_max_length"] = \
                records.read_size_file(train_size_file)["labelcount"]
        else:
            error("Captioning inference needs captioning."
                  "caption_max_length in the config (or a .size "
                  "sidecar next to the training data_path)")
    run_cfg["phase"] = "defs.phase.val"
    run_cfg["resume_file"] = None if checkpoint in (None, "none") \
        else checkpoint
    run_cfg["run_id"] = str(run_cfg.get("run_id", "run")) + "_infer"
    dcfg = dict(dcfg)
    dcfg["data_path"] = paths_file
    dcfg["data_format"] = "defs.data_format.tfrecord"
    dcfg["phase"] = "defs.phase.val"
    dcfg["imgproc"] = _val_imgproc(dcfg.get("imgproc"))
    run_cfg["data"] = {name: dcfg}
    # a val: block with inference defaults (the model may have been
    # trained with a train-only config)
    val_cfg = dict(run_cfg.get("val") or {})
    if batch_size:
        val_cfg["batch_size"] = batch_size
    val_cfg.setdefault("batch_size", 8)
    if int8:
        # the w8a8 forward of the frame encoders; int8="static"
        # calibrates static activation scales on the first batch instead
        # of reducing an amax per batch
        val_cfg["quantize"] = "int8_static" if int8 == "static" \
            else "int8"
    if use_ema:
        val_cfg["use_ema"] = True
    if kind == "video" and not val_cfg.get("clip_fusion"):
        # video items always pass through clip fusion at accumulation
        val_cfg["clip_fusion"] = ["defs.fusion_type.late",
                                  "defs.fusion_method.avg"]
    run_cfg["val"] = val_cfg
    if mesh_shape:
        run_cfg["mesh_shape"] = dict(mesh_shape)
    docs = dict(docs)
    docs["run"] = run_cfg
    infer_cfg = os.path.join(workdir, "infer_run.json")
    with open(infer_cfg, "w") as f:
        json.dump(docs, f, indent=1)

    settings = Settings()
    feeder = settings.initialize(infer_cfg)
    model = Model(settings)
    params = model.init_params(settings.seed, device=device)
    ema_used = False
    if run_cfg["resume_file"]:
        state, ignorables = ckpt_mod.prepare_eval_state(
            params, model.get_ignorable_variable_names(), use_ema)
        loaded = []
        state = feeder.init_saveload(
            state, settings.resume_file, ignorables, loaded_out=loaded)
        params, ema_used = ckpt_mod.select_eval_params(
            state, loaded, use_ema, True, "--ema")
    else:
        if use_ema:
            warning("--ema requested but no checkpoint is restored "
                    "(--checkpoint none); serving fresh parameters")
        info("No checkpoint given (--checkpoint none): running with "
             "fresh parameters (smoke mode)")
    # provenance for the exporter: whether EMA weights were actually
    # restored (the request falls back to the live weights without them)
    settings.serving_ema = ema_used

    val = Validation(settings, model, device=device)
    val.validation_logits_save_interval = None  # no chunk pickles
    return settings, feeder, model, params, val, kind


def next_val_feed(feeder, model, geometry):
    """The feeder's next batch as the val loop feeds it: caption inputs
    attached, tensors on the host, padded by ``geometry`` (a
    ``BatchGeometry``).  Returns (feed, batches, padding rows)."""
    from video_learning_tpu_torch import run_task
    from video_learning_tpu_torch.data.feeder import prepare_feed

    feed, batches = feeder.get_feed(model.required_input)
    feed = run_task._host_tensors(prepare_feed(feed, batches))
    feed, _, padding = geometry.pad_feed(feed)
    return feed, batches, padding


def infer(config_file, media, checkpoint="latest", topk=5, classes=None,
          fpc=None, cpv=None, out=None, workdir=None, batch_size=None,
          int8=False, use_ema=False, device="cuda"):
    """One result row per media item: {"media", "topk": [[class,
    probability], ...]} or {"media", "caption"}."""
    from video_learning_tpu_torch import run_task
    from video_learning_tpu_torch.batching import BatchGeometry

    owns_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="vlt_infer_")
    os.makedirs(workdir, exist_ok=True)
    try:
        settings, feeder, model, params, val, kind = \
            build_serving_context(config_file, media, checkpoint,
                                  fpc, cpv, workdir, batch_size, int8,
                                  use_ema=use_ema, device=device)
        geometry = BatchGeometry()
        is_caption = model.caption_dataset is not None
        caption_rows = []
        # the val accumulator logs incremental "accuracy" against the
        # dummy labels, meaningless here: quiet the loop
        logger = logging.getLogger("vlt")
        prev_level = logger.level
        logger.setLevel(max(logger.getEffectiveLevel(), logging.WARNING))
        try:
            while feeder.loop():
                feed, batches, padding = next_val_feed(feeder, model,
                                                       geometry)
                run_task.run_val_batch(settings, val, params, model,
                                       feed, batches, padding,
                                       caption_rows)
        finally:
            logger.setLevel(prev_level)

        results = []
        if is_caption:
            if len(caption_rows) != len(media):
                error("Produced %d captions for %d media items"
                      % (len(caption_rows), len(media)))
            vocab = model.caption_dataset.vocabulary
            for path, row in zip(media, caption_rows):
                results.append({"media": path,
                                "caption": " ".join(vocab[i]
                                                    for i in row)})
        else:
            logits = np.asarray(val.item_logits)
            if len(logits) != len(media):
                error("Produced %d predictions for %d media items"
                      % (len(logits), len(media)))
            idx2name = None
            if classes:
                idx2name = load_class_map(classes)[1]
            probs = _softmax(logits)
            k = min(topk, probs.shape[-1])
            for path, p in zip(media, probs):
                order = np.argsort(-p)[:k]
                pairs = [[idx2name[int(i)] if idx2name else int(i),
                          float(p[i])] for i in order]
                results.append({"media": path, "topk": pairs})

        for r in results:
            if "caption" in r:
                info("%s -> %s" % (r["media"], r["caption"]))
            else:
                info("%s -> %s" % (r["media"],
                                   ", ".join("%s: %.3f" % (c, pr)
                                             for c, pr in r["topk"])))
        if out:
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
            info("Wrote %s" % out)
        return results
    finally:
        if owns_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser(
        description="Run a trained checkpoint on raw media.")
    parser.add_argument("config", help="the run's JSON (or YAML) config")
    parser.add_argument("--media", nargs="+", required=True,
                        help="image files or video frame folders")
    parser.add_argument("--checkpoint", default="latest",
                        help="'latest', a checkpoint path, or 'none'")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--classes", help="'classname index' map file")
    parser.add_argument("--fpc", type=int,
                        help="frames per clip for video media (default: "
                             "the training set's .size metadata)")
    parser.add_argument("--cpv", type=int,
                        help="clips per video item (default: training "
                             "metadata, else 1)")
    parser.add_argument("--out", help="write results JSON here")
    parser.add_argument("--workdir",
                        help="keep intermediate packing here instead of "
                             "a deleted temp dir")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--int8", action="store_true",
                        help="w8a8-quantize the frame encoders")
    parser.add_argument("--int8-static", action="store_true",
                        help="int8 with static activation scales "
                             "calibrated on the first batch (no "
                             "per-batch amax reductions)")
    parser.add_argument("--ema", action="store_true",
                        help="serve the EMA shadow weights from an "
                             "ema_decay training run")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on "
                             "the CPU)")
    args = parser.parse_args(argv)
    int8 = "static" if args.int8_static else args.int8
    return infer(args.config, args.media, args.checkpoint, args.topk,
                 args.classes, args.fpc, args.cpv, args.out, args.workdir,
                 args.batch_size, int8=int8, use_ema=args.ema,
                 device=args.device)


if __name__ == "__main__":
    main()
