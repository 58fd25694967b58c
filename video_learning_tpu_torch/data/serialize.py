"""Offline data packing ("serialize") CLI.

The port's copy of ``video_learning_tpu/data/serialize.py``, writing the
same bytes for the same config and seed: reads ``path label...`` list
files, infers the input mode (image / video folder / ascii feature
vectors) from the paths, samples clip/frame indices per video with the
three clipframe modes and the abort / compromise / report error
strategies (``data/samplers.py``), optionally shuffles (outer video
order + inner clip order), packs frames into the VLR record container
(``data/records.py``) with a parallel-read / single-writer pipeline or
``num_processes`` spawned workers whose shards are concatenated, writes
the ``.size`` metadata, the ``.shuffled`` / ``.unshuffled`` and clip
documentation files, and round-trip validates a sample of what it wrote.

The ``serialize:`` document is read as JSON, or as YAML where PyYAML is
installed (``config.load_document``).  Frames are read by
``imgproc.read_image``: binary .ppm / .pgm frames at the raw shape need
no PIL.  The log goes to ``log_folder`` (default: the working
directory).  This module imports no torch, so its worker processes start
no CUDA context.

Usage:  python -m video_learning_tpu_torch.data.serialize config.{json,yml}
"""

import os
import random
import string
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from os.path import basename, exists, isfile, join
from shutil import copyfile

import numpy as np

from video_learning_tpu_torch.config import load_document
from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.data.imgproc import read_image
from video_learning_tpu_torch.data.samplers import GenerationLog, sample_clips
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.parse_opts import parse_seq, parse_shape
from video_learning_tpu_torch.utils import (as_num, configure_logging, debug,
                                            elapsed_str, error,
                                            get_datetime_str, info,
                                            read_file_lines, sublist,
                                            warning)


class SerializationSettings:
    """The parsed ``serialize:`` document."""

    def __init__(self):
        self.init_file = None
        self.run_id = None
        self.input_files = []
        self.path_prepend_folder = None
        self.output_folder = None
        self.num_threads = 4
        self.num_items_per_thread = 500
        self.num_processes = 1
        self.num_frames_per_clip = 16
        self.raw_image_shape = (240, 320, 3)
        self.clipframe_mode = defs.clipframe_mode.rand_clips
        self.clip_offset_or_num = 1
        self.frame_format = "jpg"
        self.generation_error = defs.generation_error.compromise
        self.do_shuffle = False
        self.do_serialize = True
        self.do_validate = True
        self.validate_pcnt = 10
        self.seed = None
        self.log_folder = "."
        self.logfile = None
        self.generation_log = GenerationLog()
        self.rng = random.Random()

    def initialize_from_file(self, argv):
        if len(argv) > 1:
            self.init_file = argv[-1]
        if self.init_file is None:
            error("Need a JSON or YAML initialization file")
        if not exists(self.init_file):
            error("Initialization file [%s] does not exist" % self.init_file)
        if self.init_file.endswith(".ini"):
            error("Ini files deprecated")
        config = load_document(self.init_file, "serialize")
        self.output_folder = config.get("output_folder")
        self.path_prepend_folder = config.get("path_prepend_folder")
        self.input_files = [x.strip() for x in
                            parse_seq(config["input_files"])]
        rid = config.get("run_id")
        self.run_id = rid.strip() if isinstance(rid, str) else None
        if self.run_id in ("None", ""):
            self.run_id = None
        self.num_threads = as_num(config.get("num_threads", 4),
                                  "num_threads", int, minimum=1)
        self.num_items_per_thread = as_num(
            config.get("num_items_per_thread", 500),
            "num_items_per_thread", int, minimum=1)
        self.num_processes = as_num(config.get("num_processes", 1),
                                    "num_processes", int, minimum=1)
        if "raw_image_shape" in config:
            # explicit null is a deliberate no-resize request; an absent
            # key keeps the documented default rather than silently
            # packing frames at varying native sizes
            self.raw_image_shape = parse_shape(config["raw_image_shape"])
        else:
            info("raw_image_shape not set; using default %s"
                 % (self.raw_image_shape,))
        self.clip_offset_or_num = as_num(
            config.get("clip_offset_or_num", 1), "clip_offset_or_num",
            int)
        self.num_frames_per_clip = as_num(
            config.get("num_frames_per_clip", 16), "num_frames_per_clip",
            int, minimum=1)
        self.clipframe_mode = defs.check(config["clipframe_mode"],
                                         defs.clipframe_mode)
        self.generation_error = defs.check(config["generation_error"],
                                           defs.generation_error)
        self.do_shuffle = bool(config.get("do_shuffle", False))
        self.do_serialize = bool(config.get("do_serialize", True))
        self.do_validate = bool(config.get("do_validate", True))
        self.validate_pcnt = as_num(config.get("validate_pcnt", 10),
                                    "validate_pcnt", minimum=0.0)
        self.frame_format = str(config.get("frame_format", "jpg")).strip()
        logging_level = str(config.get("logging_level",
                                       "logging.INFO")).strip()

        if not self.run_id:
            self.run_id = "serialize_%s" % get_datetime_str()
        # the log (and a report strategy's problem list) go to
        # log_folder, by default the working directory as in the JAX
        # package; in-process callers (tools/infer) point it at their
        # workdir
        self.log_folder = str(config.get("log_folder") or ".")
        self.logfile = join(self.log_folder, "log_%s.log" % self.run_id)
        configure_logging(self.logfile, logging_level)

        if "seed" in config and config["seed"] not in (None, "None"):
            self.seed = as_num(config["seed"], "seed")
            info("Using supplied seed: %f" % self.seed)
        else:
            self.seed = random.random()
            info("Using randomized seed: %f" % self.seed)
        self.rng = random.Random(self.seed)
        info("Starting serialization run: [%s]" % self.run_id)


# ------------------------------------------------------------- input lists
def read_file(inp, settings):
    """Read a ``path label...`` list file and infer the input mode from
    the first line: numeric values are vectors, a path ending in
    ``.<frame_format>`` an image, anything else a video folder."""
    mode = None
    max_num_labels = -1
    paths, labels = [], []
    with open(inp, "r") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if " " not in line:
                error("Malformed line %d in %s (expected 'path label...'):"
                      " %r" % (lineno, inp, line))
            path, label = line.split(" ", 1)
            is_numeric = not any(c in string.ascii_letters for c in path)
            if not is_numeric:
                # scientific notation ('1.2e-05,...') contains the letter
                # 'e' but is still a feature value, not a path
                try:
                    float(path.split(",")[0])
                    is_numeric = True
                except ValueError:
                    pass
            if is_numeric:
                mode = defs.input_mode.vectors
                info("Set input mode to [%s] due to numeric path value."
                     % mode)
                break
            label = [int(l) for l in label.split()]
            max_num_labels = max(max_num_labels, len(label))
            if mode is None:
                if path.lower().endswith("." + settings.frame_format.lower()):
                    mode = defs.input_mode.image
                else:
                    mode = defs.input_mode.video
                info("Set input mode to [%s] from paths-file suffixes." % mode)
            if settings.path_prepend_folder is not None:
                path = join(settings.path_prepend_folder, path)
            paths.append(path)
            labels.append(label)
    return paths, labels, mode, max_num_labels


# --------------------------------------------------------- clip generation
def generate_frames_for_video(path, settings):
    """List a video folder's frames (sorted) and sample clip index lists,
    returning per-clip frame paths."""
    files = sorted(f for f in os.listdir(path) if isfile(join(path, f)))
    clips = sample_clips(len(files), settings.clipframe_mode,
                         settings.num_frames_per_clip,
                         settings.clip_offset_or_num, settings.rng,
                         path=basename(path),
                         strategy=settings.generation_error,
                         log=settings.generation_log)
    return [[join(path, files[idx]) for idx in clip] for clip in clips]


def generate_frames_per_video(paths_list, settings):
    tic = time.time()
    paths_per_video = []
    info("Fetching frame paths for %d videos, using %s with %d cpv/offset "
         "and %d fpc." % (len(paths_list), settings.clipframe_mode,
                          settings.clip_offset_or_num,
                          settings.num_frames_per_clip))
    for video_path in paths_list:
        paths_per_video.append(generate_frames_for_video(video_path,
                                                         settings))
    total = sum(len(p) for p in paths_per_video)
    info("Total generation time for %d clips: %s"
         % (total, elapsed_str(tic)))
    return paths_per_video


def check_cpv_per_item(paths_per_item, items_list, settings):
    """Verify every item met the prescribed cpv; only meaningful for
    rand_clips, where cpv is a target."""
    if settings.clipframe_mode != defs.clipframe_mode.rand_clips:
        return
    erratic = [i for i, p in enumerate(paths_per_item)
               if len(p) != settings.clip_offset_or_num]
    if erratic:
        for e in erratic:
            warning("Item %d/%d : %s has cpv of len %d" %
                    (e + 1, len(paths_per_item), items_list[e],
                     len(paths_per_item[e])))
        error("Erratic item(s) encountered")


# ------------------------------------------------------------------ shuffle
def shuffle_paths(item_paths, paths, labels, mode, settings):
    """Outer video-order shuffle + inner clip shuffle."""
    info("Shuffling data.")
    rng = settings.rng
    if mode == defs.input_mode.image:
        order = list(range(len(item_paths)))
        rng.shuffle(order)
        return ([item_paths[i] for i in order], [labels[i] for i in order])
    order = list(range(len(item_paths)))
    rng.shuffle(order)
    item_paths = [item_paths[i] for i in order]
    paths = [paths[i] for i in order]
    labels = [labels[i] for i in order]
    if settings.clipframe_mode == defs.clipframe_mode.rand_frames:
        for vid in paths:
            for clip in vid:
                rng.shuffle(clip)
    else:
        for vid in paths:
            rng.shuffle(vid)
    return item_paths, paths, labels


# -------------------------------------------------------------- record write
def _pack_shard(shard_args):
    """Worker: read + encode a slice of frames into its own shard file
    (process-parallel packing; image decode is GIL-bound so processes,
    not threads, scale it).  A spawned worker imports this module, which
    imports no torch, so it starts no CUDA context."""
    shard_path, paths, labels, raw_shape = shard_args
    with records.RecordWriter(shard_path) as writer:
        for p, lab in zip(paths, labels):
            image = read_image(p, raw_shape)
            writer.write(records.encode_image_example(image, lab))
    return shard_path


def serialize_multiprocess(item_paths, clips_per_item, frame_paths, labels,
                           outfile, mode, max_num_labels, settings):
    """Process-parallel packing: P workers write independent VLR shards,
    concatenated (byte-append + offset merge) into the final file, the
    same bytes as the single writer's."""
    from multiprocessing import get_context
    records.write_size_file(len(item_paths), clips_per_item, outfile, mode,
                            max_num_labels, settings.num_frames_per_clip)
    nproc = settings.num_processes
    chunk = (len(frame_paths) + nproc - 1) // nproc
    jobs = []
    for i in range(nproc):
        lo, hi = i * chunk, min((i + 1) * chunk, len(frame_paths))
        if lo >= hi:
            continue
        jobs.append(("%s.shard-%05d" % (outfile, i),
                     frame_paths[lo:hi], labels[lo:hi],
                     settings.raw_image_shape))
    tic = time.time()
    # spawn, not fork: the caller may already hold torch or CUDA threads,
    # and forking a multithreaded process can deadlock workers.  Job args
    # are plain picklable tuples, so spawn costs only interpreter startup
    # (and an import of the caller's main script, if it has one).
    with get_context("spawn").Pool(len(jobs)) as pool:
        shard_paths = pool.map(_pack_shard, jobs)
    records.concatenate(shard_paths, outfile, remove_shards=True)
    info("Packed %d frames with %d processes in %s"
         % (len(frame_paths), len(jobs), elapsed_str(tic)))


def serialize_multithread(item_paths, clips_per_item, frame_paths, labels,
                          outfile, mode, max_num_labels, settings):
    """Parallel-read / single-writer packing: frames are read in runs of
    (num_threads x num_items_per_thread), each
    run fanned out across a thread pool, results appended in order.
    With ``num_processes > 1`` the process-parallel sharded path is used
    instead."""
    if getattr(settings, "num_processes", 1) > 1:
        return serialize_multiprocess(item_paths, clips_per_item,
                                      frame_paths, labels, outfile, mode,
                                      max_num_labels, settings)
    records.write_size_file(len(item_paths), clips_per_item, outfile, mode,
                            max_num_labels, settings.num_frames_per_clip)
    per_run = settings.num_items_per_thread * settings.num_threads
    paths_per_run = sublist(frame_paths, per_run)
    labels_per_run = sublist(labels, per_run)
    tic = time.time()
    count = 0
    with records.RecordWriter(outfile) as writer, \
            ThreadPoolExecutor(max_workers=settings.num_threads) as pool:
        for run_index, (rpaths, rlabels) in enumerate(
                zip(paths_per_run, labels_per_run)):
            chunks = sublist(rpaths, settings.num_items_per_thread)
            lchunks = sublist(rlabels, settings.num_items_per_thread)
            futures = [pool.submit(_read_chunk, chunk, settings)
                       for chunk in chunks]
            for fut, lchunk in zip(futures, lchunks):
                images = fut.result()
                if isinstance(images, Exception):
                    error("A reader worker encountered an error in run %d: "
                          "%s" % (run_index, images))
                for image, lab in zip(images, lchunk):
                    writer.write(records.encode_image_example(image, lab))
                count += len(images)
            debug("Run %d/%d, packed %d/%d frames"
                  % (run_index + 1, len(paths_per_run), count,
                     len(frame_paths)))
    info("Time elapsed for file serialization: %s" % elapsed_str(tic))


def _read_chunk(paths, settings):
    try:
        return [read_image(p, settings.raw_image_shape) for p in paths]
    except Exception as ex:  # surfaced by the writer loop
        warning("Reader chunk failed: %s" % ex)
        return ex


def serialize_vectors(input_file, settings):
    """Pack an ascii feature-vector file.  Lines: "f1,f2,...,fD
    label[,label...]"; item ids come from ``<input>.ids``."""
    info("Reading existing features from file: [%s]" % input_file)
    vectors, labels, max_num_labels = read_vectors(input_file)
    ids_file = input_file + ".ids"
    ids = None
    if exists(ids_file):
        ids = [line.split()[0] for line in read_file_lines(ids_file)]
    outfile = _output_path(input_file, settings)
    shuffle_idx = None
    if settings.do_shuffle:
        shuffle_idx = list(range(len(vectors)))
        settings.rng.shuffle(shuffle_idx)
        vectors = vectors[shuffle_idx]
        labels = [labels[i] for i in shuffle_idx]
        if ids:
            ids = [ids[i] for i in shuffle_idx]
    info("Serializing existing features to file: [%s]" % outfile)
    records.write_size_file(len(vectors), [1 for _ in vectors], outfile,
                            defs.input_mode.vectors, max_num_labels,
                            settings.num_frames_per_clip)
    with records.RecordWriter(outfile) as writer:
        for vec, lab in zip(vectors, labels):
            writer.write(records.encode_vector_example(vec, lab))
    return (input_file, shuffle_idx), ids, labels, outfile


def read_vectors(input_file):
    """Parse an ascii feature file."""
    vectors, labels, max_num_labels = [], [], 1
    with open(input_file, "r") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            feature_str, label_str = line.split(" ", 1)
            row = np.asarray(feature_str.split(","), np.float32)
            try:
                lab = [int(label_str)]
            except ValueError:
                lab = [int(x) for x in label_str.split(",")]
            if vectors and len(row) != len(vectors[0]):
                error("Inconsistent dim %d at line %d (stored %d)"
                      % (len(row), i + 1, len(vectors[0])))
            vectors.append(row)
            labels.append(lab)
            max_num_labels = max(max_num_labels, len(lab))
    return np.stack(vectors), labels, max_num_labels


def _output_path(inp, settings):
    out = inp + ".tfrecord"
    if settings.output_folder is not None:
        os.makedirs(settings.output_folder, exist_ok=True)
        out = join(settings.output_folder, basename(out))
    return out


# --------------------------------------------------------------- packing
def write_serialization(settings):
    """Pack every input file.  Returns the written data descriptors +
    per-file error flags."""
    framepaths_per_input = []
    errors_per_input = [False for _ in settings.input_files]
    for idx, inp in enumerate(settings.input_files):
        info("Reading input file %d/%d: [%s]"
             % (idx + 1, len(settings.input_files), inp))
        item_paths, item_labels, mode, max_num_labels = read_file(inp,
                                                                  settings)
        if mode == defs.input_mode.vectors:
            meta, ids, labels, _ = serialize_vectors(inp, settings)
            framepaths_per_input.append((meta, labels, ids, None, mode))
            continue

        if mode == defs.input_mode.image:
            if settings.do_shuffle:
                item_paths, item_labels = shuffle_paths(
                    item_paths, None, item_labels, mode, settings)
            paths_to_serialize, labels_to_serialize = item_paths, item_labels
            clips_per_item = None
            framepaths_per_input.append([item_paths, item_labels, None, None,
                                         mode])
        elif mode == defs.input_mode.video:
            paths = generate_frames_per_video(item_paths, settings)
            stored = settings.generation_log
            if len(stored):
                errors_per_input[idx] = True
                warning("%d generation errors occurred (strategy [%s]):"
                        % (len(stored), settings.generation_error))
                for i, prob in enumerate(stored.problems):
                    warning("%d/%d: %s" % (i + 1, len(stored), prob.message))
                if settings.generation_error == defs.generation_error.report:
                    probl_file = join(
                        settings.log_folder, "generation_errors_files_%s_%s"
                        % (settings.run_id, get_datetime_str()))
                    with open(probl_file, "w") as f:
                        for prob in stored.problems:
                            f.write(prob.path + "\n")
                    info("Wrote problematic files to %s; omitting "
                         "serialization (strategy [report])." % probl_file)
                    stored.clear()
                    framepaths_per_input.append([item_paths, item_labels,
                                                 None, None, mode])
                    continue
                elif settings.generation_error == \
                        defs.generation_error.compromise:
                    stored.clear()
                    errors_per_input[idx] = False
                else:
                    error("Generated paths with errors under strategy [%s]"
                          % settings.generation_error)
            check_cpv_per_item(paths, item_paths, settings)
            if settings.do_shuffle:
                item_paths, paths, item_labels = shuffle_paths(
                    item_paths, paths, item_labels, mode, settings)
            clips_per_item = [len(vid) for vid in paths]
            labels_to_serialize = [item_labels[v]
                                   for v in range(len(item_labels))
                                   for clip in paths[v] for _ in clip]
            paths_to_serialize = [p for video in paths for clip in video
                                  for p in clip]
            framepaths_per_input.append([item_paths, item_labels,
                                         paths_to_serialize,
                                         labels_to_serialize, mode])
        else:
            error("Unknown data type: %s" % mode)

        if settings.do_serialize:
            output_file = _output_path(inp, settings)
            info("Serializing to %s" % output_file)
            serialize_multithread(item_paths, clips_per_item,
                                  paths_to_serialize, labels_to_serialize,
                                  output_file, mode, max_num_labels, settings)
            info("Done serializing %s" % inp)
    return framepaths_per_input, errors_per_input


def write_paths_file(data, errors, settings):
    """Document the shuffled order (``.shuffled`` / ``.unshuffled``) and
    the clip/frame selections (the ``.cpv/.fpc/.cfm`` file)."""
    info("Writing serialization metadata")
    for i, inp in enumerate(settings.input_files):
        if errors[i]:
            info("Skipping metadata for %s due to generation errors."
                 % basename(inp))
            continue
        item_paths, item_labels, paths, labels, mode = data[i]
        output_file = (join(settings.output_folder, basename(inp))
                       if settings.output_folder is not None else inp)
        if settings.do_shuffle:
            shuffled_file = output_file + ".shuffled"
            info("Documenting shuffled order to %s" % shuffled_file)
            if mode == defs.input_mode.vectors:
                with open(shuffled_file, "w") as f:
                    for item_id, label in zip(item_labels, paths or []):
                        f.write("%s %s\n" % (item_id, str(label)))
            else:
                copyfile(inp, output_file + ".unshuffled")
                with open(shuffled_file, "w") as f:
                    for v, item in enumerate(item_paths):
                        lab = item_labels[v]
                        labstr = (" ".join(str(l) for l in lab)
                                  if isinstance(lab, list) else str(lab))
                        f.write("%s %s\n" % (item, labstr))
        elif settings.output_folder is not None:
            copyfile(inp, output_file)

        if mode == defs.input_mode.vectors:
            continue
        if mode != defs.input_mode.video:
            continue
        clip_info = ("" if settings.clipframe_mode ==
                     defs.clipframe_mode.rand_frames
                     else ".%d.cpv" % settings.clip_offset_or_num)
        outfile = "%s%s.%d.fpc.%s.cfm" % (output_file, clip_info,
                                          settings.num_frames_per_clip,
                                          settings.clipframe_mode)
        info("Documenting selected clip/frame info to %s" % basename(outfile))
        with open(outfile, "w") as f:
            for path, label in zip(paths, labels):
                f.write("%s %s\n" % (path, " ".join(map(str, label))))


def validate(written_data, errors, settings):
    """Round-trip validation of a random sample of every written record
    file: re-read source images/vectors, decode the packed records,
    compare bytes + labels."""
    for index, inp in enumerate(settings.input_files):
        tic = time.time()
        if errors[index]:
            info("Skipping validation of %s due to generation errors."
                 % basename(inp))
            continue
        output_file = _output_path(inp, settings)
        if not isfile(output_file):
            error("Record file %s does not exist." % output_file)
        info("Validating %s" % output_file)
        item_paths, item_labels, paths, labels, mode = written_data[index]
        if mode == defs.input_mode.video and not settings.do_serialize:
            error("Cannot validate-only in video mode: frame selection is "
                  "not known.")
        if settings.do_shuffle and not settings.do_serialize:
            error("Cannot validate-only with shuffle enabled.")
        if mode == defs.input_mode.image:
            paths, labels = item_paths, item_labels
        shuffle_idx = None
        if mode == defs.input_mode.vectors:
            _, shuffle_idx = item_paths
            paths = list(range(len(item_labels)))
            labels = item_labels

        num_validate = (round(len(paths) * settings.validate_pcnt / 100)
                        if len(paths) >= 10000 else len(paths))
        info("Will validate %d of %d items." % (num_validate, len(paths)))
        idx_list = sorted(settings.rng.sample(range(len(paths)),
                                              num_validate))
        reader = records.RecordReader(output_file, verify=True)
        error_free = True
        vectors = None
        for i in idx_list:
            if mode == defs.input_mode.vectors:
                if vectors is None:
                    vectors, vlabels, _ = read_vectors(inp)
                    if settings.do_shuffle and shuffle_idx is not None:
                        vectors = vectors[shuffle_idx]
                        vlabels = [vlabels[s] for s in shuffle_idx]
                _, dvec, dlab = reader.read_at(i)
                explab = vlabels[i]
                explab = explab[0] if len(explab) == 1 else explab
                if not np.array_equal(dvec, vectors[i]):
                    warning("Unequal vector @ idx %d" % i)
                    error_free = False
                if dlab != explab:
                    warning("Unequal label @ idx %d: found %s expected %s"
                            % (i, dlab, explab))
                    error_free = False
            else:
                frame = read_image(paths[i], settings.raw_image_shape)
                _, dframe, dlab = reader.read_at(i)
                explab = labels[i]
                if isinstance(explab, list) and len(explab) == 1:
                    explab = explab[0]
                if not np.array_equal(frame, dframe):
                    warning("Unequal image @ %s" % paths[i])
                    error_free = False
                if dlab != explab:
                    warning("Unequal label @ %s: found %s, expected %s"
                            % (paths[i], dlab, explab))
                    error_free = False
        reader.close()
        if not error_free:
            error("Validation errors exist for %s." % basename(inp))
        info("Validation for %s completed successfully in %s."
             % (basename(inp) + ".tfrecord", elapsed_str(tic)))
    info("Validation completed error-free for all files.")


def main(argv=None):
    settings = SerializationSettings()
    settings.initialize_from_file(argv or sys.argv)
    written_data, errors_per_file = write_serialization(settings)
    write_paths_file(written_data, errors_per_file, settings)
    if settings.do_validate:
        info("Validating serialization")
        validate(written_data, errors_per_file, settings)
    if settings.output_folder is not None and settings.do_serialize and \
            not any(errors_per_file):
        if exists(settings.logfile):
            copyfile(settings.logfile,
                     join(settings.output_folder, basename(settings.logfile)))
        copyfile(settings.init_file,
                 join(settings.output_folder, basename(settings.init_file)))
    info("Serialization complete", email=True)


if __name__ == "__main__":
    main()
