"""Validation engine: the evaluation forward, logits accumulation and
fusion, chunk files, accuracies and caption scoring.

Counterpart of ``video_learning_tpu/val.py``.  The forward runs under
``torch.inference_mode()``: the val datasets' device preprocessors,
then ``Model.apply(train=False)`` (or ``decode=True`` for a captioner),
with ``val: quantize`` pre-quantizing the frame encoders once per
parameter tree (``int8_static`` calibrated on the first batch).  What
follows is numpy on the host, as in the JAX package: per-clip or per-item
logits with their labels, padding rows dropped; clip logits fused into
video rows (``avg`` or ``last``) in both batch granularities
(``batch_item: clip`` accumulates until a video's clips are complete,
``default`` fuses each batch's videos at once); the accumulated rows
pickled in ``validation_logits_<run>_<time>.part_N`` chunks (or one
``.total`` for a non-positive ``logits_save_interval``); top-1 accuracy
averaged over the chunks unweighted and top-k weighted by chunk size;
and for a captioner the decoded rows written as ``coco.results.json``
and scored by ``metrics/coco_eval.py`` into ``coco.results.json.eval.json``.

``serving_forward`` is the forward itself, the one computation behind
``run_forward``, ``build_serving_fn`` (the serving computation that
``tools/export_serving`` takes its signature from) and
``serving.ServingModule``, so evaluation, inference and the exported
artifact cannot drift apart.  On the card it runs as CUDA graph replays
(``ForwardGraphs``), the counterpart of the JAX package's
``jax.jit(forward)`` and ``jax.jit(decode)``; ``graphs=False`` keeps it
eager.

On a mesh (``mesh``, or the run config's ``mesh_shape`` in a group of
more than one rank) every rank evaluates the feed it was given: its own
rows.  That is the port's counterpart of the JAX ``_local_rows``: JAX
assembles the processes' local rows into one global batch, runs it and
hands each process its rows back, while here each rank computes only its
rows, so no gather of the outputs is needed.  (Validation datasets are
not host-sharded, so in a run every rank evaluates the whole set, as
every JAX host does.)  The whole parameter tree a caller passes is cut
into this rank's slices once per parameter content, as the JAX cache
places it once; the model-axis collectives run inside
``Model.apply(mesh=...)``, and the int8 activation ranges, dynamic and
calibrated, are the MAX over the data group, the global batch's.  Only
global rank 0 writes the chunk files and the caption JSON; the others
keep their rows in memory, so every rank computes the same accuracies.
On an NCCL mesh the forward runs as graph replays that hold its
collectives; a gloo mesh runs it eagerly, as in ``Train``.
"""

import json
import os
import pickle

import numpy as np
import torch

from video_learning_tpu_torch import graphs as graphs_mod
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.ops.preprocess import (make_preprocessor,
                                                     supports_device_path)
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.parallel import sharding
from video_learning_tpu_torch.utils import (debug, duplicates, error, info,
                                            resolve_device, warning)


def serving_forward(model, preprocessors, params, feed, decode=False,
                    quantize=None, **kw):
    """The evaluation forward on a feed of device tensors, under
    ``torch.inference_mode()``: each visual input with a
    ``<key>/proc_params`` entry through its device preprocessor
    (``preprocessors``: {key: preprocessor}), then
    ``model.apply(train=False)``; ``decode`` runs a captioner's decode,
    ``quantize`` the int8 forward on pre-quantized ``params``.  ``feed``
    is changed in place."""
    with torch.inference_mode():
        for key, pre in preprocessors.items():
            pkey = key + "/proc_params"
            if pkey in feed:
                feed[key] = pre(feed[key], feed.pop(pkey))
        return model.apply(params, feed, train=False, decode=decode,
                           quantize=quantize, **kw)


class ForwardGraphs:
    """``serving_forward`` as CUDA graph replays: one program per (feed
    shapes and dtypes, ``decode`` with the caption search options of
    ``settings.captioning``, ``quantize``, the memory of the parameter
    tree), captured at its first call (which runs eagerly and is the
    capture's warmup), all in one memory pool.  The classifier
    forward, the greedy and beam decodes and the int8 forwards all go
    through it.  A graph reads the parameters where they were at capture:
    they may change in place between calls (the live weights of a
    training run), and a tree at other addresses (the EMA, a re-quantized
    tree) gets a program of its own.  ``mesh``: this rank's forward on a
    mesh of an NCCL group (``Model.apply(mesh=...)``), whose collectives
    the programs hold."""

    def __init__(self, mesh=None):
        self.cache = graphs_mod.ProgramCache("the serving forward")
        self.mesh = mesh

    def __call__(self, model, preprocessors, params, feed, decode=False,
                 quantize=None):
        def forward(inputs):
            return serving_forward(model, preprocessors, params, inputs,
                                   decode=decode, quantize=quantize,
                                   mesh=self.mesh)

        cap = model.settings.captioning if decode else None
        search = None if cap is None else (
            cap.caption_search, cap.beam_width, cap.length_norm)
        key = (decode, search, quantize, graphs_mod.storage_key(params))
        return self.cache.run(key, forward, feed, keep=params)


def _first_leaf(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


class Validation:
    """Evaluation of ``model`` (its forward on ``device``, the GPU by
    default), or with ``model=None`` the host-side accumulation and
    scoring alone.  ``graphs`` (default: on for a CUDA device) runs the
    forward as ``ForwardGraphs`` replays; ``graphs=False`` keeps it
    eager.  ``mesh`` (default: ``make_mesh`` of ``settings.mesh_shape``)
    evaluates this rank's rows on a mesh (module docstring): graphed on
    an NCCL group, while on gloo ``graphs=True`` raises as in
    ``Train``."""

    def __init__(self, settings, model=None, device="cuda", graphs=None,
                 mesh=None):
        self._is_main_process = mesh_mod.is_primary()
        if not settings.val:
            return
        self.settings = settings
        self.model = model
        self.mesh = None
        if model is not None:
            self.mesh = mesh if mesh is not None else mesh_mod.make_mesh(
                getattr(settings, "mesh_shape", None))
            graphs = mesh_mod.graphs_on_mesh(self.mesh, graphs,
                                             "Validation")
        # only the forward needs a device: accumulation and scoring are
        # host numpy
        self.device = resolve_device(device) if model is not None else None
        self.num_classes = settings.num_classes
        self.reset_accumulation()
        self.validation_logits_save_interval = \
            settings.val.logits_save_interval
        self.run_folder = settings.run_folder
        self.run_id = settings.run_id
        self.timestamp = settings.timestamp
        self._preprocessors = {}
        use = (self.device is not None and self.device.type == "cuda"
               if graphs is None else bool(graphs))
        if use and (self.device is None or self.device.type != "cuda"):
            error("Validation: graphs=True needs a model on a CUDA device")
        self._graphs = ForwardGraphs(self.mesh) if use else None
        self.release_params()
        if model is not None:
            self._build_forward()

    # ------------------------------------------------------------ forward
    def _build_forward(self):
        for key, itype, tag in self.model.required_input:
            if itype != defs.net_input.visual:
                continue
            dsets = self.settings.feeder.get_dataset_by_tag(tag)
            if dsets and dsets[0].device_preprocess and \
                    dsets[0].processor is not None:
                if not supports_device_path(dsets[0].imgproc, dsets[0]):
                    error("Device preprocessing unsupported for imgproc %s"
                          % dsets[0].imgproc)
                self._preprocessors[key] = make_preprocessor(
                    dsets[0].processor, out_dtype=self.model.compute_dtype,
                    device=self.device)
        quantize = getattr(self.settings.val, "quantize", None)
        if quantize:
            info("Evaluation forward quantized: %s (w8a8 frame encoders)"
                 % quantize)

    def _on_device(self, feed):
        """The feed's arrays as tensors on the device (a new dict)."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v)))
                .to(self.device) for k, v in feed.items()}

    def _calibration_ranges(self, params, feed, decode=False):
        """{pipeline: {layer: amax}} of one float forward over ``feed``
        (the first eval batch), through the same preprocessing and DAG as
        the evaluation forward: the static scales of int8_static."""
        taps = {}
        serving_forward(self.model, self._preprocessors, params,
                        self._on_device(feed), decode=decode,
                        calib_taps=taps, mesh=self.mesh)
        if not taps:
            error("int8_static calibration collected no activation "
                  "ranges — no pipeline has an int8-capable frame "
                  "encoder (DCNN)")
        taps = {p: {k: float(v) for k, v in t.items()}
                for p, t in taps.items()}
        info("int8_static calibration ranges: %s" % taps)
        return taps

    def _placed(self, params):
        """This rank's slices of a whole parameter tree, cut once per
        tree (compared by identity with its first leaf, both held, as
        ``_maybe_quantize`` compares them); the tree itself off a mesh
        or on a model axis of one."""
        if self.mesh is None or self.mesh.model == 1:
            return params
        leaf0 = _first_leaf(params)
        if params is not self._src_params or leaf0 is not self._src_leaf0:
            self._placed_params = sharding.shard_tree(
                params, self.mesh, self.model.sharded_leaves(self.mesh.model))
            self._src_params, self._src_leaf0 = params, leaf0
        return self._placed_params

    def _maybe_quantize(self, params, feed=None, decode=False):
        """The frame encoders' weights quantized once per parameter tree
        (the cache compares the tree and its first leaf by identity, and
        holds both so that neither id can be reused); int8_static
        calibrates on ``feed`` at the first call."""
        mode = getattr(self.settings.val, "quantize", None)
        if not mode:
            return params
        leaf0 = _first_leaf(params)
        if params is not self._q_src_params or \
                leaf0 is not self._q_src_leaf0:
            ranges = None
            if mode == "int8_static":
                if feed is None:
                    error("quantize: int8_static requires a calibration "
                          "batch; this entry point quantizes without one "
                          "— use 'int8' (dynamic scales) here")
                ranges = self._calibration_ranges(params, feed, decode)
            self.act_ranges = ranges
            with torch.inference_mode():
                self._q_params = self.model.quantize_params(
                    params, act_ranges=ranges)
            self._q_src_params = params
            self._q_src_leaf0 = leaf0
        return self._q_params

    def build_serving_fn(self, params, sample_feed, decode=False):
        """The bare serving computation: the evaluation forward
        (``serving_forward``) with the parameters closed over (quantized
        once, ``int8_static`` calibrated on ``sample_feed``, whose ranges
        ``act_ranges`` then holds) and the visual feed arrays as a flat
        positional signature.  ``decode`` runs a captioner's decode,
        returning (B, T) word indices.  ``sample_feed`` (a real,
        geometry-padded feed) gives the shapes and dtypes.

        Returns ``(serve_fn, names, specs)``: ``serve_fn(*arrays)`` takes
        numpy arrays or tensors and returns the output tensor on the
        device, ``names[i]`` is the feed key of positional input ``i``
        and ``specs[i]`` its ``(shape, dtype name)``."""
        quantize = getattr(self.settings.val, "quantize", None)
        params = self._maybe_quantize(self._placed(params), sample_feed,
                                      decode)
        names = []
        for key, itype, _ in self.model.required_input:
            if itype != defs.net_input.visual:
                continue
            names.append(key)
            pkey = key + "/proc_params"
            if key in self._preprocessors and pkey in sample_feed:
                names.append(pkey)
        if not names:
            error("No visual inputs to export")

        def serve(*arrays):
            return self._forward(params, self._on_device(
                dict(zip(names, arrays))), decode, quantize)

        specs = [(tuple(sample_feed[n].shape),
                  str(sample_feed[n].dtype).replace("torch.", ""))
                 for n in names]
        return serve, names, specs

    def run_forward(self, params, feed, decode=False):
        """Logits (float32 numpy) of a padded feed, or a captioner's
        decoded (items, T) int32 word indices with ``decode``.  On a mesh
        ``params`` is the whole tree and ``feed`` this rank's rows, and
        the rows returned are this rank's (module docstring)."""
        quantize = getattr(self.settings.val, "quantize", None)
        params = self._maybe_quantize(self._placed(params), feed, decode)
        out = self._forward(params, self._on_device(feed), decode, quantize)
        out = out.to(torch.int32 if decode else torch.float32)
        return out.cpu().numpy()

    def _forward(self, params, feed, decode, quantize):
        if self._graphs is None:
            return serving_forward(self.model, self._preprocessors, params,
                                   feed, decode=decode, quantize=quantize,
                                   mesh=self.mesh)
        return self._graphs(self.model, self._preprocessors, params, feed,
                            decode=decode, quantize=quantize)

    # ------------------------------------------------- logits accumulation
    def process_validation_logits(self, tag, settings, logits, labels,
                                  padding=0):
        """Accumulate one batch of logits; ``padding`` rows at the tail
        are dropped first."""
        logits = np.asarray(logits)
        labels = np.asarray(labels)
        if padding:
            logits = logits[:len(logits) - padding]
            labels = labels[:len(labels) - padding]
        dataset = settings.feeder.get_dataset_by_tag(tag)[0]

        if dataset.batch_item == defs.batch_item.clip:
            self.clip_logits = np.vstack((self.clip_logits, logits))
            self.clip_labels = np.vstack((self.clip_labels, labels))
            debug("Accumulated %d clip logits (total %d)"
                  % (len(logits), len(self.clip_logits)))
            while dataset.video_index < len(dataset.clips_per_video):
                cpv = dataset.clips_per_video[dataset.video_index]
                if cpv > len(self.clip_logits):
                    break
                self.apply_clip_fusion(self.clip_logits, cpv,
                                       self.clip_labels,
                                       settings.val.clip_fusion_method)
                self.clip_logits = self.clip_logits[cpv:, :]
                self.clip_labels = self.clip_labels[cpv:, :]
                dataset.video_index += 1
        else:
            if dataset.input_mode == defs.input_mode.video:
                maxvid = dataset.batch_index * dataset.batch_size
                minvid = maxvid - dataset.batch_size
                for vidx in range(minvid, maxvid):
                    if vidx >= dataset.num_items:
                        break
                    cpv = dataset.clips_per_video[vidx]
                    self.apply_clip_fusion(logits, cpv, labels,
                                           settings.val.clip_fusion_method)
                    logits = logits[cpv:, :]
                    labels = labels[cpv:, :]
                if len(logits) != 0 or len(labels) != 0:
                    error("Logits/labels non-empty after video aggregation!")
                # the rows not yet saved in a chunk, with their labels
                # (the JAX package pairs them with all labels so far,
                # which fails once a chunk has been saved)
                live = self.item_labels[len(self.item_labels)
                                        - len(self.item_logits):]
                acc = np.mean(self.get_chunk_accuracy(self.item_logits,
                                                      live))
                info("Incremental accuracy up to current batch: %2.3f" % acc)
            else:
                self.add_item_logits_labels(logits, labels)

    def apply_clip_fusion(self, clips_logits, cpv, video_labels,
                          clip_fusion):
        """Fuse the first ``cpv`` clip rows into one video row."""
        curr = clips_logits[0:cpv, :]
        label = video_labels[0, :]
        if clip_fusion == defs.fusion_method.avg:
            video_logits = np.mean(curr, axis=0)
        elif clip_fusion == defs.fusion_method.last:
            video_logits = curr[-1, :]
        else:
            error("Unsupported clip fusion [%s]" % clip_fusion)
        self.add_item_logits_labels(video_logits, label)

    def add_item_logits_labels(self, logits, label):
        self.item_logits = np.vstack((self.item_logits, logits))
        self.item_labels = np.vstack((self.item_labels, label))

    # -------------------------------------------------- chunk persistence
    def _chunk_path(self, suffix):
        return os.path.join(self.run_folder, "validation_logits_%s_%s.%s"
                            % (self.run_id, self.timestamp, suffix))

    def save_validation_logits_chunk(self, save_all=False):
        """Pickle the accumulated rows as a ``.part_N`` chunk once there
        are ``logits_save_interval`` of them (or all, at the end); a
        non-positive interval writes one ``.total`` at the end, None
        writes nothing.  Only global rank 0 writes: the others keep their
        rows in memory."""
        if not self._is_main_process:
            return
        if self.validation_logits_save_interval is None or \
                len(self.item_logits) == 0:
            return
        if self.validation_logits_save_interval <= 0:
            if save_all:
                path = self._chunk_path("total")
                info("Saving all %d validation logits to %s"
                     % (len(self.item_logits), path))
                with open(path, "wb") as f:
                    pickle.dump(self.item_logits, f)
            return
        if len(self.item_logits) >= self.validation_logits_save_interval \
                or save_all:
            path = self._chunk_path("part_%d"
                                    % self.validation_logits_save_counter)
            info("Saving a %d-row chunk of validation logits to %s"
                 % (len(self.item_logits), path))
            with open(path, "wb") as f:
                pickle.dump(self.item_logits, f)
            self.item_logits = np.zeros([0, self.num_classes], np.float32)
            self.validation_logits_save_counter += 1

    def load_validation_logits_chunk(self, chunk_idx):
        """A chunk this run wrote (pickle: only this program's files)."""
        if self.validation_logits_save_interval is None:
            return self.item_logits
        with open(self._chunk_path("part_%d" % chunk_idx), "rb") as f:
            return pickle.load(f)

    # ------------------------------------------------------------ metrics
    def reset_accumulation(self):
        """Clear the accumulation, so one Validation can score several
        passes (the inline eval of ``eval_every_epochs``)."""
        self.item_logits = np.zeros([0, self.num_classes], np.float32)
        self.item_labels = np.zeros([0, self.num_classes], np.float32)
        self.clip_logits = np.zeros([0, self.num_classes], np.float32)
        self.clip_labels = np.zeros([0, self.num_classes], np.float32)
        self.validation_logits_save_counter = 0

    def release_params(self):
        """Drop the cached quantized parameters and the forward's graphs
        with them (the inline eval calls this after each pass: training
        moves on)."""
        if self._graphs is not None:
            self._graphs = ForwardGraphs()
        self._q_src_params = None
        self._q_src_leaf0 = None
        self._q_params = None
        self.act_ranges = None
        self._src_params = None
        self._src_leaf0 = None
        self._placed_params = None

    def get_accuracy(self, k=1):
        """Accuracy over the saved chunks and the live rows; ``k`` > 1 is
        top-k."""
        return self.get_accuracies([k])[k]

    def get_accuracies(self, ks):
        """{k: accuracy} in one pass over the chunks: top-1 is the
        unweighted mean of the chunks' accuracies (the reference's rule,
        which overweights a short last chunk), top-k the mean weighted by
        chunk size."""
        accuracies = {k: [] for k in ks}
        sizes = []

        def add(logits, labels):
            sizes.append(len(logits))
            for k in ks:
                accuracies[k].append(
                    self.get_chunk_accuracy(logits, labels, k))

        curr = 0
        for idx in range(self.validation_logits_save_counter):
            logits = self.load_validation_logits_chunk(idx)
            size = len(logits)
            add(logits, self.item_labels[curr:curr + size, :])
            curr += size
        if len(self.item_logits) > 0:
            size = len(self.item_logits)
            add(self.item_logits, self.item_labels[curr:curr + size, :])
        return {k: float(np.mean(accuracies[k]) if k <= 1 else
                         np.average(accuracies[k], weights=sizes))
                for k in ks}

    def get_chunk_accuracy(self, logits, labels, k=1):
        logits = np.asarray(logits)
        ref = np.argmax(labels, axis=1)
        if k <= 1:
            pred = np.argmax(logits, axis=1)
            return np.mean(np.equal(pred, ref))
        if k >= logits.shape[1]:
            error("top_k=%d needs more than %d classes"
                  % (k, logits.shape[1]))
        topk = np.argpartition(-logits, k - 1, axis=1)[:, :k]
        return np.mean(np.any(topk == ref[:, None], axis=1))

    # --------------------------------------------------------- captioning
    def process_description(self, settings, caption_rows=None):
        """Decoded rows (``caption_rows``, EOS-trimmed index lists, or
        the saved integer chunks) -> ``coco.results.json`` -> the COCO
        metrics, written to ``coco.results.json.eval.json``.  Returns the
        scores, or None without a ground-truth file and on every rank but
        global rank 0, which alone writes (every rank decoded the same
        whole validation set)."""
        if settings.captioning.eval_type != defs.eval_type.coco:
            error("Unsupported eval type %s"
                  % settings.captioning.eval_type)
        if not self._is_main_process:
            info("Skipping the caption artifacts on rank %d"
                 % mesh_mod.world()[1])
            return None
        dataset = settings.feeder.get_dataset_by_tag(
            defs.dataset_tag.main)[0]
        ids_captions = []
        if caption_rows is not None:
            ids_captions = dataset.validation_logits_to_captions(
                caption_rows, 0)
        else:
            if self.validation_logits_save_counter == 0:
                error("No decoded caption rows were passed and no saved "
                      "chunks exist; run the val phase with a caption "
                      "model first")
            num = 0
            for idx in range(self.validation_logits_save_counter):
                chunk = self.load_validation_logits_chunk(idx)
                if np.asarray(chunk).dtype.kind != "i":
                    error("Saved chunk %d holds %s data, not integer word "
                          "indices — these are classification logits, "
                          "not decoded captions"
                          % (idx, np.asarray(chunk).dtype))
                ids_captions.extend(
                    dataset.validation_logits_to_captions(chunk, num))
                num += len(chunk)
        dupl = [obj["image_id"] for obj in ids_captions]
        if duplicates(dupl):
            error("Duplicate image ids in coco validation: %s" % str(dupl))
        results_file = os.path.join(settings.run_folder,
                                    "coco.results.json")
        info("Writing captioning results to %s" % results_file)
        with open(results_file, "w") as fp:
            json.dump(ids_captions, fp)
        gt = settings.captioning.caption_ground_truth
        if not gt or not os.path.exists(str(gt)):
            warning("No caption ground truth file; skipping metric "
                    "computation.")
            return None
        from video_learning_tpu_torch.metrics.coco_eval import \
            evaluate_captions
        scores = evaluate_captions(results_file, gt)
        with open(results_file + ".eval.json", "w") as f:
            json.dump(scores, f, indent=2)
        info("Caption metrics: %s" % scores)
        return scores
