"""Feeder: the datasets of a run, keyed by phase and tag, their feeds,
and the run's checkpoints.

The port's copy of ``video_learning_tpu/data/feeder.py``: it matches each
model input requirement ``(name, net_input_type, tag)`` to the tagged
dataset's batch, computes the save cadence from ``save_freq_per_epoch``,
saves checkpoints with their JSON ``.snap`` sidecar [batch_index,
epoch_index, global_step] (written after the parameters, on a thread with
``checkpoint_async``), keeps at most ``num_saves`` of them, and resumes
the datasets' positions and the parameters from one.  In a group of
several ranks that share one run folder only global rank 0 writes
(``save`` returns None on the others, as the JAX feeder's process check
does); every rank restores from the same files.  ``prepare_feed`` and
``count_clips`` are ``run_task._prepare_feed`` and ``_count_clips``.
"""

import json
import os

from video_learning_tpu_torch import checkpoint as ckpt_mod
from video_learning_tpu_torch.data import captions
from video_learning_tpu_torch.data import dataset as dataset_mod
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.parallel.mesh import is_primary
from video_learning_tpu_torch.utils import (error, get_datetime_str,
                                            get_run_checkpoints, info,
                                            warning)


class Feeder:

    def __init__(self, input_mode, phases, trainval, save_freq_per_epoch,
                 run_folder, resume):
        self.datasets = {}
        self.input_mode = input_mode
        self.phases = phases
        self.phase = None
        self.run_folder = run_folder
        self.resume = resume
        self.train, self.val = trainval
        self.save_freq_per_epoch = save_freq_per_epoch
        self.save_interval = -1
        self.num_saves = 0
        self.checkpoint_async = False
        self._async_saver = None

    # -------------------------------------------------------------- set-up
    def add_dataset(self, dataset_phase, id, path, mean_image, prepend_folder,
                    image_shape, imgproc, raw_image_shape, data_format,
                    frame_format, batch_item, num_classes, tag, read_tries,
                    captioning_config=None):
        dset = dataset_mod.Dataset()
        self.datasets.setdefault(dataset_phase, []).append(dset)
        dset.initialize(id, path, mean_image, prepend_folder, image_shape,
                        imgproc, raw_image_shape, data_format, frame_format,
                        batch_item, num_classes, tag, read_tries,
                        captioning_config)

    def set_phase(self, phase):
        self.phase = phase

    def set_feed_device(self, device):
        """Where the feeds go (``Train`` calls this with its device): a
        CUDA device turns on the datasets' pinned read-buffer ring."""
        for dsets in self.datasets.values():
            for d in dsets:
                d.feed_device = device

    def initialize_datasets(self):
        if not self.datasets:
            error("No dataset configured to active phase [%s]" % self.phase)
        for phase in self.phases:
            for i, dset in enumerate(self.datasets.get(phase, [])):
                info("Reading dataset %d/%d : [%s]"
                     % (i + 1, len(self.datasets[phase]), dset.id))
                if phase == defs.phase.train and self.train:
                    dset.calculate_batches(self.train.batch_size,
                                           self.input_mode)
                elif phase == defs.phase.val and self.val:
                    dset.calculate_batches(self.val.batch_size,
                                           self.input_mode)

    # ------------------------------------------------------------ iteration
    def loop(self):
        return self.datasets[self.phase][0].loop()

    def get_dataset_by_tag(self, tag):
        return [d for d in self.datasets[self.phase] if d.tag == tag]

    def get_num_batches(self):
        if not self.datasets:
            return -1
        return len(self.datasets[self.phase][0].batches)

    def get_batch_index(self):
        return self.datasets[self.phase][0].batch_index

    def get_batch_sizes(self):
        return [d.batch_size for d in self.datasets[self.phase]]

    def get_datasets(self):
        return self.datasets[self.phase]

    def rewind_datasets(self, next_epoch=True):
        for dset in self.datasets[self.phase]:
            dset.rewind(next_epoch=next_epoch)

    def get_next_batch(self):
        """Advance every active dataset one batch; returns {tag: Batch}."""
        out = {}
        for dset in self.datasets[self.phase]:
            if dset.tag in out:
                error("Multiple datasets with tag [%s] in phase [%s]"
                      % (dset.tag, self.phase))
            out[dset.tag] = dset.get_next_batch()
        return out

    def get_feed(self, required_input):
        """The step's input dict, each requirement ``(name,
        net_input_type, tag)`` matched to the tagged dataset's batch.
        Returns (feed dict, batches dict)."""
        batches = self.get_next_batch()
        feed = {}
        for name, itype, itag in required_input:
            if itag not in batches:
                error("No dataset with tag [%s] for required input [%s]"
                      % (itag, name))
            batch = batches[itag]
            if itype == defs.net_input.visual:
                feed[name] = batch.visual
                if batch.proc_params is not None:
                    feed[name + "/proc_params"] = batch.proc_params
            elif itype == defs.net_input.labels:
                if batch.labels is None:
                    error("Dataset [%s] produced no labels for required "
                          "input [%s]" % (itag, name))
                feed[name] = batch.labels
            else:
                error("Unknown net input type [%s]" % itype)
        return feed, batches

    # ------------------------------------------------------------- cadence
    def compute_save_interval(self):
        if not self.train:
            self.save_interval, self.num_saves = -1, 0
            return
        # cadence follows the first (main) dataset
        dset = self.datasets[self.phase][0]
        self.save_interval, self.num_saves = dset.compute_dataset_portion(
            self.save_freq_per_epoch, self.train.epochs)

    def should_save(self, step):
        if self.save_interval < 0 or self.phase == defs.phase.val:
            return False
        return step % self.save_interval == 0

    # -------------------------------------------------------------- resume
    def _resolve_checkpoint(self, resume_file, require_snap=False):
        """Resolve "best" and "latest" ("latest": the newest checkpoint in
        the run folder; with ``require_snap``, the newest that has its
        ``.snap`` sidecar, skipping saves interrupted between the two
        writes)."""
        if resume_file == "best":
            best = os.path.join(self.run_folder, "checkpoints", "best.ckpt")
            if not os.path.exists(best):
                error("resume_file: best, but no best.ckpt in %s "
                      "(written by train: eval_keep_best)"
                      % os.path.dirname(best))
            return best
        if resume_file == defs.names.latest_savefile:
            ckpts = get_run_checkpoints(self.run_folder)
            if not ckpts:
                error("Resume requested but no checkpoints in %s"
                      % self.run_folder)
            if require_snap:
                for ckpt in reversed(ckpts):
                    if os.path.exists(ckpt + ".snap"):
                        return ckpt
                    warning("Skipping checkpoint without .snap sidecar "
                            "(interrupted save?): %s" % ckpt)
                error("Resume requires a checkpoint with a .snap "
                      "position sidecar, but none of the %d checkpoints "
                      "in %s has one" % (len(ckpts), self.run_folder))
            return ckpts[-1]
        return resume_file

    def resume_snap(self, resume_file):
        """Restore the dataset positions from the JSON ``.snap`` sidecar.
        Returns (epoch, global step)."""
        if not self.resume:
            return 0, 0
        ckpt = self._resolve_checkpoint(resume_file, require_snap=True)
        snap_path = ckpt + ".snap"
        info("Resuming training position from [%s]" % snap_path)
        if not os.path.exists(snap_path):
            error("Snapshot savefile does not exist: %s" % snap_path)
        try:
            with open(snap_path, "r") as f:
                params = json.load(f)
        except (UnicodeDecodeError, json.JSONDecodeError):
            error("Snapshot savefile %s is not JSON (a legacy pickle "
                  "sidecar?); the port reads JSON sidecars only"
                  % snap_path)
        batch_info, epoch, global_step = params[0], params[1], params[2]
        for dset in self.get_datasets():
            idx = batch_info.get(dset.tag, 0) \
                if isinstance(batch_info, dict) else batch_info
            dset.restore(idx, epoch)
        info("Restored snapshot of epoch %d, batch %s, global step %d"
             % (epoch + 1, str(batch_info), global_step))
        return epoch, global_step

    # ---------------------------------------------------------------- save
    def save(self, state, progress, global_step, batch_index=None,
             fixed_name=None):
        """Save ``state`` (``Train.state_dict()``) as
        ``<run_folder>/checkpoints/<time>_<progress>.ckpt`` and its
        ``.snap`` sidecar, then prune to ``num_saves``.  ``batch_index``
        overrides the live cursor (the prefetcher reads ahead);
        ``fixed_name`` writes ``<name>.ckpt`` outside the rotation
        (``best``), dropping its old ``.snap`` first so that a crash
        mid-overwrite cannot pair new parameters with an old position.
        Returns the checkpoint's path; on every rank but global rank 0,
        which alone writes, None (``state`` is whole on every rank, so it
        is the same)."""
        if not is_primary():
            return None
        folder = os.path.join(self.run_folder, "checkpoints")
        os.makedirs(folder, exist_ok=True)
        base = os.path.join(
            folder, "%s.ckpt" % fixed_name if fixed_name else
            "%s_%s.ckpt" % (get_datetime_str(), progress))
        info("Saving checkpoint to [%s]" % base)
        if batch_index is None:
            batch_index = self.get_batch_index()
        # the position now: an async write must not read a later cursor
        snap = [batch_index, self.train.epoch_index if self.train else 0,
                int(global_step)]

        def write():
            if fixed_name and os.path.exists(base + ".snap"):
                os.remove(base + ".snap")
            ckpt_mod.save_checkpoint(base, state)
            # JSON, and after the parameters: a .snap means a complete
            # checkpoint (resume_snap relies on it)
            with open(base + ".snap", "w") as f:
                json.dump(snap, f)
            self._prune_checkpoints()

        if self.checkpoint_async:
            if self._async_saver is None:
                self._async_saver = ckpt_mod.AsyncSaver()
            self._async_saver.submit(write)
        else:
            write()
        return base

    def finish_saves(self):
        """Wait for an async checkpoint write and re-raise its error."""
        if self._async_saver is not None:
            self._async_saver.wait()

    def _prune_checkpoints(self):
        """Keep the newest ``num_saves`` rotation checkpoints."""
        if self.num_saves <= 0:
            return
        ckpts = get_run_checkpoints(self.run_folder)
        for path in ckpts[:max(0, len(ckpts) - self.num_saves)]:
            ckpt_mod.delete_checkpoint(path)

    def init_saveload(self, state, resume_file, ignorable_variable_names,
                      loaded_out=None):
        """Compute the save cadence and, when resuming, restore the
        checkpoint into ``state`` by name.  A training run takes the
        checkpoint ``resume_snap`` chose (one with a ``.snap``); an
        evaluation also skips the step and the optimizer slots of either
        package.  Returns the (restored) state."""
        self.compute_save_interval()
        if not self.resume:
            return state
        ckpt = self._resolve_checkpoint(resume_file,
                                        require_snap=bool(self.train))
        info("Resuming parameters from: [%s]" % ckpt)
        if not os.path.exists(ckpt):
            error("Checkpoint does not exist: %s" % ckpt)
        ignorables = list(ignorable_variable_names or [])
        if self.val and not self.train:
            # "opt_state" covers the port's opt_state/... slots and the
            # JAX package's opt_state_leaves
            ignorables += [defs.names.global_step, "opt_state"]
        return ckpt_mod.restore_checkpoint(ckpt, state, ignorables,
                                           loaded_out=loaded_out)


def prepare_feed(feed, batches):
    """Attach the caption inputs when the main dataset is a captioner
    (``run_task._prepare_feed``)."""
    main = batches.get(defs.dataset_tag.main)
    if main is not None and main.caption is not None:
        cap = captions.feed_from_words(main.caption, main.labels)
        # the (B*T, C) labels and their mask replace the per-item rows
        # only for training batches (feed_from_words leaves them out
        # otherwise)
        feed.update(cap)
    return feed


def count_clips(batches, fpc_by_tag):
    """Clips in a step's batches, for a clips/s metric: visual rows over
    frames per clip, not label rows (a caption batch's labels span its
    (B*T, C) word grid)."""
    return sum(b.visual.shape[0] // (fpc_by_tag.get(tag) or 1)
               for tag, b in batches.items())
