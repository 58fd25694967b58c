"""Runtime dataset reader: batches packed records into model-ready arrays.

The port's copy of ``video_learning_tpu/data/dataset.py``, with the same
batch stream for one config and seed: batches by item (video/image) or
by clip, the clips-per-video bookkeeping of video record files, one-hot
labels, the epoch tail as a short last batch, positional resume over the
indexed record reader, per-epoch shuffling from
``RandomState(shuffle_seed * 100003 + epoch)``, the crop and mirror draws
of ``rng = random.Random(0)``, and host sharding with a rotating boundary.

Two preprocessing paths:
* host path: the numpy chain (``ImageProcessor.process_batch``) gives
  float32 frames;
* device path: batches stay uint8 with (crop_y, crop_x, mirror) params,
  and ``ops/preprocess.py`` crops, subtracts the mean and mirrors on the
  card.

A captioning dataset gets its vocabulary and embedding matrix from
``config.Settings.attach_captioning``; its batches then carry the caption
framing of ``captions.labels_to_words``, and a val phase maps its decoded
rows to COCO records with ``validation_logits_to_captions``.
"""

import math
import os
import random

import numpy as np

from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.data.imgproc import (ImageProcessor, imresize,
                                                   read_image)
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.utils import (debug, error, info,
                                            labels_to_one_hot, warning)


class Batch:
    """One model-ready batch.

    visual: float32/uint8 array of frames (N*fpc leading dim, frames
            flattened into the batch) or feature vectors.
    labels: one-hot (num_labeled_items, num_classes) int32.
    proc_params: (N, 3) int32 crop_y/crop_x/mirror when the device path is
            active, else None.
    raw_labels: the per-item label lists.
    """

    def __init__(self, visual, labels, proc_params=None, raw_labels=None,
                 caption=None):
        self.visual = visual
        self.labels = labels
        self.proc_params = proc_params
        self.raw_labels = raw_labels
        self.caption = caption  # dict from captions.labels_to_words


class Dataset:
    """Per-dataset state machine."""

    # ring of reusable read buffers for the native reader: a slot comes
    # round again only after _BUF_RING more batches, which
    # FeedPrefetcher's depth check keeps beyond every batch in flight
    # (producer 1 + queue depth + consumer 1).  Reuse skips the page
    # faults of a fresh 100s-of-MB allocation per batch.  On by default
    # where the feed goes to a CUDA device (Feeder.set_feed_device, which
    # Train calls); the slots are then pinned, and Train.
    # prepare_device_feed returns only after its copy out of a slot has
    # finished, so a slot is never rewritten under a copy.  Off for a CPU
    # feed, where torch.from_numpy would alias a slot into the step's
    # tensors.  VLT_REUSE_READ_BUFFERS=1/0 forces either way.
    _BUF_RING = 4
    # distinct batch geometries kept alive at once (steady state is 2:
    # the full batch + the epoch tail); LRU-evicted beyond this
    _BUF_POOL_GEOMETRIES = 4

    def __init__(self):
        self.id = None
        self.path = None
        self.reader = None
        self.native_reader = None
        self._native_shape = None
        self.num_classes = None
        self.frames = []
        self.labels = []
        self.clips_per_video = None
        self.num_frames_per_clip = None
        self.frame_format = None
        self.data_format = None
        self.input_mode = None
        self.batch_item = None
        self.batch_size = None
        self.batches = None
        self.batch_index = 0
        self.epoch_index = 0
        self.num_items = 0
        self.video_index = 0
        self.record_cursor = 0
        self.tag = None
        self.read_tries = 1
        self.prepend_folder = None
        self.mean_scalars = None
        self.desired_image_shape = None
        self.raw_image_shape = None
        self.imgproc = []
        self.processor = None
        self.device_preprocess = False
        self.rng = random.Random(0)
        self.feed_device = None
        self._buf_pools = {}
        # captioning
        self.embedding_matrix = None
        self.vocabulary = None
        self.max_caption_length = None
        self.max_sequence_length = None
        self.include_labels = False
        self.do_padding = False
        self.eval_type = None
        self.captioning_config = None
        # host sharding
        self.host_shards = 1
        self.host_shard_index = 0
        self._shard_record_offset = 0
        self._shard_item_offset = 0
        # rotating-boundary state (non-divisible item counts): the full
        # pre-shard metadata plus the current epoch's item selection
        self._shard_rotating = False
        self._shard_full_frames = None
        self._shard_full_labels = None
        self._shard_full_cpv = None
        self._shard_item_sel = None
        self._shard_index_map = None
        # per-epoch reshuffling
        self.epoch_shuffle = False
        self.shuffle_seed = 0
        self.index_map = None
        self._orig_cpv = None

    # ------------------------------------------------------------ metadata
    def initialize(self, id, path, mean_image, prepend_folder,
                   desired_image_shape, imgproc, raw_image_shape, data_format,
                   frame_format, batch_item, num_classes, tag, read_tries,
                   captioning_config=None):
        info("Initializing dataset [%s]" % id)
        self.id = id
        self.path = path
        self.data_format = data_format
        self.frame_format = frame_format
        self.prepend_folder = prepend_folder
        self.mean_scalars = mean_image
        self.desired_image_shape = desired_image_shape
        self.imgproc = list(imgproc or [])
        self.batch_item = batch_item
        self.raw_image_shape = raw_image_shape
        self.num_classes = num_classes
        self.tag = tag
        self.read_tries = read_tries
        self.captioning_config = captioning_config

    def read_frames_metadata(self):
        """Read the path/label list file."""
        debug("Reading frame metadata from [%s]" % self.path)
        self.frames, self.labels = [], []
        with open(self.path, "r") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                item_path = parts[0]
                if self.prepend_folder is not None:
                    item_path = os.path.join(self.prepend_folder, item_path)
                self.frames.append(item_path)
                self.labels.append(parts[1:])

    def get_input_data_count(self):
        """Read the ``.size`` sidecar."""
        size_file = self.path + ".size"
        if not os.path.exists(size_file):
            error("Could not find data size file: %s" % size_file)
        meta = records.read_size_file(size_file)
        self.num_items = meta["items"]
        if meta["type"] != self.input_mode:
            # the .size sidecar describes the packed data and is
            # authoritative; the configured mode is only a default
            info("Size file overrides input mode: [%s] -> [%s]"
                 % (self.input_mode, meta["type"]))
            self.input_mode = meta["type"]
        cpv, fpc = meta["cpi"], meta["fpc"]
        if (cpv is not None) == (self.input_mode == defs.input_mode.image):
            error("Read cpi %s but input mode is %s"
                  % (str(cpv), self.input_mode))
        self.clips_per_video = cpv
        self.num_frames_per_clip = fpc
        loaded_caption_length = meta["labelcount"]
        if self.max_caption_length is not None:
            if loaded_caption_length > self.max_caption_length:
                error("Data contains max caption length %d but the current "
                      "setting restricts to %d"
                      % (loaded_caption_length, self.max_caption_length))
        else:
            self.max_caption_length = loaded_caption_length
        self.max_sequence_length = self.max_caption_length + 1
        info("Read [%s] data, count: %d, fpc: %s, type: %s, lblcount: %d"
             % (self.id, self.num_items, str(fpc), self.input_mode,
                self.max_caption_length))

    # ------------------------------------------------------------- batching
    def calculate_batches(self, batch_size, input_mode):
        """Open the record file and compute the per-epoch batch plan."""
        self.batch_size = batch_size
        self.input_mode = input_mode
        if not os.path.exists(self.path):
            error("Dataset path does not exist: %s" % self.path)
        self.read_frames_metadata()
        if self.data_format == defs.data_format.tfrecord:
            self.path += ".tfrecord"
            if not os.path.exists(self.path):
                error("Record file path does not exist: %s" % self.path)
            self.reader = records.RecordReader(self.path)
            self._open_native_reader()
            self.get_input_data_count()
        else:
            # raw disk mode: the item count comes from the paths file and
            # the input mode from the paths' suffixes
            self.num_items = len(self.frames)
            if self.frames and self.frame_format:
                suffix = "." + self.frame_format.lower()
                self.input_mode = (defs.input_mode.image
                                   if self.frames[0].lower().endswith(suffix)
                                   else defs.input_mode.video)
            else:
                self.input_mode = defs.input_mode.image
            if self.input_mode == defs.input_mode.video:
                if not self.num_frames_per_clip:
                    error("Raw video datasets need frames-per-clip "
                          "metadata; pack the data (data_format tfrecord) "
                          "or provide a .size sidecar.")
                # raw video reads one clip per video
                self.clips_per_video = [1] * self.num_items
            if self.max_caption_length is None:
                self.max_caption_length = max(
                    (len(l) for l in self.labels), default=1)
                self.max_sequence_length = self.max_caption_length + 1
        self.initialize_imgproc()
        if self.host_shards > 1:
            self._apply_host_shard()
        self._compute_batch_plan()
        if self.epoch_shuffle:
            self._build_epoch_permutation()
        self.tell()

    def _compute_batch_plan(self):
        if self.batch_item == defs.batch_item.default:
            total = self.num_items
        elif self.batch_item == defs.batch_item.clip:
            total = sum(self.clips_per_video)
        else:
            error("Unknown batch item: %s" % self.batch_item)
        num_whole = total // self.batch_size
        left = total - num_whole * self.batch_size
        self.batches = [self.batch_size] * num_whole
        if left:
            self.batches.append(left)

    def _apply_host_shard(self):
        """Host sharding: each process consumes a disjoint item range of
        floor(items/shards) items, so all hosts run the same step counts.

        When the item count divides evenly, the shard is a static
        contiguous slice.  Otherwise the window rotates by the
        ``items % shards`` remainder each epoch (deterministic in
        epoch_index, so resume-consistent): epoch e covers global items
        [e*rem, e*rem + per*shards) mod items, and any two consecutive
        epochs cover the whole dataset."""
        shards, idx = self.host_shards, self.host_shard_index
        if not (0 <= idx < shards):
            error("host_shard_index %d out of range for %d shards"
                  % (idx, shards))
        per = self.num_items // shards
        if per == 0:
            error("Dataset [%s] has fewer items (%d) than host shards (%d)"
                  % (self.id, self.num_items, shards))
        dropped = self.num_items - per * shards
        if dropped:
            info("Host sharding rotates the shard boundary by the %d "
                 "remainder item(s) each epoch; every item is visited "
                 "across consecutive epochs" % dropped)
            self._shard_rotating = True
            self._shard_full_frames = self.frames
            self._shard_full_labels = self.labels
            self._shard_full_cpv = self.clips_per_video
            self._select_shard_items()
            return
        lo, hi = idx * per, (idx + 1) * per
        self._shard_item_offset = lo
        fpc = self.num_frames_per_clip or 1
        if self.clips_per_video is not None and \
                not isinstance(self.clips_per_video, int):
            self._shard_record_offset = sum(
                self.clips_per_video[:lo]) * fpc
            self.clips_per_video = self.clips_per_video[lo:hi]
        else:
            self._shard_record_offset = lo
        self.frames = self.frames[lo:hi]
        self.labels = self.labels[lo:hi]
        self.num_items = hi - lo
        info("Host shard %d/%d: items %d..%d"
             % (idx + 1, shards, lo, hi))

    def _select_shard_items(self):
        """This host's item window for the current epoch under the
        rotating boundary.  Record reads go through a global gather index
        map (the machinery epoch_shuffle uses)."""
        shards, idx = self.host_shards, self.host_shard_index
        total = len(self._shard_full_frames)
        per = total // shards
        rem = total - per * shards
        start = (idx * per + self.epoch_index * rem) % total
        sel = (start + np.arange(per)) % total
        self._shard_item_sel = sel
        self._shard_item_offset = int(start)
        self.frames = [self._shard_full_frames[i] for i in sel]
        self.labels = [self._shard_full_labels[i] for i in sel]
        self.num_items = per
        self._shard_record_offset = 0
        full_cpv = self._shard_full_cpv
        fpc = self.num_frames_per_clip or 1
        if full_cpv is not None and not isinstance(full_cpv, int):
            starts = np.concatenate(
                [[0], np.cumsum([c * fpc for c in full_cpv])[:-1]]
            ).astype(np.int64)
            self.clips_per_video = [full_cpv[i] for i in sel]
            self._shard_index_map = np.concatenate(
                [starts[i] + np.arange(full_cpv[i] * fpc) for i in sel])
        else:
            # image/vector mode: one record per item
            self.clips_per_video = full_cpv
            self._shard_index_map = sel.astype(np.int64)
        # epoch_shuffle composes its permutation on top (rebuilt from
        # this epoch's cpv); without it the gather map is used directly
        self._orig_cpv = None
        self.index_map = self._shard_index_map
        info("Host shard %d/%d (rotating, epoch %d): global items "
             "%d..%d (mod %d)" % (idx + 1, shards, self.epoch_index,
                                  start, start + per, total))

    def initialize_imgproc(self):
        if self.input_mode == defs.input_mode.vectors:
            if self.imgproc:
                info("Ignoring imgproc due to input mode [%s]"
                     % self.input_mode)
            self.imgproc = []
            self.processor = None
            return
        self.processor = ImageProcessor(self.imgproc, self.raw_image_shape,
                                        self.desired_image_shape,
                                        self.mean_scalars)

    # ---------------------------------------------------------- record read
    def _open_native_reader(self):
        """Attach the C++ batch reader when it builds and the records are
        uniformly shaped images (the packed video/image case)."""
        self.native_reader = None
        self._native_shape = None
        try:
            from video_learning_tpu_torch.data.native_io import NativeReader
            native = NativeReader(self.path)
            if len(native):
                kind, h, w, d, _ = native.record_info(0)
                if kind == records.KIND_IMAGE:
                    self.native_reader = native
                    self._native_shape = (h, w, d)
                    debug("Native batch reader active for [%s] (%dx%dx%d)"
                          % (self.id, h, w, d))
        except (OSError, RuntimeError) as ex:
            debug("Native reader unavailable for [%s]: %s" % (self.id, ex))

    def _reuse_buffers(self):
        flag = os.environ.get("VLT_REUSE_READ_BUFFERS", "auto")
        if flag in ("0", "1"):
            return flag == "1"
        return self._feeds_cuda()

    def _feeds_cuda(self):
        return self.feed_device is not None and \
            str(self.feed_device).startswith("cuda")

    def _read_buffers(self, count, max_labels):
        if not self._reuse_buffers():
            return None
        h, w, d = self._native_shape
        key = (count, h, w, d, max_labels)
        pools = self._buf_pools
        pool = pools.pop(key, None)
        if pool is None:
            # one ring per batch geometry (the full batch and the epoch
            # tail each keep their own); beyond the cap the least
            # recently used geometry is dropped (batches in flight keep
            # their arrays alive through their own references)
            while len(pools) >= self._BUF_POOL_GEOMETRIES:
                pools.pop(next(iter(pools)))
            pool = [[None] * self._BUF_RING, 0]
        pools[key] = pool  # (re-)insert at the most-recent position
        ring, i = pool
        if ring[i] is None:
            # a slot is made at its first use: the first batch waits for
            # one allocation, not the ring's
            ring[i] = self._slot(count, h, w, d, max_labels)
        pool[1] = (i + 1) % self._BUF_RING
        return ring[i]

    def _slot(self, count, h, w, d, max_labels):
        """One ring slot: (pixels, labels, nlab) arrays; the pixels in
        page-locked memory when the feed goes to a CUDA device, so its
        copy to the card runs at the link's rate without a staging copy
        (the tensor stays alive as the array's base)."""
        if self._feeds_cuda():
            import torch
            pixels = torch.empty((count, h, w, d), dtype=torch.uint8,
                                 pin_memory=True).numpy()
        else:
            pixels = np.empty((count, h, w, d), np.uint8)
        return (pixels, np.empty((count, max_labels), np.int32),
                np.empty((count,), np.int32))

    def _read_frames_native(self, count):
        if self.index_map is not None:
            # shuffled epoch or rotating shard: gather-read at the mapped
            # record indices
            idx = np.asarray(
                self.index_map[self.record_cursor:
                               self.record_cursor + count],
                dtype=np.int64) + self._shard_record_offset
            pixels, labels, nlab = self.native_reader.read_images_at(
                idx, self._native_shape, max_labels=64,
                out=self._read_buffers(count, 64))
        else:
            pixels, labels, nlab = self.native_reader.read_images(
                self._shard_record_offset + self.record_cursor, count,
                self._native_shape, max_labels=64,
                out=self._read_buffers(count, 64))
        self.record_cursor += count
        # the decoded block is one contiguous (count, h, w, d) array: it
        # goes through as it is, with no re-stacking copy
        out_labels = []
        for row, n in zip(labels, nlab):
            vals = row[:n].tolist()
            out_labels.append(vals[0] if n == 1 else vals)
        return pixels, out_labels

    def _read_frames(self, count):
        if self.native_reader is not None:
            try:
                return self._read_frames_native(count)
            except (RuntimeError, ValueError) as ex:
                warning("Native batch read failed (%s); falling back to "
                        "python reader" % ex)
                self.native_reader = None
        return self._read_frames_python(count)

    def _read_frames_python(self, count):
        """Read ``count`` frames at the cursor with bounded retries, then
        the source image as the last resort."""
        images, labels = [], []
        for k in range(count):
            idx = self.record_cursor + k
            if self.index_map is not None:
                idx = int(self.index_map[idx])
            idx += self._shard_record_offset
            rec = None
            for attempt in range(max(1, self.read_tries)):
                try:
                    rec = self.reader.read_at(idx)
                    break
                except Exception as ex:
                    warning("Read try %d for record %d failed: %s"
                            % (attempt + 1, idx, ex))
            if rec is None:
                rec = self._manually_read_image(idx)
            _, data, lab = rec
            images.append(data)
            labels.append(lab)
        self.record_cursor += count
        return images, labels

    def _manually_read_image(self, record_index):
        """Re-read the source image from disk: only possible for image
        datasets, whose record order is the paths file's.
        ``record_index`` is global; frames/labels are shard-local."""
        if self.input_mode != defs.input_mode.image:
            error("Failed to recover record %d" % record_index)
        if self._shard_rotating:
            frames, labels = self._shard_full_frames, self._shard_full_labels
            local = record_index
        else:
            frames, labels = self.frames, self.labels
            local = record_index - self._shard_record_offset
        if not (0 <= local < len(frames)):
            error("Failed to recover record %d (outside this shard)"
                  % record_index)
        impath = frames[local]
        info("Manually reading source image %d: %s" % (record_index, impath))
        image = read_image(impath)
        if self.raw_image_shape is not None:
            image = imresize(image, self.raw_image_shape)
        label = [int(x) for x in labels[local]]
        return records.KIND_IMAGE, image, label

    def _process_images(self, images):
        """The imgproc chain: the host path returns processed float32;
        the device path returns stacked uint8 + per-frame params."""
        stack = (lambda x: x if isinstance(x, np.ndarray) else np.stack(x))
        if self.input_mode == defs.input_mode.vectors:
            return stack(images), None
        if self.device_preprocess:
            params = self.processor.draw_params(len(images), self.rng)
            return stack(images), params
        out = self.processor.process_batch(images, self.rng)
        return np.stack(out).astype(np.float32), None

    # --------------------------------------------------------- batch makers
    def get_next_batch(self):
        """Assemble the next batch.  Returns Batch."""
        if self.data_format == defs.data_format.raw:
            batch = self._next_batch_raw()
        elif self.input_mode in (defs.input_mode.video,
                                 defs.input_mode.vectors):
            batch = self._next_batch_video()
        elif self.input_mode == defs.input_mode.image:
            batch = self._next_batch_image()
        else:
            error("Unknown input mode %s" % self.input_mode)
        self.batch_index += 1
        return batch

    def _make_batch(self, images, labels):
        visual, params = self._process_images(images)
        batch = Batch(visual, labels_to_one_hot(labels, self.num_classes),
                      params, raw_labels=labels)
        if self.embedding_matrix is not None:
            from video_learning_tpu_torch.data import captions
            batch.caption = captions.labels_to_words(
                labels, self.embedding_matrix, self.vocabulary,
                self.num_classes, self.max_sequence_length,
                self.include_labels, self.do_padding)
            batch.labels = batch.caption["onehot_labels"]
        return batch

    def _next_batch_video(self):
        """Video/vector records: the frames of a batch depend on the cpv
        of its videos."""
        if self.batch_item == defs.batch_item.default:
            first = self.batch_index * self.batch_size
            curr_cpv = self.clips_per_video[first:first + self.batch_size]
            nframes = sum((self.num_frames_per_clip or 1) * c
                          for c in curr_cpv)
            if not nframes:
                error("Computed 0 frames in next batch.")
            images, labels_per_frame = self._read_frames(nframes)
            # one label per clip, taken from each video's first frame
            fpv = list(np.cumsum([(self.num_frames_per_clip or 1) * c
                                  for c in curr_cpv]))
            first_frame = [0] + fpv[:-1]
            labels = []
            for vidx, cpv in enumerate(curr_cpv):
                labels.extend(labels_per_frame[first_frame[vidx]]
                              for _ in range(cpv))
        elif self.batch_item == defs.batch_item.clip:
            clips_left = sum(self.clips_per_video) - \
                self.batch_index * self.batch_size
            nclips = min(clips_left, self.batch_size)
            nframes = nclips * self.num_frames_per_clip
            images, labels_per_frame = self._read_frames(nframes)
            labels = labels_per_frame[0::self.num_frames_per_clip]
        else:
            error("Unknown batch item %s" % self.batch_item)
        return self._make_batch(images, labels)

    def _next_batch_image(self):
        count = self.batches[self.batch_index]
        images, labels = self._read_frames(count)
        return self._make_batch(images, labels)

    def _next_batch_raw(self):
        """Direct-from-disk reading."""
        count = self.batches[self.batch_index]
        start = self.batch_index * self.batch_size
        images, labels = [], []
        if self.input_mode == defs.input_mode.video:
            for j, videopath in enumerate(self.frames[start:start + count]):
                for i in range(self.num_frames_per_clip):
                    impath = "%s%04d.%s" % (videopath, 1 + i,
                                            self.frame_format)
                    images.append(read_image(impath))
                labels.append([int(x) for x in self.labels[start + j]])
        else:
            for j, impath in enumerate(self.frames[start:start + count]):
                images.append(read_image(impath))
                labels.append([int(x) for x in self.labels[start + j]])
        visual, params = self._process_images(images)
        return Batch(visual, labels_to_one_hot(labels, self.num_classes),
                     params, raw_labels=labels)

    # -------------------------------------------------------------- cursors
    def _cursor_for_batch(self, batch_index):
        """Absolute record index at the start of ``batch_index``."""
        if self.data_format != defs.data_format.tfrecord:
            return 0
        if self.input_mode == defs.input_mode.image:
            return min(batch_index * self.batch_size, self.num_items)
        item_index = batch_index * self.batch_size
        fpc = self.num_frames_per_clip or 1
        if self.batch_item == defs.batch_item.default:
            nclips = sum(self.clips_per_video[:item_index])
            return nclips * fpc
        return item_index * fpc

    def restore(self, batch_index, epoch_index):
        """Resume at a batch position.  ``rng`` is left as it is, as the
        JAX package leaves it: a resumed run draws its crops and mirrors
        from the stream's start."""
        self.batch_index = batch_index
        self.epoch_index = epoch_index
        if self._shard_rotating:
            self._select_shard_items()
            self._compute_batch_plan()
        if self.epoch_shuffle:
            self._build_epoch_permutation()
        self.record_cursor = self._cursor_for_batch(batch_index)
        if self.reader is not None:
            self.reader.seek(min(self.record_cursor, len(self.reader)))
        info("Restored dataset [%s] to batch %d (record %d)"
             % (self.id, batch_index, self.record_cursor))

    def rewind(self, next_epoch=False):
        self.batch_index = 0
        self.record_cursor = 0
        self.video_index = 0
        if next_epoch:
            self.epoch_index += 1
        if self._shard_rotating and next_epoch:
            self._select_shard_items()
            self._compute_batch_plan()
        if self.epoch_shuffle:
            self._build_epoch_permutation()
        if self.reader is not None:
            self.reader.seek(0)

    # ------------------------------------------------- per-epoch shuffling
    def _build_epoch_permutation(self):
        """Reshuffle the item order for the current epoch, deterministic
        in (seed, epoch_index) so resume reproduces the stream."""
        rng = np.random.RandomState(self.shuffle_seed * 100003 +
                                    self.epoch_index)
        fpc = self.num_frames_per_clip or 1
        if self._orig_cpv is None:
            self._orig_cpv = self.clips_per_video
        if self.input_mode == defs.input_mode.image or \
                self.clips_per_video is None:
            self.index_map = rng.permutation(self.num_items)
        else:
            cpv = self._orig_cpv
            starts = np.concatenate(
                [[0], np.cumsum([c * fpc for c in cpv])[:-1]])
            if self.batch_item == defs.batch_item.clip:
                clip_starts = np.concatenate(
                    [starts[v] + np.arange(cpv[v]) * fpc
                     for v in range(len(cpv))])
                order = rng.permutation(len(clip_starts))
                self.index_map = np.concatenate(
                    [clip_starts[c] + np.arange(fpc) for c in order])
            else:
                order = rng.permutation(len(cpv))
                self.index_map = np.concatenate(
                    [starts[v] + np.arange(cpv[v] * fpc) for v in order])
                self.clips_per_video = [cpv[v] for v in order]
        if self._shard_index_map is not None:
            # rotating host shard: the permutation above is shard-local;
            # gather through the shard's global-record map
            self.index_map = self._shard_index_map[self.index_map]

    def loop(self):
        return self.batch_index < len(self.batches)

    def get_global_batch_step(self):
        return self.epoch_index * len(self.batches) + self.batch_index

    def compute_dataset_portion(self, freq_per_epoch, epochs):
        """Save cadence from save_freq_per_epoch."""
        save_interval = math.ceil(len(self.batches) / freq_per_epoch)
        num_saves = math.ceil(freq_per_epoch * epochs)
        info("Computed save interval to %d batches and %d total saves"
             % (save_interval, num_saves))
        return save_interval, num_saves

    def single_clip(self):
        if isinstance(self.clips_per_video, int):
            return self.clips_per_video == 1
        return False

    def get_image_shape(self):
        if self.input_mode == defs.input_mode.vectors:
            return (self._vector_dim(),)
        if self.desired_image_shape is None:
            return self.raw_image_shape
        return self.desired_image_shape

    def _vector_dim(self):
        """Feature dimension of a vector dataset, probed from record 0."""
        if getattr(self, "_vec_dim", None) is None:
            if self.reader is None or not len(self.reader):
                error("Cannot determine vector dimension for [%s]"
                      % self.id)
            _, data, _ = self.reader.read_at(0)
            self._vec_dim = int(data.shape[-1])
        return self._vec_dim

    def get_embedding_dim(self):
        return int(self.embedding_matrix.shape[-1])

    def validation_logits_to_captions(self, logits, start_index=0):
        """Decoded rows of this dataset's items from ``start_index`` on ->
        COCO {"image_id", "caption"} records.  A host-sharded dataset
        decodes only its items, and the id recovery reads the global
        paths file, so the rows are offset to their global items; under
        the rotating shard boundary the rows must map to one contiguous
        run of global items (a window that wraps round the end raises,
        as in the JAX package)."""
        from video_learning_tpu_torch.data import captions
        if self._shard_rotating:
            sel = self._shard_item_sel[start_index:
                                       start_index + len(logits)]
            if len(sel) and not np.array_equal(
                    sel, sel[0] + np.arange(len(sel))):
                error("Caption id recovery across a wrapped rotating "
                      "shard window is unsupported; use divisible "
                      "host_shards for caption validation")
            offset = int(sel[0]) if len(sel) else 0
            return captions.validation_logits_to_captions(
                logits, self.path, self.vocabulary, self.eval_type, offset)
        return captions.validation_logits_to_captions(
            logits, self.path, self.vocabulary, self.eval_type,
            self._shard_item_offset + start_index)

    def tell(self):
        """Status line."""
        items = self.num_items
        clips = 0 if self.clips_per_video is None else \
            sum(self.clips_per_video)
        frames = items if self.num_frames_per_clip is None else \
            clips * self.num_frames_per_clip
        info("Dataset[%s] bmode:%s tag:%s items:%d clips:%d frames:%d "
             "b-size:%s b-num:%d b-index:%d imgproc:%s"
             % (self.id, self.batch_item, self.tag, items, clips, frames,
                self.batch_size, len(self.batches or []), self.batch_index,
                defs.imgproc_to_str(self.imgproc)))
