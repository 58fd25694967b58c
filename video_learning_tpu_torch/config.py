"""Settings objects the pipelines DAG reads, without the YAML layer.

Counterpart of the fields of ``video_learning_tpu/config.py`` that
``models/pipeline.Model``, the serving forward and the training engine
(``train.py``) consume: per pipeline ``Network``, the run-level
``Settings``, ``TrainOpts`` and ``ValOpts``.  Parsing a YAML
``run:`` document into these objects is not ported yet; callers build
them directly (``flagship.py``) or from a serving artifact's model spec
(``serving.py``).

``GeometryDataset`` / ``GeometryFeeder`` stand in for the data layer: a
dataset described by its frame geometry and preprocessing chain alone,
which is all the DAG and the device preprocessor need, plus, for a
captioning dataset, its vocabulary, word-embedding matrix and caption
lengths (``CaptionOpts`` holds the run's decode options).
"""

import numpy as np

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.utils import error

# the Network fields a pipeline spec carries (and a serving artifact
# records, serving.model_spec)
NETWORK_FIELDS = ("input", "input_shape", "input_fusion", "representation",
                  "frame_encoding_layer", "fc_output_dim", "classifier",
                  "lstm_params", "weights_file", "frame_fusion")


class Network:
    """Parsed spec of a single pipeline."""
    input = None
    input_shape = None
    input_fusion = None
    representation = None
    frame_encoding_layer = None
    fc_output_dim = None
    classifier = None
    lstm_params = None
    weights_file = None
    frame_fusion = None


class TrainOpts:
    """Training options, with the JAX ``TrainOpts`` defaults.  lr_decay:
    None or (strategy, scheme, freq, factor[, drop offset]); clip_grads:
    None or (lo, hi), each gradient tensor's norm capped at
    max(|lo|, |hi|)."""
    batch_size = 100
    epochs = 15
    optimizer = defs.optim.sgd
    base_lr = 0.001
    lr_decay = None
    lr_warmup = 0                   # linear-ramp batches (0 = off)
    clip_norm = None
    clip_grads = None
    lr_mult = None                  # the 'modified' tier's lr factor
    accum_steps = 1                 # micro-batches per optimizer step
    ema_decay = 0.0                 # weight EMA factor (0 = off)
    weight_decay = 0.0              # adamw decoupled decay (0 = off)
    dropout_keep_prob = 0.5
    batch_item = defs.batch_item.default


class ValOpts:
    batch_size = 1
    quantize = None                 # "int8"/"int8_static": w8a8 serving
    use_ema = False                 # evaluate the EMA weights


def check_quantize(value):
    """A ``val.quantize`` value as the JAX config parses it: None (or
    "None"), "int8" (dynamic activation scales) or "int8_static"
    (calibrated static scales); anything else is an error."""
    if value not in (None, "None", "int8", "int8_static"):
        error("val quantize must be 'int8' (dynamic activation "
              "scales) or 'int8_static' (scales calibrated on the "
              "first eval batch), got %r" % (value,))
    return None if value in (None, "None") else value


class CaptionOpts:
    """Caption decode options, with the JAX ``CaptionOpts`` defaults
    (greedy "max" search; "beam" with ``beam_width`` beams and
    ``length_norm`` as the length-normalisation exponent)."""
    caption_search = defs.caption_search.max
    eval_type = defs.eval_type.coco
    caption_max_length = None
    beam_width = 4
    length_norm = 0.0


class Settings:
    """Run settings the DAG reads."""

    def __init__(self):
        self.num_classes = None
        self.pipelines = {}
        self.pipeline_names = []
        self.compute_dtype = "bfloat16"
        self.print_tensors = False
        self.feeder = None
        self.phase = defs.phase.val
        self.train = None
        self.val = None
        self.captioning = None      # CaptionOpts of a captioning run
        self.global_step = 0
        self.run_id = ""
        self.run_folder = None      # where the lr schedule file goes

    def get_dropout(self):
        if self.phase == defs.phase.train:
            return self.train.dropout_keep_prob
        return 0.0


class GeometryDataset:
    """A dataset known by its geometry: frame shape, clips per video,
    frames per clip and (for device preprocessing) the imgproc chain over
    raw frames of ``raw_image_shape``.  A captioning dataset also has a
    ``vocabulary`` (list of tokens with BOS, EOS and UNK), an
    ``embedding_matrix`` (V, E) in vocabulary order, the padded word-grid
    length ``max_sequence_length`` (T) and the longest caption
    ``max_caption_length`` (T - 1 unless given)."""

    def __init__(self, tag, image_shape, fpc=1, cpv=1, imgproc=None,
                 raw_image_shape=None, mean_scalars=None, vocabulary=None,
                 embedding_matrix=None, max_sequence_length=None,
                 max_caption_length=None):
        from video_learning_tpu_torch.data.imgproc import ImageProcessor
        self.tag = tag
        self.image_shape = tuple(int(s) for s in image_shape)
        self.clips_per_video = int(cpv)
        self.num_frames_per_clip = int(fpc)
        self.vocabulary = list(vocabulary) if vocabulary is not None \
            else None
        self.embedding_matrix = (
            np.asarray(embedding_matrix, np.float32)
            if embedding_matrix is not None else None)
        self.max_sequence_length = (int(max_sequence_length)
                                    if max_sequence_length else None)
        if max_caption_length is None and self.max_sequence_length:
            max_caption_length = self.max_sequence_length - 1
        self.max_caption_length = (int(max_caption_length)
                                   if max_caption_length else None)
        self.imgproc = list(imgproc or [])
        self.raw_image_shape = (tuple(int(s) for s in raw_image_shape)
                                if raw_image_shape else None)
        self.mean_scalars = (list(mean_scalars) if mean_scalars is not None
                             else None)
        self.device_preprocess = bool(self.imgproc)
        self.processor = None
        if self.device_preprocess:
            self.processor = ImageProcessor(self.imgproc,
                                            self.raw_image_shape,
                                            self.image_shape,
                                            self.mean_scalars)

    def get_image_shape(self):
        return self.image_shape

    def get_embedding_dim(self):
        return int(self.embedding_matrix.shape[1])

    def spec(self):
        """JSON-able description; the embedding matrix is not in it (a
        serving artifact stores it beside the parameters)."""
        return {"tag": self.tag, "image_shape": list(self.image_shape),
                "fpc": self.num_frames_per_clip,
                "cpv": self.clips_per_video, "imgproc": self.imgproc,
                "raw_image_shape": (list(self.raw_image_shape)
                                    if self.raw_image_shape else None),
                "mean_scalars": self.mean_scalars,
                "vocabulary": self.vocabulary,
                "max_sequence_length": self.max_sequence_length,
                "max_caption_length": self.max_caption_length}


class GeometryFeeder:

    def __init__(self, datasets, num_batches=1):
        self.datasets = list(datasets)
        self.num_batches = int(num_batches)

    def get_num_batches(self):
        """Batches per epoch: the length of the lr schedule's epoch."""
        return self.num_batches

    def get_dataset_by_tag(self, tag):
        return [d for d in self.datasets if d.tag == tag]
