"""Run configuration: Settings + Network (pipeline spec) loading.

The port's copy of ``video_learning_tpu/config.py``: the ``run:``
document of a config file, its ``defs.*`` strings validated, the
``network.pipelines`` DAG with unread-field rejection, the train/val
option blocks and the ``data:`` entries, which become the ``Feeder``'s
datasets (``Settings.initialize``).  The file is read as JSON when it is
JSON and as YAML otherwise, PyYAML being imported only then: the GPU
machine has no PyYAML, and a JSON file, which is also valid YAML, serves
both packages.

``remat`` makes ``Model.apply`` recompute the frame encoder's
activations in the backward (``torch.utils.checkpoint``), as the JAX
package's ``jax.checkpoint`` does.  ``logging.email_notify`` ([sender,
recipient]) asks for the sender's password at the terminal, as the JAX
package does, and mails errors and the run's end
(``utils.send_email``).  Fields of the JAX package that the port reads
and checks as it does, then leaves: ``compile_cache`` (logged as
ignored: XLA's cache of compiled programs; the port captures its CUDA
graphs anew in each process); ``checkpoint_backend: orbax`` raises (a
JAX library's format; the port writes npz, which both packages load).
``mesh_shape`` ({"data": N, "model": M}) is kept on ``Settings`` for
``Train`` and ``Validation``, which build their mesh of
``torch.distributed`` ranks from it (``parallel/mesh.py``).  ``host_shards: auto`` shards a training
dataset over the mesh's data axis: as many shards as the data size, and
this rank's data coordinate as its index, so that the ranks of one model
group read the same rows (one shard outside a process group).  A
training dataset with explicit ``host_shards`` on a data axis above 1
must have as many shards as the axis.

``GeometryDataset`` / ``GeometryFeeder`` describe a dataset by its frame
geometry and preprocessing chain alone (plus, for a captioning dataset,
its vocabulary, word-embedding matrix and caption lengths), which is all
the DAG and the device preprocessor need: the flagship builders
(``flagship.py``) and serving artifacts (``serving.py``) use them.
"""

import json
import os
import shutil

import numpy as np

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.parse_opts import parse_seq, parse_shape
from video_learning_tpu_torch.utils import (as_num as _num,
                                            configure_logging, debug, error,
                                            get_datetime_str, info,
                                            prep_email, warning)

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
    epoch_index = 0
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
    eval_every_epochs = 0           # inline validation cadence (0 = off)
    early_stop_patience = 0         # stop after N non-improving evals
    eval_keep_best = False          # keep best.ckpt at the best val acc


class ValOpts:
    batch_size = 1
    logits_save_interval = None
    clip_fusion_type = None
    clip_fusion_method = None
    batch_item = defs.batch_item.default
    quantize = None                 # "int8"/"int8_static": w8a8 serving
    use_ema = False                 # evaluate the EMA weights
    top_k = None                    # extra top-k accuracies, e.g. [5]


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
    caption_ground_truth = None
    word_embeddings_file = None
    caption_max_length = None
    beam_width = 4
    length_norm = 0.0


def load_documents(init_file):
    """Every document of a config file as one dict: parsed as JSON when
    the file is JSON, else as YAML (PyYAML imported only here)."""
    with open(init_file, "r") as f:
        text = f.read()
    try:
        docs = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError:
            error("%s is not JSON, and PyYAML is not installed to read it "
                  "as YAML: write the config as JSON" % init_file)
        docs = yaml.safe_load(text)
    if not isinstance(docs, dict):
        error("%s holds no named documents" % init_file)
    return docs


def load_document(init_file, name):
    """The ``name:`` document of a config file (``load_documents``)."""
    docs = load_documents(init_file)
    if name not in docs:
        error("No %s: document in %s" % (name, init_file))
    return docs[name]


def load_run_document(init_file):
    """The ``run:`` document of a config file."""
    return load_document(init_file, "run")


def _host_shard_slot(mesh_shape=None):
    """(shards, shard index) of a training dataset with ``host_shards:
    auto``: the data size of the mesh and this rank's data coordinate
    (rank // model) in an initialised torch.distributed group, else
    (1, 0).  The ranks of one model group hold the same rows, so they
    read the same shard.  A shape that does not fill the world gives
    (world size, rank); the mesh itself refuses it when it is built."""
    import torch.distributed as dist

    from video_learning_tpu_torch.parallel.mesh import mesh_axes
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        data, model = mesh_axes(mesh_shape, size)
        if data * model != size:
            return size, rank
        return data, rank // model
    return 1, 0


class Settings:
    """Run settings: parses and validates the ``run:`` document and
    instantiates the Feeder with its datasets.  Callers that build a
    model without a config (``flagship.py``, ``serving.py``) set the
    fields directly."""

    def __init__(self):
        self.run_id = ""
        self.resume_file = None
        self.run_folder = None      # where the lr schedule file goes
        self.global_step = 0
        self.feeder = None
        self.pipelines = {}
        self.pipeline_names = []
        self.train = None
        self.val = None
        self.captioning = None      # CaptionOpts of a captioning run
        self.phases = []
        self.phase = defs.phase.val
        self.num_classes = None
        self.logging_level = "logging.INFO"
        self.tensorboard_folder = "tensorboard"
        self.tensorboard_events = False
        self.print_tensors = False
        self.watch_tensors = []
        self.email_notify = None
        self.save_freq_per_epoch = 1
        self.profile_steps = None
        self.timestamp = None
        self.seed = 0
        self.mesh_shape = None
        self.compute_dtype = "bfloat16"
        self.remat = False
        self.compile_cache = None
        self.checkpoint_backend = "npz"
        self.checkpoint_async = False
        self._inline_eval = False   # train-phase eval_every_epochs
        self._pipeline_field_cache = []

    # ------------------------------------------------------------- helpers
    def get_dropout(self):
        if self.phase == defs.phase.train:
            return self.train.dropout_keep_prob
        return 0.0

    def should_resume(self):
        return bool(self.resume_file)

    # ------------------------------------------------------- field reading
    def read_field(self, config, fieldname, validate=None, required=False,
                   listify=False):
        """Read + validate one pipeline field, recording it as read so
        that unknown keys can be rejected."""
        self._pipeline_field_cache.append(fieldname)
        val = config.get(fieldname)
        if val is None:
            if required:
                error("No value specified for required field [%s]" % fieldname)
            return [None] if listify else None
        if validate is not None:
            if isinstance(validate, (list, tuple)):
                val = list(val)
                if len(validate) != len(val):
                    error("Field [%s] requires %d entries, found: [%s]"
                          % (fieldname, len(validate), str(val)))
                val = [defs.check(el, v) for el, v in zip(val, validate)]
            else:
                val = defs.check(val, validate)
        if listify and not isinstance(val, (list, tuple)):
            val = [val]
        return list(val) if listify else val

    def read_network(self, pipeline_content):
        """Parse one pipeline spec; an unread field is an error."""
        network = Network()
        self._pipeline_field_cache = []
        network.input = self.read_field(pipeline_content, "input",
                                        listify=True)
        if any(x is None for x in network.input):
            error("<None> or undefined <input> tag in pipeline: %s"
                  % pipeline_content)
        for i, inp in enumerate(network.input):
            if inp in self.pipelines:
                continue
            is_tag, tagname = defs.check(inp, defs.dataset_tag,
                                         do_boolean=True)
            if is_tag:
                network.input[i] = tagname
            else:
                error("Input identifier [%s] is not a dataset tag, and no "
                      "such pipeline has been declared yet." % inp)

        network.representation = self.read_field(
            pipeline_content, "representation", required=True,
            validate=defs.representation)
        if network.representation == defs.representation.dcnn:
            network.frame_encoding_layer = self.read_field(
                pipeline_content, "frame_encoding_layer", required=True)
        if network.representation == defs.representation.fc:
            network.fc_output_dim = _num(
                self.read_field(pipeline_content, "fc_output_dim",
                                required=True),
                "fc_output_dim", int, minimum=1)

        network.classifier = self.read_field(pipeline_content, "classifier",
                                             validate=defs.classifier)
        if network.classifier == defs.classifier.lstm:
            params = self.read_field(pipeline_content, "lstm_params")
            if params is None:
                error("LSTM classifier requires lstm_params")
            if not isinstance(params, (list, tuple)) or len(params) < 3:
                error("lstm_params needs [hidden_dim, num_layers, "
                      "fusion_method(, visual_mode)], got: [%s]"
                      % (params,))
            network.lstm_params = [
                _num(params[0], "lstm_params[0] (hidden_dim)", int, 1),
                _num(params[1], "lstm_params[1] (num_layers)", int, 1),
                defs.check(params[2], defs.fusion_method)]
            # optional 4th entry: the captioner's visual conditioning
            if len(params) > 3:
                network.lstm_params.append(
                    defs.check(params[3], defs.rnn_visual_mode))

        network.weights_file = self.read_field(pipeline_content,
                                               "weights_file")
        # the alternate key of older configs
        lw = self.read_field(pipeline_content, "load_weights")
        if network.weights_file is None and lw is not None:
            network.weights_file = lw
        network.frame_fusion = self.read_field(
            pipeline_content, "frame_fusion",
            validate=(defs.fusion_type, defs.fusion_method))
        raw_shapes = self.read_field(pipeline_content, "input_shape",
                                     listify=True)
        network.input_shape = [
            None if shp in (None, "None") else parse_shape(shp)
            for shp in raw_shapes]
        network.input_fusion = self.read_field(pipeline_content,
                                               "input_fusion",
                                               validate=defs.fusion_method)

        unread = [k for k in pipeline_content
                  if k not in self._pipeline_field_cache]
        if unread:
            error("Undefined pipeline field(s): %s" % str(unread))
        return network

    # --------------------------------------------------------- main parser
    def read_config(self, config, init_file):
        self.resume_file = config.get("resume_file")
        self.run_folder = config["run_folder"]
        if config.get("run_id"):
            self.run_id = config["run_id"]
        self.seed = _num(config.get("seed", 0), "seed", int)
        if config.get("mesh_shape"):
            self.mesh_shape = dict(config["mesh_shape"])
            unknown = sorted(set(self.mesh_shape) - {"data", "model"})
            if unknown:
                error("mesh_shape axes are data and model; got %s"
                      % unknown)
            self.mesh_shape = {
                k: _num(v, "mesh_shape.%s" % k, int, minimum=1)
                for k, v in self.mesh_shape.items()}
            from video_learning_tpu_torch.parallel.mesh import (mesh_axes,
                                                                 world)
            size = world()[0]
            data, model = mesh_axes(self.mesh_shape, size)
            if data * model > size:
                error("mesh_shape data=%d x model=%d needs %d ranks; this "
                      "process is in a world of %d: start the ranks with "
                      "python -m torch.distributed.run --nproc-per-node %d "
                      "(the mesh: ROADMAP Queue 1, item 6)"
                      % (data, model, data * model, size, data * model))
        if config.get("compute_dtype"):
            self.compute_dtype = str(config["compute_dtype"])
        self.remat = bool(config.get("remat", False))
        self.compile_cache = config.get("compile_cache")
        if self.compile_cache:
            info("compile_cache is an XLA cache; the port ignores it")
        self.checkpoint_backend = str(config.get("checkpoint_backend",
                                                 "npz"))
        if self.checkpoint_backend == "pickle":
            # the historical name of the npz backend
            self.checkpoint_backend = "npz"
        if self.checkpoint_backend == "orbax":
            error("checkpoint_backend: orbax is a JAX library's format and "
                  "the port has no writer for it; use npz (the default), "
                  "which both packages load")
        if self.checkpoint_backend != "npz":
            error("checkpoint_backend must be 'npz'")
        self.checkpoint_async = bool(config.get("checkpoint_async", False))

        # phases + run id
        self.phases = defs.check(config["phase"], defs.phase)
        if not isinstance(self.phases, list):
            self.phases = [self.phases]
        self.phase = self.phases[0]
        trainval_str = ""
        if defs.phase.train in self.phases:
            trainval_str = "train"
        if defs.phase.val in self.phases:
            trainval_str += "val"
        trainval_str += "_resume" if self.should_resume() else "_scratch"
        base = self.run_id if self.run_id else os.path.basename(init_file)
        self.run_id = "_".join([base, trainval_str])

        if not os.path.exists(self.run_folder):
            warning("Non existent run folder %s - creating." % self.run_folder)
            os.makedirs(self.run_folder, exist_ok=True)

        # logging
        logcfg = config.get("logging", {})
        self.save_freq_per_epoch = _num(
            logcfg.get("save_freq_per_epoch", 1),
            "logging.save_freq_per_epoch", minimum=0.0)
        self.logging_level = str(logcfg.get("level", "logging.INFO"))
        valid_levels = ["logging." + x for x in ("INFO", "DEBUG", "WARN")]
        if self.logging_level not in valid_levels:
            error("Invalid logging level: %s" % self.logging_level)
        self.tensorboard_folder = logcfg.get("tensorboard_folder",
                                             "tensorboard")
        self.tensorboard_events = bool(logcfg.get("tensorboard_events",
                                                  False))
        self.print_tensors = bool(logcfg.get("print_tensors", False))
        self.watch_tensors = [str(p) for p in
                              parse_seq(logcfg.get("watch_tensors")) or []]
        profile = parse_seq(logcfg.get("profile"))
        self.profile_steps = (
            (_num(profile[0], "logging.profile[0]", int, 0),
             _num(profile[1], "logging.profile[1]", int, 1))
            if profile else None)
        self.email_notify = logcfg.get("email_notify")
        if self.email_notify:
            self.email_notify = prep_email(self.email_notify)
        self.configure_logging()

        # pipelines, in config order
        for pipeline in config["network"]["pipelines"]:
            pname, content = list(pipeline.items())[0]
            debug("Reading network [%s]" % pname)
            self.pipelines[pname] = self.read_network(content)
            self.pipeline_names.append(pname)
        self.num_classes = _num(config["network"]["num_classes"],
                                "network.num_classes", int, minimum=1)

        # per-phase option blocks
        for phase in self.phases:
            obj = config[phase]
            if phase == defs.phase.train:
                self.train = self._read_train_opts(obj)
            if phase == defs.phase.val:
                self.val = self._read_val_opts(obj)

        # inline validation during training: eval_every_epochs runs the
        # val phase on the live params every N training epochs
        self._inline_eval = bool(self.train and
                                 self.train.eval_every_epochs > 0)
        if self._inline_eval:
            if defs.phase.val in self.phases:
                error("eval_every_epochs runs validation inline; use "
                      "phase: defs.phase.train (not both phases)")
            if "val" not in config:
                error("eval_every_epochs needs a val: options block")
            if "captioning" in config:
                error("eval_every_epochs supports classification runs; "
                      "evaluate captioners with "
                      "tools/evaluate_multiple_checkpoints")
            self.val = self._read_val_opts(config["val"])
            if self.val.use_ema and not self.train.ema_decay:
                error("val: use_ema needs train: ema_decay (no EMA "
                      "shadow is maintained without it)")

        if "captioning" in config:
            self.captioning = self._read_caption_opts(config["captioning"])

        self._read_datasets(config)

    @staticmethod
    def _read_train_opts(obj):
        tr = TrainOpts()
        tr.batch_size = _num(obj["batch_size"], "train.batch_size", int,
                             minimum=1)
        tr.epochs = _num(obj["epochs"], "train.epochs", int, minimum=0)
        tr.optimizer = defs.check(obj["optimizer"], defs.optim)
        wd = obj.get("weight_decay")
        tr.weight_decay = (0.0 if wd in (None, "None")
                           else _num(wd, "train.weight_decay"))
        if tr.weight_decay < 0:
            error("weight_decay must be >= 0 (got %s)" % tr.weight_decay)
        if tr.weight_decay and tr.optimizer != defs.optim.adamw:
            error("weight_decay is decoupled decay and needs "
                  "optimizer: defs.optim.adamw (got %s)" % tr.optimizer)
        tr.base_lr = _num(obj["base_lr"], "train.base_lr")
        tr.lr_mult = (None if str(obj.get("lr_mult")) in ("None", "") or
                      obj.get("lr_mult") is None
                      else _num(obj["lr_mult"], "train.lr_mult"))
        lr_decay = parse_seq(obj.get("lr_decay"))
        if lr_decay is not None:
            if len(lr_decay) < 4:
                error("lr_decay needs [decay, periodicity, N, "
                      "factor(, offset)], got: [%s]" % (lr_decay,))
            parsed = [defs.check(lr_decay[0], defs.decay),
                      defs.check(lr_decay[1], defs.periodicity),
                      _num(lr_decay[2], "lr_decay[2]", int),
                      _num(lr_decay[3], "lr_decay[3]")]
            if len(lr_decay) > 4:
                parsed.append(_num(lr_decay[4], "lr_decay[4]", int))
            tr.lr_decay = parsed
        tr.lr_warmup = _num(obj.get("lr_warmup", 0) or 0, "train.lr_warmup",
                            int)
        if tr.lr_warmup < 0:
            error("lr_warmup must be >= 0 (got %d)" % tr.lr_warmup)
        cn = obj.get("clip_norm")
        tr.clip_norm = (None if cn in (None, "None")
                        else _num(cn, "train.clip_norm"))
        cg = parse_seq(obj.get("clip_grads"))
        tr.clip_grads = (None if not cg or cg == [None]
                         else (_num(cg[0], "train.clip_grads[0]"),
                               _num(cg[1], "train.clip_grads[1]")))
        tr.dropout_keep_prob = _num(obj.get("dropout_keep_prob", 0.5),
                                    "train.dropout_keep_prob", minimum=0.0)
        tr.accum_steps = _num(obj.get("accum_steps", 1), "train.accum_steps",
                              int)
        if tr.accum_steps < 1:
            error("accum_steps must be >= 1 (got %d)" % tr.accum_steps)
        if tr.batch_size % tr.accum_steps:
            error("accum_steps (%d) must divide batch_size (%d): the batch "
                  "is split into equal on-device micro-batches"
                  % (tr.accum_steps, tr.batch_size))
        ema = obj.get("ema_decay")
        tr.ema_decay = (0.0 if ema in (None, "None")
                        else _num(ema, "train.ema_decay"))
        if tr.ema_decay and not 0.0 < tr.ema_decay < 1.0:
            error("ema_decay must be in (0, 1) (got %s)" % tr.ema_decay)
        tr.eval_every_epochs = _num(obj.get("eval_every_epochs", 0) or 0,
                                    "train.eval_every_epochs", int)
        if tr.eval_every_epochs < 0:
            error("eval_every_epochs must be >= 0 (got %d)"
                  % tr.eval_every_epochs)
        tr.early_stop_patience = _num(obj.get("early_stop_patience", 0) or 0,
                                      "train.early_stop_patience", int)
        if tr.early_stop_patience and not tr.eval_every_epochs:
            error("early_stop_patience needs eval_every_epochs "
                  "(stopping is judged on inline val accuracy)")
        tr.eval_keep_best = bool(obj.get("eval_keep_best", False))
        if tr.eval_keep_best and not tr.eval_every_epochs:
            error("eval_keep_best needs eval_every_epochs (best is judged "
                  "on inline val accuracy)")
        return tr

    @staticmethod
    def _read_val_opts(obj):
        """Parse a ``val:`` options block (the val phase's, or the train
        phase's inline eval_every_epochs)."""
        va = ValOpts()
        va.batch_size = _num(obj["batch_size"], "val.batch_size", int,
                             minimum=1)
        lsi = obj.get("logits_save_interval")
        va.logits_save_interval = (
            None if lsi in (None, "None")
            else _num(lsi, "val.logits_save_interval", int))
        clip_fusion = parse_seq(obj.get("clip_fusion"))
        if clip_fusion is not None:
            va.clip_fusion_type = defs.check(clip_fusion[0],
                                             defs.fusion_type)
            va.clip_fusion_method = defs.check(clip_fusion[1],
                                               defs.fusion_method)
        va.quantize = check_quantize(obj.get("quantize"))
        va.use_ema = bool(obj.get("use_ema", False))
        # extra top-k accuracies (top-1 is always computed): an int or a
        # list of ints
        tk = parse_seq(obj.get("top_k"))
        if tk is not None:
            try:
                va.top_k = sorted({int(k) for k in tk})
            except (TypeError, ValueError):
                error("val top_k must be an int or list of ints, got %r"
                      % obj.get("top_k"))
            if any(k < 2 for k in va.top_k):
                error("val top_k entries must be >= 2 (top-1 is always "
                      "reported), got %s" % (va.top_k,))
        return va

    @staticmethod
    def _read_caption_opts(cap):
        co = CaptionOpts()
        co.caption_search = defs.check(
            cap.get("caption_search", "defs.caption_search.max"),
            defs.caption_search)
        co.eval_type = defs.check(cap.get("eval_type", "defs.eval_type.coco"),
                                  defs.eval_type)
        co.caption_ground_truth = cap.get("caption_ground_truth")
        co.word_embeddings_file = cap.get("word_embeddings_file")
        co.beam_width = _num(cap.get("beam_width", 4),
                             "captioning.beam_width", int, minimum=1)
        co.length_norm = _num(cap.get("length_norm", 0.0),
                              "captioning.length_norm")
        cml = cap.get("caption_max_length")
        co.caption_max_length = (None if cml is None else _num(
            cml, "captioning.caption_max_length", int, minimum=1))
        if co.length_norm < 0:
            error("captioning.length_norm must be >= 0 (got %s)"
                  % co.length_norm)
        return co

    def _read_datasets(self, config):
        """``data:`` entries -> the Feeder's datasets.  Inline eval keeps
        the run phase train but registers the val-phase datasets too."""
        from video_learning_tpu_torch.data.feeder import Feeder
        feed_phases = list(self.phases)
        if self._inline_eval:
            feed_phases.append(defs.phase.val)
        self.feeder = Feeder(defs.input_mode.video, feed_phases,
                             (self.train, self.val),
                             self.save_freq_per_epoch, self.run_folder,
                             self.should_resume())
        self.feeder.checkpoint_async = self.checkpoint_async
        for dataid, dataobj in config.get("data", {}).items():
            dataset_phase = defs.check(dataobj["phase"], defs.phase)
            if dataset_phase not in feed_phases:
                info("Omitting dataset [%s] due to its phase [%s]"
                     % (dataid, dataset_phase))
                continue
            path = dataobj["data_path"]
            mean_image = parse_seq(dataobj.get("mean_image"))
            batch_item = (defs.check(dataobj["batch_item"], defs.batch_item)
                          if "batch_item" in dataobj
                          else defs.batch_item.default)
            prepend_folder = dataobj.get("prepend_folder") or None
            image_shape = parse_shape(dataobj.get("image_shape"))
            imgproc = [defs.check(opt, defs.imgproc)
                       for opt in (parse_seq(dataobj.get("imgproc")) or [])]
            if defs.imgproc.sub_mean in imgproc and not mean_image:
                error("[%s] requires a supplied mean image intensity."
                      % defs.imgproc.sub_mean)
            raw_image_shape = parse_shape(dataobj.get("raw_image_shape"))
            data_format = defs.check(dataobj["data_format"], defs.data_format)
            frame_format = dataobj.get("frame_format")
            tag = defs.check(dataobj["tag"], defs.dataset_tag)
            if raw_image_shape is not None and \
                    defs.imgproc.raw_resize not in imgproc:
                imgproc.append(defs.imgproc.raw_resize)
            if mean_image is not None and \
                    defs.imgproc.sub_mean not in imgproc:
                imgproc.append(defs.imgproc.sub_mean)
            excl = [defs.imgproc.rand_crop in imgproc,
                    defs.imgproc.center_crop in imgproc,
                    defs.imgproc.resize in imgproc]
            if sum(excl) > 1:
                error("Need at most one of rand_crop/center_crop/resize. "
                      "Imgproc params: %s" % imgproc)
            if self.val and dataset_phase == defs.phase.val:
                if defs.imgproc.rand_crop in imgproc:
                    warning("Random cropping is enabled in validation mode.")
                if defs.imgproc.rand_mirror in imgproc:
                    warning("Random mirroring is enabled in validation mode.")
            read_tries = _num(dataobj.get("read_tries", 1),
                              "read_tries", int, minimum=1)
            captioning_config = None
            if "captioning" in dataobj:
                c = dataobj["captioning"]
                captioning_config = (c.get("word_embeddings_file"),
                                     c.get("caption_ground_truth"),
                                     c.get("eval_type"),
                                     c.get("caption_search"))
            self.feeder.add_dataset(
                dataset_phase, dataid, path, mean_image, prepend_folder,
                image_shape, imgproc, raw_image_shape, data_format,
                frame_format, batch_item, self.num_classes, tag, read_tries,
                captioning_config)
            dset = self.feeder.datasets[dataset_phase][-1]
            dset.epoch_shuffle = bool(dataobj.get("epoch_shuffle", False))
            dset.shuffle_seed = _num(
                dataobj.get("shuffle_seed", self.seed), "shuffle_seed", int)
            shards = dataobj.get("host_shards", "auto")
            if shards == "auto":
                if dataset_phase == defs.phase.train:
                    # only training data shards automatically; every host
                    # evaluates the whole validation set
                    dset.host_shards, dset.host_shard_index = \
                        _host_shard_slot(self.mesh_shape)
            else:
                dset.host_shards = _num(shards, "host_shards", int,
                                        minimum=1)
                dset.host_shard_index = _num(
                    dataobj.get("host_shard_index", 0),
                    "host_shard_index", int, minimum=0)
            if "device_preprocess" in dataobj:
                dset.device_preprocess = bool(dataobj["device_preprocess"])

    # ------------------------------------------------------- orchestration
    def configure_logging(self):
        self.timestamp = get_datetime_str()
        configure_logging(
            os.path.join(self.run_folder, "log_%s_%s.log"
                         % (self.run_id, self.timestamp)),
            self.logging_level, self.email_notify)

    def initialize_from_file(self, init_file):
        if init_file is None:
            return
        if not os.path.exists(init_file):
            error("Unable to read initialization file [%s]." % init_file)
        if init_file.endswith(".ini"):
            error(".ini files deprecated.")
        self.read_config(load_run_document(init_file), init_file)
        info("Initialized run [%s] from file %s" % (self.run_id, init_file))

    def attach_captioning(self):
        """Give the datasets that declare captioning (their own
        ``captioning:`` block or the run's) their vocabulary and
        embedding matrix, before the batch plans are computed; the
        run's ``caption_max_length`` caps the caption length."""
        from video_learning_tpu_torch.data import captions as captions_mod
        for phase, dsets in self.feeder.datasets.items():
            for d in dsets:
                emb_file = None
                if d.captioning_config is not None:
                    emb_file = d.captioning_config[0]
                elif self.captioning is not None:
                    emb_file = self.captioning.word_embeddings_file
                if emb_file:
                    captions_mod.attach_captioning(
                        d, emb_file,
                        include_labels=(phase == defs.phase.train),
                        do_padding=True)
                    if self.captioning is not None and \
                            self.captioning.caption_max_length:
                        d.max_caption_length = \
                            self.captioning.caption_max_length
                        d.max_sequence_length = d.max_caption_length + 1
                    info("Attached captioning to dataset [%s] (V=%d)"
                         % (d.id, len(d.vocabulary)))

    def _check_mesh_sharding(self):
        """On a data axis above 1 every training dataset must be split
        into as many host shards as the axis: each data rank feeds its
        own rows, and equal shards give every rank the same number of
        steps (a rank with a step more would wait for its peers at a
        collective for ever)."""
        import torch.distributed as dist

        from video_learning_tpu_torch.parallel.mesh import mesh_axes
        if not (dist.is_available() and dist.is_initialized()):
            return
        data, model = mesh_axes(self.mesh_shape, dist.get_world_size())
        if data <= 1 or data * model != dist.get_world_size():
            return
        for d in self.feeder.datasets.get(defs.phase.train, []):
            if d.host_shards != data:
                error("Dataset [%s] has host_shards %d on a mesh whose data "
                      "axis is %d: use host_shards: auto (or %d)"
                      % (d.id, d.host_shards, data, data))

    def initialize(self, init_file):
        """Full startup: parse the config, copy it into the run folder,
        attach captioning, compute the datasets' batch plans and resume
        their positions if asked.  Returns the Feeder."""
        self.initialize_from_file(init_file)
        self.attach_captioning()

        self._check_mesh_sharding()
        from video_learning_tpu_torch.parallel.mesh import is_primary
        if is_primary() and os.path.dirname(os.path.abspath(init_file)) != \
                os.path.abspath(self.run_folder):
            shutil.copyfile(init_file, os.path.join(
                self.run_folder, os.path.basename(init_file)))

        if self.train and self.val and not self._inline_eval:
            error("Cannot specify simultaneous training and validation run.")
        if not (self.train or self.val):
            error("Neither training nor validation is enabled.")
        if self._inline_eval and not self.feeder.datasets.get(
                defs.phase.val):
            error("eval_every_epochs needs at least one val-phase "
                  "dataset in data: (all entries are phase train)")

        self.tensorboard_folder = os.path.join(
            self.run_folder, self.tensorboard_folder, self.phase)

        self.feeder.initialize_datasets()
        self.feeder.set_phase(self.phase)

        if self.should_resume():
            if self.train:
                info("Resuming training.")
                self.train.epoch_index, self.global_step = \
                    self.feeder.resume_snap(self.resume_file)
            elif self.val:
                info("Evaluating trained network.")
        else:
            if self.train:
                info("Starting training from scratch.")
            elif self.val:
                warning("Starting validation-only run with an untrained "
                        "network.")
        info("Starting run on folder [%s]." % self.run_folder)
        return self.feeder


class GeometryDataset:
    """A dataset known by its geometry: frame shape, clips per video,
    frames per clip and (for device preprocessing) the imgproc chain over
    raw frames of ``raw_image_shape``.  A captioning dataset also has a
    ``vocabulary`` (list of tokens with BOS, EOS and UNK), an
    ``embedding_matrix`` (V, E) in vocabulary order, the padded word-grid
    length ``max_sequence_length`` (T) and the longest caption
    ``max_caption_length`` (T - 1 unless given).  Its frames are
    preprocessed on the device when it has an imgproc chain, unless
    ``device_preprocess`` says otherwise (then they come preprocessed,
    float32 at ``image_shape``)."""

    def __init__(self, tag, image_shape, fpc=1, cpv=1, imgproc=None,
                 raw_image_shape=None, mean_scalars=None, vocabulary=None,
                 embedding_matrix=None, max_sequence_length=None,
                 max_caption_length=None, device_preprocess=None):
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
        self.device_preprocess = bool(self.imgproc) \
            if device_preprocess is None else bool(device_preprocess)
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
                "max_caption_length": self.max_caption_length,
                "device_preprocess": self.device_preprocess}


class GeometryFeeder:

    def __init__(self, datasets, num_batches=1):
        self.datasets = list(datasets)
        self.num_batches = int(num_batches)

    def get_num_batches(self):
        """Batches per epoch: the length of the lr schedule's epoch."""
        return self.num_batches

    def get_dataset_by_tag(self, tag):
        return [d for d in self.datasets if d.tag == tag]
