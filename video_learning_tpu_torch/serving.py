"""The serving forward and its artifact.

Counterpart of the load side of
``video_learning_tpu/tools/export_serving.py`` (``tools/export_serving.py``
is the export side).  A ``ServingModule`` runs exactly the validation
forward, ``val.serving_forward``: uint8 frames and host-drawn (crop_y,
crop_x, mirror) triples go to the device, are preprocessed there
(``ops/preprocess.py``) and run through ``Model.apply(train=False)``
under ``torch.inference_mode()``.  On the card every bucket runs as a
CUDA graph replay (``val.ForwardGraphs``): ``warmup()`` captures each
bucket's program, as the JAX export compiles one program per bucket, and
a bucket that ``warmup()`` has not met is captured at its first call.
``graphs=False`` keeps the forward eager; the ``int8_static``
calibration forward is always eager.

Calls take the positional arrays ``meta["inputs"]`` describes, with the
JAX artifact's names (``frames_main_input`` and
``frames_main_input/proc_params``) and the leading dims of the largest
bucket.  ``batch_items`` may be a list of static batch sizes (buckets,
e.g. [1, 8, 32]): each call runs at the smallest bucket that fits it
(``last_bucket``), as the JAX artifact routes, so a lone request does
not pay for a full batch.  A short batch is zero-padded to its bucket and
the padding rows dropped from the output.  In float and ``int8_static``
modes a row's logits do not depend on what else shares its call (a
bucket of another size may round its float products differently in the
last bits).  In dynamic ``int8`` mode they do, as in the JAX package: the
activation scale of each int8 layer is one amax over the whole padded
batch, so a row's logits depend on its batch-mates and on the bucket.

``quantize`` ("int8" / "int8_static", ``config.check_quantize``) serves
the w8a8 forward of the frame encoders; their weights are quantized once
at construction.  ``int8_static`` first runs one float calibration
forward over ``calib_feed`` (positional arrays, as a call takes them)
through the same device preprocessing, and bakes the activation ranges
it finds into static scales; ``meta["act_ranges"]`` keeps them
({pipeline: {layer: amax}}), so ``load`` re-quantizes from them to the
same bits.

A captioner's module decodes: it returns (B, T) int32 word indices,
its meta's output is ``{"kind": "token_ids", "vocabulary": [...],
"max_caption_length": ..., "caption_search": ...}`` as in the JAX
artifact, and ``captions`` / ``captions_from_ids`` turn rows into
strings cut at the first EOS.

The artifact is a zip of ``meta.json`` (the JAX meta keys but the JAX
lowering's ``platforms``, ``trace_platform``, ``jax_version`` and
``mesh``, plus the model spec that rebuilds the DAG, caption options
included; ``ema`` says whether EMA weights were baked in and ``run_id``
names the run an export came from, false and null for a module built
otherwise and in artifacts written before they were recorded),
``params.npz`` (JAX flat names and layouts, so the artifact is also a
checkpoint for either package, float even for an int8 module) and, for a
captioner, ``embeddings.npz`` (each caption dataset's embedding matrix
by dataset tag).

On a mesh (``mesh``: a ``parallel.mesh.Mesh`` of more than one rank) the
module is called on every rank with the whole request batch, as the JAX
consumer passes it: each rank runs its rows of the padded bucket, with
its slices of the split kernels, and the outputs are gathered over the
data group, so every rank returns the whole result, as JAX's replicated
``out_shardings`` give it.  Every bucket's input rows must divide the
data axis.  The meta then records ``mesh`` ({"data", "model"}), and
``load`` of such an artifact needs an initialised group of that shape.
Graphs are off on a mesh.
"""

import io
import json
import zipfile

import numpy as np
import torch

from video_learning_tpu_torch.checkpoint import (from_jax_flat, to_jax_flat,
                                                 unflatten_tree)
from video_learning_tpu_torch.config import (NETWORK_FIELDS, CaptionOpts,
                                             GeometryDataset,
                                             GeometryFeeder, Network,
                                             Settings, ValOpts,
                                             check_quantize)
from video_learning_tpu_torch.data.captions import trim_at_eos
from video_learning_tpu_torch.models.pipeline import Model
from video_learning_tpu_torch.ops.preprocess import (make_preprocessor,
                                                     supports_device_path)
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.parallel import sharding
from video_learning_tpu_torch.utils import error, resolve_device
from video_learning_tpu_torch.val import ForwardGraphs, serving_forward

FORMAT = "vlt-torch-1"
_META_NAME = "meta.json"
_PARAMS_NAME = "params.npz"
_EMBEDDINGS_NAME = "embeddings.npz"
_CAPTION_FIELDS = ("caption_search", "eval_type", "caption_max_length",
                   "beam_width", "length_norm")
_TORCH_DTYPES = {"uint8": torch.uint8, "int32": torch.int32,
                 "float32": torch.float32}


def model_spec(settings, datasets=None):
    """JSON-able description of the DAG, its datasets' geometry and
    vocabularies (``datasets``: their specs; default, those of a
    ``GeometryFeeder``), and the caption options."""
    cap = settings.captioning
    return {
        "captioning": (None if cap is None else
                       {f: getattr(cap, f) for f in _CAPTION_FIELDS}),
        "num_classes": int(settings.num_classes),
        "compute_dtype": str(settings.compute_dtype),
        "pipeline_names": list(settings.pipeline_names),
        "pipelines": {name: {f: getattr(settings.pipelines[name], f)
                             for f in NETWORK_FIELDS}
                      for name in settings.pipeline_names},
        "datasets": (datasets if datasets is not None else
                     [d.spec() for d in settings.feeder.datasets]),
    }


def settings_from_spec(spec, embedding_matrices=None):
    """Settings rebuilt from ``model_spec``'s output;
    ``embedding_matrices``: {dataset tag: (V, E) array} of the caption
    datasets."""
    embedding_matrices = embedding_matrices or {}
    s = Settings()
    s.num_classes = int(spec["num_classes"])
    s.compute_dtype = spec["compute_dtype"]
    s.pipeline_names = list(spec["pipeline_names"])
    for name in s.pipeline_names:
        net = Network()
        for field, value in spec["pipelines"][name].items():
            if field not in NETWORK_FIELDS:
                error("Unknown pipeline field [%s] in artifact" % field)
            setattr(net, field, value)
        s.pipelines[name] = net
    s.feeder = GeometryFeeder(
        [GeometryDataset(d["tag"], d["image_shape"], fpc=d["fpc"],
                         cpv=d["cpv"], imgproc=d["imgproc"],
                         raw_image_shape=d["raw_image_shape"],
                         mean_scalars=d["mean_scalars"],
                         vocabulary=d.get("vocabulary"),
                         embedding_matrix=embedding_matrices.get(d["tag"]),
                         max_sequence_length=d.get("max_sequence_length"),
                         max_caption_length=d.get("max_caption_length"),
                         device_preprocess=d.get("device_preprocess"))
         for d in spec["datasets"]])
    if spec.get("captioning") is not None:
        s.captioning = CaptionOpts()
        for field, value in spec["captioning"].items():
            if field not in _CAPTION_FIELDS:
                error("Unknown captioning field [%s] in artifact" % field)
            setattr(s.captioning, field, value)
    s.val = ValOpts()
    return s


def serving_model(settings, model):
    """The Model an artifact of ``model`` rebuilds on ``load``: the same
    DAG over its datasets' geometry alone.  ``model`` is built from a run
    config (``Settings.initialize``); its datasets of the current phase
    that feed it frames become geometry datasets."""
    sources = {tag: src for _, tag, src in model.visual_sources()}
    datasets, embeddings = [], {}
    for d in settings.feeder.get_datasets():
        src = sources.get(d.tag)
        if src is None:
            continue
        datasets.append({
            "tag": d.tag, "image_shape": list(d.desired_image_shape),
            "fpc": int(src.fpc), "cpv": int(src.cpv),
            "imgproc": list(d.imgproc),
            "raw_image_shape": (list(d.raw_image_shape)
                                if d.raw_image_shape else None),
            "mean_scalars": (None if d.mean_scalars is None else
                             [float(m) for m in d.mean_scalars]),
            "vocabulary": d.vocabulary,
            "max_sequence_length": d.max_sequence_length,
            "max_caption_length": d.max_caption_length,
            "device_preprocess": bool(d.device_preprocess)})
        if d.embedding_matrix is not None:
            embeddings[d.tag] = d.embedding_matrix
    return Model(settings_from_spec(model_spec(settings, datasets),
                                    embeddings))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class ServingModule:
    """The serving forward of ``model`` with ``params`` at the static
    batch sizes ``batch_items`` (an int, or a list of buckets) on
    ``device``, in float or ``quantize`` mode.  ``int8_static`` takes its
    activation ranges from ``act_ranges`` ({pipeline: {layer: amax}}, as
    ``meta["act_ranges"]`` holds them) or calibrates them on
    ``calib_feed``.  ``ema`` (whether ``params`` are EMA weights) and
    ``run_id`` (the run they come from) are recorded in the meta.
    ``graphs`` (default: on for a CUDA device) runs every bucket as a
    CUDA graph replay.  ``mesh`` serves over a mesh of ranks (module
    docstring), where ``graphs=True`` raises."""

    def __init__(self, model, params, batch_items=8, device="cuda",
                 quantize=None, calib_feed=None, act_ranges=None,
                 ema=False, run_id=None, graphs=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            if graphs:
                error("ServingModule: graphs=True on a mesh of %d ranks: "
                      "gloo collectives run on the host, which a CUDA "
                      "graph cannot capture (graphs=False)"
                      % self.mesh.size)
            graphs = False
        use = self.device.type == "cuda" if graphs is None else bool(graphs)
        if use and self.device.type != "cuda":
            error("ServingModule: graphs=True needs a CUDA device")
        self.graphs = ForwardGraphs() if use else None
        self.model = model
        self.params = _to_device(params, self.device)
        sizes = batch_items if isinstance(batch_items, (list, tuple)) \
            else [batch_items]
        self.buckets = sorted({int(b) for b in sizes})
        if not self.buckets or self.buckets[0] < 1:
            error("batch sizes must be >= 1 (got %s)" % (batch_items,))
        self.batch_items = self.buckets[-1]
        self.quantize = check_quantize(quantize)
        if self.quantize != "int8_static" and \
                (calib_feed is not None or act_ranges is not None):
            error("calib_feed and act_ranges calibrate int8_static only "
                  "(quantize=%r)" % (self.quantize,))
        self.last_bucket = None
        self._pre = {}
        inputs = []
        for key, tag, src in model.visual_sources():
            rows = self.batch_items * src.cpv * src.fpc
            dset = model.settings.feeder.get_dataset_by_tag(tag)[0]
            if dset.device_preprocess:
                if not supports_device_path(dset.imgproc):
                    error("Device preprocessing unsupported for imgproc %s"
                          % dset.imgproc)
                self._pre[key] = make_preprocessor(
                    dset.processor, out_dtype=model.compute_dtype,
                    device=self.device)
                raw = dset.raw_image_shape or dset.image_shape
                inputs.append({"name": key, "shape": [rows] + list(raw),
                               "dtype": "uint8"})
                inputs.append({"name": key + "/proc_params",
                               "shape": [rows, 3], "dtype": "int32"})
            else:
                inputs.append({"name": key,
                               "shape": [rows] + list(src.shape),
                               "dtype": "float32"})
        num_classes = int(model.num_classes)
        dset = model.caption_dataset
        if dset is not None:
            cap = model.settings.captioning
            output = {"kind": "token_ids",
                      "vocabulary": list(dset.vocabulary),
                      "max_caption_length": int(dset.max_caption_length),
                      "caption_search": (str(cap.caption_search)
                                         if cap else "max")}
        else:
            output = {"kind": "logits", "num_classes": num_classes}
        self.meta = {
            "format": FORMAT,
            "inputs": inputs,
            "output": output,
            "batch_items": self.batch_items,
            "buckets": list(self.buckets),
            "num_classes": num_classes,
            "frames_per_clip": int(model.visual_sources()[0][2].fpc),
            "clips_per_item": int(model.visual_sources()[0][2].cpv),
            "compute_dtype": str(model.settings.compute_dtype),
            "quantize": self.quantize,
            "ema": bool(ema),
            "run_id": None if run_id is None else str(run_id),
            "model": model_spec(model.settings),
        }
        if self.mesh is not None:
            self.meta["mesh"] = self.mesh.shape
            for spec in inputs:
                for b in self.buckets:
                    rows = spec["shape"][0] // self.batch_items * b
                    if rows % self.mesh.data:
                        error("Bucket %d gives %d input rows, not divisible "
                              "by the mesh data axis (%d); choose bucket "
                              "sizes that shard evenly"
                              % (b, rows, self.mesh.data))
        self._params = self._local_params = self._slices(self.params)
        if self.quantize == "int8_static":
            if act_ranges is None:
                if calib_feed is None:
                    error("quantize: int8_static requires a calibration "
                          "batch; this entry point quantizes without one "
                          "— use 'int8' (dynamic scales) here")
                act_ranges = self._calibrate(calib_feed)
            act_ranges = {p: {k: float(v) for k, v in t.items()}
                          for p, t in act_ranges.items()}
            self.meta["act_ranges"] = act_ranges
        if self.quantize:
            self._params = model.quantize_params(self._local_params,
                                                 act_ranges=act_ranges)

    def _slices(self, params):
        """This rank's slices of the whole tree ``params`` on a mesh with
        a model axis; the tree itself otherwise."""
        if self.mesh is None or self.mesh.model == 1:
            return params
        return sharding.shard_tree(params, self.mesh,
                                   self.model.sharded_leaves(self.mesh.model))

    def _input_tensor(self, a, spec):
        dtype = _TORCH_DTYPES[spec["dtype"]]
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, dtype=spec["dtype"])))
        return a.to(device=self.device, dtype=dtype)

    def _tensors(self, arrays):
        """The arrays of a call as tensors on the device, checked against
        the largest bucket's input specs, and the share of that bucket
        they fill."""
        ins = self.meta["inputs"]
        if len(arrays) != len(ins):
            error("Serving module takes %d inputs %s; got %d"
                  % (len(ins), [i["name"] for i in ins], len(arrays)))
        frac = None
        tensors = []
        for a, spec in zip(arrays, ins):
            want = tuple(spec["shape"])
            shape = tuple(a.shape)
            if shape[1:] != want[1:] or not 0 < shape[0] <= want[0]:
                error("Input %s expects shape %s (leading dim may be "
                      "smaller); got %s" % (spec["name"], want, shape))
            f = shape[0] / want[0]
            if frac is None:
                frac = f
            elif abs(f - frac) > 1e-9:
                error("Inconsistent partial batch across inputs")
            tensors.append(self._input_tensor(a, spec))
        return tensors, frac

    def _forward(self, feed, params, **kw):
        """Device preprocessing and the model on a feed of device
        tensors; a captioner decodes.  A graph replay when graphs are on,
        but for the calibration forward (``calib_taps``)."""
        decode = self.model.caption_dataset is not None
        if self.mesh is not None:
            return serving_forward(self.model, self._pre, params, feed,
                                   decode=decode, mesh=self.mesh, **kw)
        if self.graphs is None or "calib_taps" in kw:
            return serving_forward(self.model, self._pre, params, feed,
                                   decode=decode, **kw)
        return self.graphs(self.model, self._pre, params, feed,
                           decode=decode, **kw)

    def _calibrate(self, arrays):
        """{pipeline: {layer: amax}} of one float forward over the
        positional ``arrays`` (as many items as they hold, no padding)."""
        tensors, _ = self._tensors(arrays)
        taps = {}
        self._forward({s["name"]: t for s, t in
                       zip(self.meta["inputs"], tensors)},
                      self._local_params, calib_taps=taps)
        if not taps:
            error("int8_static calibration collected no activation "
                  "ranges — no pipeline has an int8-capable frame "
                  "encoder (DCNN)")
        return taps

    def __call__(self, *arrays):
        """Logits (float32 numpy), or a captioner's (items, T) int32 word
        indices, for the items in ``arrays``; each array is numpy or a
        tensor, with a leading dim up to the largest bucket's.  The call
        runs at the smallest bucket that holds it.  On a mesh every rank
        passes the whole batch and gets the whole result."""
        tensors, frac = self._tensors(arrays)
        cap = self.batch_items
        bucket = next(b for b in self.buckets if b + 1e-9 >= frac * cap)
        self.last_bucket = bucket
        feed = {}
        for t, spec in zip(tensors, self.meta["inputs"]):
            rows = int(spec["shape"][0]) * bucket // cap
            if t.shape[0] < rows:
                t = torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                              + tuple(t.shape[1:]))])
            feed[spec["name"]] = t
        if self.mesh is not None:
            feed = {k: self.mesh.data_rows(t) for k, t in feed.items()}
        out = self._forward(feed, self._params, quantize=self.quantize)
        if self.mesh is not None:
            out = self.mesh.data_gather(out, 0)
        if self.model.caption_dataset is not None:
            out = out.to(torch.int32).cpu().numpy()
        else:
            out = out.to(torch.float32).cpu().numpy()
        kept = frac * cap / bucket
        if kept < 1:
            out = out[:max(int(round(out.shape[0] * kept)), 1)]
        return out

    def captions_from_ids(self, rows):
        """Decoded (B, T) word-index rows -> caption strings: each row cut
        at its first EOS and at ``max_caption_length`` words, the words
        joined by spaces (" " for an empty caption)."""
        out = self.meta["output"]
        if out.get("kind") != "token_ids":
            error("Not a caption module (output kind %r)" % out.get("kind"))
        vocab = out["vocabulary"]
        cap = int(out["max_caption_length"])
        texts = []
        for row in np.asarray(rows):
            words = [vocab[i] for i in trim_at_eos(row, vocab, cap)]
            texts.append(" ".join(words) if words else " ")
        return texts

    def captions(self, *arrays):
        """A captioner's decode of ``arrays`` as caption strings, one per
        item."""
        return self.captions_from_ids(self(*arrays))

    def warmup(self, call=None):
        """Run zeros through every bucket, smallest first, which captures
        each bucket's graph when graphs are on; returns the largest
        bucket's output.  ``call`` makes the calls instead of the module
        (``tools/serve``'s dispatch to the ranks of a mesh)."""
        call = call or self
        for bucket in self.buckets:
            out = call(*[np.zeros([s["shape"][0] * bucket //
                                   self.batch_items] + s["shape"][1:],
                                  s["dtype"])
                         for s in self.meta["inputs"]])
        return out

    def save(self, path):
        """Write the artifact: meta.json + params.npz (the float
        parameters, JAX names and layouts)."""
        buf = io.BytesIO()
        np.savez(buf, **to_jax_flat(self.params))
        embeddings = {d.tag: d.embedding_matrix
                      for d in self.model.settings.feeder.datasets
                      if d.embedding_matrix is not None}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
            z.writestr(_META_NAME, json.dumps(self.meta, indent=1))
            z.writestr(_PARAMS_NAME, buf.getvalue())
            if embeddings:
                emb = io.BytesIO()
                np.savez(emb, **embeddings)
                z.writestr(_EMBEDDINGS_NAME, emb.getvalue())


def load(path, device="cuda"):
    """Rebuild a ServingModule from an artifact written by ``save``: its
    buckets, and its quantize mode with the stored activation ranges.
    An artifact with a ``mesh`` serves over a mesh of that shape, which
    needs an initialised torch.distributed group of as many ranks, each
    of which loads it."""
    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read(_META_NAME).decode("utf-8"))
        with np.load(io.BytesIO(z.read(_PARAMS_NAME)),
                     allow_pickle=False) as npz:
            flat = {k: npz[k] for k in npz.files}
        embeddings = {}
        if _EMBEDDINGS_NAME in z.namelist():
            with np.load(io.BytesIO(z.read(_EMBEDDINGS_NAME)),
                         allow_pickle=False) as npz:
                embeddings = {k: npz[k] for k in npz.files}
    if meta.get("format") != FORMAT:
        error("%s is not a %s serving artifact (format %r)"
              % (path, FORMAT, meta.get("format")))
    mesh = None
    if meta.get("mesh"):
        shape = meta["mesh"]
        need = int(shape["data"]) * int(shape["model"])
        size = mesh_mod.world()[0]
        if size != need:
            error("Artifact was exported for a %dx%d device mesh; only %d "
                  "devices visible (the ranks of this process's "
                  "torch.distributed group; load it in a group of %d)"
                  % (shape["data"], shape["model"], size, need))
        mesh = mesh_mod.make_mesh(shape)
    model = Model(settings_from_spec(meta["model"], embeddings))
    module = ServingModule(model, unflatten_tree(from_jax_flat(flat, device)),
                           batch_items=meta.get("buckets",
                                                meta["batch_items"]),
                           device=device, quantize=meta.get("quantize"),
                           act_ranges=meta.get("act_ranges"),
                           ema=meta.get("ema", False),
                           run_id=meta.get("run_id"), mesh=mesh)
    if module.meta["inputs"] != meta["inputs"]:
        error("Artifact inputs %s do not match the rebuilt model's %s"
              % (meta["inputs"], module.meta["inputs"]))
    return module
