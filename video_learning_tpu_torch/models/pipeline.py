"""Model: interprets the settings' ordered pipelines DAG into
``init_params`` / ``apply`` over a nested dict of tensors.

Counterpart of ``video_learning_tpu/models/pipeline.py:71-456`` for
classification:

* pipelines are built in order; each ``input`` entry is a dataset tag (a
  model input ``<pipeline>_<tag>_input`` with the tagged dataset's shape,
  cpv and fpc) or the output of an earlier pipeline,
* optional multi-input fusion avg / maximum / concat / ibias,
* representation DCNN (AlexNet with frame_encoding_layer truncation) /
  FC / NOP,
* early fusion aggregates the fpc frame vectors before classification,
  late fusion aggregates per-frame logits after it,
* classifier FC (dim-converting) or LSTM; a second pipeline input becomes
  the LSTM's initial state (encoder-decoder handoff);
  ``fusion_method.state`` returns the final hidden state,
* the captioner: when a dataset carries an embedding matrix, the last
  pipeline's LSTM becomes a captioner conditioned on the visual vector
  (``_apply_captioner``): per-word logits over the padded word grid in
  training, greedy or beam decoding with ``decode=True``,
* int8 serving (``quantize="int8"`` / ``"int8_static"``): every DCNN frame
  encoder runs its w8a8 forward, everything after it (LSTM, FCs, the
  caption decode) stays in float; ``quantize_params`` pre-quantizes the
  encoders' weights once and ``calib_taps`` collects the activation
  ranges that int8_static bakes in,
* remat (``settings.remat``, ``pipeline.py:385-390``): a frame encoder
  that ``supports_remat`` runs under ``torch.utils.checkpoint`` when
  gradients are taken (not the calibration forward, as in JAX).

On a mesh (``apply(..., mesh=...)``, a ``parallel.mesh.Mesh`` of more
than one rank) ``params`` holds this rank's slices of the leaves the
JAX sharding rule splits over the model axis (``sharded_leaves``, from
the whole shapes of ``param_shapes``) and the feed holds this rank's
rows.  ``apply`` marks the split entries for the layers
(``parallel.sharding.mark``) and makes the mesh current for the int8
amax, and returns the output of this rank's rows; every rank of a
model group returns the same.  Without a mesh nothing changes.

Parameter-tree names equal the JAX names (``frames/dcnn/conv1/w``,
``clf/lstm/cells/0/w``, ``clf/state_fc/w``, ``clf/output_fc/b``), so
checkpoints move between the packages by name (``checkpoint.py``).
"""

import numpy as np
import torch
import torch.utils.checkpoint

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.models import lstm as lstm_mod
from video_learning_tpu_torch.models import vectorizer
from video_learning_tpu_torch.models.layers import (convert_dim_fc_apply,
                                                    convert_dim_fc_init,
                                                    dropout, fc_init)
from video_learning_tpu_torch.ops import fusion
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.parallel import sharding
from video_learning_tpu_torch.utils import (debug, error, fold_in,
                                            resolve_device, warning)

# the ``decode`` value with which ``apply`` stops at the captioner and
# returns the decoder's arguments (``Model.decoder_inputs``)
_DECODER_INPUTS = "decoder inputs"


class _InputSource:
    """Resolved origin of one pipeline input: a dataset tag or a previously
    built pipeline."""

    def __init__(self, kind, name, shape, cpv, fpc, dim):
        self.kind = kind        # "dataset" | "pipeline"
        self.name = name
        self.shape = shape
        self.cpv = cpv
        self.fpc = fpc
        self.dim = dim


def _dataset_cpv(dataset):
    cpv = dataset.clips_per_video
    if cpv is None:
        return 1
    if isinstance(cpv, int):
        return cpv
    if not all(cpv[0] == c for c in cpv):
        warning("Non-equal clips per item; using the first (%d)" % cpv[0])
    return cpv[0]


def _tree_device(tree):
    if isinstance(tree, dict):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return tree.device if isinstance(tree, torch.Tensor) else None
    for v in items:
        dev = _tree_device(v)
        if dev is not None:
            return dev
    return None


class Model:

    def __init__(self, settings):
        self.settings = settings
        self.num_classes = settings.num_classes
        self.compute_dtype = (torch.bfloat16
                              if settings.compute_dtype == "bfloat16"
                              else torch.float32)
        self.required_input = []
        self.pipeline_meta = {}     # name -> dict(dim, cpv, fpc, shape)
        self.specs = []             # build order
        self.caption_dataset = None
        self._embeddings = {}       # device -> the caption embedding matrix
        self._groups = {"regular": [], "modified": []}
        self._param_shapes = None
        self._resolve()

    # ------------------------------------------------------------- resolve
    def _dataset_by_tag(self, tag):
        dsets = self.settings.feeder.get_dataset_by_tag(tag)
        if not dsets:
            error("Could not find a dataset with tag [%s]" % tag)
        return dsets[0]

    def _resolve(self):
        """Static pass: resolve every pipeline's inputs and output
        metadata."""
        for pname in self.settings.pipeline_names:
            net = self.settings.pipelines[pname]
            sources = []
            for i, input_name in enumerate(net.input):
                if input_name in self.pipeline_meta:
                    meta = self.pipeline_meta[input_name]
                    sources.append(_InputSource(
                        "pipeline", input_name, meta["shape"], meta["cpv"],
                        meta["fpc"], meta["dim"]))
                else:
                    dset = self._dataset_by_tag(input_name)
                    shp = net.input_shape[i] if net.input_shape and \
                        i < len(net.input_shape) else None
                    if shp is None:
                        shp = tuple(dset.get_image_shape())
                    cpv = _dataset_cpv(dset)
                    fpc = dset.num_frames_per_clip or 1
                    key = "%s_%s_input" % (pname, input_name)
                    self.required_input.append(
                        (key, defs.net_input.visual, input_name))
                    sources.append(_InputSource("dataset", key, shp, cpv,
                                                fpc, int(shp[-1])))
                    if dset.embedding_matrix is not None:
                        self.caption_dataset = dset
                        if len(dset.vocabulary) != self.num_classes:
                            error("Captioning requires num_classes == "
                                  "vocabulary size (%d != %d)"
                                  % (self.num_classes,
                                     len(dset.vocabulary)))
                debug("Resolved pipeline input [%s] for [%s]"
                      % (input_name, pname))

            is_last = pname == self.settings.pipeline_names[-1]
            caption = (net.classifier == defs.classifier.lstm and
                       self.caption_dataset is not None and is_last)
            if net.classifier == defs.classifier.lstm and not caption:
                ft = net.frame_fusion[0] if net.frame_fusion else None
                if ft not in (None, defs.fusion_type.none):
                    error("The LSTM classifier should be used only with "
                          "[none] fusion, but it's [%s]" % ft)
                in_fpc = sources[0].fpc
                if net.input_fusion == defs.fusion_method.ibias:
                    in_fpc += 1
                if in_fpc <= 1:
                    error("The LSTM classifier requires an fpc greater "
                          "than 1 (pipeline [%s])" % pname)
            spec = {"name": pname, "net": net, "sources": sources,
                    "caption": caption,
                    "vectorizer": vectorizer.make_vectorizer(
                        net, self.num_classes)}
            self.specs.append(spec)
            self.pipeline_meta[pname] = self._output_meta(spec)
        self.required_input.append(
            ("labels", defs.net_input.labels, defs.dataset_tag.main))

    def _fused_input_meta(self, spec):
        """(dim, cpv, fpc) after optional input fusion."""
        net, sources = spec["net"], spec["sources"]
        dims = [s.dim for s in sources]
        fpcs = [s.fpc for s in sources]
        cpvs = [s.cpv for s in sources]
        if net.input_fusion is not None:
            dim = (sum(dims) if net.input_fusion == defs.fusion_method.concat
                   else dims[0])
            fpc = fpcs[0] + 1 if net.input_fusion == \
                defs.fusion_method.ibias else fpcs[0]
            return dim, cpvs[0], fpc
        return dims[0], cpvs[0], fpcs[0]

    def _output_meta(self, spec):
        net = spec["net"]
        in_dim, cpv, fpc = self._fused_input_meta(spec)
        shape = spec["sources"][0].shape
        dim = spec["vectorizer"].output_dim(in_dim)
        out_fpc = fpc
        ft = net.frame_fusion[0] if net.frame_fusion else None
        if ft == defs.fusion_type.early and fpc > 1:
            out_fpc = 1
        if net.classifier is not None:
            dim = self.num_classes
            out_fpc = 1
        return {"dim": dim, "cpv": cpv, "fpc": out_fpc, "shape": shape}

    # ---------------------------------------------------------------- init
    def init_params(self, seed=0, device="cuda"):
        """Fresh parameters from a ``torch.Generator`` seeded with
        ``seed`` (an int) or the given generator, placed on ``device``."""
        device = resolve_device(device)
        generator = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(int(seed))
        self._groups = {"regular": [], "modified": []}
        return {spec["name"]: self._init_pipeline(generator, spec, device)
                for spec in self.specs}

    def _init_pipeline(self, generator, spec, device):
        net, name = spec["net"], spec["name"]
        p = {}
        in_dim, _, _ = self._fused_input_meta(spec)
        in_shape = spec["sources"][0].shape
        vec = spec["vectorizer"]
        if vec.param_key is not None:
            vec_shape = in_shape if vec.wants_image_input else (in_dim,)
            p[vec.param_key] = vec.init(generator, vec_shape, device)
            for group, rels in (("regular", vec.train_regular),
                                ("modified", vec.train_modified)):
                self._groups[group].extend(
                    name + "/" + vec.param_key + ("/" + rel if rel else "")
                    for rel in rels)
        dim = vec.output_dim(in_dim)

        if net.classifier == defs.classifier.fc:
            p["clf_fc"] = convert_dim_fc_init(generator, dim,
                                              self.num_classes, device)
            if p["clf_fc"] is not None:
                self._groups["modified"].append(name + "/clf_fc")
        elif net.classifier == defs.classifier.lstm:
            num_hidden, num_layers = net.lstm_params[:2]
            lstm_in = dim
            if spec["caption"]:
                emb_dim = self.caption_dataset.get_embedding_dim()
                mode = self._caption_mode(net)
                if mode == defs.rnn_visual_mode.state_bias:
                    # the visual vector becomes the initial state
                    lstm_in = emb_dim
                    p["state_fc"] = convert_dim_fc_init(generator, dim,
                                                        num_hidden, device)
                elif mode == defs.rnn_visual_mode.input_concat:
                    lstm_in = emb_dim + dim
                elif mode == defs.rnn_visual_mode.input_bias:
                    # the visual vector is the first step's input
                    lstm_in = emb_dim
                    p["state_fc"] = convert_dim_fc_init(generator, dim,
                                                        emb_dim, device)
                if p.get("state_fc") is not None:
                    self._groups["modified"].append(name + "/state_fc")
            p["lstm"] = lstm_mod.init(generator, lstm_in, num_hidden,
                                      num_layers, device=device)
            self._groups["modified"].append(name + "/lstm")
            if len(spec["sources"]) > 1 and not spec["caption"]:
                p["input_state_fc"] = convert_dim_fc_init(
                    generator, spec["sources"][1].dim, num_hidden, device)
                if p["input_state_fc"] is not None:
                    self._groups["modified"].append(name + "/input_state_fc")
            if spec["caption"]:
                # caption logits span the vocabulary: the FC always exists
                p["output_fc"] = fc_init(generator, num_hidden,
                                         self.num_classes, device=device)
            else:
                p["output_fc"] = convert_dim_fc_init(
                    generator, num_hidden, self.num_classes, device)
            if p["output_fc"] is not None:
                self._groups["modified"].append(name + "/output_fc")
        return p

    def param_shapes(self):
        """{flat name: whole shape} of the parameter tree (from an init on
        the meta device, which draws nothing), computed once."""
        if self._param_shapes is None:
            from video_learning_tpu_torch.checkpoint import flatten_tree
            self._param_shapes = {
                n: tuple(t.shape) for n, t in
                flatten_tree(self.init_params(0, device="meta")).items()
                if t is not None}
        return self._param_shapes

    def sharded_leaves(self, model_size):
        """{flat name: split dimension} of the leaves the JAX rule splits
        over a model axis of ``model_size``."""
        return sharding.sharded_leaves(self.param_shapes(), model_size)

    def param_groups(self):
        """(regular, modified) parameter path prefixes for two-tier LR."""
        return self._groups["regular"], self._groups["modified"]

    def get_ignorable_variable_names(self):
        """Checkpoint names a restore skips (none: the JAX model's list
        is empty too)."""
        return []

    def quantize_params(self, params, act_ranges=None):
        """Every int8-capable frame encoder's weights pre-quantized once
        per checkpoint (the serving path); the other leaves are kept.
        ``act_ranges`` ({pipeline: {layer: amax}} from ``apply(...,
        calib_taps=...)``) also bakes static activation scales
        (int8_static).  Warns when no pipeline has an int8 path: the
        forward then runs unquantized."""
        out = dict(params)
        quantized = 0
        for spec in self.specs:
            vec = spec["vectorizer"]
            if vec.param_key is None:
                continue
            sub = out.get(spec["name"]) or {}
            vp = sub.get(vec.param_key)
            if vp is None:
                continue
            qp = vec.quantize_params(
                vp, act_ranges=(act_ranges or {}).get(spec["name"]))
            if qp is not None:
                out[spec["name"]] = dict(sub, **{vec.param_key: qp})
                quantized += 1
        if quantized == 0:
            warning("quantize requested but no pipeline has an "
                    "int8-capable frame encoder (DCNN) — the forward "
                    "runs UNQUANTIZED")
        return out

    # --------------------------------------------------------------- apply
    def apply(self, params, feed, train=False, dropout_generator=None,
              conv1_dw=None, decode=False, quantize=None,
              calib_taps=None, mesh=None, conv1_fwd=None,
              freeze_conv1=None):
        """Run the full DAG.  feed: {input_key: tensor or array}; arrays
        move to the parameters' device.  Returns float32 logits,
        (num_items, num_classes) for classification and (B*T,
        num_classes) for caption training (the feed then also holds
        ``caption_words`` and ``caption_lengths``), or with ``decode=True``
        a captioner's (B, T) int32 word indices (greedy, or beam search
        when ``settings.captioning`` asks for it).
        ``dropout_generator`` (a ``torch.Generator``)
        seeds training dropout: pipeline i draws from a generator on the
        same device seeded with ``fold_in(its seed, i)``, so two
        same-shaped dropout sites in different pipelines never share a
        mask (JAX ``fold_in(rng, i)``); a list gives pipeline i its own
        generator ``[i]`` as it stands (``Train`` seeds them so, and keeps
        them for the graphs that draw from them).
        ``conv1_fwd``, ``conv1_dw`` and ``freeze_conv1`` pick the stem
        conv's forward and weight gradient and freeze its parameters
        (``alexnet.apply``; None reads the environment).  With
        ``settings.remat`` and grad mode on, each frame encoder that
        ``supports_remat`` runs under ``torch.utils.checkpoint``: its
        activations are recomputed in the backward, not kept.
        ``quantize`` ("int8" / "int8_static") runs the frame encoders'
        w8a8 serving forward (forward only: refused in training), on raw
        or ``quantize_params`` parameters.  ``calib_taps``, a dict, runs
        the float forward and fills it with {pipeline: {layer: amax}}
        activation ranges (0-d tensors) of every int8-capable encoder:
        the calibration pass of int8_static.  ``mesh``: this rank's
        slices and rows on a mesh (module docstring)."""
        if mesh is not None and mesh.size > 1:
            if mesh.model > 1:
                params = sharding.mark(params,
                                       self.sharded_leaves(mesh.model), mesh)
            with mesh_mod.use(mesh):
                return self.apply(params, feed, train, dropout_generator,
                                  conv1_dw, decode, quantize, calib_taps,
                                  conv1_fwd=conv1_fwd,
                                  freeze_conv1=freeze_conv1)
        if quantize is not None and train:
            error("quantize=%s is a serving (forward-only) mode; "
                  "training gradients through int8 rounding are zero"
                  % quantize)
        if calib_taps is not None and quantize is not None:
            error("calibration runs the float forward; it cannot be "
                  "combined with quantize=%s" % quantize)
        conv1 = {"conv1_fwd": conv1_fwd, "conv1_dw": conv1_dw,
                 "freeze_conv1": freeze_conv1}
        device = _tree_device(params)
        feed = {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(device)
                for k, v in feed.items()}
        outputs = {}
        logits = None
        for i, spec in enumerate(self.specs):
            gen_i = None
            if isinstance(dropout_generator, (list, tuple)):
                gen_i = dropout_generator[i]
            elif dropout_generator is not None:
                gen_i = torch.Generator(dropout_generator.device).manual_seed(
                    fold_in(dropout_generator.initial_seed(), i))
            logits = self._apply_pipeline(params[spec["name"]], spec, feed,
                                          outputs, train, gen_i, conv1,
                                          decode, quantize, calib_taps)
            if decode is _DECODER_INPUTS and spec["caption"]:
                return logits
            outputs[spec["name"]] = logits
        return logits

    def decoder_inputs(self, params, feed, quantize=None, mesh=None):
        """The keyword arguments ``apply(decode=True)`` gives
        ``greedy_decode`` for ``feed`` (``beam_decode`` takes them with
        ``eos_index``): the captioner's LSTM and ``output_fc`` parameters,
        its conditioning ``visual`` (the captioner pipeline's visual vector
        through ``state_fc`` in the compute dtype with a float32 result;
        input_concat has no ``state_fc``), the embedding matrix on the
        parameters' device, BOS, T, the hidden width and the visual
        mode.  ``quantize`` as ``apply`` takes it: the frame encoders of
        the conditioning in int8."""
        return self.apply(params, feed, decode=_DECODER_INPUTS,
                          quantize=quantize, mesh=mesh)

    def _apply_pipeline(self, p, spec, feed, outputs, train,
                        dropout_generator, conv1, decode, quantize,
                        calib_taps):
        net, name = spec["net"], spec["name"]
        inputs, dims, fpcs, cpvs = [], [], [], []
        for src in spec["sources"]:
            if src.kind == "pipeline":
                inputs.append(outputs[src.name])
            else:
                if src.name not in feed:
                    error("Missing feed input [%s]" % src.name)
                inputs.append(feed[src.name])
            dims.append(src.dim)
            fpcs.append(src.fpc)
            cpvs.append(src.cpv)

        if net.input_fusion is not None:
            fused, dim, fpc, cpv = fusion.apply_tensor_list_fusion(
                inputs, net.input_fusion, dims, fpcs, cpvs)
            inputs, dims, fpcs, cpvs = [fused], [dim], [fpc], [cpv]

        x = inputs[0]
        fpc = fpcs[0]
        output_fpc = fpc
        fusion_type, fusion_method = (net.frame_fusion if net.frame_fusion
                                      else (None, None))
        vec = spec["vectorizer"]
        calib = None if calib_taps is None else vec.apply_calib(
            p.get(vec.param_key), x, compute_dtype=self.compute_dtype)
        if calib is not None:
            x, calib_taps[name] = calib
        else:
            def encode(vp, inp):
                return vec.apply(vp, inp, compute_dtype=self.compute_dtype,
                                 quant=quantize, **conv1)

            remat = getattr(self.settings, "remat", False)
            if remat and vec.supports_remat and torch.is_grad_enabled():
                # no RNG state to keep: the encoder draws no random
                # numbers (dropout comes after it), and reading the CUDA
                # generator's state would break a CUDA graph's capture
                x = torch.utils.checkpoint.checkpoint(
                    encode, p.get(vec.param_key), x, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x = encode(p.get(vec.param_key), x)
        dim = int(x.shape[-1])
        if self.settings.print_tensors:
            debug("Vectorized output [%s] shape=%s" % (name, tuple(x.shape)))

        if fusion_type == defs.fusion_type.early and fpc > 1:
            x = fusion.aggregate_clip_vectors(x, dim, fpc, fusion_method)
            output_fpc = 1

        if net.classifier is None:
            return x

        if net.classifier == defs.classifier.fc:
            logits = convert_dim_fc_apply(p.get("clf_fc"), x,
                                          self.compute_dtype)
        elif net.classifier == defs.classifier.lstm:
            if spec["caption"]:
                return self._apply_captioner(p, spec, x, feed, train,
                                             dropout_generator, decode)
            num_hidden, num_layers, lstm_fusion = net.lstm_params[:3]
            init_state = None
            if len(inputs) > 1:
                state = fusion.replicate_auxiliary_tensor(
                    inputs[1], dims[1], cpvs[0], cpvs[1])
                init_state = convert_dim_fc_apply(p.get("input_state_fc"),
                                                  state)
            seq_out, states = vectorizer.LSTM(
                num_hidden, num_layers, output_fpc).apply(
                    p["lstm"], x, compute_dtype=self.compute_dtype,
                    init_state=init_state)
            if lstm_fusion == defs.fusion_method.state:
                logits = states[-1][1]  # final hidden state
            else:
                logits = fusion.apply_temporal_fusion(
                    seq_out, num_hidden, seq_out.shape[1], lstm_fusion)
                if train:
                    logits = dropout(dropout_generator, logits,
                                     self.settings.get_dropout())
            logits = convert_dim_fc_apply(p.get("output_fc"), logits,
                                          self.compute_dtype)
        else:
            error("Undefined classifier [%s]" % net.classifier)

        if fusion_type == defs.fusion_type.late and fpc > 1 and \
                logits.dim() == 2 and logits.shape[0] != 0:
            logits = fusion.aggregate_clip_vectors(
                logits, self.num_classes, fpc, fusion_method)
        return logits

    # ----------------------------------------------------------- captioner
    @staticmethod
    def _caption_mode(net):
        if len(net.lstm_params) > 3:
            return net.lstm_params[3]
        return defs.rnn_visual_mode.state_bias

    def _embedding_matrix(self, device):
        """The caption dataset's embedding matrix as a float32 tensor on
        ``device``, copied there once."""
        key = str(device)
        if key not in self._embeddings:
            self._embeddings[key] = torch.as_tensor(
                self.caption_dataset.embedding_matrix,
                dtype=torch.float32).to(device)
        return self._embeddings[key]

    def _apply_captioner(self, p, spec, visual, feed, train,
                         dropout_generator, decode):
        """Caption branch.  Training emits per-word logits over the padded
        (B, T) word grid; decoding runs a batched greedy or beam feedback
        search.  Visual conditioning modes: state_bias (the visual vector
        as every layer's initial (c, h)), input_concat (the visual vector
        concatenated to each step's word input), input_bias (the visual
        vector fed as an extra first step).  ``state_fc`` runs in the
        compute dtype with a float32 result; decoding runs in float32;
        training projects and applies ``output_fc`` in the compute
        dtype."""
        net = spec["net"]
        num_hidden = net.lstm_params[0]
        mode = self._caption_mode(net)
        dset = self.caption_dataset
        T = dset.max_sequence_length
        visual = convert_dim_fc_apply(p.get("state_fc"), visual,
                                      self.compute_dtype)
        if decode:
            args = dict(params=p["lstm"], out_fc_params=p["output_fc"],
                        visual=visual,
                        embedding_matrix=self._embedding_matrix(
                            visual.device),
                        bos_index=dset.vocabulary.index("BOS"),
                        sequence_len=T, num_hidden=num_hidden,
                        visual_mode=mode)
            if decode is _DECODER_INPUTS:
                return args
            cap_opts = self.settings.captioning
            if cap_opts is not None and \
                    cap_opts.caption_search == defs.caption_search.beam:
                return lstm_mod.beam_decode(
                    eos_index=dset.vocabulary.index("EOS"),
                    beam_width=cap_opts.beam_width,
                    length_norm=cap_opts.length_norm, **args)
            return lstm_mod.greedy_decode(**args)

        words = feed["caption_words"]          # (B*T, E)
        lengths = feed["caption_lengths"]      # (B,) input lengths (1+len)
        E = words.shape[-1]
        if mode == defs.rnn_visual_mode.state_bias:
            seq_out, _ = lstm_mod.evaluate_sequence(
                p["lstm"], words, num_hidden, T, lengths=lengths,
                init_state=visual, compute_dtype=self.compute_dtype)
        elif mode == defs.rnn_visual_mode.input_concat:
            grid = words.reshape(-1, T, E)
            vis = visual[:, None, :].expand(grid.shape[0], T,
                                            visual.shape[-1])
            combo = torch.cat([grid, vis.to(grid.dtype)], dim=-1)
            seq_out, _ = lstm_mod.evaluate_sequence(
                p["lstm"], combo.reshape(-1, combo.shape[-1]), num_hidden,
                T, lengths=lengths, compute_dtype=self.compute_dtype)
        elif mode == defs.rnn_visual_mode.input_bias:
            grid = words.reshape(-1, T, E)
            combo = torch.cat([visual[:, None, :].to(grid.dtype), grid],
                              dim=1)
            seq_out, _ = lstm_mod.evaluate_sequence(
                p["lstm"], combo.reshape(-1, E), num_hidden, T + 1,
                lengths=lengths + 1, compute_dtype=self.compute_dtype)
            seq_out = seq_out[:, 1:, :]     # drop the visual step's output
        else:
            error("Unknown rnn visual mode [%s]" % mode)
        out = seq_out.reshape(-1, num_hidden)
        if train:
            out = dropout(dropout_generator, out, self.settings.get_dropout())
        return convert_dim_fc_apply(p["output_fc"], out, self.compute_dtype)

    # ------------------------------------------------------------- helpers
    def visual_sources(self):
        """[(input_key, dataset_tag, _InputSource)] of every model input
        fed from a dataset, in required_input order."""
        srcs = {src.name: src for spec in self.specs
                for src in spec["sources"] if src.kind == "dataset"}
        return [(key, tag, srcs[key]) for key, itype, tag in
                self.required_input if itype == defs.net_input.visual]
