"""Vectorizer strategy objects: NOP / DCNN / FC / LSTM.

Counterpart of ``video_learning_tpu/models/vectorizer.py:59-214``.
Contract with the pipeline DAG (models/pipeline.py):

* ``param_key``        - name of the vectorizer's subtree in the
                         pipeline's parameter dict (None: stateless),
* ``init(generator, shape, device)`` - build the parameter tree; fills
                         ``train_regular`` / ``train_modified`` with
                         relative parameter paths ("" = the whole tree),
* ``apply(params, x, compute_dtype, quant, **conv1)`` - run it;
                         ``conv1`` (``conv1_fwd``, ``conv1_dw``,
                         ``freeze_conv1``: ``alexnet.apply``'s) picks the
                         stem conv's lowerings and only the DCNN reads
                         it; ``quant`` ("int8" / "int8_static") selects
                         the DCNN's w8a8 serving forward,
* ``supports_remat``   - the pipeline may run ``apply`` under
                         ``torch.utils.checkpoint`` (``settings.remat``),
* ``quantize_params(params, act_ranges)`` / ``apply_calib(params, x,
  compute_dtype)`` - the int8 form of the params and the calibration
                         forward, or None where the strategy has no int8
                         path.
"""

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.models import alexnet, lstm as lstm_mod
from video_learning_tpu_torch.models.layers import (convert_dim_fc_apply,
                                                    convert_dim_fc_init)
from video_learning_tpu_torch.utils import error, warning_once


class Vectorizer:
    """Transforms raw input data into a feature vector."""

    name = "base"
    param_key = None
    # init() receives the full (H, W, C) input shape rather than the
    # flattened trailing dim
    wants_image_input = False
    # apply() costs enough that recomputing it in the backward, rather
    # than keeping its activations, can pay off (settings.remat)
    supports_remat = False

    def __init__(self):
        self.train_regular = []
        self.train_modified = []

    def require_input(self, shape, rank):
        if len(shape) < rank:
            error("The [%s] vectorizer requires input rank >= %d, got "
                  "shape %s" % (self.name, rank, tuple(shape)))

    def init(self, generator, input_shape, device="cpu"):
        return None

    def quantize_params(self, params, act_ranges=None):
        """The pre-quantized (int8 serving) form of this vectorizer's
        params, or None where the strategy has no int8 path (the
        pipeline then keeps its params and ``Model.quantize_params``
        warns).  ``act_ranges`` ({layer: amax} from ``apply_calib``)
        bakes static activation scales (int8_static)."""
        return None

    def apply_calib(self, params, x, compute_dtype=None):
        """(float output, {layer: amax} taps) for static int8
        calibration, or None where the strategy has no int8 path (the
        pipeline then runs the plain apply and calibrates nothing)."""
        return None

    def output_dim(self, in_dim):
        """Feature dimension produced for inputs of trailing dim
        ``in_dim``."""
        return in_dim

    def apply(self, params, x, compute_dtype=None, quant=None, **conv1):
        raise NotImplementedError


class NOP(Vectorizer):
    name = "nop"

    def apply(self, params, x, compute_dtype=None, quant=None, **conv1):
        if quant:
            warning_once("quantize=%s has no effect on a [nop] "
                         "representation" % quant, key="nop-quantize")
        return x


class DCNN(Vectorizer):
    name = "dcnn"
    param_key = "dcnn"
    wants_image_input = True
    supports_remat = True

    def __init__(self, num_classes, frame_encoding_layer="fc7",
                 weights_file=None):
        super().__init__()
        self.num_classes = num_classes
        self.frame_encoding_layer = frame_encoding_layer
        self.weights_file = weights_file

    def init(self, generator, input_shape, device="cpu"):
        self.require_input(input_shape, 3)
        params = alexnet.init(generator, self.num_classes,
                              self.frame_encoding_layer, self.weights_file,
                              fc6_in=alexnet.conv_output_flat_dim(
                                  input_shape),
                              device=device)
        self.train_regular, self.train_modified = \
            alexnet.param_groups(params)
        return params

    def output_dim(self, in_dim):
        return alexnet.output_dim(self.frame_encoding_layer,
                                  self.num_classes)

    def apply(self, params, x, compute_dtype=None, quant=None, **conv1):
        self.require_input(x.shape, 3)
        if quant in ("int8", "int8_static"):
            # the forward-only serving path; static scales ride in the
            # params as "xs" entries, so both modes share one forward
            return alexnet.apply_int8(params, x, self.frame_encoding_layer,
                                      compute_dtype=compute_dtype)
        return alexnet.apply(params, x, self.frame_encoding_layer,
                             compute_dtype=compute_dtype, **conv1)

    def quantize_params(self, params, act_ranges=None):
        return alexnet.quantize_params(params, act_ranges=act_ranges)

    def apply_calib(self, params, x, compute_dtype=None):
        self.require_input(x.shape, 3)
        return alexnet.apply_calib(params, x, self.frame_encoding_layer,
                                   compute_dtype=compute_dtype)


class FC(Vectorizer):
    name = "FC"
    param_key = "repr_fc"

    def __init__(self, fc_output_dim):
        super().__init__()
        self.fc_output_dim = fc_output_dim

    def init(self, generator, input_shape, device="cpu"):
        self.train_modified = [""]
        return convert_dim_fc_init(generator, int(input_shape[-1]),
                                   self.fc_output_dim, device=device)

    def output_dim(self, in_dim):
        return self.fc_output_dim

    def apply(self, params, x, compute_dtype=None, quant=None, **conv1):
        self.require_input(x.shape, 2)
        if quant:
            warning_once("quantize=%s is implemented for DCNN frame "
                         "encoders only; the [FC] representation runs "
                         "unquantized" % quant, key="fc-quantize")
        return convert_dim_fc_apply(params, x, compute_dtype)


class LSTM(Vectorizer):
    name = "lstm"
    param_key = "lstm"

    def __init__(self, num_hidden, num_layers, sequence_len):
        super().__init__()
        self.num_hidden = num_hidden
        self.num_layers = num_layers
        self.sequence_len = sequence_len

    def init(self, generator, input_shape, device="cpu"):
        self.train_modified = [""]
        return lstm_mod.init(generator, int(input_shape[-1]),
                             self.num_hidden, self.num_layers, device=device)

    def output_dim(self, in_dim):
        return self.num_hidden

    def apply(self, params, x, compute_dtype=None, lengths=None,
              init_state=None):
        self.require_input(x.shape, 2)
        return lstm_mod.evaluate_sequence(params, x, self.num_hidden,
                                          self.sequence_len, lengths,
                                          init_state,
                                          compute_dtype=compute_dtype)


def make_vectorizer(net, num_classes):
    """Vectorizer for a pipeline's ``representation`` setting."""
    if net.representation == defs.representation.dcnn:
        return DCNN(num_classes, net.frame_encoding_layer,
                    net.weights_file)
    if net.representation == defs.representation.fc:
        return FC(net.fc_output_dim)
    if net.representation == defs.representation.nop:
        return NOP()
    error("Undefined representation [%s]" % net.representation)
