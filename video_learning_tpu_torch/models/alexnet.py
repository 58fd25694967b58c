"""AlexNet DCNN frame encoder.

Counterpart of ``video_learning_tpu/models/alexnet.py:75-126,256-452``: grouped convolutions (group=2 on conv2/4/5), LRN after conv1
and conv2 (the CUDA LRN kernel on the GPU), three VALID max pools,
fc6/fc7 (4096) and a fresh fc8 sized to num_classes, with
``frame_encoding_layer`` truncation at fc6 / fc7 / prob and the two-tier
LR parameter groups.

Geometry (input 227x227x3): conv1 11x11x96 s4 SAME -> LRN -> pool3 s2 ->
conv2 5x5x256 g2 -> LRN -> pool -> conv3 3x3x384 -> conv4 3x3x384 g2 ->
conv5 3x3x256 g2 -> pool -> fc6 9216->4096 -> fc7 4096 -> fc8.

pool5 is flattened in NHWC (H, W, C) order, as the JAX package does, so
fc6's rows line up with its checkpoints.

conv1 runs through ``Conv1Function``, the counterpart of
``alexnet._conv1_direct`` (``alexnet.py:208-253``): a cuDNN forward, and
a backward whose weight gradient is a hand kernel (``ops/conv1_dw.py``)
or the im2col product (``conv1_dw_im2col``, the counterpart of
``pallas_kernels.conv1_dw_xla``).  Its forward is the direct 11x11
stride-4 conv, or the space-to-depth conv of ``alexnet.py:129-176``
(``conv1_space_to_depth``).  ``apply`` picks the lowerings by argument,
or, where an argument is None, from the JAX package's environment
variables, read at each call (``conv1_options``): ``VLT_CONV1_S2D=1``
the space-to-depth forward, ``VLT_CONV1_DW_IMPL`` the weight gradient
("shifted", "blocked" or "im2col"; ``VLT_CONV1_FAST_DW=1`` or
``VLT_CONV1_PALLAS_DW=1`` mean "im2col"), ``VLT_FREEZE_CONV1=1`` conv1's
parameters detached, as ``stop_gradient`` does (``alexnet.py:269-273``).
Unset, they give the direct forward, "shifted" and no freeze.

The int8 serving forward (``apply_int8``), its static-scale calibration
(``apply_calib``) and the once-per-checkpoint weight quantization
(``quantize_params``) follow ``alexnet.py:301-423``: conv2..conv5 and
fc6..fc8 in w8a8 (``layers.conv_apply_int8`` / ``fc_apply_int8``), conv1
in the compute dtype, LRN and pooling unchanged.  ``load_bvlc_weights``
reads a pretrained bvlc ``.npy`` ({layer: [w HWIO, b]}, checked against
its ``.sha256`` sidecar when there is one) for ``init(weights_file=...)``.
"""

import hashlib
import math
import os

import numpy as np

import torch
import torch.nn.functional as F

from video_learning_tpu_torch.models.layers import (
    CONV_WEIGHT_AXES, FC_WEIGHT_AXES, conv_apply, conv_apply_int8, conv_init,
    fc_apply, fc_apply_int8, fc_init, flat_dim, hwio_to_oihw,
    local_response_normalization, max_pool, quantize_sym, same_pads)
from video_learning_tpu_torch.ops import conv1_dw as conv1_dw_ops
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.utils import error, info

# (kernel_h, kernel_w, in_ch, out_ch, stride, groups)
_CONV_SPECS = {
    "conv1": (11, 11, 3, 96, 4, 1),
    "conv2": (5, 5, 48, 256, 1, 2),
    "conv3": (3, 3, 256, 384, 1, 1),
    "conv4": (3, 3, 192, 384, 1, 2),
    "conv5": (3, 3, 192, 256, 1, 2),
}
_FC6_IN = 9216  # 6*6*256 for 227x227 input
_FC_DIM = 4096


def load_bvlc_weights(weights_file):
    """The bvlc_alexnet.npy dict {layer: [w, b]} (conv weights HWIO).
    Where a ``<weights_file>.sha256`` sidecar exists, the file's digest
    must match it."""
    if not os.path.exists(weights_file):
        error("AlexNet weights file does not exist: %s" % weights_file)
    sidecar = weights_file + ".sha256"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            want = f.read().split()[0].strip()
        h = hashlib.sha256()
        with open(weights_file, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != want:
            error("AlexNet weights file %s does not match its .sha256 "
                  "sidecar (%s != %s)"
                  % (weights_file, h.hexdigest(), want))
    # the public file is a pickled dict inside an .npy: trusted input
    return np.load(weights_file, encoding="latin1",
                   allow_pickle=True).item()


def _pretrained(w, b, device):
    return {"w": torch.from_numpy(np.array(w, np.float32)).to(device),
            "b": torch.from_numpy(np.array(b, np.float32)).to(device)}


def init(generator, num_classes, final_layer="prob", weights_file=None,
         fc6_in=None, device="cpu"):
    """Build the parameter tree; fc8 exists only for a ``prob`` final
    layer.  With ``weights_file`` the convs and fc6/fc7 come from the
    pretrained ``.npy`` (an fc layer whose pretrained shape does not fit
    this input is drawn fresh) and fc8 is always fresh."""
    if final_layer is None:
        final_layer = "prob"
    net_data = load_bvlc_weights(weights_file) if weights_file else None
    if net_data is not None:
        info("AlexNet: loading pretrained weights from %s" % weights_file)
    params = {}
    for name, (kh, kw, cin, cout, _, _) in _CONV_SPECS.items():
        if net_data is not None and name in net_data:
            p = _pretrained(*net_data[name][:2], device)
            params[name] = {"w": hwio_to_oihw(p["w"]), "b": p["b"]}
        else:
            params[name] = conv_init(generator, (kh, kw, cin, cout),
                                     init_w=(0.0, 0.05), bias=0.1,
                                     device=device)
    fc6_in = fc6_in or _FC6_IN
    for name, din, dout in (("fc6", fc6_in, _FC_DIM),
                            ("fc7", _FC_DIM, _FC_DIM)):
        if final_layer == "fc6" and name == "fc7":
            break
        pretrained = net_data.get(name) if net_data is not None else None
        if pretrained is not None and \
                tuple(pretrained[0].shape) != (din, dout):
            info("AlexNet %s: pretrained shape %s != required (%d, %d); "
                 "initializing fresh" % (name, pretrained[0].shape, din,
                                         dout))
            pretrained = None
        if pretrained is not None:
            params[name] = _pretrained(*pretrained[:2], device)
        else:
            params[name] = fc_init(generator, din, dout, device=device)
    if final_layer not in ("fc6", "fc7"):
        params["fc8"] = fc_init(generator, _FC_DIM, num_classes,
                                device=device)
    return params


def param_groups(params, prefix=""):
    """Two-tier LR split: everything but fc8 is 'regular', fc8 is
    'modified'."""
    regular, modified = [], []
    for name in params:
        (modified if name == "fc8" else regular).append(prefix + name)
    return regular, modified


CONV1_FWD = ("direct", "s2d")
CONV1_DW = {"shifted": conv1_dw_ops.conv1_dw_shifted,
            "blocked": conv1_dw_ops.conv1_dw,
            "im2col": conv1_dw_ops.conv1_dw_im2col}


def conv1_options(conv1_fwd=None, conv1_dw=None, freeze_conv1=None):
    """(conv1_fwd, conv1_dw, freeze_conv1) with each None read from the
    JAX package's environment variables (module docstring); a value
    outside the lists, passed or read, raises."""
    if conv1_fwd is None:
        conv1_fwd = "s2d" if os.environ.get("VLT_CONV1_S2D", "0") == "1" \
            else "direct"
    if conv1_dw is None:
        conv1_dw = os.environ.get("VLT_CONV1_DW_IMPL", "")
        if not conv1_dw and os.environ.get(
                "VLT_CONV1_FAST_DW",
                os.environ.get("VLT_CONV1_PALLAS_DW", "0")) == "1":
            conv1_dw = "im2col"
        conv1_dw = conv1_dw or "shifted"
    if freeze_conv1 is None:
        freeze_conv1 = os.environ.get("VLT_FREEZE_CONV1") == "1"
    if conv1_fwd not in CONV1_FWD:
        error("conv1_fwd must be one of %s, got %r"
              % (list(CONV1_FWD), conv1_fwd))
    if conv1_dw not in CONV1_DW:
        error("conv1_dw (or VLT_CONV1_DW_IMPL) must be one of %s, got %r"
              % (sorted(CONV1_DW), conv1_dw))
    return conv1_fwd, conv1_dw, bool(freeze_conv1)


def conv1_space_to_depth(x, w, b):
    """relu(conv(x, w, stride 4, SAME) + b) as ``alexnet.py:129-176``
    lowers it: x (N, H, W, C) padded as SAME pads it, and below and right
    to whole 4x4 blocks, rearranged to (N, H/4, W/4, 16C); the OIHW
    (cout, C, 11, 11) weight padded to 12x12 taps (the 12th zero) and
    rearranged to a dense (cout, 16C, 3, 3) one; one stride-1 VALID conv,
    sliced to the SAME output, the bias added in the compute dtype.
    Input channel (di*4 + dj)*C + c of block position (P, Q) is padded
    pixel (4P + di, 4Q + dj, c)."""
    n, h, wd, c = x.shape
    cout = w.shape[0]
    out_h, out_w = -(-h // 4), -(-wd // 4)
    pad_h = max((out_h - 1) * 4 + 11 - h, 0)
    pad_w = max((out_w - 1) * 4 + 11 - wd, 0)
    top, left = pad_h // 2, pad_w // 2
    eh, ew = -(h + pad_h) % 4, -(wd + pad_w) % 4
    x = F.pad(x, (0, 0, left, pad_w - left + ew, top, pad_h - top + eh))
    bh, bw = x.shape[1] // 4, x.shape[2] // 4
    x = x.reshape(n, bh, 4, bw, 4, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, bh, bw, 16 * c)
    wp = F.pad(w, (0, 1, 0, 1)).reshape(cout, c, 3, 4, 3, 4)
    wp = wp.permute(0, 3, 5, 1, 2, 4).reshape(cout, 16 * c, 3, 3) \
        .contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), wp)
    y = y[:, :, :out_h, :out_w] + b.to(y.dtype)[:, None, None]
    return F.relu(y).permute(0, 2, 3, 1)


class Conv1Function(torch.autograd.Function):
    """relu(conv(x, w, stride 4, SAME) + b) for the stem conv, NHWC in
    and out, w OIHW, with the backward of ``alexnet._conv1_direct``:
    the output gradient masked by the relu, ``db`` summed in float32 and
    cast to b's dtype, ``dW`` from the conv1 weight gradient (``dw_impl``,
    a key of ``CONV1_DW``) cast to w's dtype, and ``dx`` only when the
    frames need a gradient (never in training), as the exact input
    gradient of the conv.  ``fwd_impl`` "direct" runs the conv as it is,
    "s2d" as ``conv1_space_to_depth``; the backward is the same function
    of (x, g) for both.  A parameter that needs no gradient (a frozen
    conv1) gets none computed."""

    @staticmethod
    def forward(ctx, x, w, b, dw_impl, fwd_impl="direct"):
        if fwd_impl == "s2d":
            out = conv1_space_to_depth(x, w, b)
        else:
            out = conv_apply({"w": w, "b": b}, x, (4, 4), "SAME", relu=True)
        ctx.save_for_backward(x, w, out)
        ctx.dw_impl = dw_impl
        ctx.b_dtype = b.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = g * (out > 0).to(g.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[2]:
            db = g.to(torch.float32).sum((0, 1, 2)).to(ctx.b_dtype)
        if ctx.needs_input_grad[1]:
            dw = hwio_to_oihw(CONV1_DW[ctx.dw_impl](x, g)).to(w.dtype)
        if ctx.needs_input_grad[0]:
            (top, bottom), (left, right) = (same_pads(x.shape[1], 11, 4),
                                            same_pads(x.shape[2], 11, 4))
            n, h, wd, c = x.shape
            dx = torch.nn.grad.conv2d_input(
                (n, c, h + top + bottom, wd + left + right), w,
                g.permute(0, 3, 1, 2), stride=4)
            dx = dx[:, :, top:top + h, left:left + wd].permute(0, 2, 3, 1)
        return dx, dw, db, None, None


def _forward(params, x, final_layer, compute_dtype, conv1, conv, fc):
    """The AlexNet stages with conv1 by ``conv1`` (the ``conv1_options``
    triple), conv2..conv5 as ``conv(name, x)`` and fc6..fc8 as
    ``fc(name, x)`` (fc6 and fc7 followed by relu)."""
    if final_layer is None:
        final_layer = "prob"
    conv1_fwd, conv1_dw, freeze_conv1 = conv1
    w1, b1 = params["conv1"]["w"], params["conv1"]["b"]
    if freeze_conv1:
        w1, b1 = w1.detach(), b1.detach()
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w1 = w1.to(compute_dtype)
    x = Conv1Function.apply(x, w1, b1, conv1_dw, conv1_fwd)
    x = local_response_normalization(x)
    x = max_pool(x, (3, 3), (2, 2), "VALID")
    x = conv("conv2", x)
    x = local_response_normalization(x)
    x = max_pool(x, (3, 3), (2, 2), "VALID")
    x = conv("conv3", x)
    x = conv("conv4", x)
    x = conv("conv5", x)
    x = max_pool(x, (3, 3), (2, 2), "VALID")
    x = x.reshape(x.shape[0], flat_dim(x.shape[1:]))    # NHWC order

    x = F.relu(fc("fc6", x))
    if final_layer == "fc6":
        return x
    x = F.relu(fc("fc7", x))
    if final_layer == "fc7":
        return x
    return fc("fc8", x)


def _conv_stride_groups(name):
    _, _, _, _, stride, groups = _CONV_SPECS[name]
    return (stride, stride), groups


def apply(params, x, final_layer="prob", compute_dtype=None,
          conv1_fwd=None, conv1_dw=None, freeze_conv1=None):
    """Forward pass.  x: (N, H, W, 3) (BGR, preprocessed).  Returns the
    float32 encoding at ``final_layer`` (fc6/fc7) or the fc8 logits.
    ``conv1_fwd`` ("direct" or "s2d") picks conv1's forward, ``conv1_dw``
    ("shifted", "blocked" or "im2col") its weight gradient, and
    ``freeze_conv1`` detaches its parameters; each None is read from the
    environment (``conv1_options``)."""
    conv1 = conv1_options(conv1_fwd, conv1_dw, freeze_conv1)

    def conv(name, inp):
        strides, groups = _conv_stride_groups(name)
        return conv_apply(params[name], inp, strides, "SAME", groups=groups,
                          relu=True, compute_dtype=compute_dtype)

    def fc(name, inp):
        return fc_apply(params[name], inp, compute_dtype)

    return _forward(params, x, final_layer, compute_dtype, conv1, conv, fc)


# conv1 of the int8 serving forward and its calibration: the direct
# forward, as JAX's apply_int8 and apply_calib run it whatever the
# environment says (alexnet.py:321, 367)
_SERVING_CONV1 = ("direct", "shifted", False)


def apply_int8(params, x, final_layer="prob", compute_dtype=None):
    """The w8a8 serving forward (forward only): conv2..conv5 and the FC
    stack in int8 with int32 sums, their outputs dequantized to the
    compute dtype (bf16 when None) for convs and float32 for FCs; conv1
    in the compute dtype; LRN and pooling unchanged.  ``params`` are raw
    or from ``quantize_params`` (with calibrated "xs" scales for
    int8_static).  Same truncation as ``apply``."""
    out_dtype = compute_dtype or torch.bfloat16

    def conv(name, inp):
        strides, groups = _conv_stride_groups(name)
        return conv_apply_int8(params[name], inp, strides, "SAME",
                               groups=groups, relu=True, out_dtype=out_dtype)

    def fc(name, inp):
        return fc_apply_int8(params[name], inp)

    return _forward(params, x, final_layer, compute_dtype, _SERVING_CONV1,
                    conv, fc)


def apply_calib(params, x, final_layer="prob", compute_dtype=None):
    """Calibration forward for static int8 activation scales: the float
    forward of ``apply``, also returning {layer: amax(|input|)} as
    float32 0-d tensors on x's device (no host sync) at every
    int8-eligible layer input (conv2..conv5, fc6..fc8 where present):
    the tensors ``apply_int8`` would reduce per batch.  Returns
    (output at ``final_layer``, taps)."""
    taps = {}

    def tap(name, inp):
        # on a mesh, the amax of the global batch (MAX over the data
        # group), so that every rank bakes the same scales
        taps[name] = mesh_mod.data_max(inp.abs().amax().to(torch.float32))
        return inp

    def conv(name, inp):
        strides, groups = _conv_stride_groups(name)
        return conv_apply(params[name], tap(name, inp), strides, "SAME",
                          groups=groups, relu=True,
                          compute_dtype=compute_dtype)

    def fc(name, inp):
        return fc_apply(params[name], tap(name, inp), compute_dtype)

    return _forward(params, x, final_layer, compute_dtype, _SERVING_CONV1,
                    conv, fc), taps


def quantize_params(params, act_ranges=None):
    """The int8-eligible layers pre-quantized once per checkpoint:
    conv2..conv5 become {"wq" OIHW int8, "ws" (Cout, 1, 1, 1), "b"} and
    fc6..fc8 {"wq" (in, out) int8, "ws" (1, out), "b"}; conv1 and absent
    (truncated) layers pass through.  ``act_ranges`` ({layer: amax}, from
    ``apply_calib``; numbers or 0-d tensors) also bakes the static
    activation scale "xs" = amax / 127 + 1e-12 (float32) into each entry
    (quantize: int8_static); a layer missing from it is an error."""
    out = dict(params)

    def entry(name, axes):
        w = out[name]["w"]
        wq, ws = quantize_sym(w, axes=axes)
        e = {"wq": wq, "ws": ws, "b": out[name]["b"]}
        if act_ranges is not None:
            if name not in act_ranges:
                error("Calibration ranges missing layer [%s] — taps %s"
                      % (name, sorted(act_ranges)))
            amax = torch.as_tensor(act_ranges[name], dtype=torch.float32,
                                   device=w.device)
            e["xs"] = amax / 127.0 + 1e-12
        return e

    for name in ("conv2", "conv3", "conv4", "conv5"):
        if name in out:
            out[name] = entry(name, CONV_WEIGHT_AXES)
    for name in ("fc6", "fc7", "fc8"):
        if name in out:
            out[name] = entry(name, FC_WEIGHT_AXES)
    return out


def output_dim(final_layer, num_classes):
    if final_layer in ("fc6", "fc7"):
        return _FC_DIM
    return num_classes


def conv_output_flat_dim(input_shape):
    """Flattened conv-stack output dim for an (H, W, C) input: sizes fc6
    for non-227 inputs."""
    h, w = int(input_shape[0]), int(input_shape[1])

    def same(s, k, st):
        return math.ceil(s / st)

    def valid(s, k, st):
        return (s - k) // st + 1

    h, w = same(h, 11, 4), same(w, 11, 4)       # conv1 SAME s4
    h, w = valid(h, 3, 2), valid(w, 3, 2)       # pool1
    h, w = valid(h, 3, 2), valid(w, 3, 2)       # pool2 (convs SAME s1)
    h, w = valid(h, 3, 2), valid(w, 3, 2)       # pool5
    if h <= 0 or w <= 0:
        error("AlexNet input %s too small for the conv stack"
              % (input_shape,))
    return h * w * 256
