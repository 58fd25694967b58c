"""Shared functional layers: parameter init and apply for FC, conv, pool
and LRN.

Counterpart of ``video_learning_tpu/models/layers.py:19-91,156-266``.
Activations keep the JAX package's NHWC layout at every public function.
A contiguous NHWC tensor viewed as NCHW (``permute(0, 3, 1, 2)``) is
exactly torch's ``channels_last`` format, so the convolutions and pools
run in NCHW on channels_last memory with no copy either way, and each
pixel's C channels stay contiguous for the LRN kernel.  Conv weights are
OIHW (channels_last) inside the port and HWIO in checkpoints
(``checkpoint.from_jax_flat`` / ``to_jax_flat``).

Precision follows the JAX package: ``fc_apply`` multiplies in the compute
dtype with a float32 result and adds the bias in float32;
``conv_apply`` computes and adds the bias in the compute dtype.

The w8a8 serving layers (``quantize_sym``, ``quantize_static``,
``conv_apply_int8``, ``fc_apply_int8``) keep the JAX numerics: x / scale
in float32, rounded half to even, clamped to +-127; scale = amax / 127 +
1e-12 in float32; the int32 product (``ops/int8_mm.py``); the epilogue
acc * (xs * ws) + b in float32.

On a mesh (``Model.apply(mesh=...)``) an FC entry that carries a
``parallel.sharding.TensorParallel`` under "tp" holds its column slice:
it multiplies the input (identity forward, gradient summed over the
model group) by its slice and gathers the output features, and the int8
layers take the MAX of their dynamic activation amax over the data
group, the amax of the global batch.  Without a mesh nothing changes.
"""

import numpy as np
import torch
import torch.nn.functional as F

from video_learning_tpu_torch.ops.int8_mm import int8_mm
from video_learning_tpu_torch.ops.lrn import LRNFunction
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.utils import error


def truncated_normal(generator, shape, stddev=0.05, mean=0.0, device="cpu"):
    """TF-style truncated normal: values beyond 2 std are re-drawn.  Drawn
    from a CPU ``torch.Generator`` so that one seed gives the same values
    on every device.  On the meta device it draws nothing (the shapes of
    a tree, ``Model.param_shapes``)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), device="meta")
    z = torch.randn(tuple(shape), generator=generator)
    bad = z.abs() > 2.0
    while bool(bad.any()):
        z[bad] = torch.randn(int(bad.sum()), generator=generator)
        bad = z.abs() > 2.0
    return (mean + stddev * z).to(device)


# ------------------------------------------------------------------- dense
def fc_init(generator, in_dim, out_dim, w_stddev=0.05, bias=0.1,
            device="cpu"):
    """FC params {"w": (in, out), "b": (out,)}."""
    return {"w": truncated_normal(generator, (in_dim, out_dim), w_stddev,
                                  device=device),
            "b": torch.full((out_dim,), bias, dtype=torch.float32,
                            device=device)}


def fc_apply(params, x, compute_dtype=None):
    """x @ w + b: operands rounded to the compute dtype, the product
    accumulated and returned in float32 (the JAX
    ``preferred_element_type=float32``), the bias added in float32.  A
    column-split entry (module docstring) returns the whole output on
    every rank of its model group."""
    w, b = params["w"], params["b"]
    tp = params.get("tp")
    if tp is not None:
        x = tp.enter(x)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if tp is None:
        return y + b.to(torch.float32)
    if tp.bias_split:
        return tp.gather(y + b.to(torch.float32))
    return tp.gather(y) + b.to(torch.float32)


def convert_dim_fc_init(generator, in_dim, out_dim, device="cpu"):
    """A dim-converting FC only when the dims differ."""
    if in_dim == out_dim:
        return None
    return fc_init(generator, in_dim, out_dim, device=device)


def convert_dim_fc_apply(params, x, compute_dtype=None):
    if params is None:
        return x
    return fc_apply(params, x, compute_dtype)


# -------------------------------------------------------------------- conv
def conv_init(generator, kernel_params, init_w=(0.0, 0.1), bias=0.0,
              device="cpu"):
    """Conv params for an HWIO ``kernel_params`` (kh, kw, in, out); the
    weight is drawn in HWIO order and stored OIHW channels_last."""
    w = truncated_normal(generator, tuple(kernel_params), init_w[1],
                         init_w[0], device=device)
    return {"w": hwio_to_oihw(w),
            "b": torch.full((kernel_params[-1],), bias, dtype=torch.float32,
                            device=device)}


def hwio_to_oihw(w):
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def oihw_to_hwio(w):
    return w.permute(2, 3, 1, 0).contiguous()


def same_pads(size, kernel, stride):
    """TF ``SAME`` padding (low, high) of one spatial dim: the extra row
    of an odd total goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_apply(params, x, strides, padding, groups=1, relu=True,
               compute_dtype=None):
    """NHWC conv (AlexNet's group=2 split via ``groups``) with TF
    ``SAME`` / ``VALID`` padding.  Returns NHWC."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    x = x.permute(0, 3, 1, 2)                    # channels_last NCHW view
    pad = 0
    if padding == "SAME":
        (top, bottom), (left, right) = (
            same_pads(x.shape[2], w.shape[2], strides[0]),
            same_pads(x.shape[3], w.shape[3], strides[1]))
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
    elif padding != "VALID":
        error("conv padding must be SAME or VALID, got %r" % (padding,))
    y = F.conv2d(x, w, None, tuple(strides), pad, 1, groups)
    y = y + b.to(y.dtype)[:, None, None]
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def max_pool(x, window, strides, padding):
    """NHWC max pool with TF ``VALID`` padding (AlexNet's) or ``SAME``
    padding (audionet's: -inf on the high side first, as JAX's
    ``reduce_window`` pads)."""
    y = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (top, bottom), (left, right) = (
            same_pads(y.shape[2], window[0], strides[0]),
            same_pads(y.shape[3], window[1], strides[1]))
        y = F.pad(y, (left, right, top, bottom), value=float("-inf"))
    elif padding != "VALID":
        error("max_pool padding must be SAME or VALID, got %r"
              % (padding,))
    y = F.max_pool2d(y, tuple(window), tuple(strides))
    return y.permute(0, 2, 3, 1)


# --------------------------------------------------------------------- LRN
def local_response_normalization(x, depth_radius=2, bias=1.0, alpha=2e-5,
                                 beta=0.75):
    """AlexNet LRN over the channels of an NHWC tensor:
    out = x / (bias + alpha * sum_{d-r..d+r} x_d^2) ** beta.  The CUDA
    kernels on the GPU, their plain versions on the CPU, forward and
    backward (ops/lrn.py ``LRNFunction``)."""
    return LRNFunction.apply(x.contiguous(), depth_radius, bias, alpha,
                             beta)


# ------------------------------------------------------- int8 (serving PTQ)
def quantize_sym(x, axes):
    """Symmetric int8 quantization: q = clamp(round(x / s), -127, 127)
    with s = amax(|x|) / 127 + 1e-12 reduced over ``axes`` (None: the
    whole tensor), in float32.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  Returns (q int8, scale float32 broadcastable
    against x: a 0-d tensor for ``axes=None``, else kept dims)."""
    if axes is None:
        a = x.abs().amax().to(torch.float32)
    else:
        a = x.abs().amax(dim=axes, keepdim=True).to(torch.float32)
    scale = a / 127.0 + 1e-12
    return quantize_static(x, scale)


def quantize_static(x, scale):
    """int8 quantization against a given (calibrated) scale: purely
    elementwise; activations beyond the calibrated range saturate at
    +-127.  x is taken to float32 before the division (a 0-d float32
    scale would not promote a bf16 x)."""
    q = torch.round(x.to(torch.float32) / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _int8_weight(params, axes):
    """(wq, ws) of a raw {"w", "b"} entry (quantized here) or a
    pre-quantized {"wq", "ws", "b"} one."""
    if "wq" in params:
        return params["wq"], params["ws"]
    return quantize_sym(params["w"], axes=axes)


def _int8_input(params, x):
    """(xq, xs): against the calibrated static scale ``xs`` when the
    entry has one, else the dynamic per-tensor amax of this batch (on a
    mesh, of the global batch: the MAX over the data group)."""
    if "xs" in params:
        return quantize_static(x, params["xs"])
    if mesh_mod.current() is None:
        return quantize_sym(x, axes=None)
    a = mesh_mod.data_max(x.abs().amax().to(torch.float32))
    return quantize_static(x, a / 127.0 + 1e-12)


def _dequantize(acc, xs, ws, b):
    """acc * (xs * ws) + b in float32, as the JAX epilogue computes it
    (on a fresh float32 copy of the int32 sums, in place)."""
    return acc.to(torch.float32).mul_(xs * ws).add_(b.to(torch.float32))


# conv weights are OIHW in the port: the per-output-channel weight scale
# reduces over (I, H, W), the JAX HWIO entry's axes (0, 1, 2)
CONV_WEIGHT_AXES = (1, 2, 3)
FC_WEIGHT_AXES = (0,)


def im2col_int8(xq, kh, kw, strides, pads, channels):
    """(N*Ho*Wo, kh*kw*Cg) int8 patch rows of an NHWC int8 tensor, with
    the input zero-padded by ``pads`` ((top, bottom), (left, right)); the
    int8 zero is the quantized zero, as in XLA's padded int8 conv.  Each
    row is ordered (kh, kw, c) over the channel slice ``channels`` (a
    (start, stop) pair), the flattening of an HWIO weight's first three
    axes."""
    (top, bottom), (left, right) = pads
    n, h, w, c = xq.shape
    if top or bottom or left or right:
        xp = xq.new_zeros((n, h + top + bottom, w + left + right, c))
        xp[:, top:top + h, left:left + w] = xq
    else:
        xp = xq.contiguous()
    hp, wp = xp.shape[1:3]
    ho = (hp - kh) // strides[0] + 1
    wo = (wp - kw) // strides[1] + 1
    c0, c1 = channels
    sn, sh, sw, _ = xp.stride()
    win = xp.as_strided((n, ho, wo, kh, kw, c1 - c0),
                        (sn, sh * strides[0], sw * strides[1], sh, sw, 1),
                        xp.storage_offset() + c0)
    return win.reshape(n * ho * wo, kh * kw * (c1 - c0)), (n, ho, wo)


def int8_weight_matrix(wq, groups, g):
    """The (kh*kw*Cin_g, Cout_g) int8 matrix of group ``g`` of an OIHW
    int8 conv weight, its rows in ``im2col_int8``'s (kh, kw, c) order."""
    cout_g = wq.shape[0] // groups
    return wq[g * cout_g:(g + 1) * cout_g].permute(0, 2, 3, 1).reshape(
        cout_g, -1).t().contiguous()


def conv_apply_int8(params, x, strides, padding, groups=1, relu=True,
                    out_dtype=torch.bfloat16):
    """w8a8 post-training-quantized NHWC conv for the forward-only
    serving path (``layers.conv_apply_int8`` of the JAX package):
    per-output-channel symmetric weight scales, a per-tensor activation
    scale (dynamic, or the calibrated ``xs``), the int32 product of an
    int8 im2col with the weight matrix of each group (``ops/int8_mm``),
    and the epilogue acc * (xs * ws) + b in float32, relu, cast to
    ``out_dtype``.  ``params`` is a raw {"w", "b"} entry (OIHW w) or a
    pre-quantized {"wq", "ws", "b"[, "xs"]} one from
    ``alexnet.quantize_params`` (wq OIHW int8, ws (Cout, 1, 1, 1))."""
    wq, ws = _int8_weight(params, CONV_WEIGHT_AXES)
    xq, xs = _int8_input(params, x)
    cout, cin_g, kh, kw = wq.shape
    if padding == "SAME":
        pads = (same_pads(x.shape[1], kh, strides[0]),
                same_pads(x.shape[2], kw, strides[1]))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        error("conv padding must be SAME or VALID, got %r" % (padding,))
    cout_g = cout // groups
    ws = ws.reshape(cout)
    out = None
    for g in range(groups):
        o0, o1 = g * cout_g, (g + 1) * cout_g
        cols, (n, ho, wo) = im2col_int8(xq, kh, kw, strides, pads,
                                        (g * cin_g, (g + 1) * cin_g))
        y = _dequantize(int8_mm(cols, int8_weight_matrix(wq, groups, g)),
                        xs, ws[o0:o1], params["b"][o0:o1])
        del cols
        if relu:
            y = torch.relu_(y)
        if out is None:
            out = torch.empty((n * ho * wo, cout), dtype=out_dtype,
                              device=x.device)
        out[:, o0:o1] = y
    return out.reshape(n, ho, wo, cout)


def fc_apply_int8(params, x):
    """w8a8 dense layer (``layers.fc_apply_int8`` of the JAX package):
    per-output-column weight scales ws (1, out), a per-tensor activation
    scale, the int32 product and a float32 result with the float32
    bias.  Takes raw or pre-quantized entries like ``conv_apply_int8``."""
    wq, ws = _int8_weight(params, FC_WEIGHT_AXES)
    xq, xs = _int8_input(params, x)
    tp = params.get("tp")
    if tp is None:
        return _dequantize(int8_mm(xq.contiguous(), wq.contiguous()), xs,
                           ws, params["b"])
    # a column slice: its per-column weight scales are the whole
    # kernel's, sliced
    return tp.gather(_dequantize(int8_mm(xq.contiguous(), wq.contiguous()),
                                 xs, ws, tp.local_bias(params["b"])))


# ----------------------------------------------------------------- dropout
def dropout(generator, x, keep_prob):
    """TF-style dropout: kept units scaled by 1/keep_prob.  The mask is
    drawn on x's device from ``generator``, which must live there (on the
    card a CUDA generator, drawn inside the step as JAX draws it)."""
    if keep_prob is None or keep_prob <= 0 or keep_prob >= 1:
        return x
    if generator is None:
        error("dropout requires a generator in training mode")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < \
        keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


# ------------------------------------------------------------------- misc
def flat_dim(shape):
    return int(np.prod([int(s) for s in shape]))
