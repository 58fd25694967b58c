"""Shared functional layers: parameter init and apply for FC, conv, pool
and LRN.

Counterpart of ``video_learning_tpu/models/layers.py:19-91,156-180``.
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
"""

import numpy as np
import torch
import torch.nn.functional as F

from video_learning_tpu_torch.ops.lrn import LRNFunction
from video_learning_tpu_torch.utils import error


def truncated_normal(generator, shape, stddev=0.05, mean=0.0, device="cpu"):
    """TF-style truncated normal: values beyond 2 std are re-drawn.  Drawn
    from a CPU ``torch.Generator`` so that one seed gives the same values
    on every device."""
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
    ``preferred_element_type=float32``), the bias added in float32."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y + b.to(torch.float32)


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
    """NHWC max pool with TF ``VALID`` padding (the only one AlexNet
    uses)."""
    if padding != "VALID":
        error("max_pool: only VALID padding is ported, got %r" % (padding,))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(strides))
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


# ----------------------------------------------------------------- dropout
def dropout(generator, x, keep_prob):
    """TF-style dropout: kept units scaled by 1/keep_prob."""
    if keep_prob is None or keep_prob <= 0 or keep_prob >= 1:
        return x
    if generator is None:
        error("dropout requires a generator in training mode")
    keep = torch.rand(x.shape, generator=generator).to(x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


# ------------------------------------------------------------------- misc
def flat_dim(shape):
    return int(np.prod([int(s) for s in shape]))
