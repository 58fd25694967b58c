"""Local response normalization: the CUDA kernels' wrappers, their plain
versions and the autograd Function that joins them.

``lrn`` runs ``csrc/lrn.cu`` (the port of
``video_learning_tpu/ops/pallas_kernels.lrn``) and ``lrn_backward`` runs
``csrc/lrn_bwd.cu`` (the port of ``pallas_kernels._lrn_vjp_bwd``) on CUDA
tensors, and the plain ``lrn_reference`` / ``lrn_backward_reference`` on
CPU tensors; on any other device, or a tensor a kernel does not take,
they raise.  ``lrn.launches`` and ``lrn_backward.launches`` count kernel
launches; ``lrn.variant_launches`` and ``lrn_backward.variant_launches``
count them by the design the kernel chose for the shape (``VARIANTS``).  A launch that
a CUDA graph capture records counts in ``.captured`` instead
(``graphs.py``).

A kernel's output has no ``grad_fn``, so a differentiable caller goes
through ``LRNFunction``, whose forward is ``lrn`` and whose backward is
``lrn_backward``; ``lrn`` raises rather than hand back a detached result
for a CUDA tensor that requires a gradient while grad mode is on.
"""

import ctypes

import torch
import torch.nn.functional as F

from video_learning_tpu_torch import graphs
from video_learning_tpu_torch.ops import _build
from video_learning_tpu_torch.utils import error

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the LRN kernels' designs, by the index vlt_lrn_fwd and vlt_lrn_bwd
# report: "vector" (16-byte chunks per lane, windows in registers,
# csrc/lrn_vec.cuh) where C is a multiple of 16 bytes, the radius at most
# half of that and the pointers 16-byte aligned; "staged" (a warp per row,
# staged in shared memory) otherwise
VARIANTS = ("staged", "vector")


def _window_sum(v, radius):
    """Sum over the channel window |k - c| <= radius, zero beyond the
    edges, in v's dtype (float32 here)."""
    c = v.shape[-1]
    v = F.pad(v, (radius, radius))
    acc = v[..., 0:c]
    for i in range(1, 2 * radius + 1):
        acc = acc + v[..., i:i + c]
    return acc


def _pow_neg_beta(d, beta):
    """d ** -beta; for beta 0.75 as rsqrt(d) * sqrt(rsqrt(d)), as the
    kernels and the JAX ``pallas_kernels._pow_neg_beta`` compute it."""
    if beta == 0.75:
        r = torch.rsqrt(d)
        return r * torch.sqrt(r)
    return torch.pow(d, -beta)


def lrn_reference(x, depth_radius=2, bias=1.0, alpha=2e-5, beta=0.75):
    """Plain sliding-window LRN over the trailing channel axis: the
    arithmetic of ``video_learning_tpu/models/layers._lrn_slide``
    (square in the input dtype, window sum and power in float32, power
    rounded to the input dtype before the product)."""
    acc = _window_sum(x.square().to(torch.float32), depth_radius)
    return x * torch.pow(bias + alpha * acc, -beta).to(x.dtype)


def lrn_backward_reference(x, g, depth_radius=2, bias=1.0, alpha=2e-5,
                           beta=0.75):
    """Plain LRN input gradient, the formula of ``_lrn_bwd_kernel`` with
    a sliding window: d and p recomputed from x, then
    ``dx = g*p - 2*alpha*beta * x * window_sum(g*x*p/d)``; the square in
    x's dtype, sums and powers in float32, the inner product rounded to
    x's dtype before its window sum, dx returned in x's dtype."""
    d = bias + alpha * _window_sum(x.square().to(torch.float32),
                                   depth_radius)
    p = _pow_neg_beta(d, beta)
    gf = g.to(torch.float32)
    xf = x.to(torch.float32)
    inner = (gf * xf * (p / d)).to(x.dtype).to(torch.float32)
    s = _window_sum(inner, depth_radius)
    return (gf * p - (2.0 * alpha * beta) * xf * s).to(x.dtype)


def _check(name, x):
    if x.device.type != "cuda":
        error("%s: no kernel for device %s" % (name, x.device))
    if x.dtype not in _DTYPES:
        error("%s: dtype %s not supported (float32, bfloat16)"
              % (name, x.dtype))
    if x.dim() < 1 or not x.is_contiguous():
        error("%s: expects a contiguous tensor with channels last, got "
              "shape %s strides %s" % (name, tuple(x.shape), x.stride()))


def lrn(x, depth_radius=2, bias=1.0, alpha=2e-5, beta=0.75):
    """LRN over the trailing channel axis of a contiguous channels-last
    (N, H, W, C) tensor in float32 or bfloat16.  On the card takes any C
    that is a multiple of 16 bytes at a radius up to half of that (the
    vector design), and other C up to 766 at radius 2 (the staged
    design).  No gradient: see ``LRNFunction``."""
    if x.device.type == "cpu":
        return lrn_reference(x, depth_radius, bias, alpha, beta)
    _check("lrn", x)
    if x.requires_grad and torch.is_grad_enabled():
        error("lrn: the kernel's output has no gradient; call "
              "LRNFunction.apply for a tensor that requires one")
    channels = x.shape[-1]
    y = torch.empty_like(x)
    variant = ctypes.c_int(-1)
    rc = _build.library().vlt_lrn_fwd(
        x.data_ptr(), y.data_ptr(), x.numel() // max(channels, 1), channels,
        _DTYPES[x.dtype], int(depth_radius), float(bias), float(alpha),
        float(beta), ctypes.byref(variant),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "lrn")
    if variant.value >= 0:          # -1: nothing to compute, no launch
        if torch.cuda.is_current_stream_capturing():
            lrn.captured += 1         # runs at the graph's replays
        else:
            lrn.launches += 1
            lrn.variant_launches[VARIANTS[variant.value]] += 1
    return y


graphs.register_wrapper(lrn)
lrn.variant_launches = dict.fromkeys(VARIANTS, 0)


def lrn_backward(x, g, depth_radius=2, bias=1.0, alpha=2e-5, beta=0.75):
    """dL/dx of ``lrn`` at x for the output gradient g: both contiguous
    channels-last tensors of one shape and dtype (float32 or bfloat16).
    On the card takes any C that is a multiple of 16 bytes at a radius up
    to half of that (the vector design), and other C up to 305 at radius 2
    (the staged design)."""
    if x.device.type == "cpu" and g.device.type == "cpu":
        return lrn_backward_reference(x, g, depth_radius, bias, alpha, beta)
    _check("lrn_backward", x)
    _check("lrn_backward", g)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        error("lrn_backward: g must match x, got %s %s %s for %s %s %s"
              % (tuple(g.shape), g.dtype, g.device, tuple(x.shape), x.dtype,
                 x.device))
    channels = x.shape[-1]
    dx = torch.empty_like(x)
    variant = ctypes.c_int(-1)
    rc = _build.library().vlt_lrn_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(),
        x.numel() // max(channels, 1), channels, _DTYPES[x.dtype],
        int(depth_radius), float(bias), float(alpha), float(beta),
        float(2.0 * alpha * beta), ctypes.byref(variant),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "lrn_backward")
    if variant.value >= 0:          # -1: nothing to compute, no launch
        if torch.cuda.is_current_stream_capturing():
            lrn_backward.captured += 1      # runs at the graph's replays
        else:
            lrn_backward.launches += 1
            lrn_backward.variant_launches[VARIANTS[variant.value]] += 1
    return dx


graphs.register_wrapper(lrn_backward)
lrn_backward.variant_launches = dict.fromkeys(VARIANTS, 0)


class LRNFunction(torch.autograd.Function):
    """LRN with its gradient: ``lrn`` forward, ``lrn_backward`` backward
    (the kernels on the card, the plain versions on the CPU).  Saves x
    only; the backward recomputes the denominator, as
    ``pallas_kernels._lrn_vjp_bwd`` does."""

    @staticmethod
    def forward(ctx, x, depth_radius=2, bias=1.0, alpha=2e-5, beta=0.75):
        ctx.save_for_backward(x)
        ctx.lrn_args = (depth_radius, bias, alpha, beta)
        return lrn(x, depth_radius, bias, alpha, beta)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        dx = lrn_backward(x, g.contiguous(), *ctx.lrn_args)
        return dx, None, None, None, None
