"""One fused LSTM cell step: the CUDA kernel's wrapper and its plain
version.

``lstm_step`` runs ``csrc/lstm_step.cu`` (the port of
``video_learning_tpu/ops/pallas_kernels.lstm_step``) on CUDA tensors and
the plain ``lstm_step_reference`` on CPU tensors; on any other device,
or tensors the kernel does not take, it raises.  ``lstm_step.launches``
counts kernel launches (``.captured`` those a CUDA graph capture
records, ``graphs.py``).

The kernel's outputs have no ``grad_fn``, so a differentiable caller goes
through ``LSTMStepFunction``; ``lstm_step`` raises rather than hand back
detached results for CUDA operands that require a gradient while grad
mode is on.
"""

import torch

from video_learning_tpu_torch import graphs
from video_learning_tpu_torch.ops import _build
from video_learning_tpu_torch.utils import error


def lstm_step_reference(xproj, h, c, wh, b):
    """Plain BasicLSTMCell step given the precomputed input projection:
    the math of ``video_learning_tpu/models/lstm._cell_step`` (gate
    order i, j, f, o; forget bias +1).  Returns (new_h, new_c)."""
    gates = xproj + torch.matmul(h, wh) + b
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, new_c


def lstm_step(xproj, h, c, wh, b):
    """xproj: (B, 4H), h and c: (B, H), wh: (H, 4H), b: (4H,), all
    float32.  Returns (new_h, new_c) in new buffers."""
    args = (xproj, h, c, wh, b)
    if all(t.device.type == "cpu" for t in args):
        return lstm_step_reference(*args)
    if any(t.device.type != "cuda" or t.device != xproj.device
           for t in args):
        error("lstm_step: all operands must be on one CUDA device, got %s"
              % [str(t.device) for t in args])
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        error("lstm_step: the kernel's outputs have no gradient; call "
              "LSTMStepFunction.apply for operands that require one")
    batch, hidden = h.shape if h.dim() == 2 else (-1, -1)
    want = {"xproj": (batch, 4 * hidden), "h": (batch, hidden),
            "c": (batch, hidden), "wh": (hidden, 4 * hidden),
            "b": (4 * hidden,)}
    for name, t in zip(want, args):
        if tuple(t.shape) != want[name] or t.dtype != torch.float32 or \
                not t.is_contiguous():
            error("lstm_step: %s must be a contiguous float32 %s, got %s %s"
                  % (name, want[name], t.dtype, tuple(t.shape)))
    new_h = torch.empty_like(h)
    new_c = torch.empty_like(c)
    rc = _build.library().vlt_lstm_step(
        xproj.data_ptr(), h.data_ptr(), c.data_ptr(), wh.data_ptr(),
        b.data_ptr(), new_h.data_ptr(), new_c.data_ptr(), batch, hidden,
        torch.cuda.current_stream(xproj.device).cuda_stream)
    _build.check(rc, "lstm_step")
    if torch.cuda.is_current_stream_capturing():
        lstm_step.captured += 1         # runs at the graph's replays
    else:
        lstm_step.launches += 1
    return new_h, new_c


graphs.register_wrapper(lstm_step)


class LSTMStepFunction(torch.autograd.Function):
    """One cell step with its gradient: the forward is ``lstm_step`` (the
    kernel on the card, the plain version on the CPU).  The JAX package
    has no backward kernel for this step (its Pallas ``lstm_step`` has no
    VJP, and its model differentiates the scan body through XLA), so the
    backward is plain torch: it recomputes
    ``gates = xproj + h @ Wh + b`` from the saved inputs and returns the
    gradients for xproj, h, c, Wh and b."""

    @staticmethod
    def forward(ctx, xproj, h, c, wh, b):
        ctx.save_for_backward(xproj, h, c, wh, b)
        return lstm_step(xproj, h, c, wh, b)

    @staticmethod
    def backward(ctx, d_h, d_c):
        xproj, h, c, wh, b = ctx.saved_tensors
        gates = xproj + torch.matmul(h, wh) + b
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        si, tj = torch.sigmoid(i), torch.tanh(j)
        sf, so = torch.sigmoid(f + 1.0), torch.sigmoid(o)
        tc = torch.tanh(c * sf + si * tj)
        d_new_c = d_c + d_h * so * (1.0 - tc * tc)
        d_gates = torch.cat([d_new_c * tj * si * (1.0 - si),
                             d_new_c * si * (1.0 - tj * tj),
                             d_new_c * c * sf * (1.0 - sf),
                             d_h * tc * so * (1.0 - so)], dim=-1)
        return (d_gates, torch.matmul(d_gates, wh.t()), d_new_c * sf,
                torch.matmul(h.t(), d_gates), d_gates.sum(0))
