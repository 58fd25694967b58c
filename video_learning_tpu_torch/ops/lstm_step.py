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

``plan`` is the kernel's division of one step over the card (row groups,
j tiles, k slices and the clusters that sum them; ``csrc/lstm_step.cu``
says why); the wrapper passes it to the kernel.  ``lstm_step_3xtf32``
emulates the kernel's arithmetic in plain torch (TF32 splits, three
products, k in the plan's order) for the tests; nothing on the main path
calls it.
"""

import collections

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


# rows a CTA at most (two warpgroups of 64), and CTAs a cluster that the
# plan takes (the kernel takes up to 8)
MAX_ROWS = 128
MAX_SPLIT = 4

Plan = collections.namedtuple(
    "Plan", "rows wj k_cta split groups tiles threads")
Plan.__doc__ = """One step's division over the card: ``groups`` row
groups of ``rows`` rows (64 a warpgroup), ``tiles`` tiles of 8 * ``wj`` j
of each gate, and ``split`` slices of ``k_cta`` k, the CTAs of one
cluster.  The grid is (split, tiles, groups), each CTA ``threads``
threads."""


def _ceil(a, b):
    return -(-a // b)


def plan(batch, hidden, resident=None):
    """The kernel's plan for (B, H).  Every row group of up to 128 rows
    (all B rows where B <= 128, 64 rows where B <= 64) reads each Wh
    element once; the j tiles are 8 wide for 64-row groups and 16 for
    128-row groups; k is split over up to 4 CTAs a cluster, fewer where
    the grid's clusters would not all be resident at once.
    ``resident(plan)``: how many clusters of the plan the card holds at
    once (``None``: as many as it has)."""
    groups = _ceil(batch, MAX_ROWS)
    rows = 64 if _ceil(batch, groups) <= 64 else 128
    wj = 1 if rows == 64 else 2
    tiles = _ceil(hidden, 8 * wj)
    k_steps = _ceil(hidden, 8)
    for split in range(min(MAX_SPLIT, k_steps), 0, -1):
        k_cta = 8 * _ceil(k_steps, split)
        p = Plan(rows, wj, k_cta, _ceil(hidden, k_cta), groups, tiles,
                 2 * rows + 32)
        if split == 1 or resident is None or \
                resident(p) >= tiles * groups:
            return p


def plan_blocks(p, batch, hidden):
    """Yield, for every CTA of plan ``p``: its rank in its cluster; the
    [start, stop) of the rows, of the j (of each of the four gates) and
    of the k whose products it computes; and of the rows (at the same j)
    whose partial sums it gathers from the cluster and whose cell update
    it runs.  All clipped to (B, H)."""
    jt = 8 * p.wj
    share = _ceil(p.rows, p.split)
    for group in range(p.groups):
        r0 = group * p.rows
        for tile in range(p.tiles):
            j0 = tile * jt
            for rank in range(p.split):
                k0 = rank * p.k_cta
                u0 = r0 + min(p.rows, rank * share)
                u1 = r0 + min(p.rows, (rank + 1) * share)
                yield {"rank": rank,
                       "rows": (r0, min(batch, r0 + p.rows)),
                       "j": (j0, min(hidden, j0 + jt)),
                       "k": (k0, min(hidden, k0 + p.k_cta)),
                       "update_rows": (min(batch, u0), min(batch, u1))}


def _tf32(x, rounded=True):
    """x cut to TF32 (10 mantissa bits): rounded to nearest with ties away
    from zero (the kernel's hi, as ``cvt.rna.tf32.f32`` rounds), or
    truncated (what the tensor core reads of a float32 operand: the
    kernel's lo)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000 if rounded else bits) & -0x2000).view(
        torch.float32)


def lstm_step_3xtf32(xproj, h, c, wh, b, passes=3):
    """The kernel's arithmetic in plain torch, for the tests (float32, CPU):
    h and Wh split as hi + lo in TF32 (hi rounded, lo = x - hi truncated);
    in each k slice of ``plan`` and each 8 k of it in order, the
    accumulator adds lo*hi, hi*lo, then hi*hi (a product of two TF32
    values is exact in float32); the slices' partials summed in rank
    order; then the cell update of ``lstm_step_reference``.  ``passes=1``
    keeps only hi*hi, one TF32 pass.  Returns (new_h, new_c)."""
    batch, hidden = h.shape
    p = plan(batch, hidden)
    h_hi, wh_hi = _tf32(h), _tf32(wh)
    h_lo, wh_lo = _tf32(h - h_hi, False), _tf32(wh - wh_hi, False)
    dot = torch.zeros_like(xproj)
    for rank in range(p.split):
        acc = torch.zeros_like(xproj)
        for k in range(rank * p.k_cta, min(hidden, (rank + 1) * p.k_cta), 8):
            s = slice(k, min(hidden, k + 8))
            if passes == 3:
                acc = acc + h_lo[:, s] @ wh_hi[s]
                acc = acc + h_hi[:, s] @ wh_lo[s]
            acc = acc + h_hi[:, s] @ wh_hi[s]
        dot = dot + acc
    gates = (xproj + dot) + b
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, new_c


_plans = {}


def card_plan(batch, hidden, device):
    """``plan`` for the card: with the clusters of each candidate that
    can be resident at once, asked once per shape and device."""
    key = (batch, hidden, device)
    if key not in _plans:
        lib = _build.library()

        def resident(p):
            n = lib.vlt_lstm_step_max_clusters(hidden, p.rows, p.wj, p.k_cta,
                                               p.split)
            if n < 0:
                _build.check(-n, "lstm_step occupancy")
            return n

        with torch.cuda.device(device):
            _plans[key] = plan(batch, hidden, resident)
    return _plans[key]


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
    p = card_plan(batch, hidden, xproj.device)
    new_h = torch.empty_like(h)
    new_c = torch.empty_like(c)
    rc = _build.library().vlt_lstm_step(
        xproj.data_ptr(), h.data_ptr(), c.data_ptr(), wh.data_ptr(),
        b.data_ptr(), new_h.data_ptr(), new_c.data_ptr(), batch, hidden,
        p.rows, p.wj, p.k_cta, p.split,
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
