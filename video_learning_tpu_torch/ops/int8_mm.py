"""int8 x int8 -> int32 matrix product for the w8a8 serving forward.

The JAX package computes its int8 convolutions and dense layers with
``lax.conv_general_dilated`` / ``lax.dot_general`` and
``preferred_element_type=int32`` (``video_learning_tpu/models/layers.py``
``conv_apply_int8`` / ``fc_apply_int8``): XLA ops, no Pallas kernel.  The
port's counterpart is one library call, ``torch._int_mm``, cuBLASLt's
int8 tensor-core GEMM; the int8 convolution is an im2col in int8 followed
by this product (``models/layers.conv_apply_int8``).

``int8_mm`` launches ``torch._int_mm`` on CUDA tensors and counts the
launches on ``int8_mm.launches`` (those a CUDA graph capture records on
``int8_mm.captured``, ``graphs.py``); on CPU tensors it computes the plain
``int8_mm_reference``.  On a CUDA tensor it launches the int8 GEMM or
raises: nothing falls back to a float product or to the CPU.

``torch._int_mm`` refuses on CUDA what cuBLASLt's int8 GEMM does not
take: an A of 16 rows or fewer, and a K or N that is not a multiple of 8;
and cuBLASLt itself refused a 17-row A (CUBLAS_STATUS_NOT_SUPPORTED at
(17, 64) x (64, 64) on an H100, torch 2.11).  The serving path meets
these (the fc6 input of one 16-frame clip has 16 rows, a one-item caption
encode 1 row, a 101-class head N = 101, conv2 of one frame 729 rows), so
the wrapper pads every dimension to a multiple of 8 and the rows to at
least ``_MIN_ROWS``, with zeros, and slices the result: zero rows and
columns add nothing to the int32 sums.
"""

import torch

from video_learning_tpu_torch import graphs
from video_learning_tpu_torch.utils import error

_MIN_ROWS = 32          # torch._int_mm on CUDA: A needs more than 16 rows
_ALIGN = 8              # ... and K and N multiples of 8 (M too, here)


def int8_mm_reference(a, b):
    """The exact int32 product of two int8 matrices.  Every partial sum
    of int8 products is an integer below 2^53 in magnitude (|a b| <=
    127^2 per term), so the float64 product is exact and its cast to
    int32 is the integer product wherever that fits int32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def _round_up(n, m):
    return -(-n // m) * m


def _padded(t, rows, cols):
    if tuple(t.shape) == (rows, cols):
        return t
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def int8_mm(a, b):
    """a: (M, K) int8, b: (K, N) int8, both contiguous.  Returns the
    (M, N) int32 product."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            a.dtype != torch.int8 or b.dtype != torch.int8:
        error("int8_mm: needs int8 (M, K) and (K, N) matrices, got %s %s "
              "and %s %s" % (a.dtype, tuple(a.shape), b.dtype,
                             tuple(b.shape)))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return int8_mm_reference(a, b)
    if a.device.type != "cuda" or a.device != b.device:
        error("int8_mm: both operands must be on one CUDA device, got %s "
              "and %s" % (a.device, b.device))
    if not (a.is_contiguous() and b.is_contiguous()):
        error("int8_mm: operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _round_up(max(m, _MIN_ROWS), _ALIGN), \
        _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    out = torch._int_mm(_padded(a, mp, kp), _padded(b, kp, np_))
    if torch.cuda.is_current_stream_capturing():
        int8_mm.captured += 1         # runs at the graph's replays
    else:
        int8_mm.launches += 1
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out


graphs.register_wrapper(int8_mm)
