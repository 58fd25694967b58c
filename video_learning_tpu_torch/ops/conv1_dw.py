"""Weight gradient of the AlexNet stem conv (11x11, stride 4, SAME,
3 -> 96 channels): the CUDA kernels' wrappers and their plain versions.

``conv1_dw`` and ``conv1_dw_shifted`` run the two entry points of
``csrc/conv1_dw.cu`` (the ports of
``video_learning_tpu/ops/pallas_kernels.conv1_dw`` and
``conv1_dw_shifted``) on CUDA tensors, and ``conv1_dw_reference`` /
``conv1_dw_shifted_reference`` on CPU tensors; on any other device, or
tensors a kernel does not take, they raise.  ``conv1_dw.launches`` and
``conv1_dw_shifted.launches`` count calls that launched the kernel (each
call launches the contraction and the fixed-order reduction of its
per-block partials; ``.captured`` counts the calls a CUDA graph capture
records, ``graphs.py``).

Both compute the gradient in the space-to-depth domain, where the conv
has stride 1 and 3x3 taps over 48 = 4x4x3 channels: nine
(48, K) x (K, 96) contractions into a (432, 96) float32 result, mapped
back to (11, 11, 3, 96) by ``conv1_dw_s2d_to_hwio`` (torch code outside
the kernel, as it is outside the Pallas call in JAX); the bf16 kernel
computes only the 384 of those rows whose 8-channel chunks the (11, 11)
kernel needs, in its own channel order (``_bf16_rows``).  The kernels read
the raw frames and build the space-to-depth rows in shared memory from
the SAME geometry that ``conv1_raw_geometry`` computes here;
``conv1_s2d_geometry`` builds the same rows as a tensor, by gather, for
the plain versions.  The products run in x's dtype and accumulate in
float32; the result is float32.

``conv1_dw_im2col`` is the port of ``pallas_kernels.conv1_dw_xla``, a
formulation the JAX package runs outside Pallas: torch ops on any
device, no kernel of this repository and no launch count.
"""

import torch
import torch.nn.functional as F

from video_learning_tpu_torch import graphs
from video_learning_tpu_torch.ops import _build
from video_learning_tpu_torch.utils import error

TAPS = 3              # ceil(11 / 4) space-to-depth taps per axis
BLOCK = 4             # space-to-depth block = the conv's stride
KERNEL = 11
COUT = 96
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv1_raw_geometry(h, w, oh, ow):
    """(top, left): the SAME padding above and left of an (h, w) frame
    for the 11x11 stride-4 conv with an (oh, ow) output (the odd pixel of
    an odd total goes below and right).  Space-to-depth position (P, Q),
    channel (di*4 + dj)*C + c is pixel (4P + di - top, 4Q + dj - left, c),
    zero outside the frame."""
    pad_h = max((oh - 1) * BLOCK + KERNEL - h, 0)
    pad_w = max((ow - 1) * BLOCK + KERNEL - w, 0)
    return pad_h // 2, pad_w // 2


def conv1_s2d_geometry(x, oh, ow):
    """Space-to-depth rearrangement of stem-conv frames for the
    weight-gradient contractions: (N, H, W, C) -> (N, oh+2, ow+2, 16*C),
    gathered from the pixels ``conv1_raw_geometry`` assigns to each
    position (the rows the kernels build in shared memory)."""
    n, h, w, c = x.shape
    top, left = conv1_raw_geometry(h, w, oh, ow)
    sub = torch.arange(BLOCK, device=x.device)
    rows = torch.arange(oh + TAPS - 1, device=x.device)[:, None] * BLOCK \
        + sub - top                                   # (oh+2, 4): 4P + di
    cols = torch.arange(ow + TAPS - 1, device=x.device)[:, None] * BLOCK \
        + sub - left                                  # (ow+2, 4): 4Q + dj
    inside = (((rows >= 0) & (rows < h))[:, :, None, None] &
              ((cols >= 0) & (cols < w))[None, None])  # (oh+2, 4, ow+2, 4)
    xp = x[:, rows.clamp(0, h - 1)][:, :, :, cols.clamp(0, w - 1)]
    xp = torch.where(inside[..., None], xp, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
    return xp.permute(0, 1, 3, 2, 4, 5).reshape(n, oh + TAPS - 1,
                                                 ow + TAPS - 1,
                                                 BLOCK * BLOCK * c)


def conv1_dw_s2d_to_hwio(dw_s2d, c, cout):
    """Map the (9*16*C, cout) space-to-depth weight gradient back to
    (11, 11, C, cout): row (ky*3 + kx)*16C + (di*4 + dj)*C + c is kernel
    tap (ky*4 + di, kx*4 + dj); tap row and column 11 (the zero pad) are
    dropped."""
    dw = dw_s2d.reshape(TAPS, TAPS, BLOCK, BLOCK, c, cout)
    dw = dw.permute(0, 2, 1, 3, 4, 5).reshape(TAPS * BLOCK, TAPS * BLOCK, c,
                                              cout)
    return dw[:KERNEL, :KERNEL]


def _bf16_slot(di, dj, c):
    """Where the bf16 kernel keeps channel (di, dj, c) of a space-to-depth
    position (the bf16 slot order of csrc/conv1_dw.cu)."""
    if di == 3:
        return dj * 3 + c
    if dj == 3:
        return 15 + 3 * di + c
    m = 3 * di + dj
    return 12 + c if m == 8 else 24 + 3 * m + c


def _bf16_rows():
    """The bf16 kernel's row count and, for each (kh, kw, c) of the (11,
    11, 3) kernel, flattened, the row of its (384, 96) result that holds
    it: row 8i + e is channel e of chunk ``kPairs[i] % 6`` at tap
    ``kPairs[i] // 6``, the (tap, chunk) pairs whose channels the kernel
    needs, in order; chunk k holds slots 8k .. 8k + 7."""
    slots = {_bf16_slot(di, dj, c): (di, dj, c) for di in range(BLOCK)
             for dj in range(BLOCK) for c in range(3)}
    pairs = []
    for tap in range(TAPS * TAPS):
        ky, kx = divmod(tap, TAPS)
        for chunk in range(6):
            if any(ky * BLOCK + slots[8 * chunk + e][0] < KERNEL and
                   kx * BLOCK + slots[8 * chunk + e][1] < KERNEL
                   for e in range(8)):
                pairs.append((tap, chunk))
    rows = [0] * (KERNEL * KERNEL * 3)
    for r in range(8 * len(pairs)):
        tap, chunk = pairs[r // 8]
        di, dj, c = slots[8 * chunk + r % 8]
        kh = tap // TAPS * BLOCK + di
        kw = tap % TAPS * BLOCK + dj
        if kh < KERNEL and kw < KERNEL:
            rows[(kh * KERNEL + kw) * 3 + c] = r
    return len(pairs) * 8, rows


_BF16_ROWS, _BF16_INDEX = _bf16_rows()
_bf16_index = {}    # _BF16_INDEX on each device, made at the first call


def _contract(a, b):
    """a: (K, M), b: (K, cout) in one dtype -> (M, cout) float32: the
    products are exact in float32 for bf16 operands, the sum float32."""
    return torch.matmul(a.to(torch.float32).t(), b.to(torch.float32))


def conv1_dw_reference(x, gout):
    """Plain version of ``conv1_dw``, the loop of ``_conv1_dw_kernel``
    over the whole batch: nine tap contractions of space-to-depth slices
    with the output gradient (cast to x's dtype).  Returns (11, 11, C,
    cout) float32."""
    n, _, _, c = x.shape
    oh, ow, cout = gout.shape[1], gout.shape[2], gout.shape[3]
    cin = BLOCK * BLOCK * c
    xp = conv1_s2d_geometry(x, oh, ow)
    gmat = gout.to(x.dtype).reshape(n * oh * ow, cout)
    rows = []
    for ky in range(TAPS):
        for kx in range(TAPS):
            patch = xp[:, ky:ky + oh, kx:kx + ow, :].reshape(n * oh * ow, cin)
            rows.append(_contract(patch, gmat))
    return conv1_dw_s2d_to_hwio(torch.cat(rows), c, cout)


def conv1_dw_shifted_reference(x, gout):
    """Plain version of ``conv1_dw_shifted``, the contractions of
    ``_conv1_dw_shift_kernel`` over the whole batch: the frames and the
    gradient (zero-padded to the same (oh+2, ow+2) grid, cast to x's
    dtype) flattened to rows of positions; tap (ky, kx) pairs row r of
    the gradient with row r + ky*(ow+2) + kx of the frames (zero past the
    end).  Returns (11, 11, C, cout) float32."""
    n, _, _, c = x.shape
    oh, ow, cout = gout.shape[1], gout.shape[2], gout.shape[3]
    w2 = ow + TAPS - 1
    k = n * (oh + TAPS - 1) * w2
    xflat = conv1_s2d_geometry(x, oh, ow).reshape(k, BLOCK * BLOCK * c)
    gflat = F.pad(gout.to(x.dtype), (0, 0, 0, TAPS - 1, 0, TAPS - 1)) \
        .reshape(k, cout)
    xpad = F.pad(xflat, (0, 0, 0, (TAPS - 1) * w2 + TAPS - 1))
    rows = [_contract(xpad[ky * w2 + kx:ky * w2 + kx + k], gflat)
            for ky in range(TAPS) for kx in range(TAPS)]
    return conv1_dw_s2d_to_hwio(torch.cat(rows), c, cout)


def _check(name, x, gout):
    if x.device.type != "cuda" or gout.device != x.device:
        error("%s: x and gout must be on one CUDA device, got %s and %s"
              % (name, x.device, gout.device))
    if x.dtype not in _DTYPES:
        error("%s: dtype %s not supported (float32, bfloat16)"
              % (name, x.dtype))
    if x.dim() != 4 or x.shape[-1] != 3 or gout.dim() != 4 or \
            tuple(gout.shape) != (x.shape[0], -(-x.shape[1] // BLOCK),
                                  -(-x.shape[2] // BLOCK), COUT):
        error("%s: expects x (N, H, W, 3) and gout (N, ceil(H/4), "
              "ceil(W/4), 96), got %s and %s"
              % (name, tuple(x.shape), tuple(gout.shape)))


def _launch(name, x, gout, per_block, by_rows):
    """Run entry point ``vlt_<name>`` on the raw frames and the unpadded
    gradient (cast to x's dtype); blocks own ``per_block`` images, or
    gradient rows when ``by_rows``, or about one block per SM when
    ``per_block`` is None."""
    _check(name, x, gout)
    n, h, w, _ = x.shape
    oh, ow = gout.shape[1], gout.shape[2]
    top, left = conv1_raw_geometry(h, w, oh, ow)
    x = x.contiguous()
    g = gout.to(x.dtype).contiguous()
    units = n * oh if by_rows else n
    if per_block is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        per_block = -(-units // sms)
    per_block = int(per_block)
    if per_block <= 0:
        error("%s: per-block work must be positive, got %d"
              % (name, per_block))
    if g.data_ptr() % 16:
        error("%s: the kernel's 16-byte copies of the gradient need it "
              "16-byte aligned" % name)
    nblocks = -(-units // per_block)
    rows = _BF16_ROWS if x.dtype == torch.bfloat16 else \
        TAPS * TAPS * BLOCK * BLOCK * 3
    partial = torch.empty((nblocks, rows, COUT), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((rows, COUT), dtype=torch.float32, device=x.device)
    rc = getattr(_build.library(), "vlt_" + name)(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, h, w, oh, ow, top, left, _DTYPES[x.dtype], per_block, nblocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, name)
    if x.dtype == torch.bfloat16:
        if x.device not in _bf16_index:     # not while a graph captures
            _bf16_index[x.device] = torch.tensor(_BF16_INDEX,
                                                 device=x.device)
        return out[_bf16_index[x.device]].reshape(KERNEL, KERNEL, 3, COUT)
    return conv1_dw_s2d_to_hwio(out, 3, COUT)


def conv1_dw(x, gout, block_images=None):
    """dL/dW of the stem conv from its input frames x (N, H, W, 3) and the
    gradient gout (N, ceil(H/4), ceil(W/4), 96) of its output (before the
    bias), as (11, 11, 3, 96) float32.  On the card each block owns
    ``block_images`` whole images (default: about one block per SM)."""
    if x.device.type == "cpu" and gout.device.type == "cpu":
        return conv1_dw_reference(x, gout)
    dw = _launch("conv1_dw", x, gout, block_images, by_rows=False)
    if torch.cuda.is_current_stream_capturing():
        conv1_dw.captured += 1         # runs at the graph's replays
    else:
        conv1_dw.launches += 1
    return dw


graphs.register_wrapper(conv1_dw)


def conv1_dw_shifted(x, gout, block_rows=None):
    """The same gradient as ``conv1_dw``, with the gradient's rows
    flattened over the batch (N*oh rows): on the card each block owns
    ``block_rows`` consecutive rows, which may start inside an image and
    cross into the next (default: about one block per SM).  The kernel
    reads the unpadded gradient; only the plain version pads it."""
    if x.device.type == "cpu" and gout.device.type == "cpu":
        return conv1_dw_shifted_reference(x, gout)
    dw = _launch("conv1_dw_shifted", x, gout, block_rows, by_rows=True)
    if torch.cuda.is_current_stream_capturing():
        conv1_dw_shifted.captured += 1         # runs at the graph's replays
    else:
        conv1_dw_shifted.launches += 1
    return dw


graphs.register_wrapper(conv1_dw_shifted)


def conv1_dw_im2col(x, gout, chunk=256):
    """The same gradient as ``conv1_dw``, as ``conv1_dw_xla`` computes it:
    the explicit (positions, C*11*11) patch matrix of ``chunk`` images at
    a time (zero images pad the last chunk; the feature order (C, KH,
    KW) of ``conv_general_dilated_patches``), each chunk's (C*121, K) x
    (K, cout) product in float32 on x's dtype's values, added up.
    Returns (11, 11, C, cout) float32."""
    n, h, w, c = x.shape
    oh, ow, cout = gout.shape[1], gout.shape[2], gout.shape[3]
    chunk = min(int(chunk), n)
    pad_n = -n % chunk
    if pad_n:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, pad_n))
        gout = F.pad(gout, (0, 0, 0, 0, 0, 0, 0, pad_n))
    pad_h = max((oh - 1) * BLOCK + KERNEL - h, 0)
    pad_w = max((ow - 1) * BLOCK + KERNEL - w, 0)
    k = c * KERNEL * KERNEL
    dw = torch.zeros((k, cout), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xs = F.pad(x[i:i + chunk].permute(0, 3, 1, 2),
                   (pad_w // 2, pad_w - pad_w // 2,
                    pad_h // 2, pad_h - pad_h // 2))
        patches = F.unfold(xs, KERNEL, stride=BLOCK)    # (chunk, k, oh*ow)
        gs = gout[i:i + chunk].to(x.dtype).reshape(-1, cout)
        dw += torch.matmul(
            patches.transpose(0, 1).reshape(k, -1).to(torch.float32),
            gs.to(torch.float32))
    return dw.reshape(c, KERNEL, KERNEL, cout).permute(1, 2, 0, 3)
