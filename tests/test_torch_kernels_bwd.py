"""The port's backward kernels through their plain versions, against the
JAX package: the LRN input gradient (``_lrn_vjp_bwd``), the stem conv's
weight gradient (``conv1_dw``, ``conv1_dw_shifted``), the conv1 autograd
Function (``alexnet._conv1_direct``) and the LSTM step Function.

The CUDA kernels have no CPU mode: on CPU tensors the wrappers take the
plain versions and count no launch.  The kernels are held against the
plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.  The JAX Pallas functions run in interpret
mode, called directly (no environment variable is set).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_learning_tpu.models import alexnet as jalexnet
from video_learning_tpu.models import layers as jlayers
from video_learning_tpu.models import lstm as jlstm
from video_learning_tpu.ops import pallas_kernels as pk
from video_learning_tpu_torch.models import alexnet
from video_learning_tpu_torch.models.layers import hwio_to_oihw, oihw_to_hwio
from video_learning_tpu_torch.ops import conv1_dw as c1
from video_learning_tpu_torch.ops import lrn as lrn_mod
from video_learning_tpu_torch.ops.lstm_step import (LSTMStepFunction,
                                                   lstm_step_reference)

_BF16 = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _lrn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32) * 40
    g = rng.randn(*shape).astype(np.float32)
    return x, g


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ------------------------------------------------------------- (a) LRN bwd
# the training sites' channel counts, a ragged one, one and two 16-byte
# chunks per row (C 8 and 16 in bf16), rows that cross warps in a row
# count no tile divides, whole-warp rows, and a radius of 3
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,radius", [
    ((2, 5, 5, 96), 2), ((1, 3, 4, 256), 2), ((3, 2, 2, 7), 2),
    ((2, 5, 5, 8), 2), ((2, 5, 5, 16), 2), ((3, 7, 5, 96), 2),
    ((2, 9, 9, 256), 2), ((2, 5, 5, 40), 3)])
def test_lrn_backward_matches_jax(shape, radius, dtype):
    """Against the JAX Pallas backward (interpret mode) -- the same formula
    and rounding points, so f32 within 1e-5 relative and bf16 within one
    bf16 ulp of dx (rtol 1e-2) -- and against jax.grad through the sliding
    form, which differentiates another but equal expression: autodiff
    rounds elsewhere (f32 rtol 1e-4) and, in bf16, rounds its
    intermediate products to bf16 where the formula keeps float32 (bf16
    rtol 2e-2 and one bf16 ulp at the gradient's scale)."""
    jdt, tdt = _BF16[dtype]
    x, g = _lrn_inputs(shape, 0)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    out = _np(lrn_mod.lrn_backward_reference(xt, gt, radius))
    _, vjp = jax.vjp(lambda v: pk.lrn(v, radius, block_rows=64,
                                      interpret=True), xj)
    pallas = np.asarray(vjp(gj)[0].astype(jnp.float32))
    _, vjp = jax.vjp(
        lambda v: jlayers._lrn_slide(v, radius, 1.0, 2e-5, 0.75), xj)
    slide = np.asarray(vjp(gj)[0].astype(jnp.float32))
    scale = float(np.abs(pallas).max())
    if dtype == "float32":
        np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-6 * scale)
        np.testing.assert_allclose(out, slide, rtol=1e-4, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(out, pallas, rtol=1e-2, atol=1e-6 * scale)
        np.testing.assert_allclose(out, slide, rtol=2e-2,
                                   atol=2 ** -7 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 5, 96), (1, 3, 4, 256),
                                   (3, 2, 2, 7)])
def test_lrn_function_backward_matches_autograd_of_reference(shape, dtype):
    """LRNFunction's backward (lrn_backward on the CPU) against autograd
    through the port's own lrn_reference: f32 rtol 1e-4 (equal
    expressions, rounded at other points); bf16 rtol 2e-2 (autograd
    rounds its intermediate products to bf16, the formula keeps float32
    until dx)."""
    _, tdt = _BF16[dtype]
    x, g = _lrn_inputs(shape, 1)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    gt = torch.from_numpy(g).to(tdt)
    before = lrn_mod.lrn_backward.launches
    y = lrn_mod.LRNFunction.apply(xt, 2, 1.0, 2e-5, 0.75)
    got, = torch.autograd.grad(y, xt, gt)
    ref, = torch.autograd.grad(lrn_mod.lrn_reference(xt), xt, gt)
    np.testing.assert_array_equal(_np(y), _np(lrn_mod.lrn_reference(xt)))
    rtol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol,
                               atol=rtol * float(ref.abs().max()))
    assert lrn_mod.lrn_backward.launches == before     # CPU: no kernel


# ---------------------------------------------------------- (b) conv1_dw
def _conv1_case(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    gout = rng.randn(shape[0], -(-shape[1] // 4), -(-shape[2] // 4),
                     96).astype(np.float32)
    return x, gout


def _direct_conv_grad(x, gout):
    w = jnp.zeros((11, 11, 3, 96), jnp.float32)

    def conv(w):
        return jax.lax.conv_general_dilated(
            jnp.asarray(x), w, (4, 4), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    return np.asarray(jax.grad(lambda w: jnp.sum(conv(w) * gout))(w))


# (39, 43) and (45, 37) are the shapes of test_pallas_kernels.py; in
# (40, 42) the SAME padding is asymmetric on both axes (7 and 9 pixels)
@pytest.mark.parametrize("shape", [(3, 39, 43, 3), (2, 45, 37, 3),
                                   (2, 40, 42, 3)])
def test_conv1_dw_plain_versions_match_jax(shape):
    """Both plain versions against both Pallas kernels (interpret mode)
    and jax.grad of the direct conv.  float32 sums of ~10^3 products of
    unit normals in another order: atol 1e-5 x the gradient's scale."""
    x, gout = _conv1_case(shape, 0)
    xt, gt = torch.from_numpy(x), torch.from_numpy(gout)
    blocked = c1.conv1_dw_reference(xt, gt).numpy()
    shifted = c1.conv1_dw_shifted_reference(xt, gt).numpy()
    refs = [np.asarray(pk.conv1_dw(jnp.asarray(x), jnp.asarray(gout),
                                   block_images=2, interpret=True)),
            np.asarray(pk.conv1_dw_shifted(jnp.asarray(x), jnp.asarray(gout),
                                           block_rows=64, interpret=True)),
            _direct_conv_grad(x, gout)]
    before = (c1.conv1_dw.launches, c1.conv1_dw_shifted.launches)
    wrapped = [c1.conv1_dw(xt, gt).numpy(),
               c1.conv1_dw_shifted(xt, gt).numpy()]
    assert (c1.conv1_dw.launches, c1.conv1_dw_shifted.launches) == before
    for ref in refs:
        atol = 1e-5 * float(np.abs(ref).max())
        for out in [blocked, shifted] + wrapped:
            assert out.shape == (11, 11, 3, 96)
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=atol)


def test_conv1_dw_plain_versions_bf16_match_jax():
    """bf16 frames and gradient: the products are exact in float32, so
    only the float32 sum order differs from the Pallas kernel."""
    x, gout = _conv1_case((2, 39, 43, 3), 1)
    xb = jnp.asarray(x, jnp.bfloat16)
    gb = jnp.asarray(gout, jnp.bfloat16)
    ref = np.asarray(pk.conv1_dw_shifted(xb, gb, block_rows=64,
                                         interpret=True))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(gout).to(torch.bfloat16)
    for fn in (c1.conv1_dw_reference, c1.conv1_dw_shifted_reference):
        out = fn(xt, gt)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_conv1_s2d_helpers_match_jax():
    """The geometry helpers are plain torch: exactly the JAX values."""
    x, gout = _conv1_case((2, 40, 42, 3), 2)
    oh, ow = gout.shape[1], gout.shape[2]
    np.testing.assert_array_equal(
        c1.conv1_s2d_geometry(torch.from_numpy(x), oh, ow).numpy(),
        np.asarray(pk._conv1_s2d_geometry(jnp.asarray(x), oh, ow)))
    dw = np.random.RandomState(3).randn(432, 96).astype(np.float32)
    np.testing.assert_array_equal(
        c1.conv1_dw_s2d_to_hwio(torch.from_numpy(dw), 3, 96).numpy(),
        np.asarray(pk._conv1_dw_s2d_to_hwio(jnp.asarray(dw), 3, 96)))


# (39, 43), (45, 37) and (40, 42) as above; (20, 21) has 5 gradient rows
# an image; (227, 227) is the training geometry (4 pixels of padding above
# and left, 5 below and right)
@pytest.mark.parametrize("shape", [(3, 39, 43, 3), (2, 45, 37, 3),
                                   (5, 40, 42, 3), (6, 20, 21, 3),
                                   (1, 227, 227, 3)])
def test_conv1_raw_geometry_gathers_the_jax_s2d_frames(shape):
    """The kernels read raw frames at the SAME geometry
    ``conv1_raw_geometry`` computes (pixel (4P + di - top, 4Q + dj - left)
    of position (P, Q)); the tensor gathered from it is exactly JAX's
    padded and rearranged one."""
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    oh, ow = -(-shape[1] // 4), -(-shape[2] // 4)
    np.testing.assert_array_equal(
        c1.conv1_s2d_geometry(torch.from_numpy(x), oh, ow).numpy(),
        np.asarray(pk._conv1_s2d_geometry(jnp.asarray(x), oh, ow)))
    top, left = c1.conv1_raw_geometry(shape[1], shape[2], oh, ow)
    pad_h = (oh - 1) * 4 + 11 - shape[1]
    pad_w = (ow - 1) * 4 + 11 - shape[2]
    assert (top, left) == (pad_h // 2, pad_w // 2)


def test_conv1_dw_bf16_kernel_rows_map_to_the_kernel():
    """The bf16 kernel's 384 rows are 48 (tap, 8-channel chunk) pairs of
    its channel layout: laid out from a 432-row s2d gradient by that
    layout, the wrapper's index gives conv1_dw_s2d_to_hwio's (11, 11, 3,
    96), each kernel entry once."""
    dw = torch.from_numpy(np.random.RandomState(9).randn(432, 96)
                          .astype(np.float32))
    slots = {c1._bf16_slot(di, dj, c): (di * 4 + dj) * 3 + c
             for di in range(4) for dj in range(4) for c in range(3)}
    assert sorted(slots) == list(range(48))
    # the pairs the kernel computes: every chunk a tap needs, in order
    pairs = [(tap, chunk) for tap in range(9) for chunk in range(6)
             if not (tap // 3 == 2 and chunk == 0) and
             not (tap % 3 == 2 and chunk == 2)]
    assert c1._BF16_ROWS == 8 * len(pairs) == 384
    rows = torch.stack([dw[tap * 48 + slots[8 * chunk + e]]
                        for tap, chunk in pairs for e in range(8)])
    index = torch.tensor(c1._BF16_INDEX)
    assert len(set(c1._BF16_INDEX)) == 363
    np.testing.assert_array_equal(
        rows[index].reshape(11, 11, 3, 96).numpy(),
        c1.conv1_dw_s2d_to_hwio(dw, 3, 96).numpy())


# ------------------------------------------------------ (c) Conv1Function
@pytest.mark.parametrize("impl", ["shifted", "blocked"])
@pytest.mark.parametrize("shape", [(2, 39, 43, 3), (2, 40, 42, 3)])
def test_conv1_function_backward_matches_jax(shape, impl):
    """dW, db (and dx when the frames ask for one) of the port's
    Conv1Function against jax.vjp of alexnet._conv1_direct, float32.
    The output gradient is masked by the relu on both sides; sums run in
    other orders: atol 1e-5 x each gradient's scale."""
    rng = np.random.RandomState(4)
    x, gout = _conv1_case(shape, 5)
    w = (rng.randn(11, 11, 3, 96) * 0.05).astype(np.float32)
    b = (rng.randn(96) * 0.1).astype(np.float32)
    out, vjp = jax.vjp(jalexnet._conv1_direct, jnp.asarray(w),
                       jnp.asarray(b), jnp.asarray(x))
    rdw, rdb, rdx = (np.asarray(v) for v in vjp(jnp.asarray(gout)))

    wt = hwio_to_oihw(torch.from_numpy(w)).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = alexnet.Conv1Function.apply(xt, wt, bt, impl)
    np.testing.assert_allclose(_np(y), np.asarray(out), rtol=1e-5,
                               atol=1e-5 * float(np.abs(out).max()))
    dw, db, dx = torch.autograd.grad(y, (wt, bt, xt),
                                     torch.from_numpy(gout))
    for got, ref in ((oihw_to_hwio(dw), rdw), (db, rdb), (dx, rdx)):
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))

    # frames that need no gradient (training): dW and db only
    xt = torch.from_numpy(x)
    y = alexnet.Conv1Function.apply(xt, wt, bt, impl)
    dw2, db2 = torch.autograd.grad(y, (wt, bt), torch.from_numpy(gout))
    np.testing.assert_array_equal(_np(dw2), _np(dw))
    np.testing.assert_array_equal(_np(db2), _np(db))


def test_conv1_function_bf16_weight_gradient_rounds_once():
    """Under bf16 the weight gradient is rounded once, to the bf16 weight,
    after the float32 sum (as alexnet.py:232 rounds it): the Function's
    dW equals the plain float32 gradient cast to bf16."""
    x, gout = _conv1_case((2, 39, 43, 3), 6)
    w = torch.from_numpy(
        (np.random.RandomState(7).randn(11, 11, 3, 96) * 0.05)
        .astype(np.float32))
    w16 = hwio_to_oihw(w).to(torch.bfloat16).requires_grad_(True)
    b = torch.full((96,), 0.1).requires_grad_(True)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    y = alexnet.Conv1Function.apply(x16, w16, b, "shifted")
    g16 = torch.from_numpy(gout).to(torch.bfloat16)
    dw, db = torch.autograd.grad(y, (w16, b), g16)
    assert dw.dtype == torch.bfloat16 and db.dtype == torch.float32
    masked = g16 * (y > 0).to(torch.bfloat16)
    want = hwio_to_oihw(c1.conv1_dw_shifted_reference(x16, masked))
    np.testing.assert_array_equal(_np(dw), _np(want.to(torch.bfloat16)))


# ------------------------------------------------------ (d) LSTM step
def test_lstm_step_function_gradcheck_float64():
    """The hand-written backward against finite differences (float64)."""
    gen = torch.Generator().manual_seed(0)
    b, h = 3, 5
    args = [torch.randn(s, generator=gen, dtype=torch.float64)
            .requires_grad_(True)
            for s in ((b, 4 * h), (b, h), (b, h), (h, 4 * h), (4 * h,))]
    assert torch.autograd.gradcheck(LSTMStepFunction.apply, args)


def test_lstm_step_function_matches_jax_grad():
    """Gradients of a loss of (h', c') for xproj, h, c, Wh and b against
    jax.grad through models/lstm._cell_step, float32: only sum order
    differs (rtol 1e-5, atol 1e-6 x scale)."""
    rng = np.random.RandomState(8)
    b, h = 4, 16
    xproj, hh, cc = (rng.randn(b, 4 * h), np.tanh(rng.randn(b, h)),
                     rng.randn(b, h))
    wh, bias = rng.randn(h, 4 * h) * 0.2, rng.randn(4 * h) * 0.1
    wa, wb = rng.randn(b, h), rng.randn(b, h)
    arrays = [a.astype(np.float32) for a in (xproj, hh, cc, wh, bias)]

    def jloss(xp, h_, c_, wh_, b_):
        nh, nc = jlstm._cell_step(wh_, b_, xp, h_, c_)
        return jnp.sum(nh * wa) + jnp.sum(nc * wb)

    refs = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    nh, nc = LSTMStepFunction.apply(*ts)
    want_h, want_c = lstm_step_reference(*ts)
    np.testing.assert_array_equal(_np(nh), _np(want_h))
    np.testing.assert_array_equal(_np(nc), _np(want_c))
    loss = (nh * torch.from_numpy(wa.astype(np.float32))).sum() + \
        (nc * torch.from_numpy(wb.astype(np.float32))).sum()
    for got, ref in zip(torch.autograd.grad(loss, ts), refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(ref).max()))
