"""The LSTM step kernel's plan and arithmetic, on the CPU.

``ops/lstm_step.plan`` divides one step over the card's CTAs: every
(row, gate column, k) product must be computed by exactly one CTA, and
every (row, j) cell updated by exactly one.  ``lstm_step_3xtf32``
emulates the kernel's 3xTF32 products in plain torch; held against the
JAX package's Pallas ``lstm_step`` (interpret mode) it stays within the
kernel's 1e-5 tolerance, where one TF32 pass does not.  The kernel itself
runs on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_learning_tpu.ops import pallas_kernels as pk
from video_learning_tpu_torch.ops import lstm_step as lstm_mod

# the main path's shapes (classifier serving, training; greedy and beam-4
# caption decodes), the smallest serving bucket, and ragged ones: H not a
# multiple of the j tile, one row past two 128-row groups
SHAPES = [(32, 256), (128, 256), (64, 512), (256, 512), (1, 256), (3, 40),
          (257, 512)]


def _boxes(p, batch, hidden):
    blocks = list(lstm_mod.plan_blocks(p, batch, hidden))
    lo = np.array([[b["rows"][0], b["j"][0], b["k"][0]] for b in blocks])
    hi = np.array([[b["rows"][1], b["j"][1], b["k"][1]] for b in blocks])
    return blocks, lo, hi


def _partition(lo, hi, extent):
    """Whether the boxes [lo, hi) (one a row; empty ones allowed) tile the
    box [0, extent) exactly: all inside, pairwise disjoint, volumes adding
    up to the whole."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    size = np.clip(hi - lo, 0, None)
    keep = size.prod(axis=1) > 0
    lo, hi, size = lo[keep], hi[keep], size[keep]
    if (lo < 0).any() or (hi > np.asarray(extent)).any():
        return False
    overlap = np.clip(np.minimum(hi[:, None], hi[None]) -
                      np.maximum(lo[:, None], lo[None]), 0, None).prod(-1)
    np.fill_diagonal(overlap, 0)
    return not overlap.any() and size.prod(axis=1).sum() == \
        np.prod(extent)


@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_plan_covers_every_product_and_cell_once(batch, hidden):
    # with all clusters resident, and with only one at a time (the plan
    # then splits k as little as it can)
    for resident in (None, lambda p: 1):
        p = lstm_mod.plan(batch, hidden, resident)
        assert p.rows in (64, 128) and p.wj in (1, 2)
        assert 1 <= p.split <= lstm_mod.MAX_SPLIT and p.k_cta % 8 == 0
        assert p.threads == 2 * p.rows + 32
        blocks, lo, hi = _boxes(p, batch, hidden)
        assert len(blocks) == p.split * p.tiles * p.groups
        # each CTA covers all four gates of its j: (row, j, k) boxes of
        # the product h @ Wh tile (B, H, H) exactly once
        assert _partition(lo, hi, (batch, hidden, hidden))
        # and the cell updates (B, H) exactly once, each by a CTA of the
        # cluster that computed the tile's sums
        upd_lo = [[b["update_rows"][0], b["j"][0]] for b in blocks]
        upd_hi = [[b["update_rows"][1], b["j"][1]] for b in blocks]
        assert _partition(upd_lo, upd_hi, (batch, hidden))
        for b in blocks:
            assert b["rows"][0] <= b["update_rows"][0] <= \
                b["update_rows"][1] <= b["rows"][1]
        # a CTA of each row group reads each Wh element once: at most
        # twice in all at every main-path shape
        if batch <= 256:
            assert p.groups <= 2


def test_plan_splits_less_where_clusters_would_not_all_fit():
    full = lstm_mod.plan(256, 512)
    fitted = lstm_mod.plan(256, 512, lambda p: 66 if p.split <= 2 else 30)
    assert (full.split, fitted.split) == (4, 2)
    assert fitted.tiles * fitted.groups <= 66


@pytest.mark.parametrize("batch,hidden", [(64, 512), (256, 512)])
def test_3xtf32_emulation_matches_pallas_and_one_pass_does_not(batch,
                                                                hidden):
    """The caption decode's shapes, inputs as phase 2 of chip_smoke.py
    draws them: three TF32 products hold the step to float32 within the
    kernel's tolerance (rtol = atol = 1e-5); one TF32 pass misses it."""
    rng = np.random.RandomState(hidden + batch)
    xproj = rng.randn(batch, 4 * hidden).astype(np.float32)
    h = np.tanh(rng.randn(batch, hidden)).astype(np.float32)
    c = rng.randn(batch, hidden).astype(np.float32)
    wh = (rng.randn(hidden, 4 * hidden) * 0.05).astype(np.float32)
    b = (rng.randn(4 * hidden) * 0.1).astype(np.float32)
    want = [np.asarray(t) for t in pk.lstm_step(
        *(jnp.asarray(a) for a in (xproj, h, c, wh, b)), interpret=True)]
    args = [torch.from_numpy(a) for a in (xproj, h, c, wh, b)]
    three = lstm_mod.lstm_step_3xtf32(*args)
    one = lstm_mod.lstm_step_3xtf32(*args, passes=1)
    for got, ref in zip(three, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert not all(np.allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
                   for got, ref in zip(one, want))


def test_tf32_split_rounds_hi_and_truncates_lo():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -1.0 - 2.0 ** -11, 0.1, -3.3e-5])
    hi = lstm_mod._tf32(x)
    lo = lstm_mod._tf32(x - hi, rounded=False)
    # ties away from zero; 10 mantissa bits
    assert hi[0] == 1.0 + 2.0 ** -10 and hi[2] == -1.0 - 2.0 ** -10
    assert hi[1] == 1.0 + 2.0 ** -10
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()
    # hi + lo is x to 2^-21 of |x|
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
