"""The program held to the plain reference at a tiny size on the CPU:
in float32 every number the check can compare is at round-off."""

import pytest
import torch

from lrcn_bench.reference import lrcn as ref
from conftest import cells

CELLS = cells()
# float32 program against the float32 reference: the parameters after a
# step carry float32 rounding of the update (its value's eps), so the
# gradient read back from them in the worst leaf is the loosest
FLOAT32_LIMITS = {"loss_gap": 1e-5, "loss1_gap": 1e-5, "grad1_gap": 2e-2,
                  "grad_gap": 2e-2, "grad1_gap_median": 1e-4,
                  "grad_gap_median": 1e-4, "logit_gap": 1e-5,
                  "row_gap": 1e-5, "row_gap_median": 1e-5, "rms_gap": 1e-5}


@pytest.mark.parametrize("name", CELLS)
def test_float32_program_matches_reference(tiny, name):
    _, _, cell = tiny(name, dtype="float32")
    assert set(cell.read) <= set(FLOAT32_LIMITS)
    for n, v in cell.read.items():
        assert v <= FLOAT32_LIMITS[n], (n, v, cell.read)


def test_dropout_masks_follow_the_trainer_seeds():
    keep = ref.dropout_keep(12, 3, 1, (64, 16), 0.5, "cpu")
    assert keep.dtype == torch.bool and 0.3 < keep.float().mean() < 0.7
    assert torch.equal(keep, ref.dropout_keep(12, 3, 1, (64, 16), 0.5,
                                              "cpu"))
    assert not torch.equal(keep, ref.dropout_keep(12, 4, 1, (64, 16), 0.5,
                                                  "cpu"))
