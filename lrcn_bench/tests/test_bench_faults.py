"""The check fails what it is there to fail: each planted fault the
cells can have, and each cell's control, one precision below the
configuration's."""

import json
import os
import time

import pytest

from lrcn_bench import calibrate, faults, harness
from conftest import cells, tiny_config, tiny_traffic

TRAIN = cells("train")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.parametrize("name, fault",
                         [(c, f) for c in TRAIN
                          for f in ("unchanged", "half_batch")])
def test_a_planted_fault_is_not_correct(tiny, name, fault):
    with faults.FAULTS[fault]():
        result, lines, _ = tiny(name)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert list(result["checks"]) == sorted(result["checks"])
    assert [l.split()[1] for l in lines] == list(result["checks"])


def test_an_altered_answer_is_not_correct():
    """The serving driver, which no cell runs yet (PERF.md), on a tiny
    float32 clip classifier: sound at a float32 limit, and not correct
    with one served logit altered."""
    spec = harness.load_spec()
    with open(os.path.join(harness.HERE, "configs", "ucf101_lrcn.json")) as f:
        cfg = tiny_config(json.load(f), "float32")
    with open(os.path.join(harness.HERE, "traffic", "infer_b32.json")) as f:
        traffic = tiny_traffic(json.load(f))
    limits = {"logit_gap": 1e-5}
    runs = []
    for fault in (None, "altered"):
        if fault:
            with faults.FAULTS[fault]():
                runs.append(harness.run("ucf101_lrcn.infer_b32", cfg,
                                        traffic, limits, spec, SEEDS[0],
                                        0.2, False, "cpu", time.monotonic()))
        else:
            runs.append(harness.run("ucf101_lrcn.infer_b32", cfg, traffic,
                                    limits, spec, SEEDS[0], 0.2, False,
                                    "cpu", time.monotonic()))
    assert runs[0][0]["correct"] is True
    assert runs[1][0]["correct"] is False and runs[1][0]["failed"] > 0


@pytest.mark.parametrize("name", TRAIN)
def test_the_float8_control_reads_above_the_program(name):
    """At a CPU test's size the limits (set at the cell's size) do not
    apply; the control's machinery does: the float8 reference in the
    program's place departs from the float32 one by more than the bf16
    program does."""
    spec = harness.load_spec()
    _, cfg, traffic, _ = harness.resolve(spec, name)
    control, program, _ = calibrate.train_control(
        tiny_config(cfg), tiny_traffic(traffic), SEEDS[0], "cpu")
    assert control["grad_gap_median"] > 2 * program["grad_gap_median"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN)
def test_the_float8_control_is_not_correct_at_the_cells_size(card, name):
    spec = harness.load_spec()
    _, cfg, traffic, limits = harness.resolve(spec, name)
    for seed in SEEDS:
        control, _, _ = calibrate.train_control(cfg, traffic, seed, "cuda")
        assert any(control[n] > limits[n] for n in limits), control
