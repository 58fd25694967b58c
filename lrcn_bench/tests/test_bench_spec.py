"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by it."""

import json
import os
import re
import pytest

from lrcn_bench import harness, spread

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_shape(spec):
    assert set(spec) == TOP
    assert spec["paths"] == ["lrcn_bench"]
    assert spec["command"] == ["python3", "lrcn_bench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits in twelve hours
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(spec)) < 64 * 1024


def test_entries(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        harness.resolve(spec, w["name"])        # every file it names
    assert len(pairs) == len(spec["workloads"])
    assert configs == {w["config"] for w in spec["workloads"]}


def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    layers = {}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        harness.reader(m["name"])
        if "layer" in m:
            layers.setdefault(m["layer"], []).append(m["name"])
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for cell in cells:
        reported = harness.metrics_for(spec, "end_to_end", cell)
        assert len(reported) >= 2
        assert harness.metrics_for(spec, "per_layer", cell)


CAN_COMPARE = {
    "train": {"loss_gap", "loss1_gap", "grad1_gap", "grad1_gap_median",
              "grad_gap", "grad_gap_median"},
    "classify": {"logit_gap", "row_gap", "row_gap_median", "rms_gap"}}


def test_limits_name_numbers_the_check_gives(spec):
    for w in spec["workloads"]:
        _, cfg, traffic, limits = harness.resolve(spec, w["name"])
        kind = "train" if traffic["kind"] == "train" else cfg["task"]
        assert limits and set(limits) <= CAN_COMPARE[kind]
        assert all(v > 0 for v in limits.values())


def test_spread_is_the_quartile_distance_over_the_median(tmp_path):
    paths = []
    for i, v in enumerate([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]):
        p = tmp_path / ("run%d.out" % i)
        p.write_text("noise\n" + json.dumps(
            {"metrics": {"x": {"value": v, "unit": "s"}}}) + "\n")
        paths.append(str(p))
    rows = spread.table([spread.result_of(p) for p in paths])
    n, med, q1, q3, share = rows["x"]
    assert (n, med, q1, q3) == (6, 3.5, 1.75, 5.25)
    assert share == pytest.approx(1.0)
