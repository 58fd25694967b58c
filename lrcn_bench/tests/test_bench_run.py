"""The run's entry point and the harness's reliance on data: a cell, a
traffic mix and a metric are added as files, with no file changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from lrcn_bench import harness
from conftest import tiny_config, tiny_traffic


def _digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        if "__pycache__" in d:
            continue
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        return      # the check is of a machine without a card
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "ucf101_lrcn.train_b128", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no result" in out.stderr


def test_a_cell_a_mix_and_a_metric_are_added_as_files(tmp_path):
    before = _digest(harness.HERE)
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (base / d).mkdir(parents=True)
    with open(os.path.join(harness.HERE, "configs",
                           "ucf101_lrcn.json")) as f:
        cfg = tiny_config(json.load(f), "float32")
    (base / "configs" / "ucf101_lrcn.json").write_text(json.dumps(cfg))
    mix = tiny_traffic({"kind": "infer", "crop": "center",
                        "mirror": "none"})
    (base / "traffic" / "infer_b2.json").write_text(json.dumps(mix))
    (base / "limits" / "ucf101_lrcn.infer_b2.json").write_text(
        json.dumps({"logit_gap": 1e-5}))
    (base / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    (base / "metrics" / "infer_items_per_s.py").write_text(
        "def read(run):\n    if run.trace is None:\n"
        "        return run.calls * run.items / run.window_s\n")
    spec = harness.load_spec()
    spec["workloads"].append({"name": "ucf101_lrcn.infer_b2",
                              "config": "ucf101_lrcn", "traffic": "infer_b2",
                              "chips": 1, "why": "added in a test"})
    spec["end_to_end"].append({"name": "infer_items_per_s",
                               "unit": "items/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["ucf101_lrcn.infer_b2"]})
    spec["per_layer"].append({"name": "calls_made", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving forward",
                              "moves": "infer_items_per_s",
                              "workloads": ["ucf101_lrcn.infer_b2"]})
    _, c, t, lim = harness.resolve(spec, "ucf101_lrcn.infer_b2", base=base)
    dirs = [str(base / "metrics"), os.path.join(harness.HERE, "metrics")]
    result, _, _ = harness.run("ucf101_lrcn.infer_b2", c, t, lim, spec,
                               2 ** 31 + 3, 0.2, False, "cpu",
                               time.monotonic(), metric_dirs=dirs)
    assert result["correct"]
    assert set(result["metrics"]) == {"infer_items_per_s", "setup_s"}
    traced, _, _ = harness.run("ucf101_lrcn.infer_b2", c, t, lim, spec,
                               2 ** 31 + 3, 0.2, True, "cpu",
                               time.monotonic(), metric_dirs=dirs)
    assert traced["metrics"]["calls_made"]["value"] == t["trace_calls"]
    assert _digest(harness.HERE) == before
    shutil.rmtree(base)
