"""Shared pieces of the benchmark's tests: the ``cuda`` marker and the
tiny versions of the cells that run on the CPU."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on a CUDA card; skips with the reason where "
                   "there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def cells(kind=None):
    """The cells of BENCHMARK.json, or those whose traffic is of
    ``kind`` ("train" or "infer")."""
    from lrcn_bench import harness
    spec = harness.load_spec()
    return [w["name"] for w in spec["workloads"]
            if kind is None or harness.resolve(spec, w["name"])[2]["kind"]
            == kind]


def tiny_config(cfg, dtype=None):
    """The configuration at a size a CPU test holds: 67x67 crops of
    72x80 frames, 2 frames a clip, 11 classes or a 23-word vocabulary, a
    16-unit LSTM (AlexNet keeps its widths)."""
    cfg = copy.deepcopy(cfg)
    cfg.update(image=67, raw_hw=[72, 80])
    cfg["lstm"]["hidden"] = 16
    if cfg["task"] == "caption":
        cfg["num_classes"] = 23
        cfg["caption"].update(vocabulary=23, embedding_dim=8, max_T=5,
                              eos_index=21, bos_index=22)
    else:
        cfg.update(frames_per_clip=2, num_classes=11)
    if dtype:
        cfg["compute_dtype"] = dtype
    return cfg


def tiny_traffic(traffic):
    traffic = dict(traffic)
    traffic.update(items=2, pool=2, trace_calls=2, ref_block_items=1)
    return traffic


@pytest.fixture
def tiny():
    """run(cell, dtype=None, traced=False, quantize=None, spec=None,
    metric_dirs=None) -> (result, lines, cell) of one CPU run of the
    tiny cell."""
    import time
    from lrcn_bench import harness

    def run(name, dtype=None, traced=False, quantize=None, spec=None,
            metric_dirs=None, seed=2 ** 31 + 11):
        spec = spec or harness.load_spec()
        _, cfg, traffic, limits = harness.resolve(spec, name)
        return harness.run(name, tiny_config(cfg, dtype),
                           tiny_traffic(traffic), limits, spec, seed, 0.2,
                           traced, "cpu", time.monotonic(),
                           quantize=quantize, metric_dirs=metric_dirs)
    return run
