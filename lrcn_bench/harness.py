"""One run of one cell: set-up, the measured window, the check, and the
result line.

Everything that belongs to one cell is found by name:
``BENCHMARK.json`` names the cell's configuration and traffic, which
are ``configs/<config>.json`` and ``traffic/<traffic>.json`` here; the
check's limits are ``limits/<cell>.json``; every metric, end to end or
per layer, is read by ``metrics/<metric>.py``, whose ``read(run)``
returns a number or None (nothing to read in this run: the metric is
left out of the line).  A new cell, configuration, mix or metric is new
files and entries; no file here changes.

The window: with ``--trace 0`` the cell's call runs back to back for
``seconds`` seconds on the host clock, each call ending in a host sync
(the trainer reads its metrics back, the serving call returns its
answer to the host); with ``--trace 1`` the traffic's ``trace_calls``
calls run in one profiler session instead, after two untraced ones.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from lrcn_bench import trace as trace_mod
from lrcn_bench import workload

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "video_learning_tpu")


def load_json(*parts, base=HERE):
    with open(os.path.join(base, *parts)) as f:
        return json.load(f)


def load_spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(spec, name, base=HERE):
    """(workload entry, configuration, traffic, limits) of cell ``name``,
    from the files under ``base``."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return (w, load_json("configs", w["config"] + ".json", base=base),
                    load_json("traffic", w["traffic"] + ".json", base=base),
                    load_json("limits", name + ".json", base=base))
    raise KeyError("no workload %r in BENCHMARK.json" % name)


def metrics_for(spec, group, name):
    """The entries of ``spec[group]`` that cell ``name`` reports."""
    return [m for m in spec[group]
            if "workloads" not in m or name in m["workloads"]]


def reader(name, dirs=None):
    """``read`` of the metric's reader ``metrics/<name>.py`` (the first
    of ``dirs`` that holds one)."""
    for d in dirs or [os.path.join(HERE, "metrics")]:
        path = os.path.join(d, name + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "lrcn_bench_metric_" + name.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError("no reader for metric %r" % name)


def forbidden_modules():
    """The forbidden top-level names among the loaded modules, compared
    whole (``video_learning_tpu_torch`` is not ``video_learning_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def gpu_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi unavailable (%s)" % exc
    return out[0] if out else "nvidia-smi printed no card"


class Run:
    """What a metric reader reads of one run."""

    def __init__(self, cell, cfg, traffic, calls, window_s, setup_s,
                 trace=None):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.kind = traffic["kind"]
        self.items = traffic["items"]
        self.calls, self.window_s, self.setup_s = calls, window_s, setup_s
        self.trace = trace


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(cell, seconds, device):
    """Calls back to back until ``seconds`` have passed; returns the
    window's length, from the first call's start to the last one's end."""
    t0 = time.monotonic()
    while True:
        cell.call()
        now = time.monotonic()
        if now - t0 >= seconds:
            break
    _sync(device)
    return time.monotonic() - t0


def traced_window(cell, calls, device):
    """``calls`` calls in one profiler session; returns the reduced
    trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(2):
        cell.call()
    _sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace_mod.WINDOW):
            for _ in range(calls):
                with record_function("bench.call"):
                    cell.call()
            _sync(device)
    return trace_mod.Trace(prof.events(), calls)


def run(name, cfg, traffic, limits, spec, seed, seconds, traced, device,
        t_start, quantize=None, metric_dirs=None):
    """One run of cell ``name``; returns (result dict, check lines, the
    cell's driver).
    ``quantize`` serves an inference cell through the program's int8
    path (the control); ``metric_dirs`` where readers are looked for."""
    device = torch.device(device)
    cell = workload.CELLS[traffic["kind"]](cfg, traffic, seed, device)
    if quantize:
        cell.setup(quantize=quantize)
    else:
        cell.setup()
    setup_s = time.monotonic() - t_start
    tr = None
    if traced:
        tr = traced_window(cell, traffic["trace_calls"], device)
        window_s = tr.window_s
        calls = tr.calls
    else:
        window_s = timed_window(cell, seconds, device)
        calls = cell.calls
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.release()
    numbers = cell.check()
    if not set(limits) <= set(numbers):
        raise ValueError("the limits name %s; the check gives %s"
                         % (sorted(limits), sorted(numbers)))
    correct = all(numbers[n] <= limits[n] for n in limits)
    facts = Run(name, cfg, traffic, calls, window_s, setup_s, tr)
    group = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(spec, group, name):
        value = reader(m["name"], metric_dirs)(facts)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": calls * traffic["items"],
              "failed": 0 if correct else cell.compared_items(),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                        for n in sorted(limits)}
    lines = ["check %s %.6g limit %.6g" % (n, numbers[n], limits[n])
             for n in sorted(limits)]
    return result, lines, cell
