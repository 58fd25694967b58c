"""Step metrics and profiling for the run driver.

Counterpart of ``video_learning_tpu/observe.py``: ``MetricsWriter``
appends one JSON line per step to ``<folder>/metrics_<run_id>_<time>.jsonl``
({"step", "time", scalar...}, the JAX package's file names and records);
``events=True`` also writes TensorBoard scalar events when
``torch.utils.tensorboard`` (which needs the ``tensorboard`` package) can
be imported, and otherwise warns and writes the JSONL alone.
``StepProfiler`` traces steps [start, start + num) with ``torch.profiler``
and writes a Chrome trace into its folder.
"""

import json
import os
import time

from video_learning_tpu_torch.utils import info, warning


class MetricsWriter:
    """Append-only JSONL scalar writer of one run phase, with an optional
    TensorBoard event sink (``events=True``).  ``primary=False`` writes
    nothing: in a group of ranks that share a run folder only global
    rank 0 streams the metrics, which are global (all-rank reductions)."""

    def __init__(self, folder, run_id, timestamp=None, events=False,
                 primary=True):
        self._primary = bool(primary)
        self.path, self._f, self._tb = None, None, None
        if not self._primary:
            return
        os.makedirs(folder, exist_ok=True)
        suffix = ("%s_%s" % (run_id, timestamp)) if timestamp else run_id
        self.path = os.path.join(folder, "metrics_%s.jsonl" % suffix)
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if events:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                warning("logging.tensorboard_events requested but "
                        "torch.utils.tensorboard is not importable; "
                        "writing JSONL only")
            else:
                self._tb = SummaryWriter(folder)
                info("TensorBoard event sink enabled at %s" % folder)

    def write(self, step, **scalars):
        if not self._primary:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                if hasattr(v, "__float__"):
                    self._tb.add_scalar(k, float(v), int(step))

    def flush(self):
        if not self._primary:
            return
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if not self._primary:
            return
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepProfiler:
    """Trace steps [start_step, start_step + num_steps) with
    ``torch.profiler`` (CPU, and CUDA where available) and write
    ``trace_<start>_<stop>.json`` (Chrome trace format) into
    ``out_dir``."""

    def __init__(self, out_dir, start_step, num_steps):
        self.out_dir = out_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._done = False

    def maybe_start(self, step):
        # >= not ==: a resumed run can start past start_step
        if self._prof is None and not self._done and \
                self.start_step <= step < self.stop_step:
            import torch
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            info("Profiler trace started at step %d" % step)

    def maybe_stop(self, step):
        if self._prof is not None and step >= self.stop_step:
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            path = os.path.join(self.out_dir, "trace_%d_%d.json"
                                % (self.start_step, self.stop_step))
            self._prof.export_chrome_trace(path)
            self._prof = None
            self._done = True
            info("Profiler trace written to %s" % path)
