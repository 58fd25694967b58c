"""One profiled window, reduced to what the per-layer metrics read.

The traced run profiles one steady stretch of calls in one
``torch.profiler`` session (CPU and CUDA activities), inside a
``bench.window`` range that the harness opens.  From its events:

* ``kernels``: every device record (kernels, copies, sets) in the
  window as (name, microseconds);
* ``busy_s``: the union of the device records' intervals in the window;
  ``window_s``: the window range's length on the same clock;
* ``breakdown``: the device operations that took the most time, and the
  idle gaps of the device summed by what the host was doing in them (the
  harness's own range, then the innermost host event open at the gap's
  middle).
"""

import collections
import re

from torch.autograd import DeviceType

WINDOW = "bench.window"
TOP = 10


def _interval(e):
    return e.time_range.start, e.time_range.end


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The reduction of one profile (``prof.events()``) over ``calls``
    calls of the window."""

    def __init__(self, events, calls):
        self.calls = calls
        windows = [e for e in events if e.name == WINDOW
                   and e.device_type == DeviceType.CPU]
        if not windows:
            raise RuntimeError("the profile has no %s range" % WINDOW)
        w0, w1 = _interval(windows[0])
        self.window_s = (w1 - w0) / 1e6
        device, host = [], []
        for e in events:
            s, t = _interval(e)
            if t <= w0 or s >= w1:
                continue
            if e.device_type != DeviceType.CUDA:
                host.append((e.name, s, t))
            elif not e.name.startswith("bench."):
                # (the harness's ranges are mirrored on the device side)
                device.append((e.name, max(s, w0), min(t, w1)))
        self.kernels = [(n, t - s) for n, s, t in device]
        busy = _merge([(s, t) for _, s, t in device])
        self.busy_s = sum(t - s for s, t in busy) / 1e6
        self._busy = busy
        self._host = host
        self._w = (w0, w1)

    def device_ms_per_call(self, pattern):
        """Device milliseconds a call in records whose name matches the
        regular expression ``pattern``, or None where none does."""
        rx = re.compile(pattern)
        us = [d for n, d in self.kernels if rx.search(n)]
        if not us:
            return None
        return sum(us) / 1e3 / self.calls

    def count_per_call(self, pattern):
        rx = re.compile(pattern)
        return sum(1 for n, _ in self.kernels if rx.search(n)) / self.calls

    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def _gaps(self):
        edges = [self._w[0]]
        for s, t in self._busy:
            edges += [s, t]
        edges.append(self._w[1])
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    @staticmethod
    def _name(spans):
        """The harness's innermost range and the innermost host event of
        the events ``spans`` open at one moment."""
        if not spans:
            return "nothing"
        inner = min(spans, key=lambda x: x[2] - x[1])
        outer = [x for x in spans if x[0].startswith("bench.")]
        if outer:
            mine = min(outer, key=lambda x: x[2] - x[1])
            if mine is not inner:
                return mine[0] + "/" + inner[0]
        return inner[0]

    def _gap_names(self):
        """[(name, seconds)] of every idle gap, by one sweep over the host
        events in start order."""
        host = sorted(self._host, key=lambda x: x[1])
        out, active, i = [], [], 0
        for s, t in self._gaps():
            mid = (s + t) / 2
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [x for x in active if x[2] >= mid]
            out.append((self._name(active), (t - s) / 1e6))
        return out

    def breakdown(self):
        ops = collections.Counter()
        for n, d in self.kernels:
            ops[n[:160]] += d / 1e6
        gaps = collections.Counter()
        for name, sec in self._gap_names():
            gaps[name] += sec
        return {"device_ops": [[n, v] for n, v in ops.most_common(TOP)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(TOP)]}
