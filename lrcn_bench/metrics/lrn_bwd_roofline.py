"""lrn_bwd_roofline: the bound of both LRNs' input gradient over a step's
frames (x and the output gradient read, the input gradient written, in
the compute dtype, at the HBM rate) over the device time a step of the
kernels that compute it."""

from lrcn_bench import counts

PATTERN = r"lrn_bwd_(vec_)?kernel<"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ms = run.trace.device_ms_per_call(PATTERN)
    if ms is None:
        return None
    frames = run.items * run.cfg["frames_per_clip"]
    return 100.0 * counts.lrn_backward_bound_s(run.cfg, frames) * 1e3 / ms
