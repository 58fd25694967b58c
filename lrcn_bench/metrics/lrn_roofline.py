"""lrn_roofline: the bound of both LRNs' forward over a call's frames (x
read, y written, in the compute dtype, at the HBM rate) over the device
time a call of the kernels that compute it."""

from lrcn_bench import counts

PATTERN = r"lrn_fwd_(vec_)?kernel<"


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_ms_per_call(PATTERN)
    if ms is None:
        return None
    frames = run.items * run.cfg["frames_per_clip"]
    return 100.0 * counts.lrn_forward_bound_s(run.cfg, frames) * 1e3 / ms
