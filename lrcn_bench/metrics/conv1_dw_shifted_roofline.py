"""conv1_dw_shifted_roofline: the bound of conv1's weight gradient over a
step's frames (the cropped frames and conv1's output gradient read in
the compute dtype; its multiply-adds at the bf16 rate; the larger) over
the device time a step of the kernels that compute it."""

from lrcn_bench import counts

PATTERN = r"conv1_dw_(wgmma|f32)<true>"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ms = run.trace.device_ms_per_call(PATTERN)
    if ms is None:
        return None
    frames = run.items * run.cfg["frames_per_clip"]
    return 100.0 * counts.conv1_dw_bound_s(run.cfg, frames) * 1e3 / ms
