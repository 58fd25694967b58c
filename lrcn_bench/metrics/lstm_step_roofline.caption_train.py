"""lstm_step_roofline.caption_train: the bound of a captioner's training
step's forward LSTM cell steps (each: the input projection, h, c, the
recurrent kernel and bias read and h, c written in float32, or its
h @ Wh product at the TF32 rate, the larger) over the device time a step
of the kernel that computes them."""

from lrcn_bench import counts

PATTERN = r"lstm_step_wgmma\b"


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_ms_per_call(PATTERN)
    if ms is None:
        return None
    bound = sum(counts.lstm_step_bound_s(rows, hidden) for rows, hidden in
                counts.lstm_steps_of_call(run.cfg, run.traffic))
    return 100.0 * bound * 1e3 / ms
