"""idle_pct.caption_train: the share of the captioner's traced training
window in which no operation ran on the card (100 - busy / window, both
from the profiler's clock)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return 100.0 * run.trace.idle_share()
