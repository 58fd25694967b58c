"""caption_train_items_per_s: captions trained in the window over the
window's length on the host clock (every step ends in the host reading
its metrics back).  The captioner's steps are host-bound (PERF.md), so
its rate spreads more from run to run than the clip classifier's
``train_items_per_s`` and has a bound of its own."""


def read(run):
    if run.kind != "train" or run.trace is not None:
        return None
    return run.calls * run.items / run.window_s
