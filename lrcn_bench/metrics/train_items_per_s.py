"""train_items_per_s: clips trained in the window over the window's
length on the host clock (every step ends in the host reading its
metrics back)."""


def read(run):
    if run.kind != "train" or run.trace is not None:
        return None
    return run.calls * run.items / run.window_s
