"""Faults planted in the program under test, for the checks' tests and
for reading what the check reads of each (``calibrate.py``).  Each is a
context manager that patches the program while it is open.

The training faults sit on the timed path alone: the steps from the
trainer's ``WARMUP_STEPS`` on, which on the card are replays of the
captured step (the fault is in the capture), and which with graphs off
run eagerly (the fault acts from that step).  The check's first steps,
which run eagerly on the card too, stay sound.

* ``unchanged``: a replayed step leaves the parameters as they were;
* ``half_batch``: a replayed step's loss is the mean over the first
  half of the batch's rows, the rest left out;
* ``altered``: one logit of every serving answer is raised by 1 where
  the call returns it.
"""

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    saved = getattr(owner, name)
    setattr(owner, name, make(saved))
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _timed(engine):
    """Whether the trainer's next step is on the timed path: a replay,
    or with graphs off a step from ``WARMUP_STEPS`` on."""
    from video_learning_tpu_torch.train import WARMUP_STEPS
    return engine._global_step >= WARMUP_STEPS


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def unchanged():
    from video_learning_tpu_torch.train import Train

    def make(run_step):
        def run_step_unchanged(self, feed):
            if not _timed(self):
                return run_step(self, feed)
            before = [p.detach().clone() for p in self._flat.values()]
            out = run_step(self, feed)
            with torch.no_grad():
                for p, b in zip(self._flat.values(), before):
                    p.copy_(b)
            return out
        return run_step_unchanged
    return _patched(Train, "run_step", make)


@contextlib.contextmanager
def half_batch():
    from video_learning_tpu_torch import train
    eager = [False]

    def make_step(run_step):
        def run_step_flagged(self, feed):
            eager[0] = not self.graphs and _timed(self)
            try:
                return run_step(self, feed)
            finally:
                eager[0] = False
        return run_step_flagged

    def make_loss(loss):
        def half_loss(logits, labels, mask=None):
            if not (eager[0] or _capturing()):
                return loss(logits, labels, mask)
            n = logits.shape[0] // 2
            return loss(logits[:n], labels[:n],
                        None if mask is None else mask[:n])
        return half_loss

    with _patched(train.Train, "run_step", make_step), \
            _patched(train, "softmax_cross_entropy", make_loss):
        yield


def altered():
    from video_learning_tpu_torch.serving import ServingModule

    def make(call):
        def altered_call(self, *arrays):
            out = call(self, *arrays).copy()
            out[0, 0] += 1.0
            return out
        return altered_call
    return _patched(ServingModule, "__call__", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
