"""Background batch prefetching: host reads overlap the card's step.

The port's copy of ``video_learning_tpu/data/prefetch.py``: a bounded
producer thread keeps ``depth`` prepared batches ahead of the training
step, so record reads, label framing and (with ``prepare_fn =
Train.prepare_device_feed``) the copy to the card run while the card
executes the previous step.  Each item carries the batch index at
production time, the resume position of that batch while the feeder's
cursor runs ahead.
"""

import queue
import threading

from video_learning_tpu_torch.data.dataset import Dataset
from video_learning_tpu_torch.utils import error, warning


class _Stop:
    pass


class FeedPrefetcher:
    """Iterate one epoch's batches with background preparation.

    prepare_fn(feed, batches) -> feed : optional post-processing hook
    applied in the producer thread.
    """

    def __init__(self, feeder, required_input, prepare_fn=None, depth=2):
        self.feeder = feeder
        self.required_input = required_input
        self.prepare_fn = prepare_fn
        self.depth = max(1, depth)
        # the datasets' reusable read-buffer ring must outlast every
        # batch in flight: producer (1) + queue (depth) + consumer (1).
        # A deeper prefetch would rewrite pixels still queued.
        if self.depth + 2 > Dataset._BUF_RING:
            error("Prefetch depth %d needs a read-buffer ring >= %d "
                  "(Dataset._BUF_RING is %d); raise the ring or lower "
                  "the depth" % (self.depth, self.depth + 2,
                                 Dataset._BUF_RING))

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        exc = []
        cancelled = threading.Event()

        def put(item):
            # a bounded put that notices the consumer leaving, so the
            # producer is never left blocked advancing the shared feeder
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                while not cancelled.is_set() and self.feeder.loop():
                    batch_index = self.feeder.get_batch_index()
                    feed, batches = self.feeder.get_feed(
                        self.required_input)
                    if self.prepare_fn is not None:
                        feed = self.prepare_fn(feed, batches)
                    if not put((feed, batches, batch_index)):
                        return
            except BaseException as ex:  # raised again on the consumer side
                exc.append(ex)
            finally:
                put(_Stop)

        worker = threading.Thread(target=produce, daemon=True,
                                  name="feed-prefetch")
        worker.start()
        try:
            while True:
                item = q.get()
                if item is _Stop:
                    break
                yield item
        finally:
            cancelled.set()
            # never abandon a live producer: one finishing a blocking
            # get_feed after the caller rewinds the feeder would advance
            # the fresh cursors
            worker.join(timeout=30)
            while worker.is_alive():
                warning("Prefetch worker still draining a blocking read; "
                        "waiting before releasing the feeder")
                worker.join(timeout=30)
        if exc:
            raise exc[0]
