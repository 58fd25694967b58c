"""Batch geometry: padding feeds to stable shapes.

The port's copy of ``video_learning_tpu/batching.py`` over torch tensors.
A ragged batch (the epoch tail, a variable clips-per-video batch) is
padded up to the largest geometry seen so far, with a row-validity
``label_mask``, so every step of a run has the same shapes (what CUDA
graphs need, ROADMAP Queue 1, item 5) and the masked loss and accuracy
of the padded step equal the unpadded one's.
"""

import torch

from video_learning_tpu_torch.utils import info


class BatchGeometry:
    """Per-input target row counts.  The geometry adapts upward: a batch
    larger than any seen grows the target instead of failing."""

    def __init__(self):
        self.target_rows = {}

    def pad_feed(self, feed):
        """Pad every tensor's leading dim to the target geometry, with
        zero rows on the tensor's device.

        Returns (padded_feed, n_valid_label_rows, padding_rows).  A
        caller's ``label_mask`` (e.g. caption word-grid validity) is kept
        and padded; otherwise a mask over the label rows is made.
        """
        out = {}
        grown = []
        for k, v in feed.items():
            if not isinstance(v, torch.Tensor) or v.dim() < 1:
                out[k] = v
                continue
            target = self.target_rows.get(k, 0)
            if v.shape[0] > target:
                if target:
                    grown.append((k, target, v.shape[0]))
                self.target_rows[k] = target = v.shape[0]
            if v.shape[0] < target:
                v = torch.cat([v, v.new_zeros((target - v.shape[0],) +
                                              tuple(v.shape[1:]))])
            out[k] = v
        if grown:
            info("Batch geometry grew: %s" % ["%s %d->%d" % g for g in grown])

        n_valid = feed["labels"].shape[0] if "labels" in feed else 0
        target_labels = self.target_rows.get("labels", n_valid)
        padding = target_labels - n_valid
        if "label_mask" in feed:
            out["label_mask"] = out["label_mask"].to(torch.float32)
        elif "labels" in feed:
            mask = torch.zeros((target_labels,), dtype=torch.float32,
                               device=feed["labels"].device)
            mask[:n_valid] = 1.0
            out["label_mask"] = mask
        return out, n_valid, padding
