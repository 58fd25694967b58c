"""The traffic generator: every input of a run, made from its seed.

A traffic file (``traffic/<mix>.json``) gives the parameters; this one
generator reads them for every configuration:

* ``kind``: "train" (the training step) or "infer" (the serving call);
* ``items``: clips or captions a call; ``pool``: distinct batches made
  in set-up and cycled through the window;
* ``crop``: "random" (a host draw per frame and step, as the feeder
  draws) or "center"; ``mirror``: "random" or "none".

Frames are uint8 (N, H, W, 3) made on the card in one call from a
``torch.Generator`` seeded with ``seeds[0]``.  Labels, caption lengths,
words and random crops come from a numpy generator seeded with
``seeds[1]``.  Every seed gives the same shapes; only the values
differ.
"""

import numpy as np
import torch

# the trainer's feed names for the frames and their crop parameters
FRAMES = "frames_main_input"
PROC = FRAMES + "/proc_params"


def _frames(cfg, count, gen, device):
    h, w = cfg["raw_hw"]
    return torch.randint(0, 256, (count, h, w, 3), generator=gen,
                         device=device, dtype=torch.uint8)


class Traffic:
    """The inputs of one run: ``pool`` batches of ``items`` items, and the
    host's per-step crop draws."""

    def __init__(self, cfg, traffic, seeds, device, embedding=None):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.items = traffic["items"]
        self.frames_per_item = cfg["frames_per_clip"]
        self.rows = self.items * self.frames_per_item
        self.host = np.random.default_rng(seeds[1])
        gen = torch.Generator(device=device)
        gen.manual_seed(seeds[0])
        pool = traffic["pool"]
        frames = _frames(cfg, pool * self.rows, gen, device)
        self.frames = list(frames.split(self.rows))
        self.embedding = embedding
        self.batches = ([self._labels() for _ in range(pool)]
                        if traffic["kind"] == "train" else [])
        self.center = self._center_crops()

    # ------------------------------------------------------------ labels
    def _labels(self):
        """One batch's labels: one-hot classes, or a caption grid."""
        cfg, dev = self.cfg, self.device
        if cfg["task"] != "caption":
            ids = self.host.integers(0, cfg["num_classes"], self.items)
            onehot = torch.zeros(self.items, cfg["num_classes"],
                                 dtype=torch.int32, device=dev)
            onehot[torch.arange(self.items, device=dev),
                   torch.as_tensor(ids, device=dev)] = 1
            return {"labels": onehot}
        cap = cfg["caption"]
        T, V = cap["max_T"], cfg["num_classes"]
        B = self.items
        lengths = self.host.integers(1, T, B)       # caption words
        words = np.full((B, T), -1, np.int64)       # input ids on the grid
        targets = np.full((B, T), -1, np.int64)     # label ids on the grid
        for b, n in enumerate(lengths):
            toks = self.host.integers(0, V - 3, n)
            words[b, 0] = cap["bos_index"]
            words[b, 1:n + 1] = toks
            targets[b, :n] = toks
            targets[b, n] = cap["eos_index"]
        words_t = torch.as_tensor(words.reshape(-1), device=dev)
        targets_t = torch.as_tensor(targets.reshape(-1), device=dev)
        valid = targets_t >= 0
        grid = self.embedding[words_t.clamp(min=0)] * \
            (words_t >= 0)[:, None].to(torch.float32)
        onehot = torch.zeros(B * T, V, dtype=torch.int32, device=dev)
        rows = torch.nonzero(valid)[:, 0]
        onehot[rows, targets_t[rows]] = 1
        mask = valid.to(torch.float32)
        return {"labels": onehot, "caption_words": grid,
                "caption_lengths": torch.as_tensor(lengths + 1,
                                                   dtype=torch.int32,
                                                   device=dev),
                "caption_mask": mask.reshape(B, T),
                "label_mask": mask}

    # ------------------------------------------------------------- crops
    def _center_crops(self):
        h, w = self.cfg["raw_hw"]
        size = self.cfg["image"]
        crops = torch.zeros(self.rows, 3, dtype=torch.int32)
        crops[:, 0] = (h - size) // 2
        crops[:, 1] = (w - size) // 2
        return crops.to(self.device)

    def draw_crops(self):
        """(rows, 3) int32 (y, x, mirror) of one step, drawn on the host:
        random offsets over the raw frame, a random mirror flag, or the
        center window unmirrored, by the traffic's ``crop`` and
        ``mirror``."""
        t = self.traffic
        if t.get("crop", "center") == "center":
            return self.center
        h, w = self.cfg["raw_hw"]
        size = self.cfg["image"]
        crops = np.zeros((self.rows, 3), np.int32)
        crops[:, 0] = self.host.integers(0, h - size + 1, self.rows)
        crops[:, 1] = self.host.integers(0, w - size + 1, self.rows)
        if t.get("mirror", "none") == "random":
            crops[:, 2] = self.host.integers(0, 2, self.rows)
        return torch.from_numpy(crops)

    # -------------------------------------------------------------- feeds
    def train_feed(self, k, crops):
        """The trainer's feed for pool batch ``k`` with these crops."""
        feed = {FRAMES: self.frames[k], PROC: crops}
        feed.update(self.batches[k])
        return feed

    def infer_args(self, k):
        """The serving call's positional arrays for pool batch ``k``."""
        return self.frames[k], self.center
