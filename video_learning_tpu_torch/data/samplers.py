"""Clip / frame index samplers for offline packing.

The port's copy of ``video_learning_tpu/data/samplers.py``; every draw
comes from the ``random.Random`` it is given, in the JAX package's order,
so one seed packs the same clips in both packages:

* ``rand_frames``  -- one pseudo-clip of fpc randomly chosen frames
  (shuffled in place),
* ``rand_clips``   -- cpv random contiguous fpc-frame windows with
  coverage-aware non-repeating start sampling,
* ``iterative``    -- sequential clips spaced fpc+offset apart.

An under-length video is handled by the abort / compromise / report
strategies (``defs.generation_error``); compromise and report record it
in a ``GenerationLog``.  Imports no torch: the packer's worker processes
use it.
"""

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.utils import error


class GenerationProblem:
    """One recoverable clip-generation problem (message + offending path)."""

    def __init__(self, message, path):
        self.message = message
        self.path = path


class GenerationLog:
    """Collects generation problems for deferred reporting."""

    def __init__(self):
        self.problems = []

    def add(self, message, path):
        self.problems.append(GenerationProblem(message, path))

    def __len__(self):
        return len(self.problems)

    def clear(self):
        self.problems = []


def _handle_shortfall(message, path, strategy, log):
    """Shared abort/report handling; 'compromise' is caller-specific."""
    if strategy == defs.generation_error.abort:
        error(message)
    log.add(message, path)
    if strategy not in (defs.generation_error.compromise,
                        defs.generation_error.report):
        error("Undefined generation error strategy: %s" % strategy)


def sample_rand_frames(num_frames, fpc, rng, path="", strategy=None,
                       log=None):
    """One clip of ``fpc`` random frame indices.  Returns a list of clips
    (0 or 1)."""
    if num_frames == 0:
        error("No frames for path [%s]" % path)
    idxs = list(range(num_frames))
    rng.shuffle(idxs)
    missing = fpc - num_frames
    if missing > 0:
        msg = ("Attempted to get a %d-framed clip from video %s which has "
               "%d frames." % (fpc, path, num_frames))
        _handle_shortfall(msg, path, strategy, log)
        if strategy == defs.generation_error.report:
            return []
        # evaluate the draws BEFORE extending: a lazy generator would
        # re-sample its own freshly appended duplicates
        idxs.extend([rng.choice(idxs) for _ in range(missing)])
    return [idxs[:fpc]]


def sample_rand_clips(num_frames, fpc, cpv, rng, path="", strategy=None,
                      log=None):
    """``cpv`` random contiguous clips with frame-coverage-aware start
    selection: after picking a start, all starts
    whose clip would overlap it are removed from the candidate pool; the
    pool resets when exhausted."""
    if num_frames == 0:
        error("No frames for path [%s]" % path)
    missing_frames = fpc - num_frames
    if missing_frames > 0:
        msg = ("Video %s cannot sustain a number of %d fpc, as it has %d "
               "frames" % (path, fpc, num_frames))
        _handle_shortfall(msg, path, strategy, log)
        if strategy == defs.generation_error.compromise:
            # pad at the front with the first frame, then emit cpv copies
            # of the single realizable clip
            padded = [0] * missing_frames + list(range(num_frames))
            return [list(padded) for _ in range(cpv)]
        # report: fall through so the cpv shortfall is also logged
    possible_starts = list(range(max(0, num_frames - fpc + 1)))
    missing_clips = cpv - len(possible_starts)
    if missing_clips > 0:
        msg = ("Video %s cannot sustain a number of %d cpv as it has %d "
               "frames" % (path, cpv, num_frames))
        _handle_shortfall(msg, path, strategy, log)
        if strategy == defs.generation_error.report:
            return []
        possible_starts.extend([rng.choice(possible_starts)
                                for _ in range(missing_clips)])

    starts = []
    pool = list(possible_starts)
    for _ in range(cpv):
        start = rng.choice(pool)
        starts.append(start)
        lo, hi = start - fpc + 1, start + fpc
        pool = [s for s in pool if not (lo <= s < hi)]
        if not pool:
            pool = list(possible_starts)
    return [list(range(s, s + fpc)) for s in starts]


def sample_iterative(num_frames, fpc, offset, rng=None, path="",
                     strategy=None, log=None):
    """All sequential clips spaced ``fpc + offset`` frames apart."""
    if num_frames == 0:
        error("No frames for path [%s]" % path)
    missing = fpc - num_frames
    frames = list(range(num_frames))
    if missing > 0:
        msg = ("Attempted to get %d-framed sequential clips from video %s "
               "which has %d frames." % (fpc, path, num_frames))
        _handle_shortfall(msg, path, strategy, log)
        if strategy == defs.generation_error.report:
            return []
        frames.extend([rng.choice(frames) for _ in range(missing)])
        num_frames = len(frames)
    stride = fpc + offset
    starts = range(0, num_frames - fpc + 1, stride)
    return [frames[s:s + fpc] for s in starts]


def sample_clips(num_frames, mode, fpc, clip_offset_or_num, rng, path="",
                 strategy=None, log=None):
    """Dispatch on clipframe_mode."""
    if mode == defs.clipframe_mode.rand_frames:
        return sample_rand_frames(num_frames, fpc, rng, path, strategy, log)
    if mode == defs.clipframe_mode.rand_clips:
        return sample_rand_clips(num_frames, fpc, clip_offset_or_num, rng,
                                 path, strategy, log)
    if mode == defs.clipframe_mode.iterative:
        return sample_iterative(num_frames, fpc, clip_offset_or_num, rng,
                                path, strategy, log)
    error("Unknown clipframe mode: %s" % mode)
