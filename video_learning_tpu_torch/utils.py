"""Logging, the framework error, and device resolution for the PyTorch port.

A short counterpart of ``video_learning_tpu/utils.py``: the same logger
name ("vlt") and the same ``error`` contract (log, then raise
``FrameworkError``), without that module's email notifier or its JAX
debug printing.
"""

import logging

_LOGGER = "vlt"


class FrameworkError(Exception):
    """Raised by error(); carries the logged message."""


def error(msg):
    logging.getLogger(_LOGGER).error(msg)
    raise FrameworkError(msg)


def info(message):
    logging.getLogger(_LOGGER).info(message)


def warning(message):
    logging.getLogger(_LOGGER).warning(message)


def debug(message):
    logging.getLogger(_LOGGER).debug(message)


_ONCE_SEEN = set()


def warning_once(message, key=None):
    """``warning`` deduplicated on ``key`` (default: the message text)."""
    key = message if key is None else key
    if key in _ONCE_SEEN:
        return
    _ONCE_SEEN.add(key)
    warning(message)


def ensure_console_logging(level=logging.INFO):
    """Give standalone CLI tools a console handler so info() output is
    visible without a full run configuration."""
    logger = logging.getLogger(_LOGGER)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s| %(levelname)7s - "
                                         "%(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)


def fold_in(seed, data):
    """A new 63-bit seed derived from ``seed`` and the integer ``data``:
    the port's counterpart of ``jax.random.fold_in`` for torch generator
    seeds (distinct streams per step, micro-batch or pipeline; not JAX's
    bits)."""
    import numpy as np
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def resolve_device(device="cuda"):
    """The torch.device an entry point runs on.  The port's entry points
    default to the GPU; asking for CUDA where there is none raises rather
    than falling back to the CPU (pass ``device="cpu"`` for that)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        error("device %r requested but torch.cuda.is_available() is False; "
              "pass device='cpu' to run on the CPU" % str(device))
    return dev
