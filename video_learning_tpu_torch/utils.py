"""Logging, the framework error, small helpers and device resolution for
the PyTorch port.

A short counterpart of ``video_learning_tpu/utils.py``: the same logger
name ("vlt") and the same ``error`` contract (log, mail, then raise
``FrameworkError``), the best-effort email notifier (``prep_email``
asks for the sender's password, ``configure_logging(...,
email_notify)`` turns it on, ``send_email`` mails; ``error`` mails, and
``info`` and ``warning`` do when given ``email=True``), the config
scalar check
``as_num``, the run-folder helpers, ``elapsed_str``, ``sublist``,
``duplicates``, the file readers and the label encoder, without that
module's JAX debug printing.
"""

import logging
import os
import time

import numpy as np

_LOGGER = "vlt"
# (sender, password, recipient) of the email notifier, or None (off);
# set by configure_logging
_email_notify = None


class FrameworkError(Exception):
    """Raised by error(); carries the logged message."""


def send_email(message, message_type):
    """Best-effort email notification (``utils.py:89-110`` of the JAX
    package): the same subject, body, server and call order; off unless
    ``configure_logging`` was given a notifier; a failure is logged and
    ignored."""
    if not _email_notify:
        return
    try:
        import smtplib
        sender, passw, recipient = _email_notify
        subject = "video-learning-tpu | %s : %s" % (os.uname()[1],
                                                    message_type)
        body = "\r\n".join(["To: %s" % recipient, "From: %s" % sender,
                             "Subject: %s" % subject, "", message])
        server = smtplib.SMTP("smtp.gmail.com", 587, timeout=10)
        server.ehlo()
        server.starttls()
        server.login(sender, passw)
        server.sendmail(sender, [recipient], body)
        server.quit()
    except Exception:
        logging.getLogger(_LOGGER).warning(
            "Email notification failed (ignored).")


def prep_email(tofrom):
    """(sender, password, recipient) of a [sender, recipient] pair, the
    password asked for at the terminal."""
    if not tofrom or len(tofrom) != 2:
        error("Need a sender and recipient email address, got [%s]" % tofrom)
    import getpass
    passw = getpass.getpass(
        prompt="Enter password for sender email [%s]: " % tofrom[0])
    return (tofrom[0], passw, tofrom[1])


def error(msg):
    logging.getLogger(_LOGGER).error(msg)
    send_email(str(msg), "ERROR")
    raise FrameworkError(msg)


def as_num(value, field, conv=float, minimum=None):
    """Convert a config scalar, surfacing a typo as a FrameworkError
    naming the field (``int`` refuses a value it would truncate)."""
    try:
        out = conv(value)
        if conv is int and not isinstance(value, bool) and \
                float(value) != out:
            raise ValueError(value)
    except (TypeError, ValueError):
        error("Field [%s] must be a %s, got: [%s]"
              % (field, conv.__name__, value))
    if minimum is not None and out < minimum:
        error("Field [%s] must be >= %s (got %s)" % (field, minimum, out))
    return out


def info(message, email=False):
    logging.getLogger(_LOGGER).info(message)
    if email:
        send_email(message, "INFO")


def warning(message, email=False):
    logging.getLogger(_LOGGER).warning(message)
    if email:
        send_email(message, "WARNING")


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


def configure_logging(logfile, logging_level, email_notify=None):
    """File (when ``logfile`` is given) and console handlers on the "vlt"
    logger at ``logging_level`` (an int or a "logging.INFO"-style
    string); ``email_notify`` ((sender, password, recipient) from
    ``prep_email``, or None) turns the email notifier on or off."""
    global _email_notify
    if isinstance(logging_level, str):
        resolved = getattr(logging, logging_level.split(".")[-1], None)
        if not isinstance(resolved, int):
            error("Invalid logging level: %s" % logging_level)
        logging_level = resolved
    logger = logging.getLogger(_LOGGER)
    logger.setLevel(logging_level)
    for handler in logger.handlers:
        # a log file of an earlier configuration (the packer's, in a
        # temporary folder infer removes) is closed, not leaked
        handler.close()
    logger.handlers = []
    fmt = logging.Formatter("%(asctime)s| %(levelname)7s - %(filename)15s - "
                            "line %(lineno)4d - %(message)s")
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setLevel(logging_level)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    _email_notify = email_notify


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


def get_datetime_str():
    return time.strftime("%d%m%y_%H%M%S")


def elapsed_str(previous_tic, up_to=None):
    """H:MM:SS since ``previous_tic`` (a ``time.time()``)."""
    if up_to is None:
        up_to = time.time()
    m, s = divmod(up_to - previous_tic, 60)
    h, m = divmod(m, 60)
    return "%d:%02d:%02d" % (h, m, s)


def sublist(llist, sublist_length):
    """``llist`` in consecutive chunks of ``sublist_length``."""
    return [llist[i:i + sublist_length]
            for i in range(0, len(llist), sublist_length)]


def duplicates(llist):
    """The set of items that occur more than once in ``llist``."""
    seen, dups = set(), set()
    for x in llist:
        if x in seen:
            dups.add(x)
        seen.add(x)
    return dups


def labels_to_one_hot(labels, num_classes):
    """Multi-hot encode a scalar, a flat list, or a list of per-item label
    lists; returns (num_items, num_classes) int32."""
    if not isinstance(labels, list):
        labels = [labels]
    norm = [[int(x) for x in item]
            if isinstance(item, (list, tuple, np.ndarray)) else [int(item)]
            for item in labels]
    flat = [label for item in norm for label in item]
    if flat and max(flat) >= num_classes:
        error("Encountered label %d but the number of classes is %d"
              % (max(flat), num_classes))
    onehots = np.zeros((len(norm), num_classes), dtype=np.int32)
    for i, item in enumerate(norm):
        onehots[i, item] = 1
    return onehots


def read_file_lines(filename):
    with open(filename, "r") as f:
        return [line.strip() for line in f]


def read_file_dict(filename):
    """key<TAB>value lines -> dict."""
    out = {}
    with open(filename, "r") as f:
        for line in f:
            if not line.strip():
                continue
            key, value = line.strip().split("\t", 1)
            key, value = key.strip(), value.strip()
            if key in out:
                warning("Duplicate key %s in file %s" % (key, filename))
            out[key] = value
    return out


def get_run_checkpoints(run_folder):
    """Checkpoint paths under <run_folder>/checkpoints, oldest first;
    ``best.ckpt`` stays outside the rotation."""
    folder = os.path.join(run_folder, "checkpoints")
    if not os.path.isdir(folder):
        return []
    files = [os.path.join(folder, x) for x in os.listdir(folder)
             if x.endswith(".ckpt") and x != "best.ckpt"]
    return sorted(files, key=os.path.getmtime)


def fold_in(seed, data):
    """A new 63-bit seed derived from ``seed`` and the integer ``data``:
    the port's counterpart of ``jax.random.fold_in`` for torch generator
    seeds (distinct streams per step, micro-batch or pipeline; not JAX's
    bits)."""
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
