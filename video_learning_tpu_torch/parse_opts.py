"""Config scalar / sequence parsing: the port's copy of
``video_learning_tpu/parse_opts.py``.

Config values may be Python-literal strings ("(227, 227, 3)", "[1, 2]"),
plain scalars, or already-parsed YAML lists; ``parse_seq`` normalizes all of
them to a list, and ``parse_scalar`` to a scalar.
"""

import ast

from video_learning_tpu_torch.utils import error


def _literal(value):
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def parse_seq(value):
    """Parse a config value into a list."""
    if value is None:
        return None
    if isinstance(value, (list, tuple)):
        return list(value)
    if isinstance(value, str):
        text = value.strip()
        parsed = _literal(text)
        if isinstance(parsed, (list, tuple)):
            return list(parsed)
        if text.startswith(("[", "(")) and text.endswith(("]", ")")):
            # bracketed list of non-literal tokens (e.g. defs.* strings):
            # split on commas and parse each element individually
            return [_literal(tok.strip())
                    for tok in text[1:-1].split(",") if tok.strip()]
        return [parsed]
    return [value]


def parse_scalar(value):
    if value is None:
        return None
    if isinstance(value, str):
        return _literal(value.strip())
    return value


def parse_shape(value):
    """Parse an image/tensor shape spec into a tuple of ints, or None."""
    seq = parse_seq(value)
    if seq is None:
        return None
    try:
        return tuple(int(x) for x in seq)
    except (TypeError, ValueError):
        error("Invalid shape specification: %s" % str(value))
