"""Audionet: a small CIFAR10-style CNN for audio spectrogram images.

The port's counterpart of ``video_learning_tpu/models/audionet.py``,
plain functions on tensors as ``models/alexnet.py`` is: three conv +
max-pool stages (5x5x64 s1, 5x5x64 s1, 11x11x64 s2, each with a relu and
followed by a 3x3 s2 SAME max pool) -> flatten in NHWC order -> FC to
num_classes.  Parameters carry the JAX names and, through
``checkpoint.from_jax_flat``, its values; no pipeline uses it.
"""

import math

from video_learning_tpu_torch.models.layers import (conv_apply, conv_init,
                                                    fc_apply, fc_init,
                                                    flat_dim, max_pool)

_SPECS = [
    ("conv1", (5, 5, 3, 64), (1, 1)),
    ("conv2", (5, 5, 64, 64), (1, 1)),
    ("conv3", (11, 11, 64, 64), (2, 2)),
]


def _conv_stack(params, x, compute_dtype=None):
    for name, _, strides in _SPECS:
        x = conv_apply(params[name], x, strides, "SAME", relu=True,
                       compute_dtype=compute_dtype)
        x = max_pool(x, (3, 3), (2, 2), "SAME")
    return x


def conv_output_shape(input_shape):
    """(H, W, C) after the conv stack: each SAME conv and each SAME pool
    keeps ceil(size / stride)."""
    h, w = input_shape[0], input_shape[1]
    for _, _, (sh, sw) in _SPECS:
        h = math.ceil(math.ceil(h / sh) / 2)
        w = math.ceil(math.ceil(w / sw) / 2)
    return h, w, _SPECS[-1][1][-1]


def init(generator, input_shape, num_classes, device="cpu"):
    """Parameters for (H, W, C) inputs, drawn from the CPU
    ``torch.Generator`` ``generator`` (the JAX initializers' laws: conv
    weights truncated normal 0.1 with zero biases, the FC's 0.05 with
    biases 0.1), on ``device``."""
    params = {}
    for name, kshape, _ in _SPECS:
        params[name] = conv_init(generator, kshape, device=device)
    params["fc1"] = fc_init(generator,
                            flat_dim(conv_output_shape(input_shape)),
                            num_classes, device=device)
    return params


def apply(params, x, compute_dtype=None):
    """Logits (N, num_classes), float32, of NHWC inputs (N, H, W, C)."""
    x = _conv_stack(params, x, compute_dtype)
    x = x.reshape(x.shape[0], flat_dim(x.shape[1:]))
    return fc_apply(params["fc1"], x, compute_dtype)


def param_groups(params, prefix=""):
    """All audionet layers train at the fresh-layer rate."""
    return [], [prefix + name for name in params]
