"""Weights made on the card from the run's seed, in one draw.

Every leaf of the program's parameter tree (names and shapes as the
program declares them, checked against the configuration) is cut from
one float32 ``randn`` of a ``torch.Generator`` on the device and scaled:
a weight by ``gain / sqrt(fan_in)`` with the gain of the longest prefix
in the configuration's ``init.weight_gain``, a bias by
``init.bias_std``.  The leaves keep the memory format the program gives
its own (channels_last convolution kernels).  The same flat dict goes to
the program and, after the window, to the reference.
"""

import math

import torch

from lrcn_bench import counts


def expected_shapes(cfg):
    """{name: shape} that the configuration's widths give the model."""
    pre = cfg["param_prefix"]
    enc, head = pre["encoder"], pre["head"]
    shapes = {}
    for layer in counts.encoder_layers(cfg):
        name = enc + layer["name"]
        if layer["kind"] == "conv":
            k = layer["kernel"]
            shapes[name + "/w"] = (layer["cout"], layer["cin"] //
                                   layer["groups"], k, k)
        else:
            shapes[name + "/w"] = (layer["cin"], layer["cout"])
        shapes[name + "/b"] = (layer["cout"],)
    D, H = counts.feature_dim(cfg), cfg["lstm"]["hidden"]
    d = D
    if cfg["task"] == "caption":
        shapes[head + "state_fc/w"] = (D, H)
        shapes[head + "state_fc/b"] = (H,)
        d = cfg["caption"]["embedding_dim"]
    for l in range(cfg["lstm"]["layers"]):
        shapes["%slstm/cells/%d/w" % (head, l)] = (d + H, 4 * H)
        shapes["%slstm/cells/%d/b" % (head, l)] = (4 * H,)
        d = H
    shapes[head + "output_fc/w"] = (H, cfg["num_classes"])
    shapes[head + "output_fc/b"] = (cfg["num_classes"],)
    return shapes


def _std(cfg, name, shape):
    init = cfg["init"]
    if len(shape) == 1:
        return init["bias_std"]
    fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
    gains = init["weight_gain"]
    prefix = max((p for p in gains if name.startswith(p)), key=len)
    return gains[prefix] / math.sqrt(fan_in)


def make(cfg, program_leaves, seed, device):
    """{name: float32 tensor on ``device``}: ``program_leaves`` is the
    program's {name: tensor} on the meta device (shapes and strides)."""
    want = expected_shapes(cfg)
    got = {n: tuple(t.shape) for n, t in program_leaves.items()}
    if got != want:
        raise ValueError("the program's parameters %s differ from the "
                         "configuration's %s"
                         % (sorted(set(got.items()) ^ set(want.items())),
                            cfg["name"]))
    names = sorted(want)
    sizes = [math.prod(want[n]) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for n, size in zip(names, sizes):
        leaf = torch.empty_like(program_leaves[n], device=device,
                                dtype=torch.float32)
        leaf.copy_(flat[off:off + size].view(want[n]) *
                   _std(cfg, n, want[n]))
        out[n] = leaf
        off += size
    return out


def embedding(cfg, seed, device):
    """The captioner's (V, E) word embeddings, drawn on the card."""
    cap = cfg["caption"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return cap["embedding_std"] * torch.randn(
        cfg["num_classes"], cap["embedding_dim"], generator=gen,
        device=device)
