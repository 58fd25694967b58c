"""Stacked BasicLSTMCell sequence evaluation.

Counterpart of ``video_learning_tpu/models/lstm.py:33-141``.  The cell is
BasicLSTMCell-compatible: gate order i, j, f, o, forget bias +1, one
fused (D + H, 4H) kernel per layer split into its input and recurrent
parts.  ``torch.nn.LSTM`` cannot stand in (its gate order, bias and
weight layout differ).

The input projection x @ Wx for all timesteps is hoisted out of the
recurrence into one matrix product; the recurrence is a Python loop over
T whose step is the ``lstm_step`` CUDA kernel for CUDA tensors (its
plain version on the CPU), through ``LSTMStepFunction`` so that training
differentiates it.  Length masks freeze the state and zero the
outputs past each sequence's length (``dynamic_rnn`` semantics), in plain
torch around the step.  Caption decoding (greedy / beam) is not ported
yet.
"""

import torch

from video_learning_tpu_torch.models.layers import truncated_normal
from video_learning_tpu_torch.ops.lstm_step import LSTMStepFunction


def init(generator, input_dim, num_hidden, num_layers, device="cpu"):
    """Per layer one fused kernel w: (D_l + H, 4H) and bias b: (4H,)."""
    layers = []
    for l in range(num_layers):
        d = input_dim if l == 0 else num_hidden
        layers.append({
            "w": truncated_normal(generator, (d + num_hidden, 4 * num_hidden),
                                  stddev=0.05, device=device),
            "b": torch.zeros((4 * num_hidden,), dtype=torch.float32,
                             device=device),
        })
    return {"cells": layers}


def zero_state(batch_size, num_hidden, num_layers, device="cpu"):
    z = torch.zeros((batch_size, num_hidden), dtype=torch.float32,
                    device=device)
    return [(z, z) for _ in range(num_layers)]


def state_from_vector(vec, num_layers):
    """One (B, H) vector as every layer's (c, h)."""
    return [(vec, vec) for _ in range(num_layers)]


def _split_kernel(layer_params, input_dim):
    w = layer_params["w"]
    return w[:input_dim, :], w[input_dim:, :]


def evaluate_sequence(params, x, num_hidden, sequence_len, lengths=None,
                      init_state=None, compute_dtype=None):
    """Run the stacked LSTM over a (N*T, D) input laid out frames-first.

    lengths: optional (N,) per-sequence valid lengths.
    init_state: optional (N, H) vector used as every layer's (c, h).
    Returns (outputs (N, T, H) float32, final_states list[(c, h)])."""
    input_dim = x.shape[-1]
    num_layers = len(params["cells"])
    x = x.reshape(-1, sequence_len, input_dim)
    batch = x.shape[0]

    if init_state is not None:
        if init_state.dim() == 1:
            init_state = init_state[None, :]
        states = state_from_vector(init_state, num_layers)
    else:
        states = zero_state(batch, num_hidden, num_layers, device=x.device)

    mask_t = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device)
        t_idx = torch.arange(sequence_len, device=x.device)[:, None]
        mask_t = (t_idx < lengths[None, :]).to(torch.float32)[..., None]

    seq = x
    final_states = []
    for l, layer in enumerate(params["cells"]):
        wx, wh = _split_kernel(layer, seq.shape[-1])
        mm_in = seq
        if compute_dtype is not None:
            mm_in = mm_in.to(compute_dtype)
            wx = wx.to(compute_dtype)
        # hoisted input projection, float32 result: (T, B, 4H)
        xproj = torch.matmul(mm_in.to(torch.float32), wx.to(torch.float32))
        xproj_t = xproj.transpose(0, 1).contiguous()
        wh = wh.to(torch.float32).contiguous()
        b = layer["b"].to(torch.float32).contiguous()
        c, h = (s.to(torch.float32).contiguous() for s in states[l])
        outs = []
        for t in range(sequence_len):
            new_h, new_c = LSTMStepFunction.apply(xproj_t[t], h, c, wh, b)
            if mask_t is not None:
                m = mask_t[t]
                new_h = torch.where(m > 0, new_h, h)
                new_c = torch.where(m > 0, new_c, c)
                outs.append(new_h * m)
            else:
                outs.append(new_h)
            c, h = new_c, new_h
        seq = torch.stack(outs, dim=1)
        final_states.append((c, h))
    return seq, final_states
