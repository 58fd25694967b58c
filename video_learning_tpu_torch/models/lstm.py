"""Stacked BasicLSTMCell sequence evaluation and caption decoding.

Counterpart of ``video_learning_tpu/models/lstm.py``.  The cell is
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
torch around the step.

Caption decoding (``greedy_decode``, ``beam_decode``) feeds each step's
choice back as the next input: a Python loop over T whose step runs, per
layer, the input projection x @ Wx as a float32 matmul and one
``lstm_step`` call (the kernel for CUDA tensors), then the output FC.
It needs no gradient and runs under ``torch.no_grad()``, so that live
training parameters (which require gradients) may be passed.  Nothing
in the loop reads a tensor back to the host.

On a mesh a layer whose fused kernel is split over the model axis
carries a ``TensorParallel`` mark (``parallel/sharding.py``).  The
kernel needs all four gates of a unit, which a column slice does not
hold, so the layer's kernel is gathered once per forward or decode,
before the loop over T (``sharding.whole``; its gradient is each rank's
own slice), and the step runs whole on every rank.  A split
``output_fc`` gathers its logits before the argmax, the top-K and the
log-softmax.
"""

import torch

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.models.layers import fc_apply, truncated_normal
from video_learning_tpu_torch.ops.lstm_step import LSTMStepFunction, lstm_step
from video_learning_tpu_torch.parallel.sharding import whole
from video_learning_tpu_torch.utils import error


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
        layer = whole(layer)
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


# ----------------------------------------------------------- caption decode
def _cell_forward(params, x, states):
    """One step of the stacked cell on the input x (B, D); states is a
    list of (c, h) per layer.  Returns (top layer's h, new states)."""
    seq_in = x
    new_states = []
    for l, layer in enumerate(params["cells"]):
        wx, wh = _split_kernel(layer, seq_in.shape[-1])
        xproj = torch.matmul(seq_in, wx)
        c, h = states[l]
        new_h, new_c = lstm_step(xproj, h, c, wh, layer["b"])
        new_states.append((new_c, new_h))
        seq_in = new_h
    return seq_in, new_states


@torch.no_grad()
def greedy_decode(params, out_fc_params, visual, embedding_matrix,
                  bos_index, sequence_len, num_hidden, visual_mode,
                  return_type=None):
    """Batched greedy caption decoding, all in float32.

    visual: (B, Dv) visual encodings.  visual_mode:
    defs.rnn_visual_mode.state_bias (visual as every layer's initial
    (c, h)), input_concat (visual concatenated to every step's word
    input) or input_bias (visual fed as an extra first step, whose
    emission is dropped).
    embedding_matrix: (V, E) tensor on the decode's device.
    return_type: defs.return_type.argmax_index (default) returns (B, T)
    int32 word indices; defs.return_type.standard also returns the
    per-step logits (B, T, V)."""
    if return_type is None:
        return_type = defs.return_type.argmax_index
    if return_type not in defs.return_type:
        error("Undefined lstm return type [%s]" % return_type)
    want_logits = return_type == defs.return_type.standard
    params = {"cells": [whole(layer) for layer in params["cells"]]}
    num_layers = len(params["cells"])
    emb = embedding_matrix
    emb_dim = emb.shape[1]
    visual = visual.to(torch.float32).contiguous()
    batch = visual.shape[0]
    if visual_mode == defs.rnn_visual_mode.state_bias:
        states = state_from_vector(visual, num_layers)
    else:
        states = zero_state(batch, num_hidden, num_layers, device=emb.device)
    input_bias = visual_mode == defs.rnn_visual_mode.input_bias
    steps = sequence_len + 1 if input_bias else sequence_len

    bos = emb[bos_index].expand(batch, emb_dim)
    word_vec = bos
    indices, logits_t = [], []
    for t in range(steps):
        if visual_mode == defs.rnn_visual_mode.input_concat:
            x = torch.cat([word_vec, visual], dim=1)
        elif input_bias:
            # t = 0 feeds the visual vector, t = 1 the BOS, then feedback
            x = _pad_to(visual, emb_dim) if t == 0 else \
                bos if t == 1 else word_vec
        else:       # state_bias: plain word inputs
            x = word_vec
        out, states = _cell_forward(params, x, states)
        logits = fc_apply(out_fc_params, out)
        word_index = torch.argmax(logits, dim=1)
        word_vec = emb[word_index]
        indices.append(word_index)
        if want_logits:
            logits_t.append(logits)
    first = 1 if input_bias else 0
    indices = torch.stack(indices[first:], dim=1).to(torch.int32)
    if want_logits:
        return indices, torch.stack(logits_t[first:], dim=1)
    return indices


def _pad_to(x, dim):
    """Zero-pad the trailing dim to ``dim`` (input_bias feeds the visual
    vector through the word-embedding input).  A wider visual is an
    error, not a truncation."""
    cur = x.shape[-1]
    if cur == dim:
        return x
    if cur > dim:
        error("input_bias visual dim %d exceeds the embedding dim %d; "
              "project the visual down first (pipeline state_fc)"
              % (cur, dim))
    return torch.nn.functional.pad(x, (0, dim - cur))


def _top_k(x, k):
    """The k largest entries of each row of x and their indices, in the
    order of ``jax.lax.top_k``: larger first and, among equal values, the
    lower index first (``torch.topk`` makes no promise about ties)."""
    values, order = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], order[:, :k]


@torch.no_grad()
def beam_decode(params, out_fc_params, visual, embedding_matrix, bos_index,
                eos_index, sequence_len, num_hidden, visual_mode,
                beam_width=4, length_norm=0.0):
    """Batched beam-search caption decoding, all in float32.

    Per step all B*K beams run through the cell as one batch, the top K of
    the (K * V) continuation scores of each item select the next beams,
    and states and tokens follow their source beams.  A finished beam
    (one that emitted EOS) may only continue with EOS, at no cost.  With
    ``length_norm`` > 0 the final scores are divided by (tokens up to and
    including the first EOS, at most T) ** length_norm.  The visual modes
    are greedy_decode's; input_bias feeds the visual through the cell
    once before the loop.  Returns (B, T) int32 tokens of each item's
    best beam."""
    params = {"cells": [whole(layer) for layer in params["cells"]]}
    num_layers = len(params["cells"])
    emb = embedding_matrix
    V, emb_dim = emb.shape
    visual = visual.to(torch.float32)
    B = visual.shape[0]
    K = beam_width
    NEG = -1e9
    device = emb.device

    def expand(x):          # (B, ...) -> (B*K, ...)
        return torch.repeat_interleave(x, K, dim=0)

    vis_k = None
    if visual_mode == defs.rnn_visual_mode.state_bias:
        states = state_from_vector(expand(visual), num_layers)
    elif visual_mode == defs.rnn_visual_mode.input_concat:
        states = zero_state(B * K, num_hidden, num_layers, device=device)
        vis_k = expand(visual)
    elif visual_mode == defs.rnn_visual_mode.input_bias:
        states = zero_state(B * K, num_hidden, num_layers, device=device)
        # pre-roll the visual step: the state advances, the output is
        # never scored
        _, states = _cell_forward(params, _pad_to(expand(visual), emb_dim),
                                  states)
    else:
        error("Undefined rnn visual mode [%s]" % visual_mode)

    word = emb[bos_index].expand(B * K, emb_dim)
    # only beam 0 is live at first (all beams are identical otherwise).
    # Fills, not assignments of a Python number: an item assignment
    # copies a host scalar to the card, which a CUDA graph capture
    # refuses
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    scores[:, 0].fill_(0.0)
    scores = scores.reshape(-1)
    finished = torch.zeros((B * K,), dtype=torch.bool, device=device)
    tokens = torch.zeros((B * K, sequence_len), dtype=torch.int64,
                         device=device)
    eos_only = torch.full((V,), NEG, dtype=torch.float32, device=device)
    eos_only[eos_index].fill_(0.0)
    item_base = torch.arange(B, device=device)[:, None] * K
    for t in range(sequence_len):
        x = word if vis_k is None else torch.cat([word, vis_k], dim=1)
        out, new_states = _cell_forward(params, x, states)
        logp = torch.log_softmax(fc_apply(out_fc_params, out), dim=-1)
        logp = torch.where(finished[:, None], eos_only[None, :], logp)
        cand = (scores[:, None] + logp).reshape(B, K * V)
        top_scores, top_idx = _top_k(cand, K)
        word_idx = (top_idx % V).reshape(-1)
        src = (item_base + top_idx // V).reshape(-1)
        states = [(c.index_select(0, src), h.index_select(0, src))
                  for c, h in new_states]
        tokens = tokens.index_select(0, src)
        tokens[:, t] = word_idx
        finished = finished.index_select(0, src) | (word_idx == eos_index)
        word = emb.index_select(0, word_idx)
        scores = top_scores.reshape(-1)

    scores = scores.reshape(B, K)
    tokens = tokens.reshape(B, K, sequence_len)
    if length_norm > 0:
        lengths = torch.clamp(
            torch.cumprod((tokens != eos_index).to(torch.int32), dim=-1)
            .sum(-1) + 1, max=sequence_len)
        scores = scores / torch.pow(lengths.to(torch.float32), length_norm)
    best = torch.argmax(scores, dim=1)
    return tokens[torch.arange(B, device=device), best].to(torch.int32)
