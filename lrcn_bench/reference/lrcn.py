"""Plain float32 LRCN (Donahue et al. 2015, arXiv:1411.4389): AlexNet to
fc7 over each frame, a stacked LSTM over the frames, and either a clip
classifier (average fusion over time, one output FC) or a captioner (the
visual vector through ``state_fc`` as every layer's initial (c, h), word
embeddings in, an output FC over the vocabulary).

Written from the published model and the configuration file alone, in
plain PyTorch, with no kernel, cache or batching of the program:

* frames: uint8 (N, H, W, 3) BGR, cropped at the given offsets,
  mean-subtracted, mirrored where the flag is set;
* AlexNet as the configuration lists it: TF ``SAME`` convolutions with
  ReLU, cross-channel LRN ``x / (bias + alpha * sum x^2) ** beta``, 3x3
  stride-2 VALID max pools, pool5 flattened in (H, W, C) order, fc6 and
  fc7 with ReLU;
* LSTM cell with gate order (i, j, f, o) and forget bias +1, one fused
  (D + H, 4H) kernel per layer; steps past a sequence's length keep the
  state and emit zeros;
* softmax cross-entropy, mean over the rows a mask keeps; plain SGD after
  a global-norm clip.

Every product runs in float32 with TF32 off (``exact_float32``).  The
``rnd`` argument of the model functions sets the precision of every
convolution and matrix product: ``rnd(x)`` is an operand as the product
takes it and ``rnd.out(y)`` the product's output.  ``identity`` leaves
both as they are (the reference); ``fake_fp8`` is the same model one
precision below bfloat16, for the control.

Parameters are a flat {name: tensor} dict under the checkpoint names
that the configuration's ``param_prefix`` gives: convolution weights
OIHW, dense weights (in, out).
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e9


@contextlib.contextmanager
def exact_float32():
    """Float32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _Exact:
    """Float32 operands and outputs, as they are."""

    def __call__(self, x):
        return x

    def out(self, y):
        return y


def _to_fp8(x, dtype, top):
    """x rounded to ``dtype`` under one per-tensor scale (amax to
    ``top``), back in float32."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand in float8 e4m3; backward: straight through."""

    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8OutputGrad(torch.autograd.Function):
    """Forward: as it is; backward: the gradient of a product's output,
    which the backward's products take as an operand, in float8 e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, 57344.0)


class _Fp8:
    """Every product in float8, as fp8 training runs its GEMMs: forward
    operands e4m3, the output's gradient e5m2 in the backward's products,
    float32 accumulation and outputs (weight gradients too)."""

    def __call__(self, x):
        return _Fp8Operand.apply(x)

    def out(self, y):
        return _Fp8OutputGrad.apply(y)


identity = _Exact()
fake_fp8 = _Fp8()


# ------------------------------------------------------------- dropout
def fold_in(seed, data):
    """A 63-bit seed derived from ``seed`` and the integer ``data`` by
    numpy's SeedSequence: the derivation by which the trainer seeds its
    dropout generators (a frozen copy, so that the masks can be drawn
    again here)."""
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def dropout_keep(train_seed, step, pipeline, shape, keep_prob, device):
    """The keep mask of training step ``step`` (0-based) of the trainer
    seeded with ``train_seed``, for the dropout of pipeline index
    ``pipeline``: one uniform float32 draw per unit from a generator on
    ``device`` seeded with fold_in(fold_in(train_seed + 1, step),
    pipeline), kept where below ``keep_prob``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(fold_in(train_seed + 1, step), pipeline))
    return torch.rand(tuple(shape), generator=gen, device=device) < keep_prob


def apply_dropout(x, keep, keep_prob):
    if keep is None:
        return x
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


# --------------------------------------------------------------- frames
def preprocess(frames, crops, mean_bgr, out_hw, mirror):
    """uint8 (N, H, W, 3) frames -> float32 (N, h, w, 3): the window at
    each row's (y, x) offset, minus the per-channel mean, flipped left to
    right where ``mirror`` is on and the row's flag is set."""
    n = frames.shape[0]
    h, w = out_hw
    crops = crops.to(device=frames.device, dtype=torch.long)
    rows = crops[:, 0:1] + torch.arange(h, device=frames.device)
    cols = crops[:, 1:2] + torch.arange(w, device=frames.device)
    idx = torch.arange(n, device=frames.device)
    x = frames[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
    x = x.to(torch.float32) - torch.tensor(mean_bgr, dtype=torch.float32,
                                           device=frames.device)
    if mirror:
        flip = crops[:, 2] > 0
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return x


# ---------------------------------------------------------------- AlexNet
def same_pads(size, kernel, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lrn(x, depth_radius, bias, alpha, beta):
    """Cross-channel LRN of an NCHW tensor."""
    r = depth_radius
    sq = F.pad(x.square(), (0, 0, 0, 0, r, r))
    window = sq.unfold(1, 2 * r + 1, 1).sum(-1)
    return x * (bias + alpha * window).pow(-beta)


def encoder(p, prefix, x, cfg, rnd=identity):
    """AlexNet of ``cfg["encoder"]`` on preprocessed NHWC frames; returns
    the ``frame_encoding_layer`` output (N, D) float32."""
    enc = cfg["encoder"]
    norm = enc["lrn"]
    x = x.permute(0, 3, 1, 2)
    flat = False
    for layer in enc["layers"]:
        w = p[prefix + layer["name"] + "/w"]
        b = p[prefix + layer["name"] + "/b"]
        if layer["kind"] == "conv":
            k, s = layer["kernel"], layer["stride"]
            if layer["padding"] == "SAME":
                (t, bt), (lf, rt) = (same_pads(x.shape[2], k, s),
                                     same_pads(x.shape[3], k, s))
                x = F.pad(x, (lf, rt, t, bt))
            x = F.relu(rnd.out(F.conv2d(rnd(x), rnd(w), None, s, 0, 1,
                                        layer["groups"]))
                       + b[:, None, None])
            if layer.get("lrn"):
                x = lrn(x, norm["depth_radius"], norm["bias"],
                        norm["alpha"], norm["beta"])
            if layer.get("pool"):
                x = F.max_pool2d(x, layer["pool"][0], layer["pool"][1])
        else:
            if not flat:
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
                flat = True
            x = F.relu(rnd.out(rnd(x) @ rnd(w)) + b)
        if layer["name"] == enc["frame_encoding_layer"]:
            break
    return x


# ------------------------------------------------------------------ LSTM
def lstm_cell(x_proj, h, c, wh, b, rnd=identity):
    gates = x_proj + rnd.out(rnd(h) @ rnd(wh)) + b
    i, j, f, o = gates.chunk(4, dim=-1)
    c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
    return torch.tanh(c) * torch.sigmoid(o), c


def lstm_stack(p, prefix, x, layers, init=None, lengths=None,
               rnd=identity):
    """The stacked LSTM over x (N, T, D); ``init`` (N, H) is every
    layer's initial c and h (zeros when None); ``lengths`` (N,) stops
    each sequence (state kept, output zeroed).  Returns (N, T, H)."""
    seq = x
    for l in range(layers):
        w = p["%scells/%d/w" % (prefix, l)]
        b = p["%scells/%d/b" % (prefix, l)]
        d = seq.shape[-1]
        hidden = w.shape[1] // 4
        xp = rnd.out(rnd(seq) @ rnd(w[:d]))
        if init is None:
            h = c = torch.zeros(seq.shape[0], hidden, device=seq.device)
        else:
            h = c = init
        outs = []
        for t in range(seq.shape[1]):
            nh, nc = lstm_cell(xp[:, t], h, c, w[d:], b, rnd)
            if lengths is not None:
                m = (lengths > t)[:, None]
                nh, nc = torch.where(m, nh, h), torch.where(m, nc, c)
                outs.append(nh * m)
            else:
                outs.append(nh)
            h, c = nh, nc
        seq = torch.stack(outs, dim=1)
    return seq


# ------------------------------------------------------------------ heads
def classify(p, cfg, x, keep=None, rnd=identity):
    """Clip logits (clips, classes) from preprocessed frames laid out
    clip by clip; ``keep`` is the training dropout's keep mask on the
    fused (clips, H) vector."""
    pre = cfg["param_prefix"]
    fpc = cfg["frames_per_clip"]
    feats = encoder(p, pre["encoder"], x, cfg, rnd)
    seq = lstm_stack(p, pre["head"] + "lstm/",
                     feats.reshape(-1, fpc, feats.shape[-1]),
                     cfg["lstm"]["layers"], rnd=rnd)
    fused = seq.mean(1)
    fused = apply_dropout(fused, keep, cfg["train"]["dropout_keep_prob"])
    w, b = p[pre["head"] + "output_fc/w"], p[pre["head"] + "output_fc/b"]
    return rnd.out(rnd(fused) @ rnd(w)) + b


def visual_state(p, cfg, x, rnd=identity):
    """The captioner's conditioning: fc7 through ``state_fc``, (B, H)."""
    pre = cfg["param_prefix"]
    feats = encoder(p, pre["encoder"], x, cfg, rnd)
    w, b = p[pre["head"] + "state_fc/w"], p[pre["head"] + "state_fc/b"]
    return rnd.out(rnd(feats) @ rnd(w)) + b


def caption_logits(p, cfg, x, words, lengths, keep=None, rnd=identity):
    """Per-word logits (B*T, V) of caption training: words (B*T, E) are
    BOS and the caption's embeddings on the padded grid, ``lengths`` the
    input lengths; ``keep`` the dropout keep mask on the (B*T, H)
    outputs."""
    pre = cfg["param_prefix"]
    T = cfg["caption"]["max_T"]
    visual = visual_state(p, cfg, x, rnd)
    seq = lstm_stack(p, pre["head"] + "lstm/",
                     words.reshape(-1, T, words.shape[-1]),
                     cfg["lstm"]["layers"], init=visual, lengths=lengths,
                     rnd=rnd)
    out = apply_dropout(seq.reshape(-1, seq.shape[-1]), keep,
                        cfg["train"]["dropout_keep_prob"])
    w, b = p[pre["head"] + "output_fc/w"], p[pre["head"] + "output_fc/b"]
    return rnd.out(rnd(out) @ rnd(w)) + b


def cross_entropy_sum(logits, onehot, mask=None):
    """Sum over rows of -sum(onehot * log_softmax(logits)), rows weighted
    by ``mask``."""
    per_row = -(onehot.to(torch.float32)
                * torch.log_softmax(logits, dim=-1)).sum(-1)
    if mask is not None:
        per_row = per_row * mask.to(torch.float32)
    return per_row.sum()


# ---------------------------------------------------------------- training
def sgd_clip(params, grads, lr, clip_norm):
    """Plain SGD after a global-norm clip; returns (new params, the
    clipped gradients)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.where(norm < clip_norm, torch.ones_like(norm),
                        clip_norm / norm)
    clipped = {n: g * scale for n, g in grads.items()}
    return {n: params[n] - lr * clipped[n] for n in params}, clipped


def train_steps(params, cfg, batches, block_items, rnd=identity):
    """Run len(batches) training steps from ``params`` ({name: float32
    tensor}).  Each batch is a dict with uint8 ``frames`` laid out item
    by item, their ``crops`` and ``mirror`` (``preprocess``), ``labels``
    one-hot, the dropout ``keep`` mask and, for a captioner, ``words``,
    ``lengths`` and ``label_mask``.  The
    gradient of the masked mean loss is accumulated over blocks of
    ``block_items`` items.  Returns (losses, clipped gradients of each
    step, params after the last step)."""
    opt = cfg["train"]
    caption = cfg["task"] == "caption"
    fpc = cfg["frames_per_clip"]
    losses, clipped_steps = [], []
    for batch in batches:
        leaves = {n: t.detach().clone().requires_grad_(True)
                  for n, t in params.items()}
        items = batch["labels"].shape[0] // (cfg["caption"]["max_T"]
                                             if caption else 1)
        if caption:
            count = batch["label_mask"].to(torch.float32).sum().clamp(
                min=1.0)
        else:
            count = torch.tensor(float(items), device=batch["labels"].device)
        total = 0.0
        for i0 in range(0, items, block_items):
            i1 = min(i0 + block_items, items)
            f0, f1 = i0 * fpc, i1 * fpc
            x = preprocess(batch["frames"][f0:f1], batch["crops"][f0:f1],
                           cfg["mean_bgr"], (cfg["image"], cfg["image"]),
                           batch["mirror"])
            if caption:
                T = cfg["caption"]["max_T"]
                r0, r1 = i0 * T, i1 * T
                logits = caption_logits(
                    leaves, cfg, x, batch["words"][r0:r1],
                    batch["lengths"][i0:i1], keep=batch["keep"][r0:r1],
                    rnd=rnd)
                s = cross_entropy_sum(logits, batch["labels"][r0:r1],
                                      batch["label_mask"][r0:r1])
            else:
                logits = classify(leaves, cfg, x,
                                  keep=batch["keep"][i0:i1], rnd=rnd)
                s = cross_entropy_sum(logits, batch["labels"][i0:i1])
            (s / count).backward()
            total = total + s.detach()
        losses.append(float(total / count))
        grads = {n: t.grad if t.grad is not None else torch.zeros_like(t)
                 for n, t in leaves.items()}
        params, clipped = sgd_clip({n: t.detach() for n, t in
                                    leaves.items()}, grads, opt["base_lr"],
                                   opt["clip_norm"])
        clipped_steps.append(clipped)
    return losses, clipped_steps, params
