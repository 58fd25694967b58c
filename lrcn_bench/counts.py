"""Operations and bytes of the LRCN's work, counted from a configuration's
shapes, and the published peaks of the card they are measured against.

The counts are of the operation, not of any kernel that implements it:
a multiply-add is two operations, each input of an operation is read
once and each output written once.  A training step counts the forward,
the input gradient and the weight gradient of every layer, except that
conv1's input (the frames) takes no gradient; nothing is recomputed.
"""

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
                  "int8": 1979e12, "fp8": 1979e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes, ops, precision):
    """The least time the card could take: the larger of the bytes at
    the HBM rate and the operations at ``precision``'s tensor-core peak."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[precision])


# ----------------------------------------------------------------- AlexNet
def _same(size, stride):
    return -(-size // stride)


def _valid(size, kernel, stride):
    return (size - kernel) // stride + 1


def encoder_layers(cfg, conv1_padding=None):
    """Per encoder layer up to the frame encoding layer: {name, kind,
    in_hw, out_hw, cin, cout, kernel, groups, macs} for one frame at the
    configuration's image size.  ``conv1_padding`` overrides conv1's
    padding ("VALID" gives CaffeNet's unpadded 55x55 conv1)."""
    enc = cfg["encoder"]
    h = w = cfg["image"]
    c = 3
    flat = None
    out = []
    for layer in enc["layers"]:
        if layer["kind"] == "conv":
            k, s, g = layer["kernel"], layer["stride"], layer["groups"]
            pad = layer["padding"]
            if layer["name"] == "conv1" and conv1_padding:
                pad = conv1_padding
            oh, ow = ((_same(h, s), _same(w, s)) if pad == "SAME"
                      else (_valid(h, k, s), _valid(w, k, s)))
            cout = layer["out"]
            macs = oh * ow * cout * k * k * (c // g)
            out.append({"name": layer["name"], "kind": "conv",
                        "in_hw": (h, w), "out_hw": (oh, ow), "cin": c,
                        "cout": cout, "kernel": k, "groups": g,
                        "lrn": bool(layer.get("lrn")), "macs": macs})
            h, w, c = oh, ow, cout
            if layer.get("pool"):
                pk, ps = layer["pool"]
                h, w = _valid(h, pk, ps), _valid(w, pk, ps)
        else:
            if flat is None:
                flat = h * w * c
                c = flat
            out.append({"name": layer["name"], "kind": "fc", "cin": c,
                        "cout": layer["out"], "macs": c * layer["out"]})
            c = layer["out"]
        if layer["name"] == enc["frame_encoding_layer"]:
            break
    return out


def encoder_macs(cfg, conv1_padding=None):
    """{layer: multiply-adds for one frame}."""
    return {l["name"]: l["macs"] for l in encoder_layers(cfg, conv1_padding)}


def feature_dim(cfg):
    return encoder_layers(cfg)[-1]["cout"]


def lstm_macs(cfg, input_dim, rows_steps):
    """Multiply-adds of the stacked LSTM's products over ``rows_steps``
    (rows x timesteps) cell steps."""
    H, total, d = cfg["lstm"]["hidden"], 0, input_dim
    for _ in range(cfg["lstm"]["layers"]):
        total += (d + H) * 4 * H
        d = H
    return total * rows_steps


# ------------------------------------------------------------- model FLOPs
def forward_flops(cfg, items):
    """FLOPs of the training forward of ``items`` clips or captions."""
    frames = items * cfg["frames_per_clip"]
    macs = sum(encoder_macs(cfg).values()) * frames
    D, H = feature_dim(cfg), cfg["lstm"]["hidden"]
    if cfg["task"] == "caption":
        cap = cfg["caption"]
        rows = items * cap["max_T"]
        macs += items * D * H                       # state_fc
        macs += lstm_macs(cfg, cap["embedding_dim"], rows)
        macs += rows * H * cfg["num_classes"]       # output FC
    else:
        macs += lstm_macs(cfg, D, frames)
        macs += items * H * cfg["num_classes"]
    return 2 * macs


def train_step_flops(cfg, items):
    """Forward, input gradients and weight gradients of one step: three
    times the forward, less conv1's input gradient."""
    conv1 = encoder_macs(cfg)["conv1"] * items * cfg["frames_per_clip"]
    return 3 * forward_flops(cfg, items) - 2 * conv1


# ---------------------------------------------------------------- kernels
def lrn_sites(cfg):
    """(h, w, c) of every LRN's tensor for one frame."""
    return [l["out_hw"] + (l["cout"],) for l in encoder_layers(cfg)
            if l["kind"] == "conv" and l["lrn"]]


def lrn_elements(cfg, frames):
    return frames * sum(h * w * c for h, w, c in lrn_sites(cfg))


def lrn_forward_bound_s(cfg, frames):
    """Both LRNs' forward over ``frames`` frames: x read, y written, in
    the compute dtype; its few operations an element never bind."""
    nbytes = 2 * lrn_elements(cfg, frames) * DTYPE_BYTES[cfg["compute_dtype"]]
    return bound_s(nbytes, 0, cfg["compute_dtype"])


def lrn_backward_bound_s(cfg, frames):
    """Both LRNs' input gradient: x and the output gradient read, the
    input gradient written."""
    nbytes = 3 * lrn_elements(cfg, frames) * DTYPE_BYTES[cfg["compute_dtype"]]
    return bound_s(nbytes, 0, cfg["compute_dtype"])


def conv1_dw_bound_s(cfg, frames):
    """conv1's weight gradient: the cropped frames and conv1's output
    gradient read in the compute dtype (the weight gradient written is
    negligible), the conv's multiply-adds at the compute dtype's rate."""
    conv1 = encoder_layers(cfg)[0]
    size = DTYPE_BYTES[cfg["compute_dtype"]]
    h, w = conv1["in_hw"]
    oh, ow = conv1["out_hw"]
    k, cout = conv1["kernel"], conv1["cout"]
    nbytes = size * frames * (h * w * conv1["cin"] + oh * ow * cout) + \
        4 * k * k * conv1["cin"] * cout
    return bound_s(nbytes, 2 * conv1["macs"] * frames, cfg["compute_dtype"])


def lstm_step_bound_s(rows, hidden):
    """One fused LSTM cell step in float32: the input projection
    (rows, 4H), h and c, the recurrent kernel (H, 4H) and bias read; h
    and c written; the h @ Wh product at the TF32 rate."""
    nbytes = 4 * (rows * 4 * hidden + 2 * rows * hidden + 4 * hidden * hidden
                  + 4 * hidden + 2 * rows * hidden)
    return bound_s(nbytes, 2 * rows * hidden * 4 * hidden, "tf32")


def lstm_steps_of_call(cfg, traffic):
    """[(rows, hidden)] of every forward lstm_step launch of one call: a
    row per clip or caption, a step per frame or word, in every layer."""
    H, L = cfg["lstm"]["hidden"], cfg["lstm"]["layers"]
    T = (cfg["caption"]["max_T"] if cfg["task"] == "caption"
         else cfg["frames_per_clip"])
    return [(traffic["items"], H)] * (L * T)
