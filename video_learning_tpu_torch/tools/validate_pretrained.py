"""Validate a pretrained ``bvlc_alexnet.npy`` against the port.

The port's counterpart of ``video_learning_tpu/tools/validate_pretrained.py``,
for a weights file that the port's ``models/get_alexnet_weights.sh``
fetched (or a synthesized file of the same schema):

1. **Schema check**: the exact bvlc layer set and shapes (the grouped
   conv2/4/5 kernels carry ``C_in/2`` input channels).
2. **Integrity pin**: the file's sha256 is printed and written to a
   ``<file>.sha256`` sidecar, which ``alexnet.load_bvlc_weights``
   verifies on every later load.
3. **Feature fingerprint**: a seeded fixture image runs through the
   port's AlexNet (``models/alexnet.init(weights_file=...)`` and
   ``apply``, float32, on ``--device``: the card by default, where the
   LRN kernel runs) to fc6 and to fc7, and each feature vector is
   fingerprinted (sha256 of the vector rounded to 1e-4).  The
   fingerprints are stored in a JSON manifest on the first run and
   compared on every later one (trust on first use).  A manifest written
   by the JAX tool may differ from the port's where a float32 difference
   crosses a rounding edge: pin each package's own.

Usage:
    bash video_learning_tpu_torch/models/get_alexnet_weights.sh \\
        /data/bvlc_alexnet.npy
    python -m video_learning_tpu_torch.tools.validate_pretrained \\
        /data/bvlc_alexnet.npy [--manifest M] [--no-sidecar] [--device cpu]
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np

from video_learning_tpu_torch.utils import resolve_device

# bvlc_alexnet.npy ground-truth schema: {layer: [w, b]} with the grouped
# conv2/4/5 kernels at half input depth and the 227x227 fc6 fan-in
BVLC_SHAPES = {
    "conv1": ((11, 11, 3, 96), (96,)),
    "conv2": ((5, 5, 48, 256), (256,)),
    "conv3": ((3, 3, 256, 384), (384,)),
    "conv4": ((3, 3, 192, 384), (384,)),
    "conv5": ((3, 3, 192, 256), (256,)),
    "fc6": ((9216, 4096), (4096,)),
    "fc7": ((4096, 4096), (4096,)),
    "fc8": ((4096, 1000), (1000,)),
}


def sha256_file(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def check_schema(net_data):
    """Exact layer/shape/dtype validation; returns a list of problems."""
    problems = []
    for layer, (wshape, bshape) in BVLC_SHAPES.items():
        if layer not in net_data:
            problems.append("missing layer %s" % layer)
            continue
        pair = net_data[layer]
        if len(pair) != 2:
            problems.append("%s: expected [w, b], got %d arrays"
                            % (layer, len(pair)))
            continue
        w, b = np.asarray(pair[0]), np.asarray(pair[1])
        if tuple(w.shape) != wshape:
            problems.append("%s/w: shape %s != %s"
                            % (layer, w.shape, wshape))
        if tuple(b.shape) != bshape:
            problems.append("%s/b: shape %s != %s"
                            % (layer, b.shape, bshape))
        for nm, arr in (("w", w), ("b", b)):
            if not np.all(np.isfinite(arr)):
                problems.append("%s/%s: non-finite values" % (layer, nm))
    extra = sorted(set(net_data) - set(BVLC_SHAPES))
    if extra:
        problems.append("unexpected layers: %s" % extra)
    return problems


def fixture_image():
    """Deterministic 227x227x3 'photograph': seeded low-frequency blobs +
    noise, mean-subtracted like the training path."""
    rng = np.random.RandomState(2026)
    y, x = np.mgrid[0:227, 0:227].astype(np.float32)
    img = np.zeros((227, 227, 3), np.float32)
    for _ in range(6):
        cx, cy = rng.uniform(0, 227, 2)
        s = rng.uniform(20, 80)
        a = rng.uniform(-80, 80, 3)
        g = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s))
        img += g[:, :, None] * a[None, None, :]
    img += 127.0 + rng.normal(0, 12, img.shape)
    img = np.clip(img, 0, 255)
    return img - np.float32([104.0, 117.0, 123.0])


def features(weights_file, device="cuda"):
    """{"fc6", "fc7": float32 feature vector} of the fixture image through
    the port's AlexNet with the file's weights, on ``device``."""
    import torch

    from video_learning_tpu_torch.models import alexnet

    device = resolve_device(device)
    params = alexnet.init(torch.Generator().manual_seed(0), num_classes=1000,
                          final_layer="prob", weights_file=weights_file,
                          device=device)
    x = torch.from_numpy(fixture_image()[None]).to(device)
    with torch.no_grad():
        return {layer: alexnet.apply(params, x, final_layer=layer,
                                     compute_dtype=torch.float32)[0]
                .cpu().numpy() for layer in ("fc6", "fc7")}


def feature_fingerprint(weights_file, device="cuda"):
    """fc6/fc7 activations of the fixture image -> stats + sha256 of the
    1e-4-rounded vectors (tolerant to benign last-ulp jitter, sensitive
    to any real numerics change)."""
    out = {}
    for layer, feat in features(weights_file, device).items():
        out[layer] = {
            "mean": float(feat.mean()), "std": float(feat.std()),
            "min": float(feat.min()), "max": float(feat.max()),
            "nonzero_frac": float((feat != 0).mean()),
            "sha256_r4": hashlib.sha256(
                np.round(feat.astype(np.float64), 4).tobytes()).hexdigest(),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("weights", help="path to bvlc_alexnet.npy")
    ap.add_argument("--manifest", default=None,
                    help="JSON manifest path (default: <weights>.manifest."
                         "json); created on first run, compared afterwards")
    ap.add_argument("--no-sidecar", action="store_true",
                    help="do not write the <weights>.sha256 sidecar")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fixture forward (default "
                         "cuda; cpu to run on the CPU)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if not os.path.exists(args.weights):
        print("weights file not found: %s" % args.weights)
        return 2
    digest = sha256_file(args.weights)
    print("sha256(%s) = %s" % (args.weights, digest))

    net_data = np.load(args.weights, encoding="latin1",
                       allow_pickle=True).item()
    problems = check_schema(net_data)
    if problems:
        print("SCHEMA FAIL:")
        for p in problems:
            print("  -", p)
        return 1
    print("schema OK: 8 layers, bvlc shapes exact")

    fp = feature_fingerprint(args.weights, args.device)
    for layer, st in fp.items():
        print("%s: mean %+.4f std %.4f nonzero %.3f fingerprint %s"
              % (layer, st["mean"], st["std"], st["nonzero_frac"],
                 st["sha256_r4"][:16]))

    manifest_path = args.manifest or args.weights + ".manifest.json"
    record = {"sha256": digest, "features": fp}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            stored = json.load(f)
        fails = []
        if stored.get("sha256") != digest:
            fails.append("file sha256 changed: %s -> %s"
                         % (stored.get("sha256"), digest))
        for layer in ("fc6", "fc7"):
            a = stored.get("features", {}).get(layer, {}).get("sha256_r4")
            b = fp[layer]["sha256_r4"]
            if a != b:
                fails.append("%s fingerprint changed: %s -> %s"
                             % (layer, a, b))
        if fails:
            print("MANIFEST MISMATCH (%s):" % manifest_path)
            for fail in fails:
                print("  -", fail)
            return 1
        print("manifest OK: matches %s" % manifest_path)
    else:
        with open(manifest_path, "w") as f:
            json.dump(record, f, indent=1)
        print("manifest recorded: %s (trust-on-first-use; commit or "
              "archive it to pin these weights)" % manifest_path)
    if not args.no_sidecar:
        with open(args.weights + ".sha256", "w") as f:
            f.write(digest + "\n")
        print("sidecar written: %s.sha256 (load_bvlc_weights verifies it "
              "on every load)" % args.weights)
    return 0


if __name__ == "__main__":
    sys.exit(main())
