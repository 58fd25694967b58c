"""Vocabulary -> word-embedding matrix generation.

The port's copy of ``video_learning_tpu/tools/produce_vocab_embeddings.py``:
parses a GloVe-style text embedding file, looks up every vocabulary
token, optionally fills missing tokens with uniform-random vectors drawn
from the observed min/max (``np.random.RandomState(seed)``, as the JAX
package draws them), and writes the ``<vocab>.embeddings`` TSV the
runtime loads.  Without the random fill, the missing tokens are listed
in ``missing_embeddings.txt`` beside the vocabulary file.

Usage: python -m video_learning_tpu_torch.tools.produce_vocab_embeddings
config.{json,yml} (reads the ``captions:`` document).
"""

import os
import sys

import numpy as np

from video_learning_tpu_torch.config import load_document
from video_learning_tpu_torch.tools.process_annotations import read_vocabulary
from video_learning_tpu_torch.utils import (ensure_console_logging, error,
                                            info)


def read_glove(embeddings_file):
    embeddings = {}
    with open(embeddings_file, "r") as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            embeddings[parts[0]] = [float(x) for x in parts[1:]]
    return embeddings


def produce(vocabulary_file, embeddings_file, embeddings_file_type="glove",
            randomize_missing_embeddings=False, seed=0):
    if embeddings_file_type != "glove":
        error("Unsupported embeddings file type: %s" % embeddings_file_type)
    vocab = read_vocabulary(vocabulary_file)
    embeddings = read_glove(embeddings_file)
    dims = {len(v) for v in embeddings.values()}
    if len(dims) != 1:
        error("Inconsistent embedding dimensions: %s" % dims)
    dim = dims.pop()
    all_vals = np.concatenate([np.asarray(v) for v in embeddings.values()])
    lo, hi = float(all_vals.min()), float(all_vals.max())
    info("Embedding dim %d, min/max %.4f/%.4f" % (dim, lo, hi))

    missing = [w for w in vocab if w not in embeddings]
    if len(missing) > 3:
        info("%d vocabulary items missing from the embeddings "
             "(beyond EOS/BOS/UNK)." % (len(missing) - 3))
    if missing and not randomize_missing_embeddings:
        listed = os.path.join(os.path.dirname(vocabulary_file),
                              "missing_embeddings.txt")
        with open(listed, "w") as f:
            f.write("\n".join(missing))
        error("Missing embeddings and randomization disabled; "
              "see %s" % listed)

    rng = np.random.RandomState(seed)
    out_path = vocabulary_file + ".embeddings"
    info("Writing embeddings for vocabulary at %s" % out_path)
    with open(out_path, "w") as fp:
        # file order == vocabulary order (class indices depend on it)
        for token in vocab:
            vec = embeddings.get(token)
            if vec is None:
                vec = rng.uniform(lo, hi, size=(dim,)).tolist()
                info("Random vector for missing token: %s" % token)
            fp.write("%s\t%s\n"
                     % (token, " ".join("%5.5f" % v for v in vec)))
    return out_path


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: produce_vocab_embeddings <config.{json,yml}>")
    cfg = load_document(argv[-1], "captions")
    return produce(cfg["vocabulary_file"], cfg["embeddings_file"],
                   cfg.get("embeddings_file_type", "glove"),
                   bool(cfg.get("randomize_missing_embeddings", False)))


if __name__ == "__main__":
    main()
