"""Caption vocabulary round-trip viewers: translate between vocab-index
label lines and word strings for eyeballing encoded caption datasets.

The port's copy of ``video_learning_tpu/tools/caption_vocab_tools.py``.

Usage:
  python -m video_learning_tpu_torch.tools.caption_vocab_tools \\
      to-words   <vocab_file> <encoded_paths_file>
  python -m video_learning_tpu_torch.tools.caption_vocab_tools \\
      to-indexes <vocab_file> <caption_text_file>
"""

import sys

from video_learning_tpu_torch.data.captions import read_vocabulary_list
from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def annotation_to_words(vocab_file, encoded_file):
    vocab = read_vocabulary_list(vocab_file)
    out = []
    with open(encoded_file) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            words = [vocab[int(i)] for i in parts[1:]]
            out.append((parts[0], " ".join(words)))
            info("%s : %s" % out[-1])
    return out


def words_to_vocab_indexes(vocab_file, text_file):
    vocab = {w: i for i, w in enumerate(read_vocabulary_list(vocab_file))}
    unk = vocab.get("UNK")
    out = []
    with open(text_file) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            idxs = [vocab.get(w.lower(), unk) for w in parts[1:]]
            out.append((parts[0], idxs))
            info("%s : %s" % (parts[0], " ".join(map(str, idxs))))
    return out


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 4:
        error("Usage: caption_vocab_tools {to-words|to-indexes} "
              "<vocab> <file>")
    cmd, vocab_file, target = argv[-3], argv[-2], argv[-1]
    if cmd == "to-words":
        return annotation_to_words(vocab_file, target)
    if cmd == "to-indexes":
        return words_to_vocab_indexes(vocab_file, target)
    error("Unknown command %s" % cmd)


if __name__ == "__main__":
    main()
