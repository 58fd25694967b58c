"""Caption annotation preprocessing: caption files -> vocabulary ->
vocab-index label files.

The port's copy of ``video_learning_tpu/tools/process_annotations.py``:
reads COCO-json and Flickr-tsv caption sources, tokenizes them
(``data/captions.normalize_caption``) with optional token replacements,
builds a frequency-thresholded vocabulary with UNK and appends EOS/BOS,
and encodes captions to vocab-index ``.paths.txt`` label files with
max-length truncation.

Usage: python -m video_learning_tpu_torch.tools.process_annotations
config.{json,yml} (reads the ``captions:`` document as JSON, or as YAML
where PyYAML is installed).
"""

import json
import os
import sys

from video_learning_tpu_torch.config import load_document
from video_learning_tpu_torch.data.captions import (normalize_caption,
                                                    read_vocabulary_list)
from video_learning_tpu_torch.utils import (as_num, ensure_console_logging,
                                            error, info)


def read_caption_file(filename, fmt):
    """Read one caption source into [{id, filename, raw_captions}]; also
    writes the ``.per_image.json`` sidecar."""
    info("Reading caption file %s (format %s)" % (filename, fmt))
    img_captions, img_filenames = {}, {}
    if fmt == "coco":
        with open(filename, "r") as f:
            data = json.load(f)
        for annot in data["annotations"]:
            img_captions.setdefault(annot["image_id"], []).append(
                annot["caption"])
        for image in data["images"]:
            img_filenames[image["id"]] = image["file_name"]
    elif fmt == "flickr":
        with open(filename, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                img, caption = line.split("\t")
                name, _ = img.split("#")
                img_captions.setdefault(name, []).append(caption)
                img_filenames[name] = name
    else:
        error("Unknown caption file format: %s" % fmt)

    image_jsons = [{"id": iid, "filename": img_filenames[iid],
                    "raw_captions": caps}
                   for iid, caps in img_captions.items()]
    with open(filename + ".per_image.json", "w") as fp:
        json.dump(image_jsons, fp)
    return image_jsons


def read_replacements(vocab_replacement_file):
    replacements = {}
    with open(vocab_replacement_file, "r") as f:
        for line in f:
            tokens = [t.strip() for t in line.strip().split("\t")
                      if t.strip()]
            if tokens:
                replacements[tokens[0]] = " ".join(tokens[1:])
    return replacements


def preprocess_captions(imgs_json, vocab_replacement_file=None):
    """PTB-tokenize (lowercase, clitic splits, punctuation drop); apply
    replacements."""
    info("Tokenizer: PTB rules + COCO punctuation drop "
         "(data/captions.normalize_caption)")
    replacements = (read_replacements(vocab_replacement_file)
                    if vocab_replacement_file else None)
    for img in imgs_json:
        img["processed_tokens"] = []
        for s in img["raw_captions"]:
            toks = normalize_caption(s)
            if replacements:
                out = []
                for t in toks:
                    out.extend(replacements[t].split()
                               if t in replacements else [t])
                toks = out
            img["processed_tokens"].append(toks)


def build_vocab(imgs, word_count_thresh):
    """Frequency-filtered vocabulary: words occurring <= threshold map to
    UNK."""
    counts = {}
    for img in imgs:
        for txt in img["processed_tokens"]:
            for w in txt:
                counts[w] = counts.get(w, 0) + 1
    if word_count_thresh is None:
        return sorted(counts)
    vocab = [w for w, n in counts.items() if n > word_count_thresh]
    bad = sum(1 for n in counts.values() if n <= word_count_thresh)
    info("Vocabulary: %d words kept, %d mapped to UNK (threshold %d)"
         % (len(vocab), bad, word_count_thresh))
    return vocab


def finalize_captions(img_list, vocab, caption_max_length):
    """Map tokens to vocabulary (OOV -> UNK) + truncate."""
    vocab_set = set(vocab)
    for img in img_list:
        img["final_captions"] = []
        for raw in img["processed_tokens"]:
            words = [w if w in vocab_set else "UNK" for w in raw]
            if caption_max_length is not None and \
                    len(words) > caption_max_length:
                words = words[:caption_max_length]
            img["final_captions"].append(words)


def read_vocabulary(vocab_file):
    """vocab file -> {token: index} in file order (a repeated token takes
    the count of distinct tokens before it, as in the JAX package)."""
    vocab = {}
    for token in read_vocabulary_list(vocab_file):
        vocab[token] = len(vocab)
    info("Read a %d-word vocabulary." % len(vocab))
    return vocab


def main(argv=None):
    ensure_console_logging()
    argv = argv or sys.argv
    if len(argv) < 2:
        error("Usage: process_annotations <config.{json,yml}>")
    cfg = load_document(argv[-1], "captions")
    caption_files = cfg["caption_files"]
    caption_file_formats = cfg["caption_file_formats"]
    vocabulary_file = cfg.get("vocabulary_file")
    if vocabulary_file in ("None", ""):
        vocabulary_file = None
    repl_file = cfg.get("vocab_replacement_file")
    if repl_file in ("None", ""):
        repl_file = None
    word_count_thresh = cfg.get("word_count_thresh")
    if word_count_thresh is not None:
        word_count_thresh = as_num(word_count_thresh,
                                   "captions.word_count_thresh", int,
                                   minimum=0)
    caption_max_length = cfg.get("caption_max_length")
    if caption_max_length is not None:
        caption_max_length = as_num(caption_max_length,
                                    "captions.caption_max_length", int,
                                    minimum=1)

    image_jsons = [read_caption_file(c, f)
                   for c, f in zip(caption_files, caption_file_formats)]
    for c in image_jsons:
        preprocess_captions(c, repl_file)

    if vocabulary_file is None:
        merged = [obj for group in image_jsons for obj in group]
        vocab = build_vocab(merged, word_count_thresh)
        vocab.extend(["UNK", "EOS", "BOS"])
        out = os.path.join(
            os.path.dirname(caption_files[0]),
            "_".join(os.path.basename(c) for c in caption_files) + ".vocab")
        info("Writing %d-word vocabulary (incl UNK/EOS/BOS) to %s"
             % (len(vocab), out))
        with open(out, "w") as f:
            f.write("\n".join(vocab) + "\n")
        return out

    vocab = read_vocabulary(vocabulary_file)
    outputs = []
    for filename, imgjson in zip(caption_files, image_jsons):
        finalize_captions(imgjson, vocab, caption_max_length)
        outfile = filename + ".paths.txt"
        with open(outfile, "w") as f:
            for image_obj in imgjson:
                for cap in image_obj["final_captions"]:
                    labels = [str(vocab[w]) for w in cap]
                    f.write("%s %s\n" % (image_obj["filename"],
                                         " ".join(labels)))
        info("Wrote %s" % outfile)
        outputs.append(outfile)
    return outputs


if __name__ == "__main__":
    main()
