"""Caption framing and decoded-caption trimming.

Counterpart of the pieces of ``video_learning_tpu/data/captions.py`` and
``video_learning_tpu/run_task.py`` that captioner training and caption
serving use: ``labels_to_words`` turns per-item caption word indices into
the LSTM's BOS-framed word inputs and the (caption + EOS) one-hot labels,
``feed_from_words`` lays them out as the model's training feed
(``run_task._prepare_feed``), and ``trim_at_eos`` cuts a decoded row at
its first EOS.  The vocabulary / embedding file readers are not ported
yet.
"""

import numpy as np

from video_learning_tpu_torch.utils import error, labels_to_one_hot


def labels_to_words(raw_batch_labels, embedding_matrix, vocabulary,
                    num_classes, max_sequence_length, include_labels,
                    do_padding):
    """Per-item caption word indices -> the LSTM's inputs.

    Returns a dict of
      word_embeddings   : (B*T, E) float32, BOS + caption embeddings per
                          item, zero-padded to T = max_sequence_length
                          (with do_padding),
      onehot_labels     : (sum of lengths + B, num_classes) int32, caption
                          + EOS one-hots, unpadded,
      caption_lengths   : the raw caption lengths,
      non_padding_index : flat indices of the non-pad rows of the (B*T)
                          grid,
      mask              : (B, T) float32 validity mask.
    """
    emb_dim = embedding_matrix.shape[1]
    bos_index = vocabulary.index("BOS")
    eos_index = vocabulary.index("EOS")
    all_vectors, all_labels, non_pad = [], [], []
    B = len(raw_batch_labels)
    T = max_sequence_length
    mask = np.zeros((B, T), np.float32)
    for batch_index, item_labels in enumerate(raw_batch_labels):
        item_labels = [int(x) for x in (item_labels if isinstance(
            item_labels, (list, tuple)) else [item_labels])]
        if include_labels and 1 + len(item_labels) > T:
            # BOS + caption must fit the padded grid
            error("Caption of %d tokens exceeds max sequence length %d"
                  % (len(item_labels), T))
        vectors = embedding_matrix[[bos_index], :]
        if include_labels:
            vectors = np.vstack((vectors, embedding_matrix[item_labels, :]))
        labels = labels_to_one_hot([[x] for x in item_labels], num_classes)
        if include_labels:
            labels = np.vstack((labels,
                                labels_to_one_hot(eos_index, num_classes)))
        if do_padding:
            rows = vectors.shape[0]   # 1 + len in training; 1 (BOS) in val
            offset = batch_index * T
            non_pad.extend(offset + i for i in range(rows))
            if T > rows:
                vectors = np.vstack((vectors, np.zeros((T - rows, emb_dim),
                                                       np.float32)))
            mask[batch_index, :rows] = 1.0
        all_vectors.append(vectors.astype(np.float32))
        all_labels.append(labels)
    return {
        "word_embeddings": np.vstack(all_vectors),
        "onehot_labels": np.vstack(all_labels).astype(np.int32),
        "caption_lengths": [len(x) if isinstance(x, (list, tuple)) else 1
                            for x in raw_batch_labels],
        "non_padding_index": non_pad,
        "mask": mask,
    }


def feed_from_words(framed, labels):
    """The caption entries of a model feed from ``labels_to_words``'
    output: ``caption_words`` (B*T, E), ``caption_lengths`` (B,) int32
    input lengths (1 + caption length: BOS plus the words), and
    ``caption_mask`` (B, T).  Where the unpadded one-hot ``labels`` have
    one row per non-pad grid row (training batches) also ``labels``
    scattered onto the padded (B*T, C) grid, so loss rows line up with
    the LSTM's outputs, and ``label_mask`` (B*T,)."""
    feed = {"caption_words": framed["word_embeddings"],
            "caption_lengths": np.asarray(
                [n + 1 for n in framed["caption_lengths"]], np.int32),
            "caption_mask": framed["mask"]}
    if len(framed["non_padding_index"]) == len(labels):
        B, T = framed["mask"].shape
        padded = np.zeros((B * T, labels.shape[-1]), labels.dtype)
        padded[np.asarray(framed["non_padding_index"], np.int64)] = labels
        feed["labels"] = padded
        feed["label_mask"] = framed["mask"].reshape(-1)
    return feed


def trim_at_eos(word_indices, vocabulary, max_caption_length):
    """A decoded index sequence cut at its first EOS and capped at
    ``max_caption_length`` tokens."""
    eos_index = vocabulary.index("EOS")
    out = []
    for idx in list(word_indices)[:max_caption_length]:
        if int(idx) == eos_index:
            break
        out.append(int(idx))
    return out
