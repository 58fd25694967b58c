"""Late logit-level ensembling of N validation runs.

The port's counterpart of ``video_learning_tpu/tools/combine_logits.py``,
host numpy with the same lines and the same sweep table: it loads the
pickled validation-logit matrices (the ``validation_logits_*`` files that
``val.Validation`` writes), ``video label`` ground-truth files and
optional ``classname index`` maps, re-orders logit columns to a shared
class alignment, keeps the video ids common to every run in the
intersect mode, and sweeps convex weight combinations over the step-0.1
simplex of the N runs, reporting each one's accuracy.  ``load_class_map``
is also the class map of ``tools/serve`` and ``tools/infer``.

Usage:
  python -m video_learning_tpu_torch.tools.combine_logits \\
      -paths l1.pickle l2.pickle -gt gt1.txt gt2.txt \\
      [-lbl cls1.txt cls2.txt -align aligned_classes.txt] \\
      [-compromise intersect] [-limit N]
"""

import argparse
import os
import pickle

import numpy as np

from video_learning_tpu_torch.utils import ensure_console_logging, error, info


def load_logits(path):
    """A pickled logits matrix (only files a validation run wrote: a
    pickle can run code)."""
    with open(path, "rb") as f:
        arr = pickle.load(f)
    return np.asarray(arr)


def load_gt(path):
    """``video label`` lines -> (vid basenames, int labels)."""
    vids, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            vids.append(os.path.basename(parts[0]))
            labels.append(int(parts[1]))
    return vids, np.asarray(labels)


def load_class_map(path):
    """``classname index`` lines -> (name->idx, idx->name)."""
    c2i, i2c = {}, {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            name, idx = parts[0], int(parts[1])
            c2i[name] = idx
            i2c[idx] = name
    if len(c2i) != len(i2c):
        error("Non-bijective class map in %s" % path)
    return c2i, i2c


def align_to(logits, labels, i2c, align_c2i):
    """Re-index labels and re-order logit columns into the alignment
    map's class indexing."""
    labels_aligned = np.asarray([align_c2i[i2c[int(l)]] for l in labels])
    mapping = [align_c2i[i2c[l]] for l in range(logits.shape[1])]
    # invert: column j of the aligned matrix comes from the old column
    # whose class maps to j
    order = [old for _, old in sorted(zip(mapping, range(len(mapping))))]
    return logits[:, order], labels_aligned


def intersect_runs(vids, labels, logits):
    """Keep only video ids present in every run, preserving run-1 order
    and checking label agreement."""
    indexes = [{v: i for i, v in enumerate(vs)} for vs in vids[1:]]
    keeps = [[] for _ in vids]
    common_labels = []
    for i0, vid in enumerate(vids[0]):
        others = [idx.get(vid) for idx in indexes]
        if any(i is None for i in others):
            continue
        for r, ir in enumerate(others, start=1):
            if labels[0][i0] != labels[r][ir]:
                error("Video %s has different labels in runs 1 and %d: "
                      "%d vs %d" % (vid, r + 1, labels[0][i0],
                                    labels[r][ir]))
        keeps[0].append(i0)
        for r, ir in enumerate(others, start=1):
            keeps[r].append(ir)
        common_labels.append(labels[0][i0])
    return ([lg[k] for lg, k in zip(logits, keeps)],
            np.asarray(common_labels))


def _dump_alignment(path, vids, labels, logits, i2c):
    """Document vid/label/classname/argmax before and after alignment."""
    with open(path, "w") as f:
        for vid, label, logit in zip(vids, labels, logits):
            f.write("%s %d %s %d\n" % (vid, int(label),
                                        i2c[int(label)],
                                        int(np.argmax(logit))))


def accuracy(logits, labels):
    return float(np.mean(np.argmax(logits, 1) == np.asarray(labels)))


def _simplex_grid(nruns, n):
    """All tuples of non-negative ints summing to ``n`` (weight numerators
    of the step-1/n convex simplex), lexicographic descending (w1 from
    1.0 down to 0.0)."""
    if nruns == 1:
        return [(n,)]
    out = []
    for k in range(n, -1, -1):
        out.extend((k,) + rest for rest in _simplex_grid(nruns - 1, n - k))
    return out


def weight_sweep(logits_list, labels, step=0.1):
    """Convex-combination sweep over the N-run simplex grid; returns
    [(w1, .., wN, accuracy)]: for two runs the (w, 1-w) table, for more
    the full simplex at the same step."""
    results = []
    n = int(round(1 / step))
    for ks in _simplex_grid(len(logits_list), n):
        ws = [round(k * step, 10) for k in ks]
        combined = sum(w * lg for w, lg in zip(ws, logits_list))
        results.append(tuple(round(w, 1) for w in ws) +
                       (accuracy(combined, labels),))
    return results


def combine(paths, gt_paths, lbl_paths=None, align_path=None,
            compromise=None, limit=None):
    logits = [load_logits(p) for p in paths]
    if len(logits) < 2:
        error("Need at least two runs to combine.")
    if len(gt_paths) != len(paths):
        error("Need one ground-truth file per logits file.")
    gts = [load_gt(p) for p in gt_paths]
    vids = [g[0] for g in gts]
    labels = [g[1] for g in gts]
    if limit:
        vids = [v[:limit] for v in vids]
        labels = [l[:limit] for l in labels]
        logits = [x[:limit] for x in logits]

    if align_path:
        maps = [load_class_map(p) for p in (lbl_paths or [])]
        if len(maps) != len(logits):
            error("-align requires one -lbl class map per logits file")
        align_c2i, align_i2c = load_class_map(align_path)
        dump_dir = os.path.dirname(os.path.abspath(paths[0]))
        for i in range(len(logits)):
            _dump_alignment(os.path.join(
                dump_dir, "dset_%d_to_align_prior.txt" % i), vids[i],
                labels[i], logits[i], maps[i][1])
            logits[i], labels[i] = align_to(logits[i], labels[i],
                                            maps[i][1], align_c2i)
            _dump_alignment(os.path.join(
                dump_dir, "dset_%d_to_align_post.txt" % i), vids[i],
                labels[i], logits[i], align_i2c)

    for i in range(len(logits)):
        if len(logits[i]) != len(labels[i]):
            error("Mismatch in logits/labels #%d lengths: %d, %d"
                  % (i + 1, len(logits[i]), len(labels[i])))
        info("Logits #%d accuracy: %.5f"
             % (i + 1, accuracy(logits[i], labels[i])))

    lengths = [len(lg) for lg in logits]
    if len(set(lengths)) > 1:
        if compromise == "intersect":
            info("Logit length mismatch; keeping only common vid ids")
            logits, final_labels = intersect_runs(vids, labels, logits)
        else:
            error("Logit length mismatch (%s) and no compromise "
                  "selected" % lengths)
    else:
        for lb in labels[1:]:
            if not np.array_equal(labels[0], lb):
                error("Inconsistent labels between the runs.")
        final_labels = labels[0]

    sweep = weight_sweep(logits, final_labels)
    info("\t".join("w%d" % (i + 1) for i in range(len(logits))) +
         "\tmean acc.")
    for row in sweep:
        info("\t".join("%.1f" % w for w in row[:-1]) + "\t%.5f" % row[-1])
    return sweep


def main(argv=None):
    ensure_console_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("-paths", nargs="+", required=True)
    parser.add_argument("-gt", nargs="+", required=True)
    parser.add_argument("-lbl", nargs="+")
    parser.add_argument("-align")
    parser.add_argument("-compromise", choices=["intersect"])
    parser.add_argument("-limit", type=int)
    args = parser.parse_args(argv)
    return combine(args.paths, args.gt, args.lbl, args.align,
                   args.compromise, args.limit)


if __name__ == "__main__":
    main()
