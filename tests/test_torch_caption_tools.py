"""The port's caption preprocessing and packed-data tools against the JAX
package's: ``process_annotations`` on a COCO-json and a Flickr-tsv
source writes identical vocabulary, per-image and encoded label files;
``produce_vocab_embeddings`` an identical TSV with the random fill on;
``caption_vocab_tools`` round-trips as JAX's does; ``compute_image_mean``
writes an identical ``.pickle`` and ``.txt``; ``check_serialized_data``
gives the same histograms and counts.  Each package reads the same JSON
config documents, over its own copy of the files it writes beside."""

import json
import os
import shutil

import numpy as np
import pytest

from tests.conftest import make_image
from video_learning_tpu.tools import caption_vocab_tools as jcvt
from video_learning_tpu.tools import check_serialized_data as jcheck
from video_learning_tpu.tools import compute_image_mean as jmean
from video_learning_tpu.tools import process_annotations as jpa
from video_learning_tpu.tools import produce_vocab_embeddings as jpve
from video_learning_tpu.utils import FrameworkError as JError
from video_learning_tpu_torch.data import records
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.tools import caption_vocab_tools as tcvt
from video_learning_tpu_torch.tools import check_serialized_data as tcheck
from video_learning_tpu_torch.tools import compute_image_mean as tmean
from video_learning_tpu_torch.tools import process_annotations as tpa
from video_learning_tpu_torch.tools import produce_vocab_embeddings as tpve
from video_learning_tpu_torch.utils import FrameworkError as TError

PACKAGES = (("jax", jpa, jpve, jcvt), ("port", tpa, tpve, tcvt))


def _sources(folder):
    """A COCO-json and a Flickr-tsv caption source, a replacements file
    and a GloVe-style embeddings file missing a few words."""
    folder.mkdir()
    coco = {"images": [{"id": i, "file_name": "COCO_%03d.jpg" % i}
                       for i in (3, 1, 2)],
            "annotations": [
                {"image_id": 3, "caption": "A man riding a horse."},
                {"image_id": 1, "caption": "Two dogs, playing in the "
                                           "park's grass!"},
                {"image_id": 3, "caption": "The man isn't on a bike"},
                {"image_id": 2, "caption": "a red car parked near a "
                                           "tree"},
                {"image_id": 1, "caption": "dogs run in the grass"}]}
    (folder / "coco.json").write_text(json.dumps(coco))
    (folder / "flickr.tsv").write_text(
        "f1.jpg#0\tA dog jumps over a log.\n"
        "f1.jpg#1\tthe dog is brown\n"
        "f2.jpg#0\tKids play soccer on the grass\n")
    (folder / "repl.txt").write_text("kids\tyoung children\n")
    words = ["a", "man", "riding", "horse", "dog", "dogs", "the", "grass",
             "red", "car", "on", "in", "is"]
    rs = np.random.RandomState(0)
    (folder / "glove.txt").write_text("".join(
        "%s %s\n" % (w, " ".join("%.4f" % x for x in rs.randn(5)))
        for w in words))


def _config(folder, vocabulary_file=None, **over):
    cap = {"caption_files": [str(folder / "coco.json"),
                             str(folder / "flickr.tsv")],
           "caption_file_formats": ["coco", "flickr"],
           "vocabulary_file": vocabulary_file,
           "vocab_replacement_file": str(folder / "repl.txt"),
           "word_count_thresh": 0, "caption_max_length": 6,
           "embeddings_file": str(folder / "glove.txt"),
           "embeddings_file_type": "glove",
           "randomize_missing_embeddings": True}
    cap.update(over)
    path = folder / "captions.json"
    path.write_text(json.dumps({"captions": cap}))
    return str(path)


def _written(folder):
    return {n: (folder / n).read_bytes() for n in sorted(os.listdir(folder))
            if not n.endswith(".json") or n.endswith(".per_image.json")}


@pytest.mark.parametrize("thresh", [None, 0, 1])
def test_annotations_vocabulary_and_embeddings_equal_jax(tmp_path, thresh):
    """Vocabulary (no vocabulary_file), then encoded labels (with it),
    then the embeddings TSV with random vectors for the missing tokens:
    every file each package writes is byte-identical."""
    out = {}
    for name, pa, pve, _ in PACKAGES:
        folder = tmp_path / name
        _sources(folder)
        vocab = pa.main(["x", _config(folder, word_count_thresh=thresh)])
        encoded = pa.main(["x", _config(folder, vocabulary_file=vocab,
                                        word_count_thresh=thresh)])
        assert [os.path.basename(p) for p in encoded] == \
            ["coco.json.paths.txt", "flickr.tsv.paths.txt"]
        emb = pve.main(["x", _config(folder, vocabulary_file=vocab)])
        assert emb == vocab + ".embeddings"
        out[name] = _written(folder)
    assert sorted(out["port"]) == sorted(out["jax"])
    for key in out["jax"]:
        assert out["port"][key] == out["jax"][key], key
    vocab = out["port"]["coco.json_flickr.tsv.vocab"].decode().split()
    assert vocab[-3:] == ["UNK", "EOS", "BOS"]
    assert ("young" in vocab) == (thresh is None or thresh == 0)


def test_missing_embeddings_without_the_fill_fail_alike(tmp_path):
    errors = []
    for name, pa, pve, _ in PACKAGES:
        folder = tmp_path / name
        _sources(folder)
        vocab = pa.main(["x", _config(folder)])
        cfg = _config(folder, vocabulary_file=vocab,
                      randomize_missing_embeddings=False)
        with pytest.raises((JError, TError)) as e:
            if name == "jax":
                cwd = os.getcwd()
                os.chdir(folder)    # the JAX tool lists them in the CWD
                try:
                    pve.main(["x", cfg])
                finally:
                    os.chdir(cwd)
            else:
                pve.main(["x", cfg])
        errors.append(str(e.value))
        assert (folder / "missing_embeddings.txt").read_text().split()[-3:] \
            == ["UNK", "EOS", "BOS"]
    assert errors[0].startswith("Missing embeddings and randomization "
                                "disabled")
    assert errors[1].startswith(errors[0].split(";")[0])


def test_caption_vocab_tools_round_trip(tmp_path):
    """to-words of the encoded labels and to-indexes of those words give
    what the JAX tools give, and map back to the labels."""
    folder = tmp_path / "src"
    _sources(folder)
    vocab = tpa.main(["x", _config(folder)])
    encoded = tpa.main(["x", _config(folder, vocabulary_file=vocab)])[0]
    words = tcvt.main(["x", "to-words", vocab, encoded])
    assert words == jcvt.main(["x", "to-words", vocab, encoded])
    text = tmp_path / "words.txt"
    text.write_text("".join("%s %s\n" % (k, w) for k, w in words))
    idx = tcvt.main(["x", "to-indexes", vocab, str(text)])
    assert idx == jcvt.main(["x", "to-indexes", vocab, str(text)])
    labels = [[int(i) for i in line.split()[1:]]
              for line in open(encoded) if line.strip()]
    assert [i for _, i in idx] == labels
    with pytest.raises(TError, match="Unknown command"):
        tcvt.main(["x", "to-nothing", vocab, encoded])


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A small packed video set (3 videos, 2 and 3 clips of 4 frames)
    written by the port's RecordWriter with its .size sidecar."""
    folder = tmp_path_factory.mktemp("packed")
    path = str(folder / "vids.tfrecord")
    cpv = [2, 3, 2]
    with records.RecordWriter(path) as w:
        for v, c in enumerate(cpv):
            for f in range(c * 4):
                w.write(records.encode_image_example(
                    make_image(12, 16, seed=10 * v + f), [v, 2 * v]))
    records.write_size_file(3, cpv, path, defs.input_mode.video, 2, 4)
    return folder, path


def test_image_mean_equals_jax(packed, tmp_path):
    folder, path = packed
    got = {}
    for name, mod in (("jax", jmean), ("port", tmean)):
        copy = tmp_path / name
        copy.mkdir()
        rec = str(copy / "vids.tfrecord")
        for suffix in ("", ".idx", ".size"):
            shutil.copy(path + suffix, rec + suffix)
        means = mod.main(["x", rec])
        got[name] = (means, (copy / "vids.tfrecord.mean.pickle").read_bytes(),
                     (copy / "vids.tfrecord.mean.txt").read_bytes())
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1:] == got["jax"][1:]
    assert np.all(np.isfinite(got["port"][0]))


def test_check_serialized_data_equals_jax(packed, tmp_path):
    _, path = packed
    want = jcheck.main(["x", path])
    got = tcheck.main(["x", path])
    assert got == want
    assert got["count"] == 7 * 4 and got["labels"] == 3
    bad = str(tmp_path / "short.tfrecord")
    shutil.copy(path, bad)
    shutil.copy(path + ".idx", bad + ".idx")
    records.write_size_file(3, [2, 3, 3], bad, defs.input_mode.video, 2, 4)
    for mod, exc in ((jcheck, JError), (tcheck, TError)):
        with pytest.raises(exc, match="does not match the .size"):
            mod.main(["x", bad])
