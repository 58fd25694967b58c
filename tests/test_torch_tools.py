"""The port's checkpoint, schedule, logit, dataset and format tools
against the JAX package's on the same inputs: equal log lines, equal npz
arrays, equal sweep tables and statistics, byte-identical TFRecord files
and equal converted records, the same ffmpeg command line and errors.
The cases mirror ``tests/test_tools.py``'s."""

import json
import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu.data import records as jrec
from video_learning_tpu.tools import combine_logits as jcl
from video_learning_tpu.tools import combine_runs as jcr
from video_learning_tpu.tools import compute_evaluation_stats as jces
from video_learning_tpu.tools import examine_dataset as jed
from video_learning_tpu.tools import export_tfrecord as jexp
from video_learning_tpu.tools import import_tfrecord as jimp
from video_learning_tpu.tools import inspect_checkpoint as jic
from video_learning_tpu.tools import lr_calc as jlr
from video_learning_tpu.tools import modify_checkpoint as jmc
from video_learning_tpu.tools import plot_metrics as jpm
from video_learning_tpu.tools import split_video as jsv
from video_learning_tpu.tools import view_logits_info as jvli
from video_learning_tpu.utils import FrameworkError as JError
from video_learning_tpu_torch import checkpoint as tckpt
from video_learning_tpu_torch.data import records as trec
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.tools import combine_logits as tcl
from video_learning_tpu_torch.tools import combine_runs as tcr
from video_learning_tpu_torch.tools import compute_evaluation_stats as tces
from video_learning_tpu_torch.tools import examine_dataset as ted
from video_learning_tpu_torch.tools import export_tfrecord as texp
from video_learning_tpu_torch.tools import import_tfrecord as timp
from video_learning_tpu_torch.tools import inspect_checkpoint as tic
from video_learning_tpu_torch.tools import lr_calc as tlr
from video_learning_tpu_torch.tools import modify_checkpoint as tmc
from video_learning_tpu_torch.tools import plot_metrics as tpm
from video_learning_tpu_torch.tools import split_video as tsv
from video_learning_tpu_torch.tools import view_logits_info as tvli
from video_learning_tpu_torch.utils import FrameworkError as TError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def logged(caplog, fn, *args, **kwargs):
    """(fn's result, the "vlt" log lines it wrote at INFO and above)."""
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="vlt"):
        out = fn(*args, **kwargs)
    return out, [r.getMessage() for r in caplog.records]


def both(caplog, jfn, tfn, *args, **kwargs):
    """Run the JAX and the port function on the same arguments; their
    results and log lines."""
    return (logged(caplog, jfn, *args, **kwargs),
            logged(caplog, tfn, *args, **kwargs))


# ---------------------------------------------- a: checkpoints, schedule
def _state():
    rs = np.random.RandomState(0)
    return {"params": {"fc": {"w": rs.randn(2, 3).astype(np.float32),
                              "b": np.zeros(3, np.float32)},
                       "conv": {"w": rs.randn(3, 3, 2, 4)
                                .astype(np.float32)}},
            "step": np.asarray(7)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_inspect_and_modify_checkpoint_as_jax(tmp_path, caplog, writer):
    """A checkpoint either package wrote: the port's inspect prints JAX's
    lines (list, one tensor, --all), and the port's modify writes JAX's
    npz array for array, with the .snap carried along; each package's
    loader reads the other's output."""
    src = str(tmp_path / "a.ckpt")
    if writer == "jax":
        jckpt.save_checkpoint(src, _state())
    else:
        flat = jckpt.flatten_tree(_state())
        tckpt.save_checkpoint(src, tckpt.from_jax_flat(flat, device="cpu"))
    with open(src + ".snap", "w") as f:
        f.write("[1, 2, 3]")
    assert tckpt.get_checkpoint_tensor_names(src) == \
        jckpt.get_checkpoint_tensor_names(src)
    for argv in (["prog", src], ["prog", src, "params/fc/w"],
                 ["prog", src, "--all"]):
        (_, jlines), (_, tlines) = both(caplog, jic.main, tic.main, argv)
        assert tlines == jlines and tlines
    with pytest.raises(TError, match="not in checkpoint"):
        tic.print_tensors_in_checkpoint(src, "nope")

    ops = dict(deletes=["step"], renames=[("params/fc/b", "params/fc/bias")],
               regex_renames=[(r"^params/", "model/")],
               creates=[("model/extra", "4,4")])
    outs = {}
    for who, fn in (("jax", jmc.modify), ("port", tmc.modify)):
        dst = str(tmp_path / ("%s.ckpt" % who))
        outs[who] = [line.replace(dst, "DST")
                     for line in logged(caplog, fn, src, dst, **ops)[1]]
        assert os.path.exists(dst + ".snap")
    assert outs["port"] == outs["jax"]
    jout = jckpt.load_flat(str(tmp_path / "jax.ckpt"))
    tout = tckpt.load_flat(str(tmp_path / "port.ckpt"))
    assert sorted(tout) == sorted(jout) == [
        "model/conv/w", "model/extra", "model/fc/bias", "model/fc/w"]
    for k in jout:
        assert tout[k].dtype == jout[k].dtype
        np.testing.assert_array_equal(tout[k], jout[k])
    cross = jckpt.load_flat(str(tmp_path / "port.ckpt"))
    for k in jout:
        np.testing.assert_array_equal(cross[k], jout[k])
    with pytest.raises(TError, match="already exists"):
        tmc.modify(src, str(tmp_path / "x.ckpt"),
                   renames=[("params/fc/b", "params/fc/w")])


@pytest.mark.parametrize("decay,every", [
    (["staircase", "interval", 5, 0.5], 5),
    (["exp", "drops", 3, 0.9], 1),
    (["cosine", "interval", 4, 0.1], 2),
    (["staircase", "interval", 5, 0.5, 3], 7)])
def test_lr_calc_as_jax(caplog, decay, every):
    """The schedule the port's ``Train`` runs, projected: JAX's values and
    lines."""
    (jlrs, jlines), (tlrs, tlines) = both(caplog, jlr.project, tlr.project,
                                          0.1, 10, 2, decay, every=every)
    assert tlrs == jlrs and len(tlrs) == 20
    assert tlines == jlines


def test_lr_calc_cli_as_jax(caplog):
    argv = ["--base-lr", "0.01", "--num-batches", "7", "--epochs", "3",
            "--decay", "defs.decay.exp", "defs.periodicity.drops", "2",
            "0.5", "--every", "4"]
    (jlrs, jlines), (tlrs, tlines) = both(caplog, jlr.main, tlr.main, argv)
    assert tlrs == jlrs and tlines == jlines
    assert defs.check("defs.decay.cosine", defs.decay) == "cosine"


# ------------------------------------------------ d: logits, runs, data
def _pickle(path, arr):
    with open(path, "wb") as f:
        pickle.dump(arr, f)
    return str(path)


def _gt(path, labels, names=None):
    names = names or ["vid%d" % i for i in range(len(labels))]
    path.write_text("".join("%s %d\n" % (v, l)
                            for v, l in zip(names, labels)))
    return str(path)


def test_combine_logits_sweeps_as_jax(tmp_path, caplog):
    """Two and three runs: the port's sweep table and lines are JAX's."""
    rs = np.random.RandomState(3)
    labels = rs.randint(0, 4, 15)
    runs = [np.eye(4)[labels] * 5.0, rs.randn(15, 4), rs.randn(15, 4)]
    paths = [_pickle(tmp_path / ("v%d.pickle" % i), lg)
             for i, lg in enumerate(runs)]
    gt = _gt(tmp_path / "gt.txt", labels)
    for n, rows in ((2, 11), (3, 66)):
        (jsw, jlines), (tsw, tlines) = both(
            caplog, jcl.combine, tcl.combine, paths[:n], [gt] * n)
        assert tsw == jsw and len(tsw) == rows
        assert tlines == jlines
    (jsw, _), (tsw, _) = both(caplog, jcl.combine, tcl.combine, paths[:2],
                              [gt] * 2, limit=9)
    assert tsw == jsw
    with pytest.raises(TError, match="at least two"):
        tcl.combine(paths[:1], [gt])


def test_combine_logits_alignment_and_intersect_as_jax(tmp_path, caplog):
    """Class alignment (with the dumps it writes) and the intersect
    compromise over runs with different video sets."""
    rs = np.random.RandomState(4)
    (tmp_path / "cls1.txt").write_text("b 0\na 1\nc 2\n")
    (tmp_path / "cls2.txt").write_text("c 0\nb 1\na 2\n")
    (tmp_path / "align.txt").write_text("a 0\nb 1\nc 2\n")
    l1, l2 = rs.randn(6, 3), rs.randn(4, 3)
    lab1 = np.array([0, 1, 2, 0, 1, 2])
    names1 = ["v%d" % i for i in range(6)]
    # v5 is c, v1 is a and v3 is b in both runs' own class indexing
    lab2 = np.array([0, 2, 0, 1])
    names2 = ["v5", "v1", "v9", "v3"]
    p1 = _pickle(tmp_path / "l1.pickle", l1)
    p2 = _pickle(tmp_path / "l2.pickle", l2)
    g1 = _gt(tmp_path / "g1.txt", lab1, names1)
    g2 = _gt(tmp_path / "g2.txt", lab2, names2)
    kw = dict(lbl_paths=[str(tmp_path / "cls1.txt"),
                         str(tmp_path / "cls2.txt")],
              align_path=str(tmp_path / "align.txt"),
              compromise="intersect")
    dumps = ["dset_%d_to_align_%s.txt" % (i, w) for i in (0, 1)
             for w in ("prior", "post")]
    outs = []
    for fn in (jcl.combine, tcl.combine):
        outs.append(logged(caplog, fn, [p1, p2], [g1, g2], **kw) +
                    ([(tmp_path / d).read_text() for d in dumps],))
    assert outs[1] == outs[0]
    assert len(outs[1][0]) == 11 and outs[1][2][3].count("\n") == 4
    assert tcl.load_class_map(str(tmp_path / "cls2.txt")) == \
        jcl.load_class_map(str(tmp_path / "cls2.txt"))
    with pytest.raises(TError, match="mismatch"):
        tcl.combine([p1, p2], [g1, g2])


def test_combine_runs_as_jax(tmp_path, caplog):
    """Labels from a packed video set and its .size, each run's chunked
    ``validation_logits`` files in part order: JAX's accuracies."""
    path = str(tmp_path / "d.tfrecord")
    labels = [0, 1, 2, 1]
    with trec.RecordWriter(path) as w:
        for item, lab in enumerate(labels):
            for _ in range(4):          # 2 clips x 2 frames
                img = np.full((4, 4, 3), item, np.uint8)
                w.write(trec.encode_image_example(img, lab))
    trec.write_size_file(4, [2, 2, 2, 2], path, "video", 1, 2)
    rs = np.random.RandomState(5)
    folders = []
    for r in range(3):
        folder = tmp_path / ("run%d" % r)
        folder.mkdir()
        logits = np.abs(rs.randn(4, 3)) + np.eye(3)[labels] * r
        for part, rows in enumerate((logits[:1], logits[1:3], logits[3:])):
            _pickle(folder / ("validation_logits_x_1.part_%d" % part), rows)
        folders.append(str(folder))
    (jres, jlines), (tres, tlines) = both(caplog, jcr.combine, tcr.combine,
                                          folders, path, 3)
    assert tres == jres and tlines == jlines
    assert "gmean" in tres and "weighted_favor_2" in tres


def test_evaluation_stats_logits_info_and_dataset_as_jax(tmp_path, caplog):
    rs = np.random.RandomState(6)
    logits = rs.randn(40, 5)
    p = _pickle(tmp_path / "l.pickle", logits)
    gt = _gt(tmp_path / "gt.txt", rs.randint(0, 5, 40))
    (jst, jlines), (tst, tlines) = both(caplog, jces.main, tces.main,
                                        ["prog", p, gt, "5"])
    assert tst == jst and tlines == jlines
    np.testing.assert_array_equal(
        tces.prf1([0, 0, 1, 1, 2], [0, 1, 1, 1, 2], 3)["per_class"]["f1"],
        jces.prf1([0, 0, 1, 1, 2], [0, 1, 1, 1, 2], 3)["per_class"]["f1"])
    q = _pickle(tmp_path / "q.pickle", rs.randn(120, 5))   # > 50 runs
    for path in (p, q):
        (jv, jlines), (tv, tlines) = both(caplog, jvli.main, tvli.main,
                                          ["prog", path])
        assert tv == jv and tlines == jlines
    (tmp_path / "paths.txt").write_text("a 0\nb 0\nc 1\nd 0\ne 2 3\nf\n")
    (jx, jlines), (tx, tlines) = both(caplog, jed.examine, ted.examine,
                                      str(tmp_path / "paths.txt"))
    assert tx == jx and tlines == jlines
    (tmp_path / "none.txt").write_text("a\n")
    with pytest.raises(TError, match="No labeled items"):
        ted.examine(str(tmp_path / "none.txt"))


def test_plot_metrics_as_jax(tmp_path, caplog):
    rows = [{"step": i, "time": 1.0 + i, "loss": 2.0 / (i + 1),
             "lr": 0.1, "clips_per_sec": 10.0 + i % 3}
            for i in range(1, 90)]
    path = tmp_path / "metrics_x.jsonl"
    path.write_text("".join("%s\n" % json.dumps(r) for r in rows))
    for kw in ({}, {"key": "loss", "width": 20}):
        (js, jlines), (ts, tlines) = both(caplog, jpm.summarize,
                                          tpm.summarize, str(path), **kw)
        assert ts == js and tlines == jlines
    assert tpm.sparkline([1.0, 2.0, 3.0], 60) == jpm.sparkline([1.0, 2.0,
                                                               3.0], 60)


# ----------------------------------------------------- e: formats, media
def _vlr(path):
    rs = np.random.RandomState(3)
    with trec.RecordWriter(path) as w:
        for i in range(2):
            w.write(trec.encode_image_example(
                rs.randint(0, 255, (5, 4, 3), np.uint8), [i]))
        w.write(trec.encode_vector_example(
            rs.randn(8).astype(np.float32), [7, 9]))
    trec.write_size_file(3, None, path, "image", 2, None)


def test_crc32c_and_framing_as_jax():
    """The CRC32C vectors of RFC 3720 and the masked framing, bytes equal
    to JAX's."""
    import io
    assert texp._crc32c(b"123456789") == 0xE3069283
    assert texp._crc32c(b"") == 0
    payloads = [b"alpha", b"b" * 3000, bytes(range(256))]
    for pay in payloads:
        assert texp._crc32c(pay) == jexp._crc32c(pay)
    bufs = [io.BytesIO(), io.BytesIO()]
    for pay in payloads:
        jexp.write_tfrecord(bufs[0], pay)
        texp.write_tfrecord(bufs[1], pay)
    assert bufs[1].getvalue() == bufs[0].getvalue()


def test_export_and_import_tfrecord_as_jax(tmp_path, monkeypatch):
    """Without TensorFlow both exporters frame in pure Python and write
    the same bytes for image and vector records, which TensorFlow's
    writer writes too; both importers turn the port's file back into the
    original records; without TensorFlow the importers raise the same
    error."""
    vlr = str(tmp_path / "packed.tfrecord")
    _vlr(vlr)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    jout, jn = jexp.convert(vlr, str(tmp_path / "jax.tf.tfrecord"))
    tout, tn = texp.convert(vlr)
    assert tout == str(tmp_path / "packed.tf.tfrecord")
    assert tn == jn == 3
    with open(tout, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
    assert open(tout + ".size").read() == open(vlr + ".size").read()
    with pytest.raises(JError) as jerr:
        jimp.convert(tout)
    with pytest.raises(TError) as terr:
        timp.convert(tout)
    assert str(terr.value) == str(jerr.value)
    assert not os.path.exists(str(tmp_path / "packed.tf.vlr.tfrecord"))
    monkeypatch.delitem(sys.modules, "tensorflow")

    pytest.importorskip("tensorflow")
    # with TensorFlow importable both exporters take its writer: the same
    # bytes again
    for mod, name in ((jexp, "jax_tf"), (texp, "port_tf")):
        out, _ = mod.convert(vlr, str(tmp_path / ("%s.tfrecord" % name)))
        with open(out, "rb") as f, open(jout, "rb") as g:
            assert f.read() == g.read()
    jback, jn = jimp.convert(tout, str(tmp_path / "jax.vlr.tfrecord"))
    tback, tn = timp.convert(tout)
    assert tn == jn == 3
    orig = jrec.RecordReader(vlr)
    readers = [jrec.RecordReader(jback, verify=True),
               trec.RecordReader(tback, verify=True)]
    for i in range(3):
        want = orig.read_at(i)
        for r in readers:
            kind, data, lab = r.read_at(i)
            assert kind == want[0] and lab == want[2]
            np.testing.assert_array_equal(data, want[1])
    with open(jback, "rb") as f, open(tback, "rb") as g:
        assert f.read() == g.read()
    for r in readers + [orig]:
        r.close()


def _stub_ffmpeg(bindir, log):
    """An ``ffmpeg`` that records its argv and writes two frames."""
    bindir.mkdir()
    stub = bindir / "ffmpeg"
    stub.write_text("#!/bin/sh\nprintf '%%s\\n' \"$@\" >> %s\n"
                    "out=\"$(eval echo \\${$#})\"\n"
                    "touch \"$(dirname \"$out\")/f_0001.jpg\" "
                    "\"$(dirname \"$out\")/f_0002.jpg\"\n" % log)
    stub.chmod(0o755)


def test_split_video_as_jax(tmp_path, monkeypatch, caplog):
    """With a stub ffmpeg on PATH both packages pass the same argv and
    count the same frames; without one both raise the same error."""
    log = tmp_path / "argv.log"
    _stub_ffmpeg(tmp_path / "bin", log)
    monkeypatch.setenv("PATH", "%s:%s" % (tmp_path / "bin",
                                          os.environ["PATH"]))
    argvs = {}
    for who, mod in (("jax", jsv), ("port", tsv)):
        out = tmp_path / who
        log.write_text("")
        (target, lines) = logged(caplog, mod.main,
                                 [str(out), "/data/clip.avi", "--fps", "5"])
        assert target == [str(out / "clip")]
        argvs[who] = (log.read_text().replace(str(out), "OUT"),
                      [line.replace(str(out), "OUT") for line in lines])
    assert argvs["port"] == argvs["jax"]
    assert "fps=5.0" in argvs["port"][0]
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(JError) as jerr:
        jsv.split_video("/data/clip.avi", str(tmp_path / "x"))
    with pytest.raises(TError) as terr:
        tsv.split_video("/data/clip.avi", str(tmp_path / "x"))
    assert str(terr.value) == str(jerr.value)


def test_to_single_item_instance_as_jax(tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("a/1 0\nb/2 1\na/1 0\nc/3 2 5\nb/2 1\na/1 3\n")
    outs = [subprocess.run(
        ["bash", os.path.join(REPO, pkg, "tools",
                              "to_single_item_instance.sh"), str(lst)],
        capture_output=True, text=True, check=True).stdout
        for pkg in ("video_learning_tpu", "video_learning_tpu_torch")]
    assert outs[1] == outs[0] == "a/1 0\nb/2 1\nc/3 2 5\n"
