"""The port's data layer against the JAX package's on the CPU: the record
container (byte-identical files, each reader reading the other's), the
native reader built into the port's ``build/``, the feeders of both
packages over one packed dataset and one JSON run config (the same
batches: frames, labels and crop/mirror parameters, over two epochs),
``BatchGeometry``, ``FeedPrefetcher``, and two ``Train.run_step``s fed
by each package's feeder, one of them the padded epoch tail.

Datasets are packed inside the tests with the JAX ``RecordWriter`` at
the port tests' tiny geometry: 72x80 raw frames cropped to 67x67, fpc 4.

Tolerances.  Batches must be equal, element for element (the host chain
runs the same float32 arithmetic in both packages).  The fed steps use
``test_torch_train.py``'s: loss 1e-5 relative, grad_norm 1e-2 relative,
accuracy and lr equal.  A relu whose input lies within rounding of zero
may switch on one side only (here one fc7 unit in the padded step, which
moves that unit's column of fc7/w outright), so the parameters are held
to that file's rule for flipped steps: per tensor every element within
two of the largest distances the tensor moved, and all but 1% of the
elements within 10% of it (plus 1e-6 of the tensor's scale).
"""

import json
import os

import numpy as np
import pytest
import torch

from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import train as jtrain
from video_learning_tpu.batching import BatchGeometry as JBatchGeometry
from video_learning_tpu.config import Settings as JSettings
from video_learning_tpu.data import records as jrecords
from video_learning_tpu.models.pipeline import Model as JModel
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import train as ttrain
from video_learning_tpu_torch.batching import BatchGeometry
from video_learning_tpu_torch.config import Settings
from video_learning_tpu_torch.data import native_io, records
from video_learning_tpu_torch.data.dataset import Dataset
from video_learning_tpu_torch.data.prefetch import FeedPrefetcher
from video_learning_tpu_torch.models.pipeline import Model
from video_learning_tpu_torch.utils import FrameworkError

FPC, RAW, IMAGE, CLASSES = 4, (72, 80, 3), (67, 67, 3), 5
MEAN = [104.0, 117.0, 123.0]
REQUIRED = [("frames_main_input", "visual", "main"),
            ("labels", "labels", "main")]


def _pack(folder, cpvs, seed=0):
    """One video per entry of ``cpvs`` (its clips of FPC random frames,
    its label), packed by the JAX RecordWriter; returns the paths file."""
    rs = np.random.RandomState(seed)
    base = os.path.join(str(folder), "videos.train")
    labels = rs.randint(0, CLASSES, len(cpvs))
    with jrecords.RecordWriter(base + ".tfrecord") as w:
        for v, cpv in enumerate(cpvs):
            for _ in range(cpv * FPC):
                w.write(jrecords.encode_image_example(
                    rs.randint(0, 256, RAW, np.uint8), int(labels[v])))
    jrecords.write_size_file(len(cpvs), list(cpvs), base + ".tfrecord",
                             "video", 1, FPC)
    with open(base, "w") as f:
        f.write("".join("vid%d %d\n" % (v, l) for v, l in enumerate(labels)))
    return base


def _run_doc(folder, data_path, batch_size=2, device_preprocess=True,
             shuffle=True, batch_item="default", host_shards=None,
             resume_file=None, data_format="tfrecord", raw=RAW,
             image=IMAGE, classes=CLASSES, lstm=16):
    data = {"data_path": data_path, "prepend_folder": "",
            "raw_image_shape": str(tuple(raw)),
            "image_shape": str(tuple(image)), "mean_image": MEAN,
            "data_format": "defs.data_format." + data_format,
            "frame_format": "jpg",
            "imgproc": ["defs.imgproc.rand_crop", "defs.imgproc.rand_mirror",
                        "defs.imgproc.sub_mean"],
            "batch_item": "defs.batch_item." + batch_item,
            "phase": "defs.phase.train", "tag": "defs.dataset_tag.main",
            "device_preprocess": device_preprocess,
            "epoch_shuffle": shuffle, "shuffle_seed": 3}
    if host_shards is not None:
        data["host_shards"], data["host_shard_index"] = host_shards
    return {"run": {
        "resume_file": resume_file,
        "run_folder": os.path.join(str(folder), "run"),
        "phase": "defs.phase.train", "seed": 0,
        "mesh_shape": {"data": 1, "model": 1}, "compute_dtype": "float32",
        "data": {"train-set": data},
        "network": {"num_classes": classes, "pipelines": [
            {"frames": {"input": "defs.dataset_tag.main",
                        "representation": "defs.representation.dcnn",
                        "frame_encoding_layer": "fc7"}},
            {"clf": {"input": "frames",
                     "representation": "defs.representation.nop",
                     "classifier": "defs.classifier.lstm",
                     "lstm_params": [lstm, 2, "defs.fusion_method.avg"]}}]},
        "train": {"batch_size": batch_size, "epochs": 2,
                  "optimizer": "defs.optim.sgd", "base_lr": 0.01,
                  "lr_mult": "None", "clip_norm": 10,
                  "dropout_keep_prob": 1.0},
        "logging": {"level": "logging.WARN"}}}


def _both_settings(tmp_path, doc_kw):
    """(JAX Settings, port Settings), each initialised from its own copy
    of one JSON run document (only the run folders differ)."""
    out = []
    for name, cls in (("jax", JSettings), ("port", Settings)):
        folder = tmp_path / name
        folder.mkdir()
        path = str(folder / "run.json")
        with open(path, "w") as f:
            json.dump(_run_doc(folder, **doc_kw), f)
        s = cls()
        s.initialize(path)
        out.append(s)
    return out


def _epochs(feeder, n=2):
    """Every batch of ``n`` epochs as numpy feeds."""
    out = []
    for _ in range(n):
        while feeder.loop():
            out.append(feeder.get_feed(REQUIRED)[0])
        feeder.rewind_datasets(next_epoch=True)
    return out


# --------------------------------------------------------------- records
def test_records_byte_identical_and_cross_readable(tmp_path):
    rs = np.random.RandomState(1)
    items = [(rs.randint(0, 256, (5, 7, 3), np.uint8), [i, i + 2][:1 + i % 2])
             for i in range(6)]
    vec = rs.randn(9).astype(np.float32)
    paths = {}
    for name, mod in (("jax", jrecords), ("port", records)):
        path = str(tmp_path / ("%s.tfrecord" % name))
        with mod.RecordWriter(path) as w:
            for im, lab in items:
                w.write(mod.encode_image_example(im, lab))
            w.write(mod.encode_vector_example(vec, 4))
        mod.write_size_file(6, [2, 2, 1, 3, 3, 3], path, "video", 2, 4)
        mod.write_size_file(6, None, path + "_img", "image", 1, 4)
        mod.concatenate([path, path], path + "_cat")
        paths[name] = path
    for suffix in ("", ".idx", ".size", "_img.size", "_cat", "_cat.idx"):
        with open(paths["jax"] + suffix, "rb") as a, \
                open(paths["port"] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    for reader_mod, writer in ((records, "jax"), (jrecords, "port")):
        r = reader_mod.RecordReader(paths[writer], verify=True)
        assert len(r) == 7
        for i, (im, lab) in enumerate(items):
            kind, data, labels = r.read_at(i)
            assert kind == 0 and np.array_equal(data, im)
            assert labels == (lab[0] if len(lab) == 1 else lab)
        kind, data, labels = r.read_at(6)
        assert kind == 1 and np.array_equal(data, vec) and labels == 4
        r.close()
        meta = reader_mod.read_size_file(paths[writer] + ".size")
        assert meta == jrecords.read_size_file(paths["jax"] + ".size")
        assert meta["cpi"] == [2, 2, 1, 3, 3, 3]
    # a stale .idx (from an earlier, longer file) is rescanned
    with open(paths["port"] + ".idx", "ab") as f:
        f.write(np.asarray([10 ** 9], np.uint64).tobytes())
    assert len(records.RecordReader(paths["port"])) == 7


def test_native_reader_matches_python_reader(tmp_path):
    """The reader built from native/vlrecords.cpp into the port's build/
    reads what the Python reader reads, in order and gathered."""
    if native_io.get_library() is None:
        pytest.skip("no C++ compiler to build the native reader")
    assert os.path.dirname(native_io.lib_path) == native_io.BUILD_DIR
    assert "video_learning_tpu_torch" in native_io.BUILD_DIR
    base = _pack(tmp_path, [1, 2, 1])
    path = base + ".tfrecord"
    py = records.RecordReader(path, verify=True)
    nat = native_io.NativeReader(path, verify=True)
    assert len(nat) == len(py) == 16
    assert nat.record_info(3) == (0,) + RAW + (1,)
    want = [py.read_at(i) for i in range(16)]
    px, lab, nlab = nat.read_images(0, 16, RAW, max_labels=4)
    order = [5, 0, 15, 7]
    gx, glab, gn = nat.read_images_at(order, RAW, max_labels=4)
    for i in range(16):
        assert np.array_equal(px[i], want[i][1])
        assert nlab[i] == 1 and lab[i, 0] == want[i][2]
    for k, i in enumerate(order):
        assert np.array_equal(gx[k], want[i][1]) and glab[k, 0] == want[i][2]
    out = (np.empty((16,) + RAW, np.uint8), np.empty((16, 4), np.int32),
           np.empty((16,), np.int32))
    assert nat.read_images(0, 16, RAW, max_labels=4, out=out)[0] is out[0]
    assert np.array_equal(out[0], px)
    nat.close()


# -------------------------------------------------------------- feeders
FEEDER_CASES = {
    # video records, batch_item default, a shuffled order each epoch, the
    # device path (uint8 frames + crop/mirror parameters), a 1-clip tail
    "default_device_shuffled": (dict(cpvs=[1] * 5), {}),
    # clips as batch items over videos of 1-3 clips, unshuffled
    "clip_items": (dict(cpvs=[2, 1, 3, 2]),
                   dict(batch_item="clip", batch_size=3, shuffle=False)),
    # the host chain (float32 crop, mean and mirror on the host)
    "host_path": (dict(cpvs=[1, 2, 1]),
                  dict(device_preprocess=False, batch_size=2)),
    # the second of two host shards over 5 items: a rotating boundary
    "host_shards_2": (dict(cpvs=[1] * 5), dict(host_shards=(2, 1))),
    # per-video clip counts with a shuffled order, batch_item default
    "ragged_cpv_shuffled": (dict(cpvs=[2, 1, 3, 1, 2]), dict(batch_size=2)),
}


@pytest.mark.parametrize("name", sorted(FEEDER_CASES))
def test_feeders_yield_equal_batches(name, tmp_path):
    pack_kw, doc_kw = FEEDER_CASES[name]
    base = _pack(tmp_path, **pack_kw)
    js, ts = _both_settings(tmp_path, dict(doc_kw, data_path=base))
    jd, td = js.feeder.get_datasets()[0], ts.feeder.get_datasets()[0]
    assert td.batches == jd.batches
    ref, out = _epochs(js.feeder), _epochs(ts.feeder)
    assert len(out) == len(ref) == 2 * len(jd.batches)
    for step, (a, b) in enumerate(zip(ref, out)):
        assert sorted(a) == sorted(b), step
        for k in a:
            assert a[k].dtype == b[k].dtype, (step, k)
            assert np.array_equal(a[k], b[k]), (step, k)
    if doc_kw.get("device_preprocess", True):
        assert "frames_main_input/proc_params" in out[0]
    else:
        assert out[0]["frames_main_input"].dtype == np.float32


def test_feeders_resume_from_snap(tmp_path):
    """Both feeders resumed from one .snap [batch 1, epoch 1, step 4]
    yield the same rest of epoch 1 and epoch 2, and the epoch-1 batches
    of an unbroken run (crop/mirror draws aside: restore leaves the rng
    at its start in both packages)."""
    base = _pack(tmp_path, [1, 2, 1, 1, 1])
    snap = str(tmp_path / "ckpt.ckpt")
    with open(snap + ".snap", "w") as f:
        json.dump([1, 1, 4], f)
    js, ts = _both_settings(tmp_path, dict(data_path=base, resume_file=snap))
    assert js.global_step == ts.global_step == 4
    assert js.train.epoch_index == ts.train.epoch_index == 1
    assert ts.feeder.get_batch_index() == 1
    ref, out = _epochs(js.feeder), _epochs(ts.feeder)
    assert len(out) == len(ref) == 2 + 3
    for a, b in zip(ref, out):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    (tmp_path / "fresh").mkdir()
    fresh = Settings()
    path = str(tmp_path / "fresh" / "run.json")
    with open(path, "w") as f:
        json.dump(_run_doc(tmp_path / "fresh", base), f)
    fresh.initialize(path)
    unbroken = _epochs(fresh.feeder)[4:6]
    for a, b in zip(unbroken, out[:2]):
        assert np.array_equal(a["frames_main_input"], b["frames_main_input"])
        assert np.array_equal(a["labels"], b["labels"])


def test_raw_disk_images_match_jax(tmp_path, tiny_image_tree):
    """Raw-disk image mode (jpgs read through PIL, no packing), the host
    chain: equal batches in both packages."""
    doc = dict(data_path=str(tiny_image_tree), data_format="raw",
               raw=(48, 64, 3), image=(40, 40, 3), classes=4, batch_size=3,
               device_preprocess=False)
    js, ts = _both_settings(tmp_path, doc)
    assert ts.feeder.get_datasets()[0].batches == [3, 3, 2]
    for a, b in zip(_epochs(js.feeder), _epochs(ts.feeder)):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_python_reader_fallback_matches_native(tmp_path):
    """A dataset without the native reader (a failed build) reads the
    same batches through the Python reader."""
    base = _pack(tmp_path, [1] * 5)
    _, ts = _both_settings(tmp_path, dict(data_path=base))
    (tmp_path / "py").mkdir()
    path = str(tmp_path / "py" / "run.json")
    with open(path, "w") as f:
        json.dump(_run_doc(tmp_path / "py", base), f)
    py = Settings()
    py.initialize(path)
    py.feeder.get_datasets()[0].native_reader = None
    for a, b in zip(_epochs(ts.feeder), _epochs(py.feeder)):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------------- geometry, prefetch
def test_batch_geometry_matches_jax():
    rs = np.random.RandomState(2)
    geo, jgeo = BatchGeometry(), JBatchGeometry()
    feeds = [{"x": rs.randn(8, 3).astype(np.float32),
              "labels": np.eye(4, dtype=np.int32)[[0, 1, 2, 3]]},
             {"x": rs.randn(4, 3).astype(np.float32),
              "labels": np.eye(4, dtype=np.int32)[[1, 2]]},
             {"x": rs.randn(2, 3).astype(np.float32),
              "labels": np.eye(4, dtype=np.int32)[[3]],
              "label_mask": np.asarray([0.0], np.float32)}]
    for feed in feeds:
        ref, rn, rp = jgeo.pad_feed(feed)
        out, n, p = geo.pad_feed({k: torch.from_numpy(v)
                                  for k, v in feed.items()})
        assert (n, p) == (rn, rp) and sorted(out) == sorted(ref)
        for k in ref:
            assert np.array_equal(out[k].numpy(), ref[k]), k
            assert out[k].dtype == torch.from_numpy(ref[k]).dtype, k


class _ListFeeder:
    """A feeder over a list of feeds; raises at ``fail_at``."""

    def __init__(self, n, fail_at=None):
        self.n, self.i, self.fail_at = n, 0, fail_at

    def loop(self):
        return self.i < self.n

    def get_batch_index(self):
        return self.i

    def get_feed(self, required_input):
        if self.i == self.fail_at:
            raise ValueError("read failed at %d" % self.i)
        self.i += 1
        return {"x": np.full(2, self.i - 1)}, {"main": None}


def test_prefetcher_order_depth_and_errors():
    items = list(FeedPrefetcher(_ListFeeder(7), REQUIRED,
                                prepare_fn=lambda f, b: dict(f, p=1)))
    assert [i for _, _, i in items] == list(range(7))
    assert [int(f["x"][0]) for f, _, _ in items] == list(range(7))
    assert all(f["p"] == 1 for f, _, _ in items)
    with pytest.raises(FrameworkError, match="read-buffer ring"):
        FeedPrefetcher(_ListFeeder(1), REQUIRED,
                       depth=Dataset._BUF_RING - 1)
    seen = []
    with pytest.raises(ValueError, match="read failed at 3"):
        for _, _, i in FeedPrefetcher(_ListFeeder(7, fail_at=3), REQUIRED):
            seen.append(i)
    assert seen == [0, 1, 2]


# ---------------------------------------------------------- fed run_step
def test_fed_run_steps_match_jax(tmp_path):
    """Two steps of each package, each fed by its own feeder from one
    packed dataset (3 videos at batch 2: a full batch, then the tail of
    1 clip padded to 2 with a label_mask), from shared parameters,
    dropout off.  The port's feed goes through FeedPrefetcher and
    prepare_device_feed."""
    base = _pack(tmp_path, [1, 1, 1])
    js, ts = _both_settings(tmp_path, dict(data_path=base, shuffle=False,
                                           lstm=32))
    jmodel, tmodel = JModel(js), Model(ts)
    jeng = jtrain.Train(js, js.feeder, jmodel, seed=0)
    jeng.place_params()
    start = {k: np.asarray(v)
             for k, v in jckpt.flatten_tree(jeng.params).items()}
    teng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu",
                        params=ckpt.unflatten_tree(
                            ckpt.from_jax_flat(start, "cpu")))
    ref = []
    while js.feeder.loop():
        ref.append(jeng.run_step(js.feeder.get_feed(
            jmodel.required_input)[0]))
    out, masks = [], []
    for feed, _, _ in FeedPrefetcher(ts.feeder, tmodel.required_input,
                                     prepare_fn=teng.prepare_device_feed):
        masks.append(feed["label_mask"].tolist())
        out.append(teng.run_step(feed))
    assert masks == [[1.0, 1.0], [1.0, 0.0]]
    assert len(out) == len(ref) == 2
    for step, (o, r) in enumerate(zip(out, ref)):
        assert o["lr"] == pytest.approx(r["lr"], rel=1e-7)
        assert o["accuracy"] == r["accuracy"], step
        assert o["loss"] == pytest.approx(r["loss"], rel=1e-5), step
        assert o["grad_norm"] == pytest.approx(r["grad_norm"], rel=1e-2)
    port = ckpt.to_jax_flat(teng.params)
    for k, v in jckpt.flatten_tree(jeng.params).items():
        v = np.asarray(v)
        moved = float(np.abs(v - start[k]).max())
        atol = 1e-6 * float(np.abs(v).max())
        diff = np.abs(port[k] - v)
        assert moved > 0, k
        assert diff.max() <= 2.0 * moved + atol, (k, diff.max(), moved)
        assert np.mean(diff > 0.1 * moved + atol) <= 0.01, k


def test_prepare_device_feed_checks_accum_and_keeps_caller_mask():
    """accum_steps must divide every padded feed array's rows; a caller's
    label_mask survives the padding."""
    from video_learning_tpu_torch.flagship import flagship
    ts, tmodel = flagship(compute_dtype="float32", batch_size=2)
    ts.train.accum_steps = 2
    eng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu")
    rs = np.random.RandomState(0)
    feed = {"frames_main_input": rs.randn(8, 67, 67, 3).astype(np.float32),
            "labels": np.eye(16, dtype=np.int32)[[1, 2]],
            "label_mask": np.asarray([1.0, 0.0], np.float32)}
    out = eng.prepare_device_feed(feed)
    assert out[ttrain.ON_DEVICE] and out["label_mask"].tolist() == [1.0, 0.0]
    eng._geometry.target_rows["labels"] = 3
    with pytest.raises(FrameworkError, match="does not divide"):
        eng.prepare_device_feed(feed)


def test_caption_batches_and_prepare_feed_match_jax(tmp_path):
    """Image records whose labels are captions (word indices), with the
    vocabulary and embeddings set on both packages' datasets: the same
    caption framing per batch, and ``feeder.prepare_feed`` /
    ``count_clips`` equal ``run_task._prepare_feed`` / ``_count_clips``
    (the port refuses captioning configs until the file readers come;
    the framing is checked here)."""
    from video_learning_tpu import run_task as jrun_task
    from video_learning_tpu_torch.data import feeder as tfeeder
    rs = np.random.RandomState(4)
    vocab = ["w%d" % i for i in range(7)] + ["UNK", "EOS", "BOS"]
    emb = rs.randn(len(vocab), 6).astype(np.float32)
    base = os.path.join(str(tmp_path), "images.train")
    caps = [list(rs.randint(0, 7, rs.randint(1, 5))) for _ in range(5)]
    with jrecords.RecordWriter(base + ".tfrecord") as w:
        for cap in caps:
            w.write(jrecords.encode_image_example(
                rs.randint(0, 256, RAW, np.uint8), cap))
    jrecords.write_size_file(5, None, base + ".tfrecord", "image", 4, None)
    with open(base, "w") as f:
        f.write("".join("im%d %s\n" % (i, " ".join(map(str, c)))
                        for i, c in enumerate(caps)))
    js, ts = _both_settings(tmp_path, dict(data_path=base, batch_size=2,
                                           classes=len(vocab)))
    for s in (js, ts):
        d = s.feeder.get_datasets()[0]
        d.vocabulary, d.embedding_matrix = vocab, emb
        d.include_labels = d.do_padding = True
    for _ in range(3):
        jfeed, jb = js.feeder.get_feed(REQUIRED)
        tfeed, tb = ts.feeder.get_feed(REQUIRED)
        ref = jrun_task._prepare_feed(jfeed, jb, None)
        out = tfeeder.prepare_feed(tfeed, tb)
        assert sorted(out) == sorted(ref)
        for k in ref:
            assert np.array_equal(out[k], ref[k]), k
        assert tfeeder.count_clips(tb, {"main": 1}) == \
            jrun_task._count_clips(jb, {"main": 1})


def test_resume_resolves_latest_and_best_as_jax(tmp_path):
    """"latest" is the newest checkpoint that has its .snap sidecar (a
    newer one without it is skipped); "best" must exist; an explicit
    path is taken as it is; a non-JSON sidecar is refused."""
    from video_learning_tpu.data.feeder import Feeder as JFeeder
    from video_learning_tpu_torch.data.feeder import Feeder
    folder = tmp_path / "checkpoints"
    folder.mkdir()
    for i, name in enumerate(("a.ckpt", "b.ckpt", "c.ckpt")):
        (folder / name).write_text("x")
        os.utime(folder / name, (1000 + i, 1000 + i))
    (folder / "b.ckpt.snap").write_text("[0, 0, 0]")
    feeders = [cls("video", ["train"], (None, None), 1, str(tmp_path), True)
               for cls in (JFeeder, Feeder)]
    for f in feeders:
        assert f._resolve_checkpoint("latest", require_snap=True) == \
            str(folder / "b.ckpt")
        assert f._resolve_checkpoint("latest") == str(folder / "c.ckpt")
        assert f._resolve_checkpoint("/x/y.ckpt") == "/x/y.ckpt"
    with pytest.raises(FrameworkError, match="best.ckpt"):
        feeders[1]._resolve_checkpoint("best")
    (folder / "c.ckpt.snap").write_bytes(b"\x80\x04pickle")
    with pytest.raises(FrameworkError, match="not JSON"):
        feeders[1].resume_snap("latest")
