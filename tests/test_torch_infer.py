"""The port's inference on raw media (``tools/infer.py``) and export from a
checkpoint (``tools/export_serving.py``) against the JAX package's, on
checkpoints the JAX package wrote (72x80 frames cropped to 67, fpc 4,
cpv 2, AlexNet to fc6, float32).

- Video folders: ``infer`` with a checkpoint that the JAX ``run_task``
  trained (one step, EMA 0.5) gives JAX's top-k classes, probabilities
  within 1e-5, with ``--classes`` and with ``--ema``; images (.ppm,
  read without PIL by the port, through PIL by JAX) likewise on a JAX
  checkpoint of an fc classifier, and ``--checkpoint none`` runs.
- Missing and mixed media and an untagged dataset fail with JAX's
  messages.
- A captioner (JAX checkpoint, decode length from the training ``.size``)
  gives JAX's captions.
- ``export`` -> ``serving.load`` -> call on the batch ``infer`` packs
  gives ``infer``'s logits: float within 1e-5 x max(1, |logit|), int8
  (dynamic) exactly, a bucketed [1, 2] artifact at bucket 1 and 2, and
  an int8_static artifact on its own signature batch exactly; a
  captioner's artifact gives infer's token ids.  The meta has every key
  of the JAX artifact's meta but the JAX lowering's ``platforms``,
  ``trace_platform``, ``jax_version`` and ``mesh``, with JAX's values;
  ``ema`` and ``run_id`` record the export, and an artifact written
  without them loads with ``ema`` false and ``run_id`` null.
"""

import json
import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from tests.conftest import make_image
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import run_task as jrun
from video_learning_tpu.config import Settings as JSettings
from video_learning_tpu.data import serialize as jser
from video_learning_tpu.models.pipeline import Model as JModel
from video_learning_tpu.tools import export_serving as jexp
from video_learning_tpu.tools import infer as jinf
from video_learning_tpu.utils import FrameworkError as JError
from video_learning_tpu_torch import serving
from video_learning_tpu_torch.batching import BatchGeometry
from video_learning_tpu_torch.tools import export_serving as texp
from video_learning_tpu_torch.tools import infer as tinf
from video_learning_tpu_torch.tools.export_serving import write_ppm
from video_learning_tpu_torch.utils import FrameworkError as TError

RAW, CROP, FPC, CPV = (72, 80), 67, 4, 2
MEAN = [99.2, 105.3, 109.5]
JAX_ONLY_META = ("platforms", "trace_platform", "jax_version", "mesh")


def _pack(folder, list_file, fpc=FPC, cpv=CPV, mode="rand_clips",
          frame_format="jpg"):
    cfg = {"serialize": {
        "output_folder": None, "path_prepend_folder": None,
        "input_files": [str(list_file)], "run_id": "fixture",
        "num_threads": 2, "num_items_per_thread": 8,
        "raw_image_shape": "(%d, %d, 3)" % RAW,
        "clip_offset_or_num": cpv, "num_frames_per_clip": fpc,
        "clipframe_mode": "defs.clipframe_mode." + mode,
        "generation_error": "defs.generation_error.compromise",
        "do_shuffle": False, "do_serialize": True, "do_validate": False,
        "validate_pcnt": 0, "frame_format": frame_format,
        "logging_level": "logging.WARN", "log_folder": str(folder),
        "seed": 1}}
    path = os.path.join(str(folder), "pack.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    jser.main(["serialize", path])


def _run_cfg(folder, data_path, pipelines, num_classes, phase="val",
             **over):
    """A JSON run config read by both packages; returns its path."""
    run = {
        "resume_file": None, "run_folder": os.path.join(str(folder), "run"),
        "run_id": "inf", "seed": 3, "mesh_shape": {"data": 1},
        "compute_dtype": "float32", "phase": "defs.phase." + phase,
        "data": {"main": {
            "data_path": str(data_path),
            "raw_image_shape": "(%d, %d, 3)" % RAW,
            "image_shape": "(%d, %d, 3)" % (CROP, CROP),
            "mean_image": MEAN,
            "data_format": "defs.data_format.tfrecord",
            "frame_format": "jpg",
            "imgproc": ["defs.imgproc.rand_crop", "defs.imgproc.rand_mirror",
                        "defs.imgproc.sub_mean"],
            "batch_item": "defs.batch_item.default",
            "phase": "defs.phase." + phase, "tag": "defs.dataset_tag.main",
            "device_preprocess": True}},
        "network": {"num_classes": num_classes, "pipelines": pipelines},
        "train": {"batch_size": 3, "epochs": 1,
                  "optimizer": "defs.optim.sgd", "base_lr": 0.01,
                  "lr_mult": None, "clip_norm": 5,
                  "dropout_keep_prob": 1.0, "ema_decay": 0.5},
        "logging": {"save_freq_per_epoch": 1, "level": "logging.WARN"}}
    run.update(over)
    path = os.path.join(str(folder), "%s.json" % phase)
    with open(path, "w") as f:
        json.dump({"run": run}, f, indent=1)
    return path


ENCODER = {"frames": {"input": "defs.dataset_tag.main",
                      "representation": "defs.representation.dcnn",
                      "frame_encoding_layer": "fc6"}}


@pytest.fixture(scope="module")
def video_run(tmp_path_factory):
    """JPEG video folders packed by the JAX serializer, and one epoch (one
    step) of the JAX ``run_task`` with an EMA: its config, whose dataset
    the training set is, and the folders."""
    root = tmp_path_factory.mktemp("infer_video")
    vids = []
    for v, n in enumerate((10, 12, 9)):
        vdir = root / ("vid%d" % v)
        vdir.mkdir()
        for i in range(n):
            Image.fromarray(make_image(*RAW, seed=100 * v + i)).save(
                vdir / ("f_%04d.jpg" % i), quality=90)
        vids.append(str(vdir))
    tree = root / "videos.train"
    tree.write_text("".join("%s %d\n" % (v, i) for i, v in enumerate(vids)))
    _pack(root, tree)
    cfg = _run_cfg(root, tree, [ENCODER, {"clf": {
        "input": "frames", "representation": "defs.representation.nop",
        "classifier": "defs.classifier.lstm",
        "lstm_params": [16, 1, "defs.fusion_method.avg"]}}], 3,
        phase="train")
    jrun.main(cfg)
    (root / "classes.txt").write_text("alpha 0\nbeta 1\ngamma 2\n")
    return root, cfg, vids


def _jax_checkpoint(cfg):
    """Fresh JAX parameters of ``cfg``'s model written by the JAX
    package's checkpoint writer into its run folder."""
    import jax
    s = JSettings()
    s.initialize(cfg)
    params = JModel(s).init_params(jax.random.PRNGKey(1))
    folder = os.path.join(s.run_folder, "checkpoints")
    os.makedirs(folder, exist_ok=True)
    jckpt.save_checkpoint(os.path.join(folder, "init.ckpt"),
                          {"params": params})


def _assert_rows_equal(port, jax_rows, tol=1e-5):
    assert [r["media"] for r in port] == [r["media"] for r in jax_rows]
    for p, j in zip(port, jax_rows):
        assert [c for c, _ in p["topk"]] == [c for c, _ in j["topk"]]
        np.testing.assert_allclose([x for _, x in p["topk"]],
                                   [x for _, x in j["topk"]], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("ema", [False, True])
def test_video_infer_equals_jax(video_run, tmp_path, ema):
    root, cfg, vids = video_run
    classes = str(root / "classes.txt")
    want = jinf.infer(cfg, vids, "latest", topk=2, classes=classes,
                      use_ema=ema)
    out = tmp_path / "rows.json"
    argv = [cfg, "--media", *vids, "--topk", "2", "--classes", classes,
            "--out", str(out), "--workdir", str(tmp_path / "w"),
            "--device", "cpu"] + (["--ema"] if ema else [])
    got = tinf.main(argv)
    _assert_rows_equal(got, want)
    assert {c for r in got for c, _ in r["topk"]} <= {"alpha", "beta",
                                                      "gamma"}
    assert json.load(open(out)) == got
    assert os.path.exists(tmp_path / "w" / "media.infer.tfrecord")
    assert json.load(open(tmp_path / "w" / "infer_run.json"))["run"][
        "val"]["clip_fusion"] == ["defs.fusion_type.late",
                                  "defs.fusion_method.avg"]


@pytest.fixture(scope="module")
def image_run(tmp_path_factory):
    """A .ppm image set (raw shape, so the port reads it without PIL) and
    an fc classifier's config with a JAX-written checkpoint."""
    root = tmp_path_factory.mktemp("infer_images")
    media = []
    for i in range(3):
        p = str(root / ("im%d.ppm" % i))
        write_ppm(p, make_image(*RAW, seed=7 + i))
        media.append(p)
    tree = root / "imgs.train"
    tree.write_text("".join("%s %d\n" % (m, i) for i, m in enumerate(media)))
    cfg = _run_cfg(root, tree, [ENCODER, {"clf": {
        "input": "frames", "representation": "defs.representation.fc",
        "fc_output_dim": 8, "classifier": "defs.classifier.fc"}}], 4,
        val={"batch_size": 2, "logits_save_interval": -1})
    _pack(root, tree, fpc=1, cpv=1, mode="iterative", frame_format="ppm")
    _jax_checkpoint(cfg)
    return root, cfg, media


def test_image_infer_equals_jax(image_run):
    root, cfg, media = image_run
    want = jinf.infer(cfg, media, "latest", topk=3)
    got = tinf.infer(cfg, media, "latest", topk=3, device="cpu")
    _assert_rows_equal(got, want)
    smoke = tinf.infer(cfg, media, "none", topk=4, device="cpu")
    assert [r["media"] for r in smoke] == media
    for r in smoke:
        assert np.isclose(sum(p for _, p in r["topk"]), 1.0, atol=1e-5)
        assert all(isinstance(c, int) for c, _ in r["topk"])


def test_media_errors_equal_jax(image_run, video_run, tmp_path):
    root, cfg, media = image_run
    cases = [([str(tmp_path / "no_such_dir")], cfg),
             ([media[0], video_run[2][0]], cfg)]
    run = json.load(open(cfg))
    run["run"]["data"]["main"]["tag"] = "defs.dataset_tag.aux"
    untagged = tmp_path / "untagged.json"
    untagged.write_text(json.dumps(run))
    cases.append((media, str(untagged)))
    for items, config in cases:
        with pytest.raises(JError) as want:
            jinf.infer(config, items, "none")
        with pytest.raises(TError) as got:
            tinf.infer(config, items, "none", device="cpu")
        assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def caption_run(tmp_path_factory):
    """A captioner (9 words, 8-d embeddings, 1x16 LSTM over fc6) whose
    packed training set sets the decode length, with a JAX-written
    checkpoint, and two .ppm images to caption."""
    root = tmp_path_factory.mktemp("infer_caption")
    words = ["a", "red", "dog", "cat", "runs", "sits"]
    vocab = words + ["UNK", "EOS", "BOS"]
    rs = np.random.RandomState(0)
    emb = root / "v.vocab.embeddings"
    emb.write_text("".join("%s\t%s\n" % (w, " ".join(
        "%.5f" % x for x in rs.randn(8))) for w in vocab))
    lines = []
    for iid, lab in {1: [0, 1, 2, 4], 2: [0, 3, 5], 3: [0, 2]}.items():
        p = root / ("img_%04d.jpg" % iid)
        Image.fromarray(make_image(*RAW, seed=iid)).save(p, quality=90)
        lines.append("%s %s" % (p, " ".join(map(str, lab))))
    tree = root / "caps.train"
    tree.write_text("\n".join(lines) + "\n")
    _pack(root, tree, fpc=1, cpv=1, mode="iterative")
    cfg = _run_cfg(root, tree, [ENCODER, {"capt": {
        "input": "frames", "representation": "defs.representation.nop",
        "classifier": "defs.classifier.lstm",
        "lstm_params": [16, 1, "defs.fusion_method.avg",
                        "defs.rnn_visual_mode.state_bias"]}}], len(vocab),
        val={"batch_size": 2, "logits_save_interval": -1},
        captioning={"caption_search": "defs.caption_search.max",
                    "eval_type": "defs.eval_type.coco",
                    "word_embeddings_file": str(emb)})
    _jax_checkpoint(cfg)
    media = []
    for i in range(2):
        p = str(root / ("q%d.ppm" % i))
        write_ppm(p, make_image(*RAW, seed=40 + i))
        media.append(p)
    return root, cfg, media


def test_captioner_infer_and_export_equal_jax(caption_run, tmp_path):
    root, cfg, media = caption_run
    want = jinf.infer(cfg, media, "latest")
    got = tinf.infer(cfg, media, "latest", device="cpu")
    assert got == want
    assert all(r["caption"].strip() for r in got)
    out = str(tmp_path / "cap.zip")
    meta = texp.export(cfg, out, "latest", batch_items=[2], device="cpu")
    assert meta["output"]["kind"] == "token_ids"
    module = serving.load(out, device="cpu")
    feed, ids = _context_feed(cfg, media, tmp_path, decode=True)
    rows = module(*[feed[i["name"]] for i in module.meta["inputs"]])
    np.testing.assert_array_equal(rows, ids)
    assert module.captions_from_ids(rows) == [r["caption"] for r in got]


def _context_feed(cfg, media, tmp_path, decode=False, **kw):
    """The batch ``infer`` packs for ``media`` and the output its val
    forward gives on it (logits per clip, or decoded word indices)."""
    work = tmp_path / ("ctx%d" % len(os.listdir(tmp_path)))
    work.mkdir()
    _, feeder, model, params, val, _ = tinf.build_serving_context(
        cfg, media, "latest", workdir=str(work), device="cpu", **kw)
    assert feeder.loop()
    feed, _, _ = tinf.next_val_feed(feeder, model, BatchGeometry())
    return feed, val.run_forward(params, dict(feed), decode=decode)


def _host_preprocessed(cfg, tmp_path):
    """``cfg`` with its frames preprocessed on the host (the config's
    default), over the same run folder and checkpoint."""
    run = json.load(open(cfg))
    run["run"]["data"]["main"]["device_preprocess"] = False
    path = str(tmp_path / "host.json")
    with open(path, "w") as f:
        json.dump(run, f)
    return path


def test_build_serving_fn_equals_jax(video_run, tmp_path):
    """``Validation.build_serving_fn`` on the batch infer packs: JAX's
    input names and shapes, and JAX's serving computation's logits
    within 1e-5 x max(1, |logit|)."""
    import jax
    _, cfg, vids = video_run
    out = {}
    for name, mod in (("jax", jinf), ("port", tinf)):
        work = tmp_path / name
        work.mkdir()
        kw = {} if name == "jax" else {"device": "cpu"}
        _, feeder, model, params, val, _ = mod.build_serving_context(
            cfg, vids[:2], "latest", None, None, str(work), batch_size=2,
            **kw)
        assert feeder.loop()
        if name == "jax":
            from video_learning_tpu import run_task as jrt
            from video_learning_tpu.batching import BatchGeometry as JGeo
            feed, batches = feeder.get_feed(model.required_input)
            feed, _, _ = JGeo().pad_feed(jrt._prepare_feed(feed, batches,
                                                           model))
            serve, names, specs = val.build_serving_fn(params, feed)
            logits = np.asarray(jax.jit(serve)(*[feed[n] for n in names]))
            specs = [(tuple(sp.shape), str(np.dtype(sp.dtype)))
                     for sp in specs]
        else:
            feed, _, _ = tinf.next_val_feed(feeder, model, BatchGeometry())
            serve, names, specs = val.build_serving_fn(params, feed)
            logits = serve(*[feed[n] for n in names]).numpy()
            np.testing.assert_array_equal(logits,
                                          val.run_forward(params, feed))
        out[name] = (names, specs, logits)
    assert out["port"][:2] == out["jax"][:2]
    want = out["jax"][2]
    assert np.all(np.abs(out["port"][2] - want)
                  <= 1e-5 * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("mode", ["float", "int8", "buckets", "host"])
def test_export_load_call_equals_infer(video_run, tmp_path, mode):
    """``host``: frames preprocessed on the host, so the artifact takes
    float32 frames at the crop, as the val feed gives them."""
    root, cfg, vids = video_run
    if mode == "host":
        cfg = _host_preprocessed(cfg, tmp_path)
    out = str(tmp_path / "m.zip")
    argv = [cfg, "--out", out, "--device", "cpu", "--ema",
            "--batch-items", "1,2" if mode == "buckets" else "2"]
    if mode == "int8":
        argv.append("--int8")
    meta = texp.main(argv)
    assert meta["quantize"] == ("int8" if mode == "int8" else None)
    assert meta["ema"] is True and meta["run_id"] == "inf_infer_val_resume"
    module = serving.load(out, device="cpu")
    assert module.meta == meta
    assert [i["dtype"] for i in meta["inputs"]] == (
        ["float32"] if mode == "host" else ["uint8", "int32"])
    feed, logits = _context_feed(cfg, vids[:2], tmp_path, batch_size=2,
                                 use_ema=True,
                                 int8=mode == "int8")
    arrays = [feed[i["name"]] for i in module.meta["inputs"]]
    got = module(*arrays)
    assert got.shape == logits.shape == (2 * CPV, 3)
    if mode == "int8":
        np.testing.assert_array_equal(got, logits)
        return
    tol = 1e-5 * np.maximum(1.0, np.abs(logits))
    assert np.all(np.abs(got - logits) <= tol)
    if mode == "buckets":
        assert module.last_bucket == 2
        one = module(*[a[:a.shape[0] // 2] for a in arrays])
        assert module.last_bucket == 1
        assert np.all(np.abs(one - logits[:CPV]) <= tol[:CPV])


def test_int8_static_export_calibrates_on_its_signature_batch(
        video_run, tmp_path):
    """The artifact's static scales are those a val pass calibrates on
    the signature batch (its .ppm dummy media, kept in ``--workdir``),
    and the loaded artifact gives that pass's logits exactly."""
    root, cfg, vids = video_run
    out = str(tmp_path / "s.zip")
    work = tmp_path / "sig"
    meta = texp.export(cfg, out, "latest", batch_items=2, int8="static",
                       workdir=str(work), device="cpu")
    assert meta["quantize"] == "int8_static" and meta["act_ranges"]
    media = sorted(str(work / d) for d in os.listdir(work)
                   if d.startswith("export_vid"))
    feed, logits = _context_feed(cfg, media, tmp_path, batch_size=2,
                                 int8="static")
    module = serving.load(out, device="cpu")
    got = module(*[feed[i["name"]] for i in module.meta["inputs"]])
    np.testing.assert_array_equal(got, logits)


def test_meta_has_jax_keys_and_values(video_run, tmp_path):
    root, cfg, vids = video_run
    jmeta = jexp.export(cfg, str(tmp_path / "j.vlx"), "latest",
                        batch_items=[1, 2], platforms="cpu", use_ema=True)
    tmeta = texp.export(cfg, str(tmp_path / "t.zip"), "latest",
                        batch_items=[1, 2], use_ema=True, device="cpu")
    missing = set(jmeta) - set(tmeta)
    assert missing == set(JAX_ONLY_META)
    for key in set(jmeta) - missing - {"format"}:
        assert tmeta[key] == jmeta[key], key
    assert tmeta["ema"] is True and tmeta["run_id"] == jmeta["run_id"]


def test_meta_of_a_module_built_outside_export_and_of_old_artifacts(
        tmp_path):
    """A ServingModule built directly records ema false and run_id null;
    an artifact written without the two keys loads with those values."""
    from video_learning_tpu_torch.flagship import flagship
    _, model = flagship(num_classes=3, fpc=2)
    module = serving.ServingModule(model, model.init_params(0, device="cpu"),
                                   batch_items=1, device="cpu")
    assert module.meta["ema"] is False and module.meta["run_id"] is None
    path = str(tmp_path / "old.zip")
    module.save(path)
    old = str(tmp_path / "older.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(old, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                meta = json.loads(data)
                del meta["ema"], meta["run_id"]
                data = json.dumps(meta).encode()
            dst.writestr(name, data)
    loaded = serving.load(old, device="cpu")
    assert loaded.meta["ema"] is False and loaded.meta["run_id"] is None


def test_export_refuses_mesh_and_platforms(video_run, tmp_path):
    _, cfg, _ = video_run
    out = str(tmp_path / "x.zip")
    with pytest.raises(TError, match="--mesh"):
        texp.main([cfg, "--out", out, "--mesh", "data=2", "--device",
                   "cpu"])
    with pytest.raises(TError, match="--platforms"):
        texp.main([cfg, "--out", out, "--platforms", "cpu", "--device",
                   "cpu"])
    assert not os.path.exists(out)
