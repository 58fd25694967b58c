"""The port's run driver (``video_learning_tpu_torch/run_task.py``) against
the JAX package's ``run_task``, on a tiny video set packed by the JAX
serializer (96x96 crops of 112x112 frames, fpc 4, cpv 2, AlexNet to fc6, a
1x32 LSTM, 3 classes, float32, dropout off).

Both drivers start from one initial checkpoint (JAX init params, global
step 0, ``.snap`` [0, 0, 0], ``resume_file: latest``) and train two
epochs: per-step losses agree within 1e-4 relative, every leaf of the
final checkpoint within 1e-3 normwise, and val phases of either package
resumed from either package's checkpoint write equal accuracy files and
``.total`` logits within 1e-4 x max(1, max|logit|).  The watched tensor
statistics (``param|grad/<name>/mean|std|min|max``) agree within 1e-5 of
the tensor's scale (its largest |min| or |max|), and at the first step,
which both drivers take from the same state, the std within 1e-5 of
itself (over N, not N - 1).  The encoder starts from a bvlc-schema
weights file that keeps the LSTM's gates out of saturation
(``_weights_npy``).  Also: resume from ``latest`` after a SIGTERM
preemption, inline eval with ``eval_keep_best`` and early stop, an int8
val phase, and a caption train + val phase."""

import glob
import json
import os
import pickle
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest
import yaml

from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import run_task as jrun
from video_learning_tpu.config import Settings as JSettings
from video_learning_tpu.data import serialize as ser
from video_learning_tpu.models.pipeline import Model as JModel
from video_learning_tpu_torch import run_task as trun
from video_learning_tpu_torch.train import Train as TTrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEOS, FRAMES, RAW, CROP = 3, 12, 112, 96


def _pack(folder, tree, fpc=4, cpv=2, raw=RAW, mode="rand_clips",
          items=8):
    cfg = {"serialize": {
        "output_folder": None, "path_prepend_folder": None,
        "input_files": [str(tree)], "run_id": "packrun",
        "num_threads": 2, "num_items_per_thread": items,
        "raw_image_shape": "(%d, %d, 3)" % (raw, raw),
        "clip_offset_or_num": cpv, "num_frames_per_clip": fpc,
        "clipframe_mode": "defs.clipframe_mode.%s" % mode,
        "generation_error": "defs.generation_error.compromise",
        "do_shuffle": False, "do_serialize": True, "do_validate": False,
        "validate_pcnt": 100, "frame_format": "jpg",
        "logging_level": "logging.INFO", "seed": 11}}
    p = os.path.join(str(folder), "pack.yml")
    with open(p, "w") as f:
        yaml.safe_dump(cfg, f)
    cwd = os.getcwd()
    os.chdir(str(folder))     # the serializer logs into the working dir
    try:
        ser.main(["serialize", p])
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    from PIL import Image
    from tests.conftest import make_image
    root = tmp_path_factory.mktemp("run_task")
    vids = []
    for v in range(VIDEOS):
        vdir = root / ("vid%d" % v)
        vdir.mkdir()
        for i in range(FRAMES):
            Image.fromarray(make_image(RAW, RAW, seed=v * 50 + i)).save(
                vdir / ("f_%04d.jpg" % i), quality=95)
        vids.append(vdir)
    tree = root / "videos.train"
    tree.write_text("".join("%s %d\n" % (v, i) for i, v in enumerate(vids)))
    _pack(root, tree)
    _weights_npy(root)
    return root, str(tree)


def _weights_npy(folder):
    """A bvlc-schema weights file: He-scaled convs with biases 0.1, and
    an fc6 that brings its outputs to ~0.3 (1/74 for the mean-subtracted
    pixels' scale folded in).  The fresh init's O(1e3) fc6 outputs would
    saturate the LSTM's gates, where float32 rounding differences between
    the packages grow by the saturation's slope; here the comparison is
    well conditioned."""
    from video_learning_tpu.models.alexnet import (_CONV_SPECS,
                                                   conv_output_flat_dim)
    rng = np.random.RandomState(11)
    net = {}
    for name, (kh, kw, cin, cout, _, _) in _CONV_SPECS.items():
        w = rng.randn(kh, kw, cin, cout) * np.sqrt(2.0 / (kh * kw * cin))
        net[name] = [w.astype(np.float32), np.full(cout, 0.1, np.float32)]
    fc6_in = conv_output_flat_dim((CROP, CROP, 3))
    net["fc6"] = [(rng.randn(fc6_in, 4096) * np.sqrt(0.08 / fc6_in) / 74.0)
                  .astype(np.float32), np.full(4096, 0.02, np.float32)]
    path = os.path.join(str(folder), "weights.npy")
    np.save(path, np.asarray(net, dtype=object), allow_pickle=True)
    return path


def _run(folder, data_path, phase="train", resume=None, epochs=2,
         run_id="rt", train=None, val=None, logging=None, extra=None):
    """A run config (JSON, read by both packages) and its run folder."""
    run_folder = os.path.join(str(folder), "run")
    cfg = {
        "resume_file": resume, "run_folder": run_folder, "run_id": run_id,
        "seed": 3, "mesh_shape": {"data": 1}, "compute_dtype": "float32",
        "phase": "defs.phase.%s" % phase,
        "data": {"tinyvid": {
            "data_path": data_path,
            "raw_image_shape": "(%d, %d, 3)" % (RAW, RAW),
            "image_shape": "(%d, %d, 3)" % (CROP, CROP),
            "mean_image": [99.2, 105.3, 109.5],
            "data_format": "defs.data_format.tfrecord",
            "frame_format": "jpg",
            "imgproc": ["defs.imgproc.center_crop", "defs.imgproc.sub_mean"],
            "batch_item": "defs.batch_item.default",
            "phase": "defs.phase.%s" % phase,
            "tag": "defs.dataset_tag.main"}},
        "network": {"num_classes": 3, "pipelines": [
            {"frames": {"input": "defs.dataset_tag.main",
                        "representation": "defs.representation.dcnn",
                        "frame_encoding_layer": "fc6",
                        "weights_file": os.path.join(
                            os.path.dirname(data_path), "weights.npy")}},
            {"clf": {"input": "frames",
                     "representation": "defs.representation.nop",
                     "classifier": "defs.classifier.lstm",
                     "lstm_params": [32, 1, "defs.fusion_method.avg"]}}]},
        "train": dict({"batch_size": 2, "epochs": epochs,
                       "optimizer": "defs.optim.sgd", "base_lr": 0.001,
                       "lr_mult": 2.0,
                       "lr_decay": ["defs.decay.exp",
                                    "defs.periodicity.drops", 2, 0.9],
                       "clip_norm": 10, "dropout_keep_prob": 1.0},
                      **(train or {})),
        "val": dict({"batch_size": 2, "logits_save_interval": -1,
                     "top_k": [2],
                     "clip_fusion": ["defs.fusion_type.late",
                                     "defs.fusion_method.avg"]},
                    **(val or {})),
        "logging": dict({"save_freq_per_epoch": 1, "level": "logging.INFO",
                         "tensorboard_folder": "tb"}, **(logging or {})),
    }
    cfg.update(extra or {})
    os.makedirs(str(folder), exist_ok=True)
    path = os.path.join(str(folder), "%s.json" % phase)
    with open(path, "w") as f:
        json.dump({"run": cfg}, f, indent=1)
    return path, run_folder


def _jax_init_checkpoint(folder, data_path, run_folders, **kw):
    """JAX init params at global step 0 with a .snap [0, 0, 0] in each of
    ``run_folders``' checkpoints, the starting point of both drivers."""
    path, _ = _run(os.path.join(str(folder), "init"), data_path, **kw)
    return _init_checkpoints(path, run_folders)


def _init_checkpoints(path, run_folders):
    """``_jax_init_checkpoint`` of the run config at ``path``."""
    import jax
    settings = JSettings()
    settings.initialize(path)
    params = JModel(settings).init_params(jax.random.PRNGKey(7))
    state = {"params": jax.tree_util.tree_map(np.asarray, params),
             "global_step": np.asarray(0)}
    for rf in run_folders:
        os.makedirs(os.path.join(rf, "checkpoints"), exist_ok=True)
        ckpt = os.path.join(rf, "checkpoints", "init.ckpt")
        jckpt.save_checkpoint(ckpt, state)
        with open(ckpt + ".snap", "w") as f:
            json.dump([0, 0, 0], f)
    return state


def _metrics(run_folder, phase="train"):
    """The metrics records of a run folder's phase, oldest file first."""
    files = sorted(glob.glob(os.path.join(run_folder, "tb", phase,
                                          "metrics_*.jsonl")),
                   key=os.path.getmtime)
    return [json.loads(line) for f in files for line in open(f)]


def _latest(run_folder):
    ckpts = glob.glob(os.path.join(run_folder, "checkpoints", "*_gs_*.ckpt"))
    return max(ckpts, key=os.path.getmtime)


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _val_outputs(run_folder):
    accs = {os.path.basename(p).split("_rt")[0]: open(p).read()
            for p in glob.glob(os.path.join(run_folder, "accuracy_*"))}
    (total,) = glob.glob(os.path.join(run_folder, "*.total"))
    with open(total, "rb") as f:
        return accs, pickle.load(f)


def _close_logits(port, ref, tol=1e-4):
    """Port logits against JAX's: within ``tol`` x max(1, max|logit|); an
    argmax may differ only where JAX's top-2 margin is under 1e-4."""
    port, ref = np.asarray(port), np.asarray(ref)
    limit = tol * max(1.0, float(np.abs(ref).max()))
    assert np.abs(port - ref).max() <= limit
    top2 = np.sort(ref, axis=1)[:, -2:]
    flips = np.argmax(port, 1) != np.argmax(ref, 1)
    assert np.all(top2[flips, 1] - top2[flips, 0] < 1e-4)
    return int(flips.sum())


def test_both_drivers_train_and_validate_alike(packed, tmp_path):
    """Two epochs of both drivers from one initial checkpoint with EMA,
    an async saver and watched tensors; then four val phases (each
    package from each package's checkpoint, EMA weights)."""
    root, data = packed
    kw = dict(resume="latest",
              train={"ema_decay": 0.9},
              val={"use_ema": True},
              logging={"watch_tensors": ["clf/lstm/cells/0/w",
                                         "output_fc/w$"]},
              extra={"checkpoint_async": True})
    jcfg, jrf = _run(tmp_path / "jax", data, **kw)
    tcfg, trf = _run(tmp_path / "port", data, **kw)
    _jax_init_checkpoint(tmp_path, data, [jrf, trf])
    jrun.main(jcfg)
    trun.main(tcfg, device="cpu")

    jm, tm = _metrics(jrf), _metrics(trf)
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == [1, 2, 3, 4]
    for a, b in zip(tm, jm):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-7)
        watched = sorted(k for k in b if k.startswith(("param/", "grad/")))
        assert watched and sorted(k for k in a if k.startswith(
            ("param/", "grad/"))) == watched
        assert len(watched) == 16     # 2 tensors x param/grad x 4 stats
        for k in watched:
            t, stat = k.rsplit("/", 1)
            scale = max(abs(b[t + "/min"]), abs(b[t + "/max"]))
            assert abs(a[k] - b[k]) <= 1e-5 * scale, k
            if stat == "std" and b["step"] == 1:   # over N, not N - 1
                assert abs(a[k] - b[k]) <= 1e-5 * b[k], k
    assert "clips_per_sec" not in tm[0] and tm[1]["clips_per_sec"] > 0

    jflat = jckpt.load_flat(_latest(jrf))
    tflat = jckpt.load_flat(_latest(trf))
    leaves = [k for k in jflat if k.startswith(("params/", "ema_params/"))]
    assert len(leaves) == 2 * 16
    for k in leaves:
        assert tflat[k].shape == jflat[k].shape, k
        assert _normwise(tflat[k], jflat[k]) <= 1e-3, k
    assert int(tflat["global_step"]) == int(jflat["global_step"]) == 4
    with open(_latest(trf) + ".snap") as f:
        assert json.load(f) == [2, 1, 4]

    outs = {}
    for who, main in (("jax", jrun.main), ("port", trun.main)):
        for src, rf in (("jax", jrf), ("port", trf)):
            vcfg, vrf = _run(tmp_path / ("val_%s_%s" % (who, src)), data,
                             phase="val", resume=_latest(rf), **{
                                 k: v for k, v in kw.items()
                                 if k != "resume"})
            if who == "port":
                main(vcfg, device="cpu")
            else:
                main(vcfg)
            outs[who, src] = _val_outputs(vrf)
    ref_accs, ref_logits = outs["jax", "jax"]
    assert sorted(ref_accs) == ["accuracy", "accuracy_top2"]
    for key, (accs, logits) in outs.items():
        assert logits.shape == ref_logits.shape == (VIDEOS, 3)
        if _close_logits(logits, ref_logits):
            # an argmax within 1e-4 of a tie: reported, not failed
            warnings.warn("%s: an argmax flipped at a near-tie" % (key,))
        else:
            assert accs == ref_accs, key
    # each package evaluates the same weights from either checkpoint
    for who in ("jax", "port"):
        _close_logits(outs[who, "port"][1], outs[who, "jax"][1])


def test_preempted_run_resumes_from_latest(packed, tmp_path, monkeypatch):
    """SIGTERM during step 3 saves a ``_preempt`` checkpoint at batch 1 of
    epoch 2 and stops; resuming from ``latest`` trains the last step, and
    the result equals an uninterrupted run."""
    root, data = packed
    cfg, rf = _run(tmp_path / "straight", data)
    trun.main(cfg, device="cpu")
    straight = jckpt.load_flat(_latest(rf))

    cfg, rf = _run(tmp_path / "preempt", data)
    step = TTrain.run_step

    def run_step(self, feed):
        if self.global_step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self, feed)

    monkeypatch.setattr(TTrain, "run_step", run_step)
    handler = signal.getsignal(signal.SIGTERM)
    trun.main(cfg, device="cpu")
    monkeypatch.setattr(TTrain, "run_step", step)
    (pre,) = glob.glob(os.path.join(rf, "checkpoints", "*_preempt.ckpt"))
    with open(pre + ".snap") as f:
        assert json.load(f) == [1, 1, 3]
    assert len(_metrics(rf)) == 3
    assert signal.getsignal(signal.SIGTERM) == handler

    cfg, _ = _run(tmp_path / "preempt", data, resume="latest")
    trun.main(cfg, device="cpu")
    steps = [m["step"] for m in _metrics(rf)]
    assert steps == [1, 2, 3, 4]
    resumed = jckpt.load_flat(_latest(rf))
    assert int(resumed["global_step"]) == 4
    for k, v in straight.items():
        if k.startswith("params/"):
            assert _normwise(resumed[k], v) <= 1e-6, k


def test_inline_eval_keeps_best_and_stops_early_as_jax(packed, tmp_path):
    """eval_every_epochs 1 with eval_keep_best and early_stop_patience 1
    over up to 4 epochs: the same val_accuracy sequence and the same stop
    as the JAX driver; best.ckpt holds the start of the epoch after the
    best eval, and eval_state.json the best accuracy and the stale
    count."""
    root, data = packed
    kw = dict(epochs=4, resume="latest",
              train={"eval_every_epochs": 1, "eval_keep_best": True,
                     "early_stop_patience": 1, "base_lr": 0.001})
    runs = {}
    for who in ("jax", "port"):
        cfg, rf = _run(tmp_path / who, data, **kw)
        # a val-phase dataset for the inline eval
        with open(cfg) as f:
            doc = json.load(f)
        doc["run"]["data"]["tinyval"] = dict(
            doc["run"]["data"]["tinyvid"], phase="defs.phase.val")
        with open(cfg, "w") as f:
            json.dump(doc, f)
        runs[who] = (cfg, rf)
    _jax_init_checkpoint(tmp_path, data, [runs["jax"][1], runs["port"][1]])
    jrun.main(runs["jax"][0])
    trun.main(runs["port"][0], device="cpu")
    seqs = {}
    for who, (_, rf) in runs.items():
        m = _metrics(rf)
        seqs[who] = [(r["step"], r["val_accuracy"]) for r in m
                     if "val_accuracy" in r]
        with open(os.path.join(rf, "checkpoints", "eval_state.json")) as f:
            seqs[who + "_state"] = json.load(f)
        with open(os.path.join(rf, "checkpoints", "best.ckpt.snap")) as f:
            seqs[who + "_best"] = json.load(f)
    assert seqs["port"] == seqs["jax"]
    assert seqs["port_state"] == seqs["jax_state"]
    assert seqs["port_best"] == seqs["jax_best"]
    evals = seqs["port"]
    assert 2 <= len(evals) <= 4
    if len(evals) < 4:      # stopped early: the last eval did not improve
        assert seqs["port_state"]["stale_evals"] == 1
        assert evals[-1][1] <= max(a for _, a in evals[:-1])
    best = max(a for _, a in evals)
    assert seqs["port_state"]["best_acc"] == best
    best_step = next(s for s, a in evals if a == best)
    assert seqs["port_best"] == [0, best_step // 2, best_step]


def test_int8_val_phase_as_jax(packed, tmp_path):
    """``val: quantize: int8`` and ``int8_static`` (calibrated on the
    first batch) evaluate a shared checkpoint as the JAX package does:
    equal accuracy files, logits within 1e-3 x max(1, max|logit|) (an
    activation within float32 rounding of a .5 step of the int8 grid may
    round the other way in one package, ``test_torch_int8.py``)."""
    root, data = packed
    _jax_init_checkpoint(tmp_path, data, [os.path.join(tmp_path, "run")])
    init = os.path.join(tmp_path, "run", "checkpoints", "init.ckpt")
    for mode in ("int8", "int8_static"):
        outs = {}
        for who, main in (("jax", jrun.main), ("port", trun.main)):
            cfg, rf = _run(tmp_path / (who + mode), data, phase="val",
                           resume=init, val={"quantize": mode})
            main(cfg, **({"device": "cpu"} if who == "port" else {}))
            outs[who] = _val_outputs(rf)
        assert outs["port"][0] == outs["jax"][0]
        _close_logits(outs["port"][1], outs["jax"][1], tol=1e-3)


def test_cli_runs_a_json_config(packed, tmp_path):
    """``python -m video_learning_tpu_torch.run_task config.json --device
    cpu`` trains one epoch and writes a checkpoint, its .snap, the
    metrics and the Chrome trace of ``logging.profile`` (steps [1, 2))."""
    root, data = packed
    cfg, rf = _run(tmp_path, data, epochs=1, logging={"profile": "(1, 1)"})
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m",
                          "video_learning_tpu_torch.run_task", cfg,
                          "--device", "cpu"], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert os.path.exists(_latest(rf) + ".snap")
    assert [m["step"] for m in _metrics(rf)] == [1, 2]
    (trace,) = glob.glob(os.path.join(rf, "profile", "trace_1_2.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


def test_metrics_writer_without_tensorboard_writes_jsonl(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    """``events=True`` where torch.utils.tensorboard cannot be imported:
    a warning, and the JSONL alone, with JAX's file name and records."""
    from video_learning_tpu.observe import MetricsWriter as JWriter
    from video_learning_tpu_torch.observe import MetricsWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    caplog.set_level("WARNING", logger="vlt")
    w = MetricsWriter(str(tmp_path / "port"), "r", "t", events=True)
    assert "writing JSONL only" in caplog.text
    j = JWriter(str(tmp_path / "jax"), "r", "t")
    for writer in (w, j):
        writer.write(3, loss=np.float32(0.5), lr=0.1)
        writer.close()
    recs = [json.loads(open(os.path.join(str(tmp_path), who,
                                         "metrics_r_t.jsonl")).read())
            for who in ("port", "jax")]
    for r in recs:
        r.pop("time")
    assert recs[0] == recs[1] == {"step": 3, "loss": 0.5, "lr": 0.1}
    assert os.listdir(str(tmp_path / "port")) == ["metrics_r_t.jsonl"]


# ------------------------------------------------------------- captioning
def _caption_configs(root, epochs):
    """The captioning example (6 images, AlexNet to fc6 from a
    bvlc-schema file, a 1x32 LSTM over 16-d embeddings), packed by the
    JAX serializer; returns its train and val run documents."""
    old = sys.argv
    sys.argv = ["prep", str(root)]
    try:
        import runpy
        runpy.run_path(os.path.join(
            REPO, "examples/captioning/prepare_captioning.py"),
            run_name="__main__")
    finally:
        sys.argv = old
    cwd = os.getcwd()
    os.chdir(str(root))
    try:
        ser.main(["serialize", os.path.join(str(root), "serialize.yml")])
    finally:
        os.chdir(cwd)
    docs = {}
    for phase in ("train", "val"):
        with open(os.path.join(str(root), phase + ".yml")) as f:
            docs[phase] = yaml.safe_load(f)["run"]
        docs[phase]["train"]["epochs"] = epochs
        docs[phase]["logging"]["save_freq_per_epoch"] = 1
    return docs


def test_caption_train_and_val_phases_as_jax(tmp_path):
    """A caption run: both drivers train 3 epochs from one initial
    checkpoint (losses within 1e-4 relative), then each val phase decodes
    greedily from its own checkpoint: the same coco.results.json and the
    same scores."""
    import jax
    docs = _caption_configs(tmp_path / "cap", epochs=3)
    paths = {}
    for who in ("jax", "port", "init"):
        for phase, doc in docs.items():
            d = json.loads(json.dumps(doc))
            d["run_folder"] = os.path.join(str(tmp_path), who, "run")
            if who != "init":
                d["resume_file"] = "latest"
            path = os.path.join(str(tmp_path), who, phase + ".json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump({"run": d}, f)
            paths[who, phase] = (path, d["run_folder"])
    settings = JSettings()
    settings.initialize(paths["init", "train"][0])
    params = JModel(settings).init_params(jax.random.PRNGKey(5))
    state = {"params": jax.tree_util.tree_map(np.asarray, params),
             "global_step": np.asarray(0)}
    for who in ("jax", "port"):
        ck = os.path.join(paths[who, "train"][1], "checkpoints")
        os.makedirs(ck)
        jckpt.save_checkpoint(os.path.join(ck, "init.ckpt"), state)
        with open(os.path.join(ck, "init.ckpt.snap"), "w") as f:
            json.dump([0, 0, 0], f)
    jrun.main(paths["jax", "train"][0])
    trun.main(paths["port", "train"][0], device="cpu")
    jm, tm = _metrics(paths["jax", "train"][1]), \
        _metrics(paths["port", "train"][1])
    assert len(tm) == len(jm) == 6
    for a, b in zip(tm, jm):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    jrun.main(paths["jax", "val"][0])
    trun.main(paths["port", "val"][0], device="cpu")
    out = {}
    for who in ("jax", "port"):
        rf = paths[who, "val"][1]
        with open(os.path.join(rf, "coco.results.json")) as f:
            res = json.load(f)
        with open(os.path.join(rf, "coco.results.json.eval.json")) as f:
            out[who] = (res, json.load(f))
    assert len(out["port"][0]) == 6
    assert out["port"] == out["jax"]


# ------------------------------------------------------------ two streams
@pytest.fixture
def two_threads():
    """Two intra-op torch threads: the suite runs six workers on the
    machine's cores, and more threads a worker only contend."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _twostream_run(folder, main_path, aux_path, weights, resume="latest"):
    """JAX ``tests/test_multiinput_e2e.py``'s two-stream run as a JSON
    config: video frames on main and images on aux, each through AlexNet
    to fc6 from ``weights`` (``_weights_npy``), fused by ``ibias`` into a
    1x24 LSTM; 2 classes, 2 epochs of 2 steps, SGD, dropout off, a
    save per epoch, resumed from ``resume``.  Returns (path, run
    folder)."""
    def dataset(path, tag):
        return {"data_path": path, "raw_image_shape": "(112, 112, 3)",
                "image_shape": "(96, 96, 3)",
                "mean_image": [99.0, 99.0, 99.0],
                "data_format": "defs.data_format.tfrecord",
                "frame_format": "jpg",
                "imgproc": ["defs.imgproc.center_crop",
                            "defs.imgproc.sub_mean"],
                "batch_item": "defs.batch_item.default",
                "phase": "defs.phase.train",
                "tag": "defs.dataset_tag.%s" % tag}

    def dcnn(tag):
        return {"input": "defs.dataset_tag.%s" % tag,
                "representation": "defs.representation.dcnn",
                "frame_encoding_layer": "fc6", "weights_file": weights}

    run_folder = os.path.join(str(folder), "run")
    cfg = {"run": {
        "resume_file": resume, "run_folder": run_folder, "run_id": "ts",
        "seed": 1, "mesh_shape": {"data": 1}, "compute_dtype": "float32",
        "phase": "defs.phase.train",
        "data": {"frames_set": dataset(main_path, "main"),
                 "specs_set": dataset(aux_path, "aux")},
        "network": {"num_classes": 2, "pipelines": [
            {"frames": dcnn("main")}, {"spectros": dcnn("aux")},
            {"combo": {"input": ["frames", "spectros"],
                       "representation": "defs.representation.nop",
                       "input_fusion": "defs.fusion_method.ibias",
                       "classifier": "defs.classifier.lstm",
                       "lstm_params": [24, 1, "defs.fusion_method.avg"]}}]},
        "train": {"batch_size": 2, "epochs": 2,
                  "optimizer": "defs.optim.sgd", "base_lr": 0.001,
                  "lr_mult": None, "lr_decay": None, "clip_norm": 5,
                  "dropout_keep_prob": 1.0},
        "val": {"batch_size": 2, "logits_save_interval": -1,
                "clip_fusion": ["defs.fusion_type.late",
                                "defs.fusion_method.avg"]},
        "logging": {"save_freq_per_epoch": 1, "level": "logging.INFO",
                    "tensorboard_folder": "tb"}}}
    os.makedirs(str(folder), exist_ok=True)
    path = os.path.join(str(folder), "train.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, run_folder


def test_two_streams_train_alike_in_both_drivers(tmp_path, two_threads):
    """JAX ``tests/test_multiinput_e2e.py``'s run (4 videos of 8 112x112
    frames on main, one image a video on aux, ibias fusion into an LSTM)
    for 2 epochs through both drivers from one JAX init checkpoint: the
    losses within 1e-5 relative, every parameter within 1.2e-3
    normwise, the step counts equal."""
    from PIL import Image
    from tests.conftest import make_image
    main_dir, aux_dir = tmp_path / "main", tmp_path / "aux"
    lines = {"main": [], "aux": []}
    for v in range(4):
        vdir = main_dir / ("vid%d" % v)
        vdir.mkdir(parents=True)
        for i in range(8):
            Image.fromarray(make_image(112, 112, seed=v * 31 + i)).save(
                vdir / ("f_%04d.jpg" % i), quality=95)
        lines["main"].append("%s %d\n" % (vdir, v % 2))
        aux_dir.mkdir(exist_ok=True)
        spec = aux_dir / ("spec_%d.jpg" % v)
        Image.fromarray(make_image(112, 112, seed=900 + v)).save(
            spec, quality=95)
        lines["aux"].append("%s %d\n" % (spec, v % 2))
    trees = {}
    for name, folder, fpc, mode in (("main", main_dir, 4, "rand_clips"),
                                    ("aux", aux_dir, 1, "iterative")):
        trees[name] = folder / ("%s.train" % name)
        trees[name].write_text("".join(lines[name]))
        _pack(folder, trees[name], fpc=fpc, cpv=1, raw=112, mode=mode)
    weights = _weights_npy(tmp_path)
    jcfg, jrf = _twostream_run(tmp_path / "jax", str(trees["main"]),
                               str(trees["aux"]), weights)
    tcfg, trf = _twostream_run(tmp_path / "port", str(trees["main"]),
                               str(trees["aux"]), weights)
    icfg, _ = _twostream_run(tmp_path / "init", str(trees["main"]),
                             str(trees["aux"]), weights, resume=None)
    _init_checkpoints(icfg, [jrf, trf])
    jrun.main(jcfg)
    trun.main(tcfg, device="cpu")

    jm, tm = _metrics(jrf), _metrics(trf)
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == [1, 2, 3, 4]
    for a, b in zip(tm, jm):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    jflat = jckpt.load_flat(_latest(jrf))
    tflat = jckpt.load_flat(_latest(trf))
    assert sorted(tflat) == sorted(jflat)
    leaves = [k for k in jflat if k.startswith("params/")]
    assert any(k.startswith("params/spectros/") for k in leaves)
    assert any(k.startswith("params/combo/lstm/") for k in leaves)
    for k in leaves:
        assert _normwise(tflat[k], jflat[k]) <= 1.2e-3, k
    assert int(tflat["global_step"]) == int(jflat["global_step"]) == 4
