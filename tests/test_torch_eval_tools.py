"""The port's evaluation tools against the JAX package's:
``evaluate_multiple_checkpoints`` / ``validate_checkpoints`` over two
checkpoints of a tiny JSON run at the flagship geometry (67x67 crops of
72x72 frames, fpc 4, cpv 2, AlexNet to fc6 from a bvlc-schema file that
keeps the LSTM out of saturation, a 1x32 LSTM, 3 classes, float32), the
logit tools on the logits the port's ``Validation`` wrote and the
metrics its ``run_task`` wrote, ``validate_pretrained`` on a synthesized
1000-class bvlc file, and ``profile_ablation`` on the CPU at a tiny
size (its rows and names; the JAX tool is not run here)."""

import glob
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_run_task import _normwise, _pack
from tests.test_torch_tools import logged
from video_learning_tpu.models import alexnet as jalexnet
from video_learning_tpu.tools import combine_logits as jcl
from video_learning_tpu.tools import compute_evaluation_stats as jces
from video_learning_tpu.tools import evaluate_multiple_checkpoints as jemc
from video_learning_tpu.tools import plot_metrics as jpm
from video_learning_tpu.tools import validate_pretrained as jvp
from video_learning_tpu.tools import view_logits_info as jvli
from video_learning_tpu_torch import run_task as trun
from video_learning_tpu_torch.tools import combine_logits as tcl
from video_learning_tpu_torch.tools import compute_evaluation_stats as tces
from video_learning_tpu_torch.tools import evaluate_multiple_checkpoints \
    as temc
from video_learning_tpu_torch.tools import plot_metrics as tpm
from video_learning_tpu_torch.tools import profile_ablation as tpa
from video_learning_tpu_torch.tools import validate_checkpoints as tvc
from video_learning_tpu_torch.tools import validate_pretrained as tvp
from video_learning_tpu_torch.tools import view_logits_info as tvli

VIDEOS, FRAMES, RAW, CROP = 3, 12, 72, 67


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's 227x227 AlexNet passes: the
    suite runs six workers on the machine's cores, and more threads a
    worker only contend."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights_npy(folder):
    """A bvlc-schema weights file for 67x67 inputs that keeps the LSTM's
    gates out of saturation (``test_torch_run_task._weights_npy``'s
    law at this crop)."""
    rng = np.random.RandomState(11)
    net = {}
    for name, (kh, kw, cin, cout, _, _) in jalexnet._CONV_SPECS.items():
        w = rng.randn(kh, kw, cin, cout) * np.sqrt(2.0 / (kh * kw * cin))
        net[name] = [w.astype(np.float32), np.full(cout, 0.1, np.float32)]
    fc6_in = jalexnet.conv_output_flat_dim((CROP, CROP, 3))
    net["fc6"] = [(rng.randn(fc6_in, 4096) * np.sqrt(0.08 / fc6_in) / 74.0)
                  .astype(np.float32), np.full(4096, 0.02, np.float32)]
    path = os.path.join(str(folder), "weights.npy")
    np.save(path, np.asarray(net, dtype=object), allow_pickle=True)
    return path


def _config(folder, data_path, weights, phase, run_folder):
    cfg = {
        "resume_file": None, "run_folder": run_folder, "run_id": "ev",
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
                        "weights_file": weights}},
            {"clf": {"input": "frames",
                     "representation": "defs.representation.nop",
                     "classifier": "defs.classifier.lstm",
                     "lstm_params": [32, 1, "defs.fusion_method.avg"]}}]},
        "train": {"batch_size": 2, "epochs": 2,
                  "optimizer": "defs.optim.sgd", "base_lr": 0.01,
                  "clip_norm": 10, "dropout_keep_prob": 1.0},
        "val": {"batch_size": 2, "logits_save_interval": -1, "top_k": [2],
                "clip_fusion": ["defs.fusion_type.late",
                                "defs.fusion_method.avg"]},
        "logging": {"save_freq_per_epoch": 1, "level": "logging.INFO",
                    "tensorboard_folder": "tb"},
    }
    os.makedirs(run_folder, exist_ok=True)
    path = os.path.join(str(folder), "%s.json" % phase)
    with open(path, "w") as f:
        json.dump({"run": cfg}, f, indent=1)
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of the port's ``run_task`` on the CPU, saving each
    epoch: (root, list file, val config, the two checkpoints)."""
    from PIL import Image
    from tests.conftest import make_image
    root = tmp_path_factory.mktemp("eval_tools")
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
    _pack(root, tree, raw=RAW)
    weights = _weights_npy(root)
    train_rf = str(root / "train_run")
    trun.main(_config(root, str(tree), weights, "train", train_rf),
              device="cpu")
    ckpts = sorted(glob.glob(os.path.join(train_rf, "checkpoints",
                                          "*.ckpt")))
    val_cfg = _config(root, str(tree), weights, "val", str(root / "val_run"))
    return root, str(tree), val_cfg, ckpts


def test_evaluate_checkpoints_and_logit_tools_as_jax(trained, tmp_path,
                                                     caplog):
    """In process on the CPU, the port's evaluation of each checkpoint
    (``validate_checkpoints`` over the run's folder) writes JAX's
    accuracy, from the same JSON config; ``--only`` / ``--omit`` select by
    epoch.  Then combine_logits (a checkpoint's logits with themselves,
    and the two checkpoints'), compute_evaluation_stats and
    view_logits_info on the logits the port's ``Validation`` wrote, and
    plot_metrics on the metrics its ``run_task`` wrote: JAX's results and
    lines."""
    root, tree, val_cfg, ckpts = trained
    assert [temc.checkpoint_epoch(c) for c in ckpts] == [1, 2]
    names = [os.path.basename(c) for c in ckpts]
    ck_dir = os.path.dirname(ckpts[0])
    run_folder = str(root / "val_run")
    port = tvc.main([val_cfg, ck_dir, "--device", "cpu"])
    assert os.path.exists(os.path.join(run_folder, "eval_ckpt_1.json"))
    jax = jemc.evaluate(val_cfg, checkpoints_dir=ck_dir)
    assert sorted(port) == names
    assert port == jax
    assert all(a is not None for a in port.values())

    pickles = []
    for i, kw in ((0, {"omit": [2]}), (1, {"only": [2]})):
        for f in glob.glob(os.path.join(run_folder, "validation_logits_*")):
            os.remove(f)
        assert temc.evaluate(val_cfg, checkpoints_dir=ck_dir, device="cpu",
                             **kw) == {names[i]: port[names[i]]}
        (total,) = glob.glob(os.path.join(run_folder, "*.total"))
        pickles.append(shutil.copy(total, str(tmp_path / ("%d.pickle"
                                                          % i))))
    sweeps = []
    for paths in ([pickles[0]] * 2, pickles):
        outs = [logged(caplog, fn, paths, [tree] * 2)
                for fn in (jcl.combine, tcl.combine)]
        assert outs[1] == outs[0]
        sweeps.append(outs[1][0])
    # a run's logits combined with themselves: its accuracy at every weight
    assert {row[-1] for row in sweeps[0]} == {port[names[0]]}
    for p in pickles:
        for argv, fns in ((["prog", p, tree, "3"], (jces.main, tces.main)),
                          (["prog", p], (jvli.main, tvli.main))):
            outs = [logged(caplog, fn, argv) for fn in fns]
            assert outs[1] == outs[0]
    (metrics,) = glob.glob(os.path.join(str(root / "train_run"), "tb",
                                        "train", "metrics_*.jsonl"))
    outs = [logged(caplog, fn, metrics) for fn in (jpm.summarize,
                                                   tpm.summarize)]
    assert outs[1] == outs[0] and "loss" in outs[1][0]


def test_evaluate_subprocess_command_line(trained, monkeypatch):
    """``--subprocess`` runs ``python -m video_learning_tpu_torch.run_task
    <eval_ckpt_i.json> --device <device>`` (a patched ``subprocess.run``:
    no child starts here), reads the accuracy file it writes, and skips a
    checkpoint whose run fails."""
    root, _, val_cfg, ckpts = trained
    run_folder = str(root / "val_run")
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        with open(cmd[3]) as f:
            run = json.load(f)["run"]
        assert run["phase"] == "defs.phase.val"
        assert run["resume_file"] in ckpts
        ok = len(calls) == 1
        if ok:
            with open(os.path.join(run_folder, "accuracy_sub%d"
                                   % len(calls)), "w") as f:
                f.write("0.25")
        return subprocess.CompletedProcess(cmd, 0 if ok else 1)

    monkeypatch.setattr(temc.subprocess, "run", fake_run)
    out = temc.main([val_cfg, "--checkpoints-dir",
                     os.path.dirname(ckpts[0]), "--subprocess",
                     "--device", "cpu"])
    assert out == {os.path.basename(ckpts[0]): 0.25}
    assert calls == [
        [sys.executable, "-m", "video_learning_tpu_torch.run_task",
         os.path.join(run_folder, "eval_ckpt_%d.json" % i), "--device",
         "cpu"] for i in (0, 1)]


def test_filter_checkpoints_as_jax():
    ckpts = ["x/170101_ep_1_btch_2_gs_2.ckpt",
             "x/170102_ep_2_btch_2_gs_4.ckpt",
             "x/170103_ep_3_btch_2_gs_6.ckpt", "x/best.ckpt"]
    for kw in ({"only": [2]}, {"omit": [2]}, {"only": [1, 3], "omit": [3]},
               {}):
        assert temc.filter_checkpoints(ckpts, **kw) == \
            jemc.filter_checkpoints(ckpts, **kw)
    assert [temc.checkpoint_epoch(c) for c in ckpts] == \
        [jemc.checkpoint_epoch(c) for c in ckpts] == [1, 2, 3, None]


# --------------------------------------------------- validate_pretrained
def _full_bvlc(path, seed=0):
    rng = np.random.default_rng(seed)
    net = {layer: [rng.standard_normal(w, np.float32) * np.float32(0.01),
                   rng.standard_normal(b, np.float32) * np.float32(0.1)]
           for layer, (w, b) in jvp.BVLC_SHAPES.items()}
    np.save(path, np.asarray(net, dtype=object), allow_pickle=True)
    return str(path)


def test_validate_pretrained_as_jax(tmp_path, capsys, monkeypatch):
    """On one synthesized 1000-class bvlc file: the port's fc6 / fc7
    features of the fixture image (its first run's) within 1e-4 normwise
    of JAX's (JAX's first run's) in float32, and in each package's own
    folder the same verdicts: the manifest recorded (0), then matched (0:
    each package's fingerprint is stable across its runs), the same
    sidecar digest; a file modified under that manifest 1; a schema
    failure 1; a missing file 2."""
    src = _full_bvlc(tmp_path / "src.npy")
    assert tvp.BVLC_SHAPES == jvp.BVLC_SHAPES
    np.testing.assert_array_equal(tvp.fixture_image(), jvp.fixture_image())
    mod = str(tmp_path / "modified.npy")
    shutil.copyfile(src, mod)
    with open(mod, "r+b") as f:
        f.seek(os.path.getsize(mod) // 2)      # inside fc6's weights
        f.write(b"\x01" * 8)
    bad = tmp_path / "bad.npy"
    np.save(bad, np.asarray({"conv1": [np.zeros((11, 11, 3, 96)),
                                       np.zeros(96)]}, dtype=object),
            allow_pickle=True)

    feats = {"jax": {}, "port": {}}
    japply, tfeatures = jalexnet.apply, tvp.features

    def jax_apply(params, x, final_layer, **kw):
        out = japply(params, x, final_layer=final_layer, **kw)
        feats["jax"].setdefault(final_layer, np.asarray(out)[0])
        return out

    def port_features(*args):
        out = tfeatures(*args)
        for layer, v in out.items():
            feats["port"].setdefault(layer, v)
        return out

    monkeypatch.setattr(jalexnet, "apply", jax_apply)
    monkeypatch.setattr(tvp, "features", port_features)
    verdicts, links = {}, []
    for who, main, extra in (("jax", jvp.main, []),
                             ("port", tvp.main, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        w = str(d / "bvlc_alexnet.npy")
        os.link(src, w)
        links.append(w)
        codes = [main([w] + extra), main([w] + extra)]
        with open(w + ".manifest.json") as f:
            manifest = json.load(f)
        with open(w + ".sha256") as f:
            sidecar = f.read()
        codes.append(main([mod, "--manifest", w + ".manifest.json",
                           "--no-sidecar"] + extra))
        codes.append(main([str(bad)] + extra))
        codes.append(main([str(d / "missing.npy")] + extra))
        out = capsys.readouterr().out
        verdicts[who] = (codes, manifest["sha256"], sorted(
            manifest["features"]), sidecar, [
            line.replace(str(d), "D").replace(str(tmp_path), "T")
            .split(":")[0] for line in out.splitlines()
            if line.startswith(("schema", "manifest", "SCHEMA", "MANIFEST",
                                "sidecar", "  - "))])
        assert not os.path.exists(mod + ".sha256")
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][0] == [0, 0, 1, 1, 2]
    for layer in ("fc6", "fc7"):
        ref = feats["jax"][layer]
        assert feats["port"][layer].shape == ref.shape == (4096,)
        assert _normwise(feats["port"][layer], ref) <= 1e-4, layer
    for path in [src, mod] + links:     # 244 MB a file: free the disk
        os.remove(path)


# ------------------------------------------------------ profile_ablation
JAX_ROWS = ["preprocess (crop+mean+mir)", "alexnet fwd (fc7)",
            "alexnet fwd+bwd", "alexnet fwd+bwd, LRN=id",
            "lrn (2, 57, 57, 96)", "lrn (2, 28, 28, 256)",
            "lstm 2x256 fwd+bwd"]


def test_profile_ablation_rows_on_the_cpu(capsys):
    """Both modes at --batch-clips 1 --fpc 2 --inner 1 --reps 1 on the
    CPU: the JAX tool's rows in its order and under its names
    (``profile_ablation.py:170-255``, ``:82-83``), every time positive
    and finite, and no kernel launched (the plain versions run on the
    CPU)."""
    small = ["--batch-clips", "1", "--fpc", "2", "--inner", "1",
             "--reps", "1", "--device", "cpu"]
    rows = tpa.main(small)
    assert [r[0] for r in rows] == JAX_ROWS
    out = capsys.readouterr().out
    assert "approx step (pre + alexnet-grad + lstm-grad)" in out
    layers = tpa.main(small + ["--per-layer"])
    assert [r[0] for r in layers] == ["conv1", "lrn1", "pool1", "conv2",
                                      "lrn2", "pool2", "conv3", "conv4",
                                      "conv5", "fc6", "fc7"]
    for r in rows + layers:
        assert math.isfinite(r[1]) and r[1] > 0, r
        assert r[-1] == {}, r
    assert layers[-1][1] == pytest.approx(sum(r[2] for r in layers))
