"""The port on a mesh of processes that share a run folder: the
counterpart of ``tests/test_multiprocess.py`` and
``tests/test_multiprocess_cli.py``.

Ranks are gloo processes on the CPU, started by
``video_learning_tpu_torch.parallel.launch`` (rank functions in
``torch_mesh_worker.py``, which import neither JAX nor the JAX package)
or by ``python -m torch.distributed.run``, as a user starts them.  The
data is a tiny video set packed by the JAX serializer (4 videos of 112x112
frames, fpc 4, cpv 2) and the model is ``test_torch_run_task.py``'s
(AlexNet to fc6 from a bvlc-schema weights file, a 1x32 LSTM, 3 classes,
float32, dropout off).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_worker as worker
from test_torch_run_task import _pack, _run, _weights_npy, RAW, FRAMES
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch.config import Settings, ValOpts
from video_learning_tpu_torch.models.pipeline import Model
from video_learning_tpu_torch.parallel import launch
from video_learning_tpu_torch.tools import dryrun_multichip
from video_learning_tpu_torch.val import Validation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
VIDEOS = 4


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    from PIL import Image
    from tests.conftest import make_image
    root = tmp_path_factory.mktemp("multiprocess")
    vids = []
    for v in range(VIDEOS):
        vdir = root / ("vid%d" % v)
        vdir.mkdir()
        for i in range(FRAMES):
            Image.fromarray(make_image(RAW, RAW, seed=v * 50 + i)).save(
                vdir / ("f_%04d.jpg" % i), quality=95)
        vids.append(vdir)
    tree = root / "videos.train"
    tree.write_text("".join("%s %d\n" % (v, i % 3)
                            for i, v in enumerate(vids)))
    _pack(root, tree)
    _weights_npy(root)
    return root, str(tree)


def _config(folder, data, mesh_shape, **kw):
    """``test_torch_run_task``'s run config on ``mesh_shape``, with a
    val-phase dataset for an inline eval when the train block asks for
    one."""
    path, run_folder = _run(folder, data, extra={"mesh_shape": mesh_shape},
                            **kw)
    if (kw.get("train") or {}).get("eval_every_epochs"):
        with open(path) as f:
            doc = json.load(f)
        doc["run"]["data"]["tinyval"] = dict(
            doc["run"]["data"]["tinyvid"], phase="defs.phase.val")
        with open(path, "w") as f:
            json.dump(doc, f)
    return path, run_folder


def _torchrun(cfg, cwd, nproc=2):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m",
         "video_learning_tpu_torch.run_task", cfg, "--device", "cpu"],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-6000:])
    return res


# ------------------------------------------------------ host shards, steps
@pytest.fixture(scope="module")
def trained(packed, tmp_path_factory):
    root, data = packed
    folder = tmp_path_factory.mktemp("ranks")
    cfg, _ = _config(folder / "data", data, {"data": 2}, epochs=2)
    model_cfg, _ = _config(folder / "model", data, {"data": 1, "model": 2},
                           epochs=2)
    res = launch.run(2, "torch_mesh_worker:packed_training", {
        "config": cfg, "model_axis_config": model_cfg,
        "folder": str(folder)}, device="cpu", backend="gloo", threads=2,
        timeout=600, path=TESTS)
    return folder, data, res


def test_two_ranks_train_on_their_host_shards_with_equal_losses(trained):
    """``host_shards: auto`` on a data axis of 2 gives the ranks disjoint
    halves of the training set, and both see the same (global) loss at
    every step of two epochs."""
    _, _, res = trained
    a, b = res
    assert a["mesh"] == b["mesh"] == {"data": 2, "model": 1}
    assert a["data_axis"]["shards"] == [2, 0]
    assert b["data_axis"]["shards"] == [2, 1]
    assert a["data_axis"]["items"] == [0, VIDEOS // 2]
    assert b["data_axis"]["items"] == [VIDEOS // 2, VIDEOS // 2]
    assert len(a["losses"]) == 2 and np.all(np.isfinite(a["losses"]))
    assert a["losses"] == b["losses"]


def test_model_group_ranks_read_the_same_rows(trained):
    """On a (1, 2) mesh ``host_shards: auto`` splits nothing: both ranks
    of the model group read the same rows (the shard count is the data
    size and the index the data coordinate, not the world size and the
    rank)."""
    _, _, res = trained
    a, b = res
    assert a["model_axis"] == b["model_axis"]
    assert a["model_axis"]["shards"] == [1, 0]
    assert a["model_axis"]["items"] == [0, VIDEOS]


def test_each_rank_evaluates_its_own_rows(trained, tmp_path):
    """A rank's ``run_forward`` rows are the single-process forward of
    that rank's feed with the same (gathered) parameters."""
    folder, data, res = trained
    cfg, _ = _config(tmp_path, data, {"data": 1}, epochs=2)
    settings = Settings()
    settings.initialize(cfg)
    settings.val = ValOpts()
    model = Model(settings)
    params = ckpt.load_params(str(folder / "params.ckpt"), "cpu")
    val = Validation(settings, model, device="cpu")
    for r in range(2):
        with np.load(str(folder / ("rank%d.npz" % r))) as z:
            feed = {k[5:]: z[k] for k in z.files if k.startswith("feed/")}
            logits = z["logits"]
        want = val.run_forward(params, feed)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(logits, want, rtol=0, atol=1e-5 * scale)


# ------------------------------------------------------------- run_task
@pytest.fixture(scope="module")
def run_folder(packed, tmp_path_factory):
    """A 2-rank ``run_task`` train phase (2 epochs, inline eval keeping
    the best) started by ``torch.distributed.run``."""
    root, data = packed
    folder = tmp_path_factory.mktemp("cli")
    cfg, rf = _config(folder, data, {"data": 2}, epochs=2, train={
        "eval_every_epochs": 1, "eval_keep_best": True})
    _torchrun(cfg, folder)
    return folder, data, cfg, rf


def _steps(rf):
    files = glob.glob(os.path.join(rf, "tb", "train", "metrics_*.jsonl"))
    return files, [json.loads(line)["step"] for f in files for line in
                   open(f) if "loss" in json.loads(line)]


def test_run_task_on_two_ranks_writes_each_artifact_once(run_folder):
    """One metrics JSONL with each step once, each rotation checkpoint
    once with its .snap, ``best.ckpt``, ``eval_state.json`` and no
    half-written files; a val phase on two ranks writes the accuracy
    files and one ``.total`` chunk with a row per video."""
    folder, data, _, rf = run_folder
    files, steps = _steps(rf)
    assert len(files) == 1 and steps == [1, 2]
    ckpts = sorted(glob.glob(os.path.join(rf, "checkpoints", "*_gs_*.ckpt")))
    progress = [os.path.basename(c).split("_", 2)[2] for c in ckpts]
    assert ckpts and len(set(progress)) == len(progress)
    assert all(os.path.exists(c + ".snap") for c in ckpts)
    assert os.path.exists(os.path.join(rf, "checkpoints", "best.ckpt"))
    with open(os.path.join(rf, "checkpoints", "eval_state.json")) as f:
        assert sorted(json.load(f)) == ["best_acc", "stale_evals"]
    assert not glob.glob(os.path.join(rf, "**", "*.tmp"), recursive=True)

    vcfg, vrf = _config(folder / "val", data, {"data": 2}, phase="val",
                        resume=max(ckpts, key=os.path.getmtime))
    _torchrun(vcfg, folder / "val")
    (total,) = glob.glob(os.path.join(vrf, "validation_logits_*.total"))
    assert np.load(total, allow_pickle=True).shape == (VIDEOS, 3)
    for name in ("accuracy_rt*", "accuracy_top2_rt*"):
        (path,) = glob.glob(os.path.join(vrf, name))
        assert 0.0 <= float(open(path).read()) <= 1.0


def test_run_task_on_two_ranks_resumes_from_the_shared_folder(run_folder):
    """A third epoch resumed from ``latest`` by both ranks continues at
    the next global step."""
    folder, data, _, rf = run_folder
    cfg, rf2 = _config(folder, data, {"data": 2}, epochs=3, resume="latest",
                       train={"eval_every_epochs": 1,
                              "eval_keep_best": True})
    assert rf2 == rf
    _torchrun(cfg, folder)
    files, steps = _steps(rf)
    assert len(files) == 2 and sorted(steps) == [1, 2, 3]


# --------------------------------------------------------------- export
def test_mesh_export_loads_and_serves_as_one_process(run_folder, tmp_path):
    """``export(mesh_shape={"data": 2})`` in a 2-rank group records the
    mesh, ``serving.load`` rebuilds it in the group, and a call with the
    whole batch gives every rank the logits of the single-process
    artifact of the same checkpoint; a bucket whose rows the data axis
    does not divide is refused with JAX's message.  ``tools.serve`` of
    the mesh artifact: rank 0 answers concurrent requests of 1, 2 and 3
    items (coalesced) and one ``--no-batch`` request with the
    single-process module's rows while rank 1 follows, both ranks
    return after each stop, a dispatch idle past its keepalive still
    serves, and when the follower fails rank 0 answers with errors
    instead of hanging."""
    from video_learning_tpu_torch.serving import load
    from video_learning_tpu_torch.tools.export_serving import export
    folder, data, _, rf = run_folder
    cfg, _ = _config(tmp_path / "cfg", data, {"data": 1}, epochs=2)
    with open(cfg) as f:
        doc = json.load(f)
    doc["run"]["run_folder"] = rf
    with open(cfg, "w") as f:
        json.dump(doc, f)
    out = str(tmp_path / "mesh.zip")
    res = launch.run(2, "torch_mesh_worker:mesh_export", {
        "config": cfg, "out": out}, device="cpu", backend="gloo",
        threads=2, timeout=600, path=TESTS)
    single = str(tmp_path / "one.zip")
    meta = export(cfg, single, checkpoint="latest", batch_items=[2, 4],
                  device="cpu")
    assert "mesh" not in meta
    module = load(single, device="cpu")
    rs = np.random.RandomState(0)
    arrays = [rs.randint(0, 255, [3 * s["shape"][0] // 4] + s["shape"][1:])
              .astype(s["dtype"]) for s in module.meta["inputs"]]
    want = module(*arrays)
    scale = max(1.0, float(np.abs(want).max()))
    for r in res:
        assert r["meta_mesh"] == r["loaded_mesh"] == {"data": 2, "model": 1}
        assert r["bucket"] == module.last_bucket == 4
        np.testing.assert_allclose(np.asarray(r["logits"]), want, rtol=0,
                                   atol=1e-5 * scale)
        assert "not divisible by the mesh data axis (2)" in r["refused"]
    served = res[0]["served"]
    assert served["status"] == [200] * len(worker.SERVE_ITEMS)
    assert 'vlx_requests_total{status="200"} 3' in served["metrics"]
    requests = worker.serve_requests(module.meta)
    for got, arrays in zip(served["rows"], requests):
        np.testing.assert_allclose(np.asarray(got), module(*arrays), rtol=0,
                                   atol=1e-5 * scale)
    assert served["no_batch"]["status"] == 200
    np.testing.assert_allclose(np.asarray(served["no_batch"]["rows"]),
                               module(*requests[1]), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(served["after_idle"]),
                               module(*requests[0]), rtol=0,
                               atol=1e-5 * scale)
    # the warm-up's calls and the one after the idle ops
    assert res[1]["served"]["followed_after_idle"] == \
        len(module.meta["buckets"]) + 1
    assert all(500 <= s < 600 for s in served["follower_failed"])
    assert "simulated device fault" in res[1]["served"]["follower_error"]


# -------------------------------------------------------------- dry run
def test_dryrun_multichip_passes_on_four_ranks(capsys):
    """The counterpart of ``__graft_entry__.dryrun_multichip(4)``: a
    (data=2, model=2) step with accum_steps 2 and EMA, the float, int8
    and int8_static forwards and a caption step and decode."""
    line = dryrun_multichip.dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK: mesh=(data=2, model=2) ")
    assert "val_logits=(4, 16)" in line
    assert "caption_decode=(4, 6)" in line
    assert line in capsys.readouterr().out
