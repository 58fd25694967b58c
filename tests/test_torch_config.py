"""The port's run-config loader against the JAX package's: the shipped
``config.example.yml`` (with ``tests/test_config_example.py``'s
substitutions) and the same document written as JSON give equal
``Settings`` in both packages; the same malformed fields are refused by
both; the fields the port does not carry out (a mesh of more than one
device, the orbax checkpoint backend) are refused, and the one it
ignores (compile_cache) is logged.  Values must be equal."""

import json
import os

import numpy as np
import pytest
import yaml

from video_learning_tpu.config import Settings as JSettings
from video_learning_tpu.utils import FrameworkError as JFrameworkError
from video_learning_tpu_torch import config as tconfig
from video_learning_tpu_torch.config import NETWORK_FIELDS, Settings
from video_learning_tpu_torch.utils import FrameworkError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET_FIELDS = (
    "id", "path", "mean_scalars", "prepend_folder", "desired_image_shape",
    "imgproc", "raw_image_shape", "data_format", "frame_format",
    "batch_item", "num_classes", "tag", "read_tries", "captioning_config",
    "epoch_shuffle", "shuffle_seed", "host_shards", "host_shard_index",
    "device_preprocess")
SETTINGS_FIELDS = (
    "run_id", "resume_file", "seed", "phases", "phase", "num_classes",
    "compute_dtype", "mesh_shape", "remat", "checkpoint_backend",
    "checkpoint_async", "save_freq_per_epoch", "logging_level",
    "tensorboard_folder", "tensorboard_events", "print_tensors",
    "watch_tensors", "profile_steps", "pipeline_names")


def _example_run(tmp_path):
    """config.example.yml's run: document with test_config_example.py's
    substitutions."""
    with open(os.path.join(REPO, "config.example.yml")) as f:
        run = yaml.safe_load(f)["run"]
    run["run_folder"] = str(tmp_path / "run")
    run["network"]["pipelines"] = [
        p for p in run["network"]["pipelines"]
        if list(p)[0] not in ("spectros", "ibias")]
    run["network"]["pipelines"].append(
        {"clf": {"input": "frames",
                 "representation": "defs.representation.nop",
                 "classifier": "defs.classifier.lstm",
                 "lstm_params": [64, 2, "defs.fusion_method.avg"]}})
    for p in run["network"]["pipelines"]:
        for spec in p.values():
            spec.pop("weights_file", None)
    return run


def _opts(obj):
    return None if obj is None else {
        k: getattr(obj, k) for k in dir(obj) if not k.startswith("_")}


def _view(s):
    """Every value the run document sets, as plain data."""
    out = {k: getattr(s, k) for k in SETTINGS_FIELDS}
    out["pipelines"] = {n: {f: getattr(net, f) for f in NETWORK_FIELDS}
                        for n, net in s.pipelines.items()}
    out["train"], out["val"] = _opts(s.train), _opts(s.val)
    out["captioning"] = _opts(s.captioning)
    out["datasets"] = {ph: [{f: getattr(d, f) for f in DATASET_FIELDS}
                            for d in dsets]
                       for ph, dsets in s.feeder.datasets.items()}
    return out


def _load(cls, run, path):
    with open(path, "w") as f:
        if path.endswith(".json"):
            json.dump({"run": run}, f)
        else:
            yaml.safe_dump({"run": run}, f)
    s = cls()
    s.initialize_from_file(path)
    return s


def test_config_example_gives_the_jax_values(tmp_path):
    """test_config_example.py's assertions hold in the port, and every
    other value equals the JAX package's, from the YAML file and from its
    JSON twin."""
    run = _example_run(tmp_path)
    yml, js = str(tmp_path / "cfg.yml"), str(tmp_path / "cfg.json")
    ref = _load(JSettings, run, yml)
    s = _load(Settings, run, yml)
    assert s.num_classes == 20
    assert s.train.optimizer == "sgd"
    assert s.train.lr_decay == ["exp", "drops", 100, 0.96]
    assert s.val is None
    assert s.captioning.caption_search == "max"
    assert s.captioning.beam_width == 4
    assert s.mesh_shape == {"data": 1, "model": 1}
    assert s.compute_dtype == "bfloat16"
    dsets = s.feeder.datasets["train"]
    assert dsets[0].raw_image_shape == (240, 320, 3)
    assert "rand_crop" in dsets[0].imgproc
    assert _view(s) == _view(ref)
    # the JSON twin: the same values in both packages (the run id names
    # the file it came from)
    ref_json, s_json = _load(JSettings, run, js), _load(Settings, run, js)
    assert _view(s_json) == _view(ref_json)
    assert dict(_view(s_json), run_id=None) == dict(_view(s), run_id=None)


def test_json_config_of_both_phases_and_options(tmp_path):
    """A JSON document that sets the optional train/val/logging fields
    (val phase, int8, top-k, clip fusion; train phase with adamw, warmup,
    clip_grads, accum_steps, EMA and inline eval) reads equal in both."""
    run = _example_run(tmp_path)
    run.pop("captioning")
    run["phase"] = "defs.phase.val"
    for d in run["data"].values():
        d["phase"] = "defs.phase.val"
        d["host_shards"], d["host_shard_index"] = 3, 2
        d["epoch_shuffle"], d["device_preprocess"] = True, True
    run["val"] = {"batch_size": 4, "quantize": "int8_static", "top_k": [5, 3],
                  "clip_fusion": ["defs.fusion_type.late",
                                  "defs.fusion_method.maximum"],
                  "logits_save_interval": 2, "use_ema": True}
    run["logging"].update(watch_tensors=["conv1/w"], profile="(3, 2)",
                          save_freq_per_epoch=0.5)
    path = str(tmp_path / "val.json")
    assert _view(_load(Settings, run, path)) == \
        _view(_load(JSettings, run, path))
    run["phase"] = "defs.phase.train"
    for d in run["data"].values():
        d["phase"] = "defs.phase.train"
    run["data"]["dataset1-test"]["phase"] = "defs.phase.val"
    run["train"].update(optimizer="defs.optim.adamw", weight_decay=0.01,
                        lr_warmup=5, clip_grads="(-1, 1)", accum_steps=2,
                        ema_decay=0.99, eval_every_epochs=1,
                        early_stop_patience=2, eval_keep_best=True,
                        lr_decay=["defs.decay.cosine",
                                  "defs.periodicity.interval", 1, 0.0])
    run["remat"], run["compile_cache"] = True, True
    path = str(tmp_path / "train.json")
    s = _load(Settings, run, path)
    assert _view(s) == _view(_load(JSettings, run, path))
    assert s.train.accum_steps == 2 and s.val.use_ema


BAD_FIELDS = {
    "unread_pipeline_field": ("pipeline", "frames", "colour", "red"),
    "bad_defs_string": ("pipeline", "frames", "representation",
                        "defs.representation.cnn"),
    "bad_quantize": ("val", None, "quantize", "int4"),
}


@pytest.mark.parametrize("name", sorted(BAD_FIELDS))
def test_both_refuse_the_same_bad_fields(name, tmp_path):
    where, pname, field, value = BAD_FIELDS[name]
    run = _example_run(tmp_path)
    if where == "pipeline":
        for p in run["network"]["pipelines"]:
            if pname in p:
                p[pname][field] = value
    else:
        run["phase"] = "defs.phase.val"
        for d in run["data"].values():
            d["phase"] = "defs.phase.val"
        run["val"] = {"batch_size": 2, field: value}
    path = str(tmp_path / "bad.json")
    with pytest.raises(JFrameworkError):
        _load(JSettings, run, path)
    with pytest.raises(FrameworkError):
        _load(Settings, run, path)


def test_port_refuses_what_it_does_not_carry_out(tmp_path, caplog):
    """A mesh of more than one device raises with a pointer to the
    ROADMAP item, the orbax checkpoint backend (a JAX library's format)
    raises and names npz; compile_cache is logged as ignored, and remat,
    which the port carries out, is kept and not logged as ignored."""
    run = _example_run(tmp_path)
    run["mesh_shape"] = {"data": 2, "model": 1}
    with pytest.raises(FrameworkError, match="Queue 1, item 6"):
        _load(Settings, run, str(tmp_path / "mesh.json"))
    run["mesh_shape"] = {"data": 1}
    run["remat"], run["compile_cache"] = True, "/nowhere"
    caplog.set_level("INFO", logger="vlt")
    path = str(tmp_path / "cap.json")
    assert _load(Settings, run, path).remat is True
    assert "compile_cache" in caplog.text
    assert "remat" not in caplog.text and "ignored" not in caplog.text
    run["checkpoint_backend"] = "orbax"
    with pytest.raises(FrameworkError, match="npz"):
        _load(Settings, run, str(tmp_path / "orbax.json"))


def test_host_shards_auto_follows_torch_distributed(tmp_path, monkeypatch):
    import torch.distributed as dist
    run = _example_run(tmp_path)
    path = str(tmp_path / "shards.json")
    d = _load(Settings, run, path).feeder.datasets["train"][0]
    assert (d.host_shards, d.host_shard_index) == (1, 0)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    d = _load(Settings, run, path).feeder.datasets["train"][0]
    assert (d.host_shards, d.host_shard_index) == (4, 3)


def test_load_run_document_needs_a_run_document(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"serialize": {}}))
    with pytest.raises(FrameworkError, match="No run: document"):
        tconfig.load_run_document(str(path))


def test_captioning_attaches_as_in_jax(tmp_path):
    """The run's captioning block gives each dataset the vocabulary and
    embedding matrix of its TSV, the framing flags (labels in training
    only) and ``caption_max_length``'s caps, as in the JAX package."""
    words = ["a", "dog", "UNK", "EOS", "BOS"]
    rs = np.random.RandomState(0)
    emb = tmp_path / "v.embeddings"
    emb.write_text("".join("%s\t%s\n" % (w, " ".join(
        "%.5f" % x for x in rs.randn(4))) for w in words))
    run = _example_run(tmp_path)
    run["captioning"]["word_embeddings_file"] = str(emb)
    run["captioning"]["caption_max_length"] = 5
    views = []
    for cls in (JSettings, Settings):
        s = _load(cls, run, str(tmp_path / "cap.json"))
        s.attach_captioning()
        views.append({ph: [(d.vocabulary, d.embedding_matrix.tolist(),
                            d.include_labels, d.do_padding, d.eval_type,
                            d.max_caption_length, d.max_sequence_length)
                           for d in dsets]
                      for ph, dsets in s.feeder.datasets.items()})
    assert views[1] == views[0]
    (train,) = views[1]["train"]
    assert train[0] == words and train[2] and train[5:] == (5, 6)
