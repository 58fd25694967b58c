"""The port stands alone: no module of ``video_learning_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, nothing they import at
module level needs jax, yaml, PIL, tensorflow or matplotlib, and the
entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "video_learning_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    """(module name, at module level?) for every import in the file."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    top = set(id(n) for n in tree.body)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(a.name, id(node) in top) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.append((node.module, id(node) in top))
    return found


def test_no_jax_or_jax_package_imports():
    bad = []
    for path in _port_sources():
        for name, _ in _imported_modules(path):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "optax", "video_learning_tpu"):
                bad.append("%s imports %s" % (os.path.relpath(path, REPO),
                                              name))
    assert not bad, "\n".join(bad)
    assert len(_port_sources()) > 15


def test_training_slice_modules_are_checked():
    """The training and captioning slices' modules are among the sources
    checked above and import neither JAX, optax nor the JAX package."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("video_learning_tpu_torch/train.py",
                "video_learning_tpu_torch/ops/conv1_dw.py",
                "video_learning_tpu_torch/ops/lrn.py",
                "video_learning_tpu_torch/ops/lstm_step.py",
                "video_learning_tpu_torch/models/alexnet.py",
                "video_learning_tpu_torch/data/captions.py",
                "video_learning_tpu_torch/models/lstm.py"):
        assert rel in sources
        roots = {n.split(".")[0]
                 for n, _ in _imported_modules(os.path.join(REPO, rel))}
        assert not roots & {"jax", "jaxlib", "optax", "video_learning_tpu"}


def test_data_slice_modules_are_checked():
    """The config loader and data layer's modules are among the sources
    checked above, import neither JAX, optax nor the JAX package, and
    nothing of yaml or PIL at module level."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("video_learning_tpu_torch/config.py",
                "video_learning_tpu_torch/parse_opts.py",
                "video_learning_tpu_torch/batching.py",
                "video_learning_tpu_torch/data/records.py",
                "video_learning_tpu_torch/data/native_io.py",
                "video_learning_tpu_torch/data/imgproc.py",
                "video_learning_tpu_torch/data/dataset.py",
                "video_learning_tpu_torch/data/feeder.py",
                "video_learning_tpu_torch/data/prefetch.py"):
        assert rel in sources
        found = _imported_modules(os.path.join(REPO, rel))
        roots = {n.split(".")[0] for n, _ in found}
        assert not roots & {"jax", "jaxlib", "optax", "video_learning_tpu"}
        assert not {n.split(".")[0] for n, top in found if top} & \
            {"yaml", "PIL"}, rel


def test_run_driver_slice_modules_are_checked():
    """The run driver and evaluation engine's modules are among the
    sources checked above, import neither JAX, optax nor the JAX package,
    and nothing of yaml, PIL, tensorflow or torch.utils.tensorboard at
    module level."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("video_learning_tpu_torch/run_task.py",
                "video_learning_tpu_torch/val.py",
                "video_learning_tpu_torch/observe.py",
                "video_learning_tpu_torch/checkpoint.py",
                "video_learning_tpu_torch/utils.py",
                "video_learning_tpu_torch/data/captions.py",
                "video_learning_tpu_torch/data/feeder.py",
                "video_learning_tpu_torch/models/alexnet.py",
                "video_learning_tpu_torch/metrics/coco_eval.py",
                "video_learning_tpu_torch/metrics/ptb.py",
                "video_learning_tpu_torch/metrics/porter.py",
                "video_learning_tpu_torch/metrics/synonyms.py"):
        assert rel in sources
        found = _imported_modules(os.path.join(REPO, rel))
        roots = {n.split(".")[0] for n, _ in found}
        assert not roots & {"jax", "jaxlib", "optax", "video_learning_tpu"}
        top = {n for n, at_top in found if at_top}
        assert not {n.split(".")[0] for n in top} & \
            {"yaml", "PIL", "tensorflow"}, rel
        assert "torch.utils.tensorboard" not in top, rel


def test_packing_and_tools_slice_modules_are_checked():
    """The packing, caption preprocessing, inference and export modules
    are among the sources checked above, import neither JAX, optax nor
    the JAX package, nothing of yaml or PIL at module level, and the
    packer and its samplers no torch at all."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    no_torch = ("video_learning_tpu_torch/data/serialize.py",
                "video_learning_tpu_torch/data/samplers.py")
    for rel in no_torch + (
            "video_learning_tpu_torch/data/imgproc.py",
            "video_learning_tpu_torch/tools/check_serialized_data.py",
            "video_learning_tpu_torch/tools/compute_image_mean.py",
            "video_learning_tpu_torch/tools/process_annotations.py",
            "video_learning_tpu_torch/tools/produce_vocab_embeddings.py",
            "video_learning_tpu_torch/tools/caption_vocab_tools.py",
            "video_learning_tpu_torch/tools/infer.py",
            "video_learning_tpu_torch/tools/export_serving.py",
            "video_learning_tpu_torch/val.py",
            "video_learning_tpu_torch/serving.py"):
        assert rel in sources
        found = _imported_modules(os.path.join(REPO, rel))
        roots = {n.split(".")[0] for n, _ in found}
        assert not roots & {"jax", "jaxlib", "optax", "video_learning_tpu"}
        assert not {n.split(".")[0] for n, top in found if top} & \
            {"yaml", "PIL"}, rel
        if rel in no_torch:
            assert "torch" not in roots, rel


def test_packer_and_its_workers_run_without_torch_pil_or_yaml(tmp_path):
    """``python -m video_learning_tpu_torch.data.serialize`` packs a .ppm
    video set from a JSON config with two spawned workers where torch,
    PIL, yaml and JAX cannot be imported (a package of each name that
    raises on import is first on the path the workers inherit)."""
    import json
    blocker = tmp_path / "blocker"
    for name in ("torch", "PIL", "yaml", "jax", "video_learning_tpu"):
        (blocker / name).mkdir(parents=True)
        (blocker / name / "__init__.py").write_text(
            "raise ImportError('%s imported by the packer')\n" % name)
    rs = np.random.RandomState(0)
    lines = []
    for v in range(2):
        vdir = tmp_path / ("v%d" % v)
        vdir.mkdir()
        for i in range(6):
            with open(vdir / ("f%02d.ppm" % i), "wb") as f:
                f.write(b"P6\n10 8\n255\n")
                f.write(rs.randint(0, 256, (8, 10, 3), np.uint8).tobytes())
        lines.append("%s %d\n" % (vdir, v))
    (tmp_path / "list").write_text("".join(lines))
    cfg = tmp_path / "pack.json"
    cfg.write_text(json.dumps({"serialize": {
        "input_files": [str(tmp_path / "list")], "run_id": "iso",
        "num_processes": 2, "raw_image_shape": [8, 10, 3],
        "clip_offset_or_num": 2, "num_frames_per_clip": 2,
        "clipframe_mode": "defs.clipframe_mode.rand_clips",
        "generation_error": "defs.generation_error.abort",
        "frame_format": "ppm", "log_folder": str(tmp_path), "seed": 1}}))
    env = dict(os.environ, PYTHONPATH="%s:%s" % (blocker, REPO))
    res = subprocess.run(
        [sys.executable, "-m", "video_learning_tpu_torch.data.serialize",
         str(cfg)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert "Validation completed error-free" in res.stderr
    assert os.path.getsize(tmp_path / "list.tfrecord") > 2 * 2 * 2 * 240


def test_json_config_loads_with_yaml_blocked(tmp_path):
    """With yaml, PIL and JAX unimportable (the GPU machine has no
    PyYAML), a JSON run config still loads through
    ``Settings.initialize_from_file``."""
    import json
    run = {"run_folder": str(tmp_path / "run"), "phase": "defs.phase.train",
           "data": {}, "network": {"num_classes": 3, "pipelines": [
               {"frames": {"input": "defs.dataset_tag.main",
                           "representation": "defs.representation.dcnn",
                           "frame_encoding_layer": "fc7"}}]},
           "train": {"batch_size": 2, "epochs": 1,
                     "optimizer": "defs.optim.sgd", "base_lr": 0.1}}
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({"run": run}))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'yaml', 'PIL',"
        " 'video_learning_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from video_learning_tpu_torch.config import Settings\n"
        "s = Settings()\n"
        "s.initialize_from_file(sys.argv[1])\n"
        "print(s.num_classes, s.train.base_lr, s.pipeline_names)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code, str(cfg)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[-2] == "3 0.1 ['frames']"


def test_no_yaml_or_pil_at_module_level():
    """Nor tensorflow or matplotlib: the GPU machine has none of the four."""
    bad = ["%s imports %s at module level" % (os.path.relpath(p, REPO), n)
           for p in _port_sources() for n, top in _imported_modules(p)
           if top and n.split(".")[0] in ("yaml", "PIL", "tensorflow",
                                           "matplotlib")]
    assert not bad, "\n".join(bad)


def test_tools_model_and_audio_slice_modules_are_checked():
    """The checkpoint, schedule, logit, format and evaluation tools,
    audionet and the audio package are among the sources checked above,
    import neither JAX, optax nor the JAX package, and nothing of yaml,
    PIL, tensorflow or matplotlib at module level."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    rels = ["video_learning_tpu_torch/tools/%s.py" % t for t in (
        "inspect_checkpoint", "modify_checkpoint", "lr_calc",
        "combine_logits", "combine_runs", "compute_evaluation_stats",
        "view_logits_info", "examine_dataset", "plot_metrics",
        "evaluate_multiple_checkpoints", "validate_checkpoints",
        "validate_pretrained", "profile_ablation", "export_tfrecord",
        "import_tfrecord", "split_video", "dryrun_multichip")]
    rels += ["video_learning_tpu_torch/models/audionet.py",
             "video_learning_tpu_torch/audio/__init__.py",
             "video_learning_tpu_torch/audio/spectrograms.py",
             "video_learning_tpu_torch/audio/postproc_folders.py"]
    for rel in rels:
        assert rel in sources, rel
        found = _imported_modules(os.path.join(REPO, rel))
        roots = {n.split(".")[0] for n, _ in found}
        assert not roots & {"jax", "jaxlib", "optax", "video_learning_tpu"}
        assert not {n.split(".")[0] for n, top in found if top} & \
            {"yaml", "PIL", "tensorflow", "matplotlib"}, rel
    for script in ("tools/to_single_item_instance.sh",
                   "audio/extract_spectrograms.sh"):
        path = os.path.join(PKG, script)
        assert os.access(path, os.X_OK), script
        assert "video_learning_tpu." not in open(path).read()


def _device_options(path):
    """The default of every ``add_argument("--device", ...)`` in a file."""
    out = []
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument" and \
                node.args and isinstance(node.args[0], ast.Constant) and \
                node.args[0].value == "--device":
            defaults = [k.value for k in node.keywords if k.arg == "default"]
            out.append(defaults[0].value if defaults and
                       isinstance(defaults[0], ast.Constant) else None)
    return out


def test_every_device_option_defaults_to_cuda():
    """Each ``--device`` option of a port entry point defaults to the
    card."""
    found = {os.path.relpath(p, REPO): _device_options(p)
             for p in _port_sources()}
    found = {k: v for k, v in found.items() if v}
    assert all(v == ["cuda"] for v in found.values()), found
    for tool in ("run_task", "tools/infer", "tools/serve",
                 "tools/export_serving", "tools/dryrun_multichip",
                 "tools/evaluate_multiple_checkpoints",
                 "tools/validate_checkpoints", "tools/validate_pretrained",
                 "tools/profile_ablation"):
        assert "video_learning_tpu_torch/%s.py" % tool in found, tool


def test_new_entry_points_refuse_cpu_unless_asked(tmp_path):
    """The dry run, the checkpoint evaluation, validate_pretrained and
    profile_ablation raise without a card unless given the CPU (no rank
    and no model is started first)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "on a machine without one")
    import json
    from video_learning_tpu_torch.tools import (
        dryrun_multichip, evaluate_multiple_checkpoints, profile_ablation,
        validate_checkpoints, validate_pretrained)
    from video_learning_tpu_torch.utils import FrameworkError

    cfg = tmp_path / "val.json"
    cfg.write_text(json.dumps({"run": {"run_folder": str(tmp_path)}}))
    for call in (lambda: dryrun_multichip.main(["4"]),
                 lambda: dryrun_multichip.dryrun_multichip(4),
                 lambda: evaluate_multiple_checkpoints.main([str(cfg)]),
                 lambda: validate_checkpoints.main([str(cfg),
                                                    str(tmp_path)]),
                 lambda: validate_pretrained.main([str(tmp_path / "w")]),
                 lambda: profile_ablation.main([]),
                 lambda: profile_ablation.main(["--per-layer"])):
        with pytest.raises(FrameworkError, match="device='cpu'"):
            call()


def test_imports_with_jax_yaml_and_pil_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'optax', 'yaml', 'PIL', 'tensorflow',"
        " 'matplotlib', 'video_learning_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import video_learning_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


def test_chip_smoke_alone_fails_without_printing_a_result(tmp_path):
    """Copied away from the package, the script cannot run and prints no
    result line."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_refuse_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "on a machine without one")
    from video_learning_tpu_torch import checkpoint, serving
    from video_learning_tpu_torch.flagship import flagship
    from video_learning_tpu_torch.utils import FrameworkError, resolve_device

    _, model = flagship(num_classes=3, fpc=2)
    with pytest.raises(FrameworkError, match="device='cpu'"):
        model.init_params(seed=0)
    params = model.init_params(seed=0, device="cpu")
    with pytest.raises(FrameworkError):
        serving.ServingModule(model, params, batch_items=1)
    mod = serving.ServingModule(model, params, batch_items=1, device="cpu")
    path = str(tmp_path / "m.zip")
    mod.save(path)
    with pytest.raises(FrameworkError):
        serving.load(path)
    with pytest.raises(FrameworkError):
        checkpoint.from_jax_flat({"a/b": np.zeros(2, np.float32)})
    with pytest.raises(FrameworkError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_train_refuses_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "on a machine without one")
    from video_learning_tpu_torch import checkpoint
    from video_learning_tpu_torch.flagship import flagship
    from video_learning_tpu_torch.train import Train
    from video_learning_tpu_torch.utils import FrameworkError

    settings, model = flagship(num_classes=3, fpc=2)
    with pytest.raises(FrameworkError, match="device='cpu'"):
        Train(settings, settings.feeder, model)
    eng = Train(settings, settings.feeder, model, device="cpu")
    leaves = checkpoint.flatten_tree(eng.params).values()
    assert all(p.device.type == "cpu" and p.requires_grad for p in leaves)
