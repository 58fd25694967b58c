"""CUDA graphs on a mesh follow the process group's backend
(``parallel.mesh.graphs_on_mesh``).  NCCL's collectives run on the card's
streams, which a capture records, so ``Train``, ``Validation`` and
``ServingModule`` keep their graphs on an NCCL mesh; gloo's run on the
host, so on a gloo mesh ``graphs=True`` raises and the default is the
eager program.

The CPU cannot make an NCCL group: these tests patch
``torch.distributed.get_backend`` and stand in for the group with a mesh
of this one process that reports two ranks, as ``chip_smoke.py`` phase 16
does on a one-rank NCCL group (the two-rank gloo refusal itself runs in
``test_torch_mesh_isolation.py``; ``test_torch_cuda.py`` runs a graphed
step on a one-rank NCCL group on the card).  Also here: a step on a mesh
sums its gradients over the data group, the int8 forward reduces its
amax over it, and the port's ``get_alexnet_weights.sh`` fetches what the
JAX package's does."""

import collections
import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from video_learning_tpu_torch.flagship import flagship
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.serving import ServingModule
from video_learning_tpu_torch.train import Train
from video_learning_tpu_torch.utils import FrameworkError
from video_learning_tpu_torch.val import Validation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPC, IMAGE, CLASSES = 4, 67, 16


class CountingMesh(mesh_mod.Mesh):
    """A mesh of this one process that reports two ranks, so that the
    port's one-rank shortcuts pass, and counts the collectives asked of
    it; its axes are 1, so each collective is the identity and none
    runs."""

    def __init__(self):
        super().__init__({"data": 1, "model": 1})
        self.size = 2
        self.calls = collections.Counter()

    def _identity(self, name, t):
        self.calls[name] += 1
        return t

    def data_sum(self, t):
        return self._identity("data_sum", t)

    def data_max(self, t):
        return self._identity("data_max", t)

    def model_sum(self, t):
        return self._identity("model_sum", t)

    def world_max(self, t):
        return self._identity("world_max", t)

    def model_gather(self, t, dim=-1):
        return self._identity("model_gather", t)

    def data_gather(self, t, dim=0):
        return self._identity("data_gather", t)


def _backend(monkeypatch, name):
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: name)


def _settings(**kw):
    settings, model = flagship(compute_dtype="float32", lstm=(32, 1), **kw)
    settings.train.dropout_keep_prob = 1.0
    return settings, model


def _feed(seed, clips=2):
    rng = np.random.RandomState(seed)
    return {"frames_main_input": (rng.randn(clips * FPC, IMAGE, IMAGE, 3)
                                  * 60).astype(np.float32),
            "labels": np.eye(CLASSES, dtype=np.int32)[
                rng.randint(0, CLASSES, clips)]}


def _build(entry, graphs):
    """``entry``'s engine on a ``CountingMesh`` on the CPU; returns
    whether it runs graphs."""
    settings, model = _settings()
    mesh = CountingMesh()
    if entry == "train":
        return Train(settings, settings.feeder, model, device="cpu",
                     graphs=graphs, mesh=mesh).graphs
    if entry == "val":
        return Validation(settings, model, device="cpu", graphs=graphs,
                          mesh=mesh)._graphs is not None
    return ServingModule(model, model.init_params(0, device="cpu"),
                         batch_items=2, device="cpu", graphs=graphs,
                         mesh=mesh).graphs is not None


@pytest.mark.parametrize("backend,graphs,want", [
    ("nccl", None, None), ("nccl", True, True), ("nccl", False, False),
    ("gloo", None, False), ("gloo", False, False)])
def test_graphs_on_mesh_follows_the_backend(monkeypatch, backend, graphs,
                                            want):
    """NCCL keeps ``graphs`` as given (None: the one-card default, on
    for a CUDA device); gloo turns the default off."""
    _backend(monkeypatch, backend)
    assert mesh_mod.graphs_on_mesh(CountingMesh(), graphs, "X") is want


def test_graphs_on_mesh_refuses_graphs_over_gloo(monkeypatch):
    _backend(monkeypatch, "gloo")
    with pytest.raises(FrameworkError) as e:
        mesh_mod.graphs_on_mesh(CountingMesh(), True, "X")
    assert "graphs=True on a mesh of 2 ranks" in str(e.value)
    assert "cannot capture" in str(e.value)


def test_graphs_on_one_rank_ask_no_backend(monkeypatch):
    """Off a mesh, or on a world of one, there is no group to ask."""
    def no_group(*a, **k):
        raise AssertionError("asked for the backend of no group")

    monkeypatch.setattr(dist, "get_backend", no_group)
    one = mesh_mod.Mesh({"data": 1})
    for graphs in (None, True, False):
        assert mesh_mod.graphs_on_mesh(None, graphs, "X") is graphs
        assert mesh_mod.graphs_on_mesh(one, graphs, "X") is graphs


@pytest.mark.parametrize("entry", ["train", "val", "serve"])
def test_entry_points_refuse_graphs_on_a_gloo_mesh(monkeypatch, entry):
    """``graphs=True`` raises the gloo reason before the CPU's own
    refusal; the default and ``graphs=False`` run eagerly."""
    _backend(monkeypatch, "gloo")
    with pytest.raises(FrameworkError) as e:
        _build(entry, True)
    assert "graphs=True on a mesh of 2 ranks over gloo" in str(e.value)
    assert "cannot capture" in str(e.value)
    assert _build(entry, None) is False
    assert _build(entry, False) is False


@pytest.mark.parametrize("entry", ["train", "val", "serve"])
def test_entry_points_keep_graphs_on_an_nccl_mesh(monkeypatch, entry):
    """On NCCL the mesh refuses nothing: ``graphs=True`` meets only the
    CPU's refusal (graphs need a CUDA device), as off a mesh."""
    _backend(monkeypatch, "nccl")
    with pytest.raises(FrameworkError, match="needs a") as e:
        _build(entry, True)
    assert "mesh" not in str(e.value)
    assert _build(entry, False) is False


@pytest.mark.parametrize("accum", [1, 2])
def test_a_mesh_step_sums_over_the_data_group(monkeypatch, accum):
    """On a mesh the step takes the micro-batch sums and adds them over
    the data group (one all-reduce a step, one a step of a scan), which
    equals the step off a mesh up to float reassociation; the clip norm
    sums nothing over the model group when no leaf is split."""
    _backend(monkeypatch, "gloo")
    out = {}
    for where in ("one", "mesh"):
        settings, model = _settings()
        settings.train.accum_steps = accum
        mesh = CountingMesh() if where == "mesh" else None
        engine = Train(settings, settings.feeder, model, device="cpu",
                       mesh=mesh)
        metrics = engine.run_step(_feed(1))
        scan = engine.compile_scan_steps(2)(_feed(2))
        out[where] = (metrics, scan, engine.state_dict(), mesh)
    (m1, s1, st1, _), (m2, s2, st2, mesh) = out["one"], out["mesh"]
    assert mesh.calls == {"data_sum": 3}
    assert m2["accuracy"] == m1["accuracy"]
    assert m2["loss"] == pytest.approx(m1["loss"], rel=1e-5)
    assert m2["grad_norm"] == pytest.approx(m1["grad_norm"], rel=1e-4)
    np.testing.assert_allclose(s2["loss"], s1["loss"], rtol=1e-5)
    for name, p in st1["params"].items():
        np.testing.assert_allclose(st2["params"][name].numpy(), p.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_int8_serving_on_a_mesh_reduces_its_amax(monkeypatch):
    """The dynamic int8 forward takes each layer's activation amax as
    the MAX over the data group (``parallel.mesh.data_max``) and the
    outputs are gathered over it; on axes of 1 the logits are those of
    the module off a mesh, bit for bit."""
    _backend(monkeypatch, "gloo")
    settings, model = _settings()
    params = model.init_params(0, device="cpu")
    frames = _feed(3)["frames_main_input"]
    mesh = CountingMesh()
    got = ServingModule(model, params, batch_items=2, device="cpu",
                        quantize="int8", mesh=mesh)(frames)
    want = ServingModule(model, params, batch_items=2, device="cpu",
                         quantize="int8")(frames)
    assert mesh.calls["data_max"] > 0
    assert mesh.calls["data_gather"] == 1
    np.testing.assert_array_equal(got, want)


def _script_assignments(path):
    with open(path) as f:
        text = f.read()
    return dict(re.findall(r'^(URL|OUT)=(.*)$', text, re.M))


def test_get_alexnet_weights_scripts_agree():
    """The port's script names the JAX copy's URL and output argument
    (``${1:-bvlc_alexnet.npy}``) and is executable; nothing runs it (no
    network here)."""
    port = os.path.join(REPO, "video_learning_tpu_torch", "models",
                        "get_alexnet_weights.sh")
    jax = os.path.join(REPO, "video_learning_tpu", "models",
                       "get_alexnet_weights.sh")
    mine, theirs = _script_assignments(port), _script_assignments(jax)
    assert mine == theirs
    assert mine["OUT"] == '"${1:-bvlc_alexnet.npy}"'
    assert mine["URL"].startswith('"https://')
    assert os.access(port, os.X_OK)
    from video_learning_tpu_torch.tools import validate_pretrained
    assert "video_learning_tpu_torch/models/get_alexnet_weights.sh" in \
        validate_pretrained.__doc__
