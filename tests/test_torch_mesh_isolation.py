"""The mesh slice stands alone and refuses what it cannot run: its
modules (``parallel/``, ``tools/dryrun_multichip.py``) and the mesh
tests' rank functions (``tests/torch_mesh_worker.py``) import neither
JAX, optax nor the JAX package (``test_torch_isolation.py`` walks every
module of the port; these are named here), a mesh shape that does not
fill the world raises at every entry point, and ``graphs=True`` raises
on a group of more than one rank."""

import os

import pytest

from test_torch_isolation import _imported_modules, _port_sources
from video_learning_tpu_torch.flagship import flagship
from video_learning_tpu_torch.parallel import launch
from video_learning_tpu_torch.parallel.mesh import Mesh
from video_learning_tpu_torch.train import Train
from video_learning_tpu_torch.utils import FrameworkError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
BANNED = {"jax", "jaxlib", "optax", "video_learning_tpu"}


@pytest.mark.parametrize("rel", [
    "video_learning_tpu_torch/parallel/__init__.py",
    "video_learning_tpu_torch/parallel/mesh.py",
    "video_learning_tpu_torch/parallel/sharding.py",
    "video_learning_tpu_torch/parallel/launch.py",
    "video_learning_tpu_torch/tools/dryrun_multichip.py",
    "tests/torch_mesh_worker.py"])
def test_mesh_modules_import_no_jax(rel):
    if rel.startswith("video_learning_tpu_torch/"):
        assert os.path.join(REPO, rel) in _port_sources()
    roots = {n.split(".")[0]
             for n, _ in _imported_modules(os.path.join(REPO, rel))}
    assert not roots & BANNED, rel


def test_a_mesh_that_does_not_fill_the_world_is_refused(tmp_path):
    """In one process (a world of one rank): the mesh, ``Train`` and the
    exporter refuse data=2 (the run config's refusal is
    ``test_torch_config.py``'s)."""
    from video_learning_tpu_torch.tools import export_serving
    with pytest.raises(FrameworkError, match="does not fill the world"):
        Mesh({"data": 2})
    settings, model = flagship(compute_dtype="float32")
    settings.mesh_shape = {"data": 1, "model": 2}
    with pytest.raises(FrameworkError, match="does not fill the world"):
        Train(settings, settings.feeder, model, device="cpu")
    with pytest.raises(FrameworkError, match="--mesh"):
        export_serving.export("unused.json", str(tmp_path / "x.zip"),
                              mesh_shape={"data": 2}, device="cpu")


def test_two_ranks_refuse_graphs_and_an_unfilled_mesh():
    """On 2 gloo ranks: a (1, 1) mesh is refused, and ``graphs=True``
    raises in ``Train``, ``Validation`` and ``ServingModule`` with the
    reason (gloo runs its collectives on the host); ``Train`` defaults to
    the eager step."""
    for res in launch.run(2, "torch_mesh_worker:guards", backend="gloo",
                          threads=2, timeout=300, path=TESTS):
        assert "does not fill the world of 2" in res["unfilled"]
        for key in ("train", "val", "serve"):
            assert "graphs=True on a mesh of 2 ranks" in res[key], key
            assert "cannot capture" in res[key], key
        assert res["default_graphs"] is False
