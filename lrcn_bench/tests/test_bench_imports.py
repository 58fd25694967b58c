"""What the benchmark loads: never JAX, its libraries or the JAX
package (by whole top-level name), and the reference nothing of the
program."""

import ast
import glob
import os
import subprocess
import sys

from lrcn_bench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_harness_reference_and_readers_load_no_jax():
    code = (
        "import glob, os, sys\n"
        "sys.path.insert(0, %r)\n"
        "from lrcn_bench import harness, calibrate, faults, workload\n"
        "from lrcn_bench.reference import lrcn\n"
        "import video_learning_tpu_torch.train, "
        "video_learning_tpu_torch.serving\n"
        "spec = harness.load_spec()\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "for path in glob.glob(os.path.join(%r, 'metrics', '*.py')):\n"
        "    harness.reader(os.path.basename(path)[:-3])\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'video_learning_tpu_torch' in top\n"
        "print(sorted(top & set(harness.FORBIDDEN)))\n"
        % (os.path.dirname(HERE), HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "video_learning_tpu_torch_x", sys)
    assert "video_learning_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return {n.split(".")[0] for n in names}


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(HERE, "reference", "*.py"))
    assert files
    for path in files:
        assert _imported(path) <= {"contextlib", "numpy", "torch"}, path
