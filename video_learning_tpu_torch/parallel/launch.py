"""Start n ranks of one function and collect what each returns.

``run(n, "package.module:function", kwargs)`` starts ``n`` Python
processes on this machine with the environment ``torch.distributed.run``
would give them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR=localhost``, a free ``MASTER_PORT``), each of which joins
the group (``mesh.init_distributed(device, backend)``), calls
``function(device=..., **kwargs)`` and writes its JSON-able result to a
file; ``run`` returns the results in rank order and raises with the
failed ranks' tracebacks.  The dry run, the tests and the card's smoke
script start their ranks with it; a run config is trained with
``python -m torch.distributed.run --nproc-per-node N -m
video_learning_tpu_torch.run_task``.

Every rank is killed when one fails or the timeout passes, so no
process outlives the call.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

from video_learning_tpu_torch.utils import error, resolve_device


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank, world_size, port, threads=None, path=None):
    """The environment of rank ``rank``: this one's, plus the launcher's
    variables (and ``OMP_NUM_THREADS`` when ``threads`` is given, and
    ``path`` first on ``PYTHONPATH``)."""
    env = dict(os.environ)
    # the folder that holds this package, so ranks import the same copy
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (path, root, env.get("PYTHONPATH")) if p])
    env.update(RANK=str(rank), WORLD_SIZE=str(world_size),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size),
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return env


def run(n, target, kwargs=None, device="cuda", backend=None, timeout=600,
        threads=None, path=None):
    """Run ``target`` ("module:function") as ``n`` ranks and return their
    results (a list, rank order).  ``device`` is the card unless
    ``device="cpu"`` (it raises without one, before a rank starts);
    ``path``: a folder to put before the ranks' ``PYTHONPATH`` (where
    ``target``'s module lives)."""
    device = str(resolve_device(device))
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="vlt_ranks_") as folder:
        spec = os.path.join(folder, "spec.json")
        with open(spec, "w") as f:
            json.dump({"target": target, "kwargs": kwargs or {},
                       "device": device, "backend": backend}, f)
        procs = []
        try:
            for r in range(n):
                log = open(os.path.join(folder, "rank%d.log" % r), "w")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "video_learning_tpu_torch.parallel.launch", spec,
                     folder],
                    env=rank_env(r, n, port, threads, path), stdout=log,
                    stderr=subprocess.STDOUT))
                log.close()
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            logs = []
            for r in failed:
                with open(os.path.join(folder, "rank%d.log" % r)) as f:
                    logs.append("--- rank %d (exit %s) ---\n%s"
                                % (r, procs[r].returncode, f.read()[-6000:]))
            error("%d of %d ranks of %s failed%s:\n%s"
                  % (len(failed), n, target,
                     "" if time.monotonic() <= deadline else
                     " (timeout %ss)" % timeout, "\n".join(logs)))
        out = []
        for r in range(n):
            with open(os.path.join(folder, "rank%d.json" % r)) as f:
                out.append(json.load(f))
        return out


def _rank_main(spec_path, folder):
    with open(spec_path) as f:
        spec = json.load(f)
    import torch.distributed as dist

    from video_learning_tpu_torch.parallel import mesh as mesh_mod
    rank = int(os.environ["RANK"])
    try:
        device = mesh_mod.init_distributed(spec["device"], spec["backend"])
        module, _, name = spec["target"].partition(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(device=str(device), **spec["kwargs"])
        with open(os.path.join(folder, "rank%d.json" % rank), "w") as f:
            json.dump(result, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
