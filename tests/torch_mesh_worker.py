"""Rank functions of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_multiprocess.py``), started as gloo ranks on the CPU by
``video_learning_tpu_torch.parallel.launch``.  Each imports the port
alone and asserts that neither JAX nor the JAX package was loaded; the
JAX side of a comparison runs in the test process.  Inputs and outputs
travel as npz files in a folder the test gives."""

import os
import sys

import numpy as np

from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch.config import ValOpts
from video_learning_tpu_torch.flagship import flagship
from video_learning_tpu_torch.parallel.mesh import make_mesh, shard_feed
from video_learning_tpu_torch.train import Train
from video_learning_tpu_torch.val import Validation

MESH = {"data": 2, "model": 2}


def _no_jax():
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                           "video_learning_tpu"))
    assert not loaded, loaded


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _feeds(path):
    """The global feeds of an npz written as {"<step>/<key>": array}."""
    flat = _npz(path)
    steps = sorted({int(k.split("/", 1)[0]) for k in flat})
    return [{k.split("/", 1)[1]: v for k, v in flat.items()
             if int(k.split("/", 1)[0]) == s} for s in steps]


def _params(folder, name):
    return ckpt.unflatten_tree(ckpt.from_jax_flat(
        _npz(os.path.join(folder, name)), "cpu"))


def _settings(kw, opts, mesh_shape, caption=False):
    settings, model = flagship(compute_dtype="float32", caption=caption,
                               fpc=1 if caption else 4, **kw)
    settings.train.dropout_keep_prob = 1.0
    for k, v in opts.items():
        setattr(settings.train, k, v)
    settings.mesh_shape = dict(mesh_shape)
    settings.val = ValOpts()
    return settings, model


def train_steps(device, folder, configs, mesh_shape=MESH):
    """For each configuration {name: (flagship kwargs, train options)}:
    the steps on ``feeds_<name>.npz`` (global feeds; this rank feeds its
    rows) from ``params.npz``; rank 0 saves the whole state as
    ``state_<name>.npz``.  Returns {name: [metrics per step]}."""
    mesh = make_mesh(mesh_shape)
    out = {}
    for name, (kw, opts) in sorted(configs.items()):
        settings, model = _settings(kw, opts, mesh_shape)
        engine = Train(settings, settings.feeder, model, device=device,
                       params=_params(folder, "params.npz"), mesh=mesh)
        out[name] = [engine.run_step(shard_feed(f, mesh))
                     for f in _feeds(os.path.join(folder,
                                                  "feeds_%s.npz" % name))]
        state = engine.state_dict()
        if mesh.rank == 0:
            ckpt.save_checkpoint(os.path.join(folder, "state_%s.npz" % name),
                                 {"params": state["params"],
                                  "ema_params": state.get("ema_params", {})})
    _no_jax()
    return out


def forwards(device, folder, mesh_shape=MESH, check_imports=True):
    """The float, int8 and int8_static evaluation forwards of
    ``params.npz`` on this rank's rows of ``eval.npz``."""
    mesh = make_mesh(mesh_shape)
    feed = shard_feed(_npz(os.path.join(folder, "eval.npz")), mesh)
    params = _params(folder, "params.npz")
    out = {}
    for mode in (None, "int8", "int8_static"):
        settings, model = _settings({}, {}, mesh_shape)
        settings.val.quantize = mode
        val = Validation(settings, model, device=device, mesh=mesh)
        out[str(mode)] = val.run_forward(params, feed).tolist()
    if check_imports:
        _no_jax()
    return out


def caption(device, folder, mesh_shape=MESH):
    """A caption training step on ``cap_feed.npz`` from
    ``cap_params.npz`` (rank 0 saves ``cap_state.npz``), then the greedy
    and beam-3 decodes of ``cap_decode_params.npz`` on this rank's rows
    of ``cap_frames.npz``."""
    mesh = make_mesh(mesh_shape)
    settings, model = _settings({}, {}, mesh_shape, caption=True)
    engine = Train(settings, settings.feeder, model, device=device,
                   params=_params(folder, "cap_params.npz"), mesh=mesh)
    feed = _npz(os.path.join(folder, "cap_feed.npz"))
    metrics = engine.run_step(shard_feed(feed, mesh))
    state = engine.state_dict()
    if mesh.rank == 0:
        ckpt.save_checkpoint(os.path.join(folder, "cap_state.npz"),
                             {"params": state["params"]})
    frames = shard_feed(_npz(os.path.join(folder, "cap_frames.npz")), mesh)
    params = _params(folder, "cap_decode_params.npz")
    tokens = {}
    for search in ("max", "beam"):
        settings.captioning.caption_search = search
        settings.captioning.beam_width = 3
        val = Validation(settings, model, device=device, mesh=mesh)
        tokens[search] = val.run_forward(params, frames,
                                         decode=True).tolist()
    _no_jax()
    return {"metrics": metrics, "tokens": tokens}


def grads(device, folder, mesh_shape, check_imports=True):
    """The gradient of every parameter of the masked-mean loss of the
    flagship on the global feed of ``eval.npz`` (this rank's rows) from
    ``params.npz``: whole tensors (gathered over the model axis), summed
    over the data axis with the step's rule, saved by rank 0 as
    ``grads_<data>x<model>.npz`` in the JAX layouts."""
    mesh = make_mesh(mesh_shape)
    settings, model = _settings({}, {}, mesh_shape)
    engine = Train(settings, settings.feeder, model, device=device,
                   params=_params(folder, "params.npz"), mesh=mesh)
    feed = engine.prepare_device_feed(
        shard_feed(_npz(os.path.join(folder, "eval.npz")), mesh))
    feed.pop("__on_device__")
    if mesh.data > 1:
        g, _, _ = engine._step_micro_sums(feed)
    else:
        g, _, _ = engine._step_mean(feed)
    whole = {n: engine._whole(n, t) for n, t in g.items()}
    if mesh.rank == 0:
        np.savez(os.path.join(folder, "grads_%dx%d.npz"
                              % (mesh.data, mesh.model)),
                 **ckpt.to_jax_flat(whole))
    if check_imports:
        _no_jax()
    return {"split": sorted(engine._split)}


def parity(device, folder, configs):
    """``train_steps``, ``forwards`` and ``caption`` in one start of the
    ranks."""
    return {"steps": train_steps(device, folder, configs),
            "forwards": forwards(device, folder),
            "caption": caption(device, folder),
            "grads": grads(device, folder, MESH)}


def packed_training(device, config, model_axis_config, folder):
    """From a run config with ``host_shards: auto`` on a data axis of 2:
    this rank's training shard, the epochs of the config (the loop of
    ``run_task``), then the evaluation forward of the trained weights on
    the last local feed, saved with that feed as ``rank<r>.npz`` (rank 0
    also saves the whole parameters as ``params.ckpt``); and the shard
    the same config gives on a (1, 2) mesh (``model_axis_config``)."""
    from video_learning_tpu_torch.config import Settings
    from video_learning_tpu_torch.data.feeder import prepare_feed
    from video_learning_tpu_torch.models.pipeline import Model

    def shard(feeder):
        d = feeder.datasets["train"][0]
        return {"shards": [d.host_shards, d.host_shard_index],
                "items": [d._shard_item_offset, d.num_items],
                "labels": np.asarray(d.labels).tolist()}

    s2 = Settings()
    model_axis = shard(s2.initialize(model_axis_config))
    settings = Settings()
    feeder = settings.initialize(config)
    data_axis = shard(feeder)
    model = Model(settings)
    engine = Train(settings, feeder, model, seed=settings.seed,
                   device=device)
    losses = []
    for _ in range(settings.train.epoch_index, settings.train.epochs):
        while feeder.loop():
            feed, batches = feeder.get_feed(model.required_input)
            feed = prepare_feed(feed, batches)
            losses.append(engine.run_step(dict(feed))["loss"])
        settings.train.epoch_index += 1
        feeder.rewind_datasets()
    params = engine.eval_params()
    settings.val = ValOpts()
    logits = Validation(settings, model, device=device).run_forward(
        params, feed)
    rank = engine.mesh.rank
    np.savez(os.path.join(folder, "rank%d.npz" % rank), logits=logits,
             **{"feed/" + k: np.asarray(v) for k, v in feed.items()})
    if rank == 0:
        ckpt.save_checkpoint(os.path.join(folder, "params.ckpt"), params)
    _no_jax()
    return {"losses": losses, "data_axis": data_axis,
            "model_axis": model_axis, "mesh": engine.mesh.shape}


# items of the requests served over the mesh, posted concurrently
SERVE_ITEMS = (1, 2, 3)


def serve_requests(meta, seed=1):
    """The arrays of one request of each of ``SERVE_ITEMS`` items, from
    ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    per = [s["shape"][0] // meta["batch_items"] for s in meta["inputs"]]
    return [[rs.randint(0, 255, [p * n] + s["shape"][1:]).astype(s["dtype"])
             for p, s in zip(per, meta["inputs"])] for n in SERVE_ITEMS]


def _post(addr, arrays):
    """POST ``arrays`` as npz to /predict; (status, JSON reply)."""
    import http.client
    import io
    import json
    buf = io.BytesIO()
    np.savez(buf, *arrays)
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request("POST", "/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npz"})
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode("utf-8"))
    finally:
        conn.close()


def _metrics(addr):
    import http.client
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request("GET", "/metrics")
        return conn.getresponse().read().decode("utf-8")
    finally:
        conn.close()


def _serve_and_post(module, requests, **kw):
    """Rank 0: ``tools.serve.serve`` of ``module`` on port 0 in a thread,
    the ``requests`` posted concurrently, then /metrics and the
    shutdown; returns ([(status, reply)], metrics text)."""
    import threading
    from video_learning_tpu_torch.tools import serve as serve_mod
    started = threading.Event()
    server = threading.Thread(target=serve_mod.serve, args=(module,),
                              kwargs=dict(port=0, started=started, **kw))
    server.start()
    assert started.wait(300)
    replies = [None] * len(requests)

    def post(i):
        replies[i] = _post(started.addr, requests[i])

    clients = [threading.Thread(target=post, args=(i,))
               for i in range(len(requests))]
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    text = _metrics(started.addr)
    started.httpd.shutdown()
    server.join(120)
    assert not server.is_alive()
    return replies, text


class _Faulty:
    """A follower's module whose calls after the warm-up's fail as a lost
    device would."""

    def __init__(self, module):
        self.module = module
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.module, name)

    def __call__(self, *arrays):
        self.calls += 1
        if self.calls > len(self.module.buckets):
            raise RuntimeError("simulated device fault on a follower")
        return self.module(*arrays)


def serve_over_mesh(module):
    """``tools.serve`` of a mesh module: rank 0 serves and posts
    ``SERVE_ITEMS`` requests concurrently (the batcher coalescing), then
    one ``--no-batch`` request; the other ranks follow and return after
    each stop.  A dispatch idle past its keepalive still serves.  Then a
    follower fails on its first call and leaves the group: rank 0's
    requests are answered 5xx, and nothing hangs."""
    import time
    import torch.distributed as dist
    from video_learning_tpu_torch.tools import serve as serve_mod
    requests = serve_requests(module.meta)
    rank = dist.get_rank()
    out = {}
    if rank == 0:
        replies, text = _serve_and_post(module, requests, window_ms=200.0)
        out["rows"] = [r[1]["outputs"] for r in replies]
        out["status"] = [r[0] for r in replies]
        out["metrics"] = text
        replies, _ = _serve_and_post(module, requests[1:2], coalesce=False)
        out["no_batch"] = {"status": replies[0][0],
                           "rows": replies[0][1]["outputs"]}
        keepalive, serve_mod.KEEPALIVE_S = serve_mod.KEEPALIVE_S, 0.2
        dispatch = serve_mod.MeshDispatch(module)
        dispatch.warmup()
        time.sleep(1.0)         # idle: the keepalive sends idle ops
        out["after_idle"] = dispatch(*requests[0]).tolist()
        dispatch.stop()
        serve_mod.KEEPALIVE_S = keepalive
        replies, _ = _serve_and_post(module, requests[:2],
                                     request_timeout_s=60)
        out["follower_failed"] = [r[0] for r in replies]
    else:
        for _ in range(2):
            assert serve_mod.serve(module) is None
        out["followed_after_idle"] = serve_mod.MeshDispatch(module).follow()
        try:
            serve_mod.serve(_Faulty(module))
        except RuntimeError as e:
            out["follower_error"] = str(e)
            dist.destroy_process_group()
    return out


def mesh_export(device, config, out):
    """``export_serving.export`` of ``config``'s latest checkpoint over a
    (2, 1) mesh to ``out``, then ``serving.load`` of it in this group and
    a call with the whole batch of ``RandomState(0)`` frames; and the
    refusal of a bucket whose rows the data axis does not divide.  Then
    the artifact served over the mesh (``serve_over_mesh``)."""
    from video_learning_tpu_torch.parallel.mesh import make_mesh
    from video_learning_tpu_torch.serving import ServingModule, load
    from video_learning_tpu_torch.tools.export_serving import export
    from video_learning_tpu_torch.utils import FrameworkError

    meta = export(config, out, checkpoint="latest", batch_items=[2, 4],
                  mesh_shape={"data": 2}, device=device)
    module = load(out, device=device)
    rs = np.random.RandomState(0)
    arrays = [rs.randint(0, 255, [3 * s["shape"][0] // 4] + s["shape"][1:])
              .astype(s["dtype"]) for s in module.meta["inputs"]]
    logits = module(*arrays)
    _, cap_model = flagship(caption=True, fpc=1, compute_dtype="float32")
    try:
        ServingModule(cap_model, cap_model.init_params(0, device=device),
                      batch_items=[1, 2], device=device,
                      mesh=make_mesh({"data": 2}))
        refused = None
    except FrameworkError as e:
        refused = str(e)
    result = {"meta_mesh": meta.get("mesh"),
              "loaded_mesh": module.meta.get("mesh"),
              "bucket": module.last_bucket, "logits": logits.tolist(),
              "refused": refused, "served": serve_over_mesh(module)}
    _no_jax()
    return result


def guards(device):
    """The refusals on a world of 2 ranks: a mesh shape that does not
    fill the world, and ``graphs=True`` for ``Train``, ``Validation``
    and ``ServingModule`` on a mesh; returns their messages and the
    engines' default."""
    from video_learning_tpu_torch.serving import ServingModule
    from video_learning_tpu_torch.utils import FrameworkError

    def message(fn):
        try:
            fn()
        except FrameworkError as e:
            return str(e)
        return None

    out = {"unfilled": message(lambda: make_mesh({"data": 1}))}
    mesh = make_mesh({"data": 2})
    settings, model = _settings({}, {}, {"data": 2})
    out["train"] = message(lambda: Train(settings, settings.feeder, model,
                                         device=device, graphs=True))
    out["val"] = message(lambda: Validation(settings, model, device=device,
                                            graphs=True))
    out["serve"] = message(lambda: ServingModule(
        model, model.init_params(0, device=device), batch_items=2,
        device=device, graphs=True, mesh=mesh))
    out["default_graphs"] = Train(settings, settings.feeder, model,
                                  device=device).graphs
    _no_jax()
    return out
