"""The port's (data x model) mesh against the JAX package's, on the CPU:
the counterpart of ``tests/test_parallel.py``.

The JAX side runs on the virtual 8-device CPU mesh (``conftest.py``) at
(data=2, model=2); the port's side runs as 4 gloo ranks
(``video_learning_tpu_torch.parallel.launch``, rank functions in
``torch_mesh_worker.py``, which import neither JAX nor the JAX package).
Both start from the same JAX-initialised parameters (carried by name
through npz files, as ``checkpoint.from_jax_flat`` carries them) of the
tiny float32 flagship of ``__graft_entry__._flagship()`` (67x67 frames,
fpc 4, 16 classes, 2x256 LSTM), dropout off, on the same global feeds of
4 clips: JAX takes each whole, each port rank its data rows (2 clips).

A step on an (N, M) mesh is to compute what one device computes on the
global batch.  The JAX package's own (2, 2) mesh does not, in one place:
with ``accum_steps`` 1 XLA's partitioned backward gives the grouped
convs (conv2, conv4, conv5) twice their weight gradient
(``test_jax_mesh_doubles_the_grouped_conv_weight_gradients``; at (4, 1),
(2, 1) and (1, 2) it does not, nor in the micro-batch-sum step of
``accum_steps`` > 1).  So the port's mesh steps are held to the JAX
step on one device of the global batch, and, where JAX's mesh is right
(``accum_steps`` 2), to JAX's mesh as well.

The same start of the ranks also takes one step with remat and one
without (``torch_mesh_worker.remat_step``): on the CPU the two are
equal bit for bit.

Tolerances: the parameters after 3 steps by ``_assert_params_close`` of
``test_torch_train.py``; losses within 1e-5 relative and gradient norms
within the 1e-2 of ``test_torch_train.py`` (a relu input within rounding
of zero moves the port's single-process norm from JAX's by up to ~1e-3;
the mesh moves it by less than 1e-4 from the port's single-process
one); the float and int8 forwards by the rule of ``test_torch_int8.py``
for ``Model.apply(quantize=...)`` (1e-3 of the logit scale); decoded
tokens equal.  After Adam steps the losses and gradient norms are held
within those bounds, or twice the distance between JAX's own mesh and
one JAX device where that is larger (an adaptive step moves every
element by about lr whatever its gradient, so rounding-noise gradients
step either way: at the third step JAX's mesh and one device differ by
6e-5 relative in the loss and 7% in the gradient norm).  The int8
forwards run on mean-subtracted uint8-range frames, the inputs of
``test_torch_int8.py``.
"""

import os

import numpy as np
import pytest

import jax

import __graft_entry__ as graft
from test_torch_train import _assert_params_close
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import train as jtrain
from video_learning_tpu.config import ValOpts as JValOpts
from video_learning_tpu.parallel import mesh as jmesh
from video_learning_tpu.parallel.sharding import param_shardings
from video_learning_tpu.val import Validation as JValidation
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch.flagship import caption_flagship, flagship
from video_learning_tpu_torch.parallel import launch, sharding

TESTS = os.path.dirname(os.path.abspath(__file__))
MESH = {"data": 2, "model": 2}
FPC, IMAGE, CLASSES, CLIPS = 4, 67, 16, 4
SGD = dict(optimizer="sgd", lr_mult=2.0, clip_norm=5.0)
CONFIGS = {
    # SGD with two tiers and the global-norm clip; the third feed's
    # label_mask zeros all fall on data rank 1 (its rows count nothing)
    "sgd_ragged_tail": (SGD, {}),
    "adam_ema_accum2": (dict(optimizer="adam", lr_mult=2.0, clip_norm=None,
                             base_lr=1e-5),
                        {"ema_decay": 0.9, "accum_steps": 2}),
}


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _frames(rng, clips, fpc=FPC):
    return (rng.randn(clips * fpc, IMAGE, IMAGE, 3) * 60).astype(np.float32)


def _global_feeds(name, seed=3):
    rng = np.random.RandomState(seed)
    feeds = [{"frames_main_input": _frames(rng, CLIPS),
              "labels": np.eye(CLASSES, dtype=np.int32)[
                  rng.randint(0, CLASSES, CLIPS)]} for _ in range(3)]
    if name == "sgd_ragged_tail":
        feeds[2]["label_mask"] = np.asarray([1, 1, 0, 0], np.float32)
    return feeds


def _jax_engine(kw, opts, caption=False, mesh_shape=MESH):
    s, model = graft._flagship(compute_dtype="float32",
                               mesh_shape=mesh_shape,
                               caption=caption, fpc=1 if caption else FPC,
                               batch_size=CLIPS, **kw)
    s.train.dropout_keep_prob = 1.0
    for k, v in opts.items():
        setattr(s.train, k, v)
    engine = jtrain.Train(s, s.feeder, model, seed=0)
    engine.place_params()
    return s, model, engine


def _jax_forward(settings, model, params, feed, quantize=None,
                 decode=False):
    settings.val = JValOpts()
    settings.val.quantize = quantize
    return np.asarray(JValidation(settings, model).run_forward(
        params, feed, decode=decode))


def _jax_grads(settings, model, params, feed, mesh_shape):
    """JAX's gradient of the masked-mean loss (the ``accum_steps`` 1
    step's), on one device or sharded over a mesh, as flat numpy."""
    from video_learning_tpu.parallel.sharding import shard_params
    from video_learning_tpu.train import softmax_cross_entropy

    def loss(p, f):
        logits = model.apply(p, {"frames_main_input": f["frames_main_input"]},
                             train=True, dropout_rng=jax.random.PRNGKey(1))
        return softmax_cross_entropy(logits, f["labels"], None)

    if mesh_shape is not None:
        mesh = jmesh.make_mesh(mesh_shape)
        params = shard_params(params, mesh)
        feed = jmesh.shard_feed(feed, mesh)
    return _flat(jax.jit(jax.grad(loss))(params, feed))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX result, and the port's from one start of 4 ranks."""
    folder = str(tmp_path_factory.mktemp("mesh"))
    ref = {}
    start = None
    for name, (kw, opts) in sorted(CONFIGS.items()):
        feeds = _global_feeds(name)
        np.savez(os.path.join(folder, "feeds_%s.npz" % name),
                 **{"%d/%s" % (i, k): v for i, f in enumerate(feeds)
                    for k, v in f.items()})
        # on one device, and on JAX's own (2, 2) mesh
        for where, shape in (("one", {"data": 1}), ("mesh", MESH)):
            s, model, engine = _jax_engine(kw, opts, mesh_shape=shape)
            if start is None:
                start = _flat(engine.params)
                np.savez(os.path.join(folder, "params.npz"), **start)
            if where == "mesh":
                fwd = (s, model)
            out = ref.setdefault(where, {"steps": {}, "params": {},
                                         "ema": {}})
            out["steps"][name] = [engine.run_step(dict(f)) for f in feeds]
            out["params"][name] = _flat(engine.params)
            if opts.get("ema_decay"):
                out["ema"][name] = _flat(engine.opt_state["ema"])

    rng = np.random.RandomState(5)
    # image statistics, as test_torch_int8 feeds its int8 forwards
    evalf = {"frames_main_input": (rng.randint(
        0, 256, (CLIPS * FPC, IMAGE, IMAGE, 3)) - 117.0).astype(np.float32),
             "labels": np.eye(CLASSES, dtype=np.int32)[
                 rng.randint(0, CLASSES, CLIPS)]}
    np.savez(os.path.join(folder, "eval.npz"), **evalf)
    s, model = fwd
    jparams = jax.tree_util.tree_map(np.asarray,
                                     ckpt.unflatten_tree(start))
    frames = {"frames_main_input": evalf["frames_main_input"]}
    ref["forwards"] = {str(q): _jax_forward(s, model, jparams, frames, q)
                       for q in (None, "int8", "int8_static")}
    ref["grads"] = {where: _jax_grads(s, model, jparams, evalf, shape)
                    for where, shape in (("one", None), ("mesh", MESH))}
    # the port in one process on the global batch
    import torch_mesh_worker as worker
    ref["port_forwards"] = worker.forwards("cpu", folder, {"data": 1},
                                           check_imports=False)
    worker.grads("cpu", folder, {"data": 1}, check_imports=False)

    # the caption step on one JAX device (JAX's mesh has the grouped
    # conv fault here too); the decodes on JAX's mesh
    _, _, cengine = _jax_engine({}, {}, caption=True,
                                mesh_shape={"data": 1})
    cs, cmodel, _ = _jax_engine({}, {}, caption=True)
    cstart = _flat(cengine.params)
    np.savez(os.path.join(folder, "cap_params.npz"), **cstart)
    cfeed = graft._caption_feed(cs, cmodel, fpc=1)
    np.savez(os.path.join(folder, "cap_feed.npz"), **cfeed)
    ref["cap_metrics"] = cengine.run_step(dict(cfeed))
    ref["cap_params"] = _flat(cengine.params)
    ref["cap_start"] = cstart
    # output weights scaled so that each step's choice stands clear of
    # rounding (as test_torch_int8's caption pair)
    dec = dict(cstart)
    dec["clf/output_fc/w"] = dec["clf/output_fc/w"] * 20.0
    np.savez(os.path.join(folder, "cap_decode_params.npz"), **dec)
    cframes = {"frames_main_input": _frames(np.random.RandomState(6),
                                            CLIPS, fpc=1)}
    np.savez(os.path.join(folder, "cap_frames.npz"), **cframes)
    dparams = jax.tree_util.tree_map(np.asarray, ckpt.unflatten_tree(dec))
    ref["tokens"] = {}
    for search in ("max", "beam"):
        cs.captioning.caption_search = search
        cs.captioning.beam_width = 3
        ref["tokens"][search] = _jax_forward(cs, cmodel, dparams, cframes,
                                             decode=True)

    port = launch.run(4, "torch_mesh_worker:parity", {
        "folder": folder, "configs": CONFIGS}, device="cpu", backend="gloo",
        threads=2, timeout=900, path=TESTS)
    return folder, ref, start, port


# ------------------------------------------------------------- sharding
def _jax_split(jshapes, model_size):
    """{flat name: split dim} of JAX's ``param_shardings`` at
    (data=2, model=model_size) on the 8-device CPU mesh."""
    mesh = jmesh.make_mesh({"data": 2, "model": model_size})
    out = {}
    for name, sh in jckpt.flatten_tree(
            param_shardings(jshapes, mesh)).items():
        for dim, axis in enumerate(tuple(sh.spec)):
            if axis == "model":
                out[name] = dim
    return out


@pytest.mark.parametrize("which", ["flagship", "captioner"])
@pytest.mark.parametrize("model_size", [1, 2])
def test_sharding_rule_matches_jax_param_shardings(which, model_size):
    """At full width (101 classes, 227x227, fpc 16; the captioner of the
    JAX bench) the port splits exactly the leaves JAX's
    ``param_shardings`` splits, along the same dimension, and at
    ``model=2`` those are ``SHARDED_AT_MODEL_2``."""
    if which == "flagship":
        _, jmodel = graft._flagship(num_classes=101, fpc=16, image=227)
        _, tmodel = flagship(num_classes=101, fpc=16, image=227)
    else:
        _, jmodel = graft._flagship(caption=True, num_classes=10000, fpc=1,
                                    image=227, lstm=(512, 1), emb_dim=300,
                                    max_T=20)
        _, tmodel = caption_flagship()
    jshapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    want = _jax_split(jshapes, model_size)
    got = tmodel.sharded_leaves(model_size)
    assert got == want
    assert sorted(got) == (sharding.SHARDED_AT_MODEL_2[which]
                           if model_size == 2 else [])
    # the rule itself on the JAX layout of every leaf
    flat = {n: tuple(s.shape)
            for n, s in jckpt.flatten_tree(jshapes).items()}
    assert sharding.sharded_leaves(flat, model_size) == want


# --------------------------------------------------------------- steps
def _assert_adaptive_ema_close(port, ref, start):
    """``_assert_params_close``'s adaptive rule for the EMA of Adam
    parameters, with the share of elements allowed beyond 10% of the
    movement counted as at least one element: a 96-element bias whose
    one element took a flipped step is 1.04% of it."""
    for k in sorted(ref):
        moved = float(np.abs(ref[k] - start[k]).max())
        atol = 1e-6 * float(np.abs(ref[k]).max())
        diff = np.abs(port[k] - ref[k])
        assert moved > 0, k
        assert diff.max() <= 2.0 * moved + atol, (k, diff.max(), moved)
        assert np.sum(diff > 0.1 * moved + atol) <= \
            max(1, int(0.01 * diff.size)), k


@pytest.mark.parametrize("where,name", [
    ("one", "sgd_ragged_tail"), ("one", "adam_ema_accum2"),
    ("mesh", "adam_ema_accum2")])
def test_mesh_steps_match_jax(runs, where, name):
    """Three steps on the (2, 2) mesh, the whole state gathered on rank 0
    and saved: every rank reports the same metrics, and they and the
    parameters (and EMA) are those of the JAX step on one device of the
    global batch, and of JAX's (2, 2) mesh where it is right (module
    docstring), by the train tests' rule."""
    folder, refs, start, port = runs
    ref = refs[where]
    adaptive = name.startswith("adam")
    for rank in port:
        assert rank["steps"][name] == port[0]["steps"][name]
    for step, (out, want) in enumerate(zip(port[0]["steps"][name],
                                           ref["steps"][name])):
        assert out["lr"] == pytest.approx(want["lr"], rel=1e-7)
        assert out["accuracy"] == want["accuracy"]
        tol = 1e-5 * abs(want["loss"])
        if adaptive:
            # an adaptive step moves every element by about lr, so an
            # element whose gradient is rounding noise steps either way:
            # after such steps the loss may differ by as much as JAX's
            # own mesh and one device differ (twice over)
            tol = max(tol, 2 * abs(refs["one"]["steps"][name][step]["loss"]
                                   - refs["mesh"]["steps"][name][step]
                                   ["loss"]))
        assert abs(out["loss"] - want["loss"]) <= tol, (step, out, want)
        tol = 1e-2 * abs(want["grad_norm"])
        if adaptive:
            tol = max(tol, 2 * abs(
                refs["one"]["steps"][name][step]["grad_norm"]
                - refs["mesh"]["steps"][name][step]["grad_norm"]))
        assert abs(out["grad_norm"] - want["grad_norm"]) <= tol, \
            (step, out, want)
    state = _npz(os.path.join(folder, "state_%s.npz" % name))
    params = {k[len("params/"):]: v for k, v in state.items()
              if k.startswith("params/")}
    assert sorted(params) == sorted(start)
    _assert_params_close(params, ref["params"][name], start, adaptive)
    if name in ref["ema"]:
        ema = {k[len("ema_params/"):]: v for k, v in state.items()
               if k.startswith("ema_params/")}
        if adaptive:
            _assert_adaptive_ema_close(ema, ref["ema"][name], start)
        else:
            _assert_params_close(ema, ref["ema"][name], start, False)


def test_jax_mesh_doubles_the_grouped_conv_weight_gradients(runs):
    """The fault of the reference (module docstring): JAX's (2, 2) mesh
    gives conv2, conv4 and conv5 twice the weight gradient one JAX device
    gives, and every other gradient the same; the port's (2, 2) mesh
    gives every gradient of the port in one process (the norm of the
    difference within 1e-3 of the gradient's, as in
    ``test_model_axis_input_gradient_is_all_reduced``), and that is one
    JAX device's (norms within 1e-2)."""
    folder, ref, _, _ = runs
    one, mesh = ref["grads"]["one"], ref["grads"]["mesh"]
    port = _npz(os.path.join(folder, "grads_2x2.npz"))
    port_one = _npz(os.path.join(folder, "grads_1x1.npz"))
    doubled = {"frames/dcnn/%s/w" % c for c in ("conv2", "conv4", "conv5")}
    assert sorted(port) == sorted(port_one) == sorted(one)
    for name, g in one.items():
        ratio = np.linalg.norm(mesh[name]) / np.linalg.norm(g)
        assert ratio == pytest.approx(2.0 if name in doubled else 1.0,
                                      rel=1e-5), name
        assert _rel(port[name], port_one[name]) <= 1e-3, name
        assert np.linalg.norm(port_one[name]) == pytest.approx(
            np.linalg.norm(g), rel=1e-2), name


def test_mesh_remat_step_equals_the_step_without_remat(runs):
    """On the (2, 2) mesh a float32 step with remat (the encoder under
    ``torch.utils.checkpoint``, its recompute gathering fc6's and fc7's
    columns again) equals the step without it: the same metrics and
    every rank's parameter slices bit for bit."""
    _, _, _, port = runs
    for rank in port:
        res = rank["remat"]
        assert res["metrics"][1] == res["metrics"][0]
        assert res["equal"], res["max_diff"]
        assert res["metrics"] == port[0]["remat"]["metrics"]


# ------------------------------------------------------------ forwards
def _rel(a, b):
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9)


@pytest.mark.parametrize("mode", ["None", "int8", "int8_static"])
def test_mesh_forwards_match_jax_mesh(runs, mode):
    """Each rank's rows of the evaluation forward (float, dynamic and
    static int8) are those of the same clips in one process: the model
    group's two ranks return the same rows, and the int8 scales are the
    global batch's (within 1e-5 of the logit scale of the port's
    single-process forward of the whole batch).  Against JAX's mesh the
    float rows are within test_torch_int8's 1e-3 of the logit scale.
    The int8 rows are within its pipeline bound (relative error < 0.1):
    on this batch the port's single-process int8 forward already
    differs from JAX's by more than 1e-3 of the scale, since a float32
    rounding difference upstream flips an activation that lies on a
    rounding tie of the int8 grid (ROADMAP, Precision)."""
    _, ref, _, port = runs
    want = ref["forwards"][mode]
    one = np.asarray(ref["port_forwards"][mode], np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    for rank, res in enumerate(port):
        data = rank // MESH["model"]
        rows = want[data * 2:(data + 1) * 2]
        out = np.asarray(res["forwards"][mode], np.float32)
        assert out.shape == rows.shape == (2, CLASSES)
        np.testing.assert_allclose(out, one[data * 2:(data + 1) * 2],
                                   rtol=0, atol=1e-5 * scale)
        if mode == "None":
            np.testing.assert_allclose(out, rows, rtol=0,
                                       atol=1e-3 * scale)
        else:
            assert _rel(out, rows) < 0.1


# ------------------------------------------------------------- caption
def test_mesh_caption_step_and_decodes_match_jax_mesh(runs):
    """The captioner on the (2, 2) mesh (its state_fc and LSTM kernel
    split): the step's loss, gradient norm and parameters are one JAX
    device's on the global batch, and the greedy and beam-3 tokens of
    each rank's rows are those of JAX's mesh."""
    folder, ref, _, port = runs
    for res in port:
        assert res["caption"]["metrics"] == port[0]["caption"]["metrics"]
    out = port[0]["caption"]["metrics"]
    assert out["loss"] == pytest.approx(ref["cap_metrics"]["loss"],
                                        rel=1e-5)
    assert out["grad_norm"] == pytest.approx(
        ref["cap_metrics"]["grad_norm"], rel=1e-2)
    state = _npz(os.path.join(folder, "cap_state.npz"))
    params = {k[len("params/"):]: v for k, v in state.items()}
    _assert_params_close(params, ref["cap_params"], ref["cap_start"], False)
    for search in ("max", "beam"):
        want = ref["tokens"][search]
        for rank, res in enumerate(port):
            data = rank // MESH["model"]
            np.testing.assert_array_equal(
                np.asarray(res["caption"]["tokens"][search]),
                want[data * 2:(data + 1) * 2])


# ------------------------------------------------- the model-axis rules
def test_model_axis_input_gradient_is_all_reduced(tmp_path):
    """On a (1, 2) mesh every gradient, conv1's included, equals the
    single-process one: the input gradient of each column-split FC is a
    partial sum on each rank, and without its all-reduce over the model
    group conv5 and everything below it would get a part of it.  Held
    by the norm of the difference, within 1e-3 of the gradient's: a
    column slice's GEMM sums in another order than the whole one, which
    the saturated LSTM gates of these large-amplitude frames amplify to
    ~1.5e-4, while a missing or doubled reduction is off by a factor."""
    import torch_mesh_worker as worker
    _, jmodel = graft._flagship(compute_dtype="float32")
    start = _flat(jmodel.init_params(jax.random.PRNGKey(0)))
    np.savez(str(tmp_path / "params.npz"), **start)
    rng = np.random.RandomState(5)
    np.savez(str(tmp_path / "eval.npz"),
             frames_main_input=_frames(rng, 2),
             labels=np.eye(CLASSES, dtype=np.int32)[[3, 7]])
    (res, _) = launch.run(2, "torch_mesh_worker:grads", {
        "folder": str(tmp_path), "mesh_shape": {"data": 1, "model": 2}},
        device="cpu", backend="gloo", threads=2, timeout=600, path=TESTS)
    assert res["split"] == sharding.SHARDED_AT_MODEL_2["flagship"]
    worker.grads("cpu", str(tmp_path), {"data": 1, "model": 1},
                 check_imports=False)
    split = _npz(str(tmp_path / "grads_1x2.npz"))
    single = _npz(str(tmp_path / "grads_1x1.npz"))
    assert sorted(split) == sorted(single)
    for name, g in single.items():
        assert np.abs(g).max() > 0, name
        assert _rel(split[name], g) <= 1e-3, name
