"""The optimizer state in both packages' checkpoints, on the CPU: the
port writes and reads the optax state as the JAX package does, its leaves
in optax's order under ``opt_state_leaves/<i>`` (the step counts int32,
the slots float32 in the JAX layouts), so a run resumes in the other
package where it stopped.  The model is the tiny flagship (67x67 frames,
fpc 2, a 1x32 LSTM, 5 classes), float32, dropout off, from the JAX init
rescaled as ``test_torch_run_task.py:_weights_npy`` scales its weights
file (He-scaled convs with biases 0.1, fc6 bringing its outputs to ~0.3
with the pixels' scale folded in, and fc7 He-scaled), so that the LSTM's
gates do not saturate and the two packages' float32 rounding stays
small."""

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import train as jtrain
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import train as ttrain
from video_learning_tpu_torch.flagship import flagship

KW = dict(num_classes=5, fpc=2, lstm=(32, 1), compute_dtype="float32")
OPTIMIZERS = ("sgd", "adam", "rmsprop", "adamw")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and more threads a worker only contend."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _settings(optimizer, lr_mult=2.0, ema_decay=0.0, base_lr=1e-4):
    """(JAX settings and model, port settings and model) of the flagship
    with a global-norm clip of 5, the per-tensor clip of ``clip_grads``
    and AdamW's decay set (neither clip holds a leaf; AdamW's decay mask
    is ``ndim > 1``)."""
    s, jmodel = graft._flagship(mesh_shape={"data": 1}, optimizer=optimizer,
                                lr_mult=lr_mult, base_lr=base_lr, **KW)
    ts, tmodel = flagship(optimizer=optimizer, lr_mult=lr_mult,
                          base_lr=base_lr, **KW)
    for st in (s, ts):
        st.train.dropout_keep_prob = 1.0
        st.train.ema_decay = ema_decay
        st.train.clip_grads = (-50.0, 50.0)
        st.train.weight_decay = 0.1
    return (s, jmodel), (ts, tmodel)


def _start(jparams):
    """The JAX init's names and shapes with ``_weights_npy``'s scales,
    drawn from RandomState(11), as a flat numpy dict."""
    rng = np.random.RandomState(11)
    out = {}
    for name, v in sorted(jckpt.flatten_tree(jparams).items()):
        shape = np.shape(v)
        if name.startswith("frames/dcnn/conv") and name.endswith("/w"):
            kh, kw, cin, _ = shape
            w = rng.randn(*shape) * np.sqrt(2.0 / (kh * kw * cin))
        elif name.startswith("frames/dcnn/conv"):
            w = np.full(shape, 0.1)
        elif name == "frames/dcnn/fc6/w":
            w = rng.randn(*shape) * np.sqrt(0.08 / shape[0]) / 74.0
        elif name == "frames/dcnn/fc7/w":
            w = rng.randn(*shape) * np.sqrt(2.0 / shape[0])
        elif name.startswith("frames/dcnn/fc"):
            w = np.full(shape, 0.02)
        else:
            w = np.asarray(v)
        out[name] = np.asarray(w, np.float32)
    return out


def _port_engine(optimizer, lr_mult=2.0, ema_decay=0.0):
    """A fresh port Train of one configuration (its parameters are
    replaced by a restore)."""
    _, (ts, tmodel) = _settings(optimizer, lr_mult, ema_decay)
    return ttrain.Train(ts, ts.feeder, tmodel, device="cpu", seed=0)


def _engines(optimizer, lr_mult=2.0, ema_decay=0.0):
    """A JAX and a port Train of one configuration from the same
    ``_start`` parameters."""
    (s, jmodel), (ts, tmodel) = _settings(optimizer, lr_mult, ema_decay)
    jeng = jtrain.Train(s, s.feeder, jmodel, seed=0)
    start = _start(jeng.params)
    jeng.params = ckpt.unflatten_tree(dict(start))
    if ema_decay:
        jeng.opt_state = {"tx": jeng.opt_state["tx"],
                          "ema": ckpt.unflatten_tree(
                              {k: v.copy() for k, v in start.items()})}
    jeng.place_params()
    teng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu", seed=0,
                        params=ckpt.unflatten_tree(
                            ckpt.from_jax_flat(start, "cpu")))
    return jeng, teng


def _feeds(n, seed=3):
    rng = np.random.RandomState(seed)
    return [{"frames_main_input": (rng.randn(2 * KW["fpc"], 67, 67, 3) * 60)
             .astype(np.float32),
             "labels": np.eye(KW["num_classes"], dtype=np.int32)[
                 rng.randint(0, KW["num_classes"], 2)]} for _ in range(n)]


def _jax_leaves(state):
    """The optax leaves of a JAX Train's state, or of an optax state."""
    if isinstance(state, jtrain.Train):
        state = state.opt_state
        if isinstance(state, dict) and "tx" in state:
            state = state["tx"]
    return [np.asarray(x) for x in jax.tree_util.tree_flatten(state)[0]]


def _port_leaves(teng):
    """The port's ``opt_state_leaves`` in the JAX layouts (4-D slots
    HWIO), as numpy."""
    return [np.asarray(v) for v in ckpt.to_jax_flat(
        {"l": teng.state_dict()["opt_state_leaves"]}).values()]


@pytest.fixture(scope="module")
def jax_params():
    """The flagship's JAX init parameters and its 'modified' prefixes
    (neither depends on the optimizer's configuration)."""
    (s, jmodel), _ = _settings("sgd")
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return params, jmodel.param_groups()[1]


@pytest.mark.parametrize("lr_mult", [None, 2.0], ids=["one_tier",
                                                      "two_tiers"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_opt_state_leaves_follow_optax(optimizer, lr_mult, jax_params):
    """At init the port's leaves are optax's: the same count, and leaf by
    leaf the same shape (conv slots HWIO) and dtype (int32 counts,
    float32 slots), against the installed optax's ``tree_flatten`` of
    the state the JAX ``Train`` makes (``make_optimizer`` over its label
    tree, ``init`` of its parameters)."""
    (s, _), (ts, tmodel) = _settings(optimizer, lr_mult)
    params, modified = jax_params
    lrs = np.asarray(jtrain.precompute_learning_rates(
        s, s.feeder.get_num_batches()), np.float32)
    tx = jtrain.make_optimizer(s, lrs,
                               jtrain.make_label_tree(params, modified))
    teng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu", seed=0)
    ref, got = _jax_leaves(tx.init(params)), _port_leaves(teng)
    assert len(got) == len(ref)
    assert [(g.shape, g.dtype) for g in got] == \
        [(r.shape, r.dtype) for r in ref]
    tiers = 1 if lr_mult is None else 2
    per_param = {"sgd": 0, "adam": 2, "rmsprop": 1, "adamw": 2}[optimizer]
    counts = {"sgd": 1, "adam": 2, "rmsprop": 1, "adamw": 2}[optimizer]
    assert len(ref) == tiers * counts + per_param * len(teng._flat)


def _one_step(jeng, teng, feed):
    """One step in each engine; returns the port's gradients, recorded
    where its optimizer receives them."""
    grads = {}
    update = teng.tx.update

    def recording(g, state, params):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return update(g, state, params)

    teng.tx.update = recording
    try:
        jeng.run_step(dict(feed))
        teng.run_step(dict(feed))
    finally:
        teng.tx.update = update
    return grads


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_state(jeng):
    return {"params": {k: np.asarray(v) for k, v in
                       jckpt.flatten_tree(jeng.params).items()},
            "ema_params": {k: np.asarray(v) for k, v in
                           jckpt.flatten_tree(jeng.opt_state["ema"]).items()},
            "opt_state_leaves": _jax_leaves(jeng)}


def _port_state(teng):
    sd = teng.state_dict()
    return {"params": ckpt.to_jax_flat(sd["params"]),
            "ema_params": ckpt.to_jax_flat(sd["ema_params"]),
            "opt_state_leaves": _port_leaves(teng)}


@pytest.fixture(scope="module")
def adam_runs(tmp_path_factory):
    """Adam with an EMA, two tiers and the global-norm clip, from one
    start in both packages: three steps each, the state saved by each
    package's ``save_checkpoint`` after step 2, the metrics and state
    after step 3, the leaves after step 1 and the port's step-1
    gradients; and the JAX engine (its step compiled)."""
    jeng, teng = _engines("adam", ema_decay=0.9)
    folder = tmp_path_factory.mktemp("opt_state")
    feeds = _feeds(3, seed=5)
    start = jeng.params
    grads = _one_step(jeng, teng, feeds[0])
    out = {"feeds": feeds, "start": start, "grads": grads,
           "step1": (_jax_leaves(jeng), _port_leaves(teng))}
    jeng.run_step(dict(feeds[1]))
    teng.run_step(dict(feeds[1]))
    out["jax_ckpt"] = str(folder / "jax.ckpt")
    out["port_ckpt"] = str(folder / "port.ckpt")
    jckpt.save_checkpoint(out["jax_ckpt"], jeng.state_dict())
    ckpt.save_checkpoint(out["port_ckpt"], teng.state_dict())
    out["jax"] = (jeng.run_step(dict(feeds[2])), _jax_state(jeng))
    out["port"] = (teng.run_step(dict(feeds[2])), _port_state(teng))
    out["jeng"], out["teng"] = jeng, teng
    return out


def _assert_leaves_close(got, ref, tol, names):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype, i
        if r.dtype == np.int32:
            assert int(g) == int(r) == 1, i
            continue
        scale = float(np.abs(r).max())
        assert scale > 0, i
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale,
                                   err_msg=str(names[i]))


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_opt_state_values_after_one_step_equal_optax(optimizer, adam_runs):
    """After one step from the same parameters on the same feed, two
    tiers, leaf by leaf: the port's leaves within 1e-6 of each leaf's
    largest |value| of the optax state that the JAX package's optimizer
    (``jtrain.make_optimizer``, clips included) makes from the port's
    own gradients, and within 1e-5 of it of the JAX package's state
    after its own step, whose float32 gradients part from the port's by
    up to 2.5e-6 of their largest element (twice that in nu, which
    squares them): the two packages' forward and backward round
    differently, not their optimizers."""
    if optimizer == "adam":
        jeng, teng = adam_runs["jeng"], adam_runs["teng"]
        start, grads = adam_runs["start"], adam_runs["grads"]
        after_jax, got = adam_runs["step1"]
    else:
        jeng, teng = _engines(optimizer)
        start = jeng.params
        grads = _one_step(jeng, teng, _feeds(1)[0])
        after_jax, got = _jax_leaves(jeng), _port_leaves(teng)
    _, from_port = jax.jit(jeng.tx.update)(
        ckpt.unflatten_tree(ckpt.to_jax_flat(grads)), jeng.tx.init(start),
        start)
    _assert_leaves_close(got, _jax_leaves(from_port), 1e-6,
                         teng._opt_leaves)
    _assert_leaves_close(got, after_jax, 1e-5, teng._opt_leaves)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_run_resumes_in_the_other_package(adam_runs, direction):
    """Adam with an EMA, two tiers and the global-norm clip: two steps in
    package A, A's ``save_checkpoint``, a strict restore (no name on one
    side only) into package B and B's ``load_state_dict`` (a fresh port
    Train; the JAX engine of the other run, whose state the restore
    replaces whole), then step 3 in B against step 3 in A: the loss
    within 1e-5 relative, every parameter, moment and EMA leaf within
    1e-4 normwise, the step counts and the lr equal.  Before the port
    wrote optax's leaves this failed both ways: the port's
    ``opt_state/<tier>/...`` names had no counterpart in the other
    package's template (strict raised), and without ``strict`` the
    moments and the step counts restarted at zero, and with them the lr
    schedule."""
    loaded = []
    if direction == "jax_to_port":
        path = adam_runs["jax_ckpt"]
        ref, want = adam_runs["jax"]
        b = _port_engine("adam", ema_decay=0.9)
        state = ckpt.restore_checkpoint(path, b.state_dict(), strict=True,
                                        loaded_out=loaded)
    else:
        path = adam_runs["port_ckpt"]
        ref, want = adam_runs["port"]
        b = adam_runs["jeng"]
        state = jckpt.restore_checkpoint(path, b.state_dict(), strict=True,
                                         loaded_out=loaded)
    b.load_state_dict(state, restored_names=loaded)
    assert sorted(loaded) == sorted(jckpt.get_checkpoint_tensor_names(path))
    assert b.global_step == 2
    if direction == "jax_to_port":
        for tier, t in b.tx.tiers.items():
            assert int(b.opt_state[tier]["count"]) == 2
            assert float(t.lr(b.opt_state[tier]["count"])) == \
                float(t.lr_array[2])
    got = b.run_step(dict(adam_runs["feeds"][2]))
    assert got["lr"] == ref["lr"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)

    have = _port_state(b) if direction == "jax_to_port" else _jax_state(b)
    for part in ("params", "ema_params"):
        assert sorted(have[part]) == sorted(want[part])
        for k in want[part]:
            assert _normwise(have[part][k], want[part][k]) <= 1e-4, (part, k)
    assert len(have["opt_state_leaves"]) == len(want["opt_state_leaves"])
    for i, (h, w) in enumerate(zip(have["opt_state_leaves"],
                                   want["opt_state_leaves"])):
        if w.dtype == np.int32:
            assert int(h) == int(w) == 3, i
        else:
            assert _normwise(h, w) <= 1e-4, i
