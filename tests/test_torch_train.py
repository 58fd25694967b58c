"""The port's training engine against the JAX package's on the CPU: the lr
schedule, the optimizer chain, and three ``Train.run_step``s of the tiny
flagship (67x67 frames, fpc 4, 16 classes, 2x256 LSTM) from shared
parameters (JAX init, carried by ``checkpoint.from_jax_flat``) on shared
feeds (numpy, from a seed), dropout off.

Tolerances.  One float32 forward agrees to ~1e-6 relative, but a relu
whose input lies within rounding of zero can switch on one side and not
the other, which changes a few gradient elements outright and the
gradient norm by up to ~1e-3 relative.  Under SGD that moves the
parameters by a small fraction of their step.  Adam, AdamW and RMSProp
scale every element to a step of about lr, so an element whose gradient
is rounding noise may step the other way: those runs use lr 1e-5 (the
nets stay near their start, where the comparison is well conditioned)
and allow a flipped step on at most 1% of the elements.  The optimizer
chain itself is held to optax exactly (rtol 1e-6) on identical
gradients.
"""

import types

import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import train as jtrain
from video_learning_tpu.defs import defs as jdefs
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import train as ttrain
from video_learning_tpu_torch.defs import defs as tdefs
from video_learning_tpu_torch.flagship import flagship

FPC, IMAGE, CLASSES = 4, 67, 16


# ------------------------------------------------------- (e) lr schedule
def _lr_settings(defs, lr_decay, warmup, run_folder=None):
    train = types.SimpleNamespace(base_lr=0.01, epochs=2, lr_warmup=warmup,
                                  lr_decay=None)
    if lr_decay is not None:
        strategy, scheme = lr_decay[:2]
        train.lr_decay = [getattr(defs.decay, strategy),
                          getattr(defs.periodicity, scheme)] + \
            list(lr_decay[2:])
    return types.SimpleNamespace(train=train, run_folder=run_folder,
                                 run_id="sched")


@pytest.mark.parametrize("lr_decay,warmup", [
    (None, 0), (None, 4),
    (("exp", "interval", 3, 0.5), 0),
    (("staircase", "interval", 3, 0.5), 2),
    (("exp", "drops", 4, 0.1), 0),
    (("staircase", "drops", 3, 0.1, 5), 0),     # drop offset 5
    (("exp", "interval", 2, 0.7, 3), 3),        # offset and warmup
    (("cosine", "interval", 4, 0.1), 0),
    (("cosine", "drops", 3, 0.0), 2),
])
def test_precompute_learning_rates_matches_jax(lr_decay, warmup, tmp_path):
    """Exactly the JAX list (the same float arithmetic), and the same
    schedule file."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    ref = jtrain.precompute_learning_rates(
        _lr_settings(jdefs, lr_decay, warmup, str(jdir)), 11)
    out = ttrain.precompute_learning_rates(
        _lr_settings(tdefs, lr_decay, warmup, str(tdir)), 11)
    assert out == ref and len(out) == 22
    if lr_decay is not None:
        name = "sched_lr_decay_schedule.txt"
        assert (tdir / name).read_text() == (jdir / name).read_text()


# ------------------------------------------------------ optimizer chain
def _nest(flat):
    return {"a": {"w": flat["a/w"], "b": flat["a/b"]},
            "m": {"w": flat["m/w"]}}


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "rmsprop", "adamw"])
@pytest.mark.parametrize("lr_mult", [None, 2.0])
def test_optimizer_chain_matches_optax(optimizer, lr_mult):
    """Global-norm clip, per-tensor clip, two tiers and the base
    optimizer on identical gradients (some above the clip, some of
    rounding-noise size) over three steps: the updates agree with the
    JAX optax chain to 1e-6 relative (float32 reassociation only)."""
    s, _ = graft._flagship(optimizer=optimizer, lr_mult=lr_mult,
                           clip_norm=5.0, mesh_shape={"data": 1})
    ts, _ = flagship(optimizer=optimizer, lr_mult=lr_mult, clip_norm=5.0)
    for st in (s, ts):
        st.train.weight_decay = 0.1
        st.train.clip_grads = (-0.3, 0.3)
        st.train.lr_decay = None
    rng = np.random.RandomState(0)
    shapes = {"a/w": (4, 3), "a/b": (3,), "m/w": (5, 2)}
    params = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    lrs = np.asarray(jtrain.precompute_learning_rates(s, 8), np.float32)
    jparams = _nest(params)
    tx = jtrain.make_optimizer(s, lrs, jtrain.make_label_tree(jparams, ["m"]))
    jstate = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = ttrain.make_optimizer(ts, lrs,
                                 ttrain.make_label_tree(tparams, ["m"]))
    tstate = topt.init(tparams)
    for step in range(3):
        grads = {k: rng.randn(*v).astype(np.float32) * 10.0 ** (step - 1)
                 for k, v in shapes.items()}
        grads["a/b"] *= 1e-8
        updates, jstate = tx.update(_nest(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tu = topt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                         tstate, tparams)
        tparams = {k: tparams[k] + tu[k] for k in tparams}
        flat = jckpt.flatten_tree(updates)
        for k in shapes:
            ref = np.asarray(flat[k])
            np.testing.assert_allclose(tu[k].numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(ref).max()))


# ----------------------------------------------------- (f) run_step parity
SGD = dict(optimizer="sgd", lr_mult=2.0, clip_norm=5.0)
CONFIGS = {
    # SGD with two tiers and the global-norm clip, over a full batch, a
    # ragged one (1 clip of 2) and one with a caller's label_mask
    "sgd_ragged_label_mask": (SGD, {}),
    "adam": (dict(optimizer="adam", lr_mult=2.0, clip_norm=None,
                  base_lr=1e-5), {}),
    "rmsprop": (dict(optimizer="rmsprop", lr_mult=None, clip_norm=None,
                     base_lr=1e-5), {}),
    "adamw_weight_decay": (dict(optimizer="adamw", lr_mult=2.0,
                                clip_norm=5.0, base_lr=1e-5),
                           {"weight_decay": 10.0}),
    "clip_grads_ema": (dict(optimizer="sgd", lr_mult=2.0, clip_norm=None),
                       {"clip_grads": (-0.5, 0.5), "ema_decay": 0.9}),
    "accum_steps_2": (SGD, {"accum_steps": 2}),
}
ADAPTIVE = ("adam", "rmsprop", "adamw_weight_decay")


def _feeds(name, seed=3):
    rng = np.random.RandomState(seed)
    ragged = name == "sgd_ragged_label_mask"
    clips = (2, 1, 2) if ragged else (2, 2, 2)
    feeds = []
    for n in clips:
        feeds.append({
            "frames_main_input": (rng.randn(n * FPC, IMAGE, IMAGE, 3) * 60)
            .astype(np.float32),
            "labels": np.eye(CLASSES, dtype=np.int32)[
                rng.randint(0, CLASSES, n)]})
    if ragged:
        feeds[2]["label_mask"] = np.asarray([0.0, 1.0], np.float32)
    return feeds


def _engines(kw, train_opts, compute_dtype="float32"):
    s, jmodel = graft._flagship(compute_dtype=compute_dtype,
                                mesh_shape={"data": 1}, **kw)
    ts, tmodel = flagship(compute_dtype=compute_dtype, **kw)
    for st in (s, ts):
        st.train.dropout_keep_prob = 1.0
        for k, v in train_opts.items():
            setattr(st.train, k, v)
    jeng = jtrain.Train(s, s.feeder, jmodel, seed=0)
    jeng.place_params()
    start = {k: np.asarray(v)
             for k, v in jckpt.flatten_tree(jeng.params).items()}
    teng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu",
                        params=ckpt.unflatten_tree(
                            ckpt.from_jax_flat(start, "cpu")))
    return jeng, teng, start


def _assert_params_close(port, ref, start, adaptive):
    """Per tensor: every element within 2% of the largest distance the
    tensor moved (plus 1e-6 of its scale, about 10 float32 ulps) under
    SGD; under the adaptive optimizers within two such steps (a flipped
    step), and all but 1% of the elements within 10% of it."""
    for k in sorted(ref):
        moved = float(np.abs(ref[k] - start[k]).max())
        atol = 1e-6 * float(np.abs(ref[k]).max())
        diff = np.abs(port[k] - ref[k])
        assert moved > 0, k
        if adaptive:
            assert diff.max() <= 2.0 * moved + atol, (k, diff.max(), moved)
            assert np.mean(diff > 0.1 * moved + atol) <= 0.01, k
        else:
            assert diff.max() <= 0.02 * moved + atol, (k, diff.max(), moved)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_step_matches_jax(name):
    kw, opts = CONFIGS[name]
    jeng, teng, start = _engines(kw, opts)
    for step, feed in enumerate(_feeds(name)):
        ref = jeng.run_step(dict(feed))
        out = teng.run_step(dict(feed))
        assert sorted(out) == sorted(ref)
        assert out["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        assert out["accuracy"] == ref["accuracy"]
        assert out["loss"] == pytest.approx(ref["loss"], rel=1e-5), step
        # relu inputs within rounding of zero (module docstring)
        assert out["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                 rel=1e-2), step
    assert teng.global_step == jeng.global_step == 3
    port = ckpt.to_jax_flat(teng.params)
    _assert_params_close(port, {k: np.asarray(v) for k, v in
                                jckpt.flatten_tree(jeng.params).items()},
                         start, name in ADAPTIVE)
    if opts.get("ema_decay"):
        ema_ref = {k: np.asarray(v) for k, v in
                   jckpt.flatten_tree(jeng.opt_state["ema"]).items()}
        ema = ckpt.to_jax_flat(teng.ema)
        _assert_params_close(ema, ema_ref, start, False)
        assert not np.array_equal(ema["frames/dcnn/conv1/w"],
                                  port["frames/dcnn/conv1/w"])


def test_gradients_reach_conv1_and_the_lstm():
    """Through Conv1Function, LRNFunction and LSTMStepFunction the step
    moves conv1 and both LSTM layers (on the CPU the Functions run the
    plain forwards and the same backward formulas as on the card)."""
    ts, tmodel = flagship(compute_dtype="float32")
    ts.train.dropout_keep_prob = 1.0
    eng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu")
    before = {k: v.detach().clone() for k, v in
              ckpt.flatten_tree(eng.params).items()}
    eng.run_step(_feeds("x")[0])
    after = ckpt.flatten_tree(eng.params)
    for name in ("frames/dcnn/conv1/w", "frames/dcnn/conv1/b",
                 "clf/lstm/cells/0/w", "clf/lstm/cells/1/w"):
        assert not torch.equal(before[name], after[name]), name


def test_bf16_step_is_finite_and_close_to_jax():
    """One bf16 step (bf16 activations and conv/fc operands, float32
    params, float32 LSTM).  The two frameworks round activations at
    different points: the loss agrees to 1e-2 relative.  The gradient of
    this randomly initialised net is small against its per-position
    terms, so in bf16 rounding noise dominates it in both frameworks
    (each gradient norm lands 35-45% above the float32 one): the norms
    agree to 50%, and every parameter stays finite and within two SGD
    steps of the JAX one.  Every parameter moves, and its update points
    the way JAX's does: two estimates of one gradient that rounding noise
    dominates agree only in part, while a dropped or scrambled gradient
    sits near cosine 0, so the cosine between the two updates is held to
    >= 0.6 per tensor, and to >= 0.99 for the head (output FC, top LSTM
    layer), whose gradient stands well above the noise."""
    jeng, teng, start = _engines(SGD, {}, compute_dtype="bfloat16")
    feed = _feeds("bf16", seed=5)[0]
    ref = jeng.run_step(dict(feed))
    out = teng.run_step(dict(feed))
    assert all(np.isfinite(v) for v in out.values())
    assert out["loss"] == pytest.approx(ref["loss"], rel=1e-2)
    assert out["grad_norm"] == pytest.approx(ref["grad_norm"], rel=0.5)
    port = ckpt.to_jax_flat(teng.params)
    jref = {k: np.asarray(v) for k, v in
            jckpt.flatten_tree(jeng.params).items()}
    for k in jref:
        assert np.all(np.isfinite(port[k])), k
        moved = float(np.abs(jref[k] - start[k]).max())
        assert float(np.abs(port[k] - jref[k]).max()) <= \
            2.0 * moved + 1e-6 * float(np.abs(jref[k]).max()), k
        up = (port[k] - start[k]).astype(np.float64).ravel()
        ref_up = (jref[k] - start[k]).astype(np.float64).ravel()
        assert np.abs(up).max() > 0, k
        cos = up @ ref_up / (np.linalg.norm(up) * np.linalg.norm(ref_up))
        head = k.startswith(("clf/output_fc/", "clf/lstm/cells/1/"))
        assert cos >= (0.99 if head else 0.6), (k, cos)


def test_state_dict_round_trip_and_ema_eval_params():
    """A second engine loaded from the first's state_dict takes the same
    next step bit for bit; eval_params gives the EMA weights only when
    val.use_ema asks for them."""
    def engine():
        ts, tmodel = flagship(compute_dtype="float32", optimizer="adam",
                              base_lr=1e-4)
        ts.train.dropout_keep_prob = 1.0
        ts.train.ema_decay = 0.5
        return ts, ttrain.Train(ts, ts.feeder, tmodel, device="cpu", seed=7)

    feeds = _feeds("x", seed=11)
    ts, a = engine()
    a.run_step(feeds[0])
    _, b = engine()
    b.load_state_dict(a.state_dict())
    assert b.global_step == 1
    ma, mb = a.run_step(feeds[1]), b.run_step(feeds[1])
    assert ma == mb
    for k, v in ckpt.flatten_tree(a.params).items():
        assert torch.equal(v, ckpt.flatten_tree(b.params)[k]), k
    live = ckpt.flatten_tree(a.eval_params())
    assert all(torch.equal(live[k], v) for k, v in
               ckpt.flatten_tree(a.params).items())
    ts.val.use_ema = True
    ema = ckpt.flatten_tree(a.eval_params())
    assert all(torch.equal(ema[k], v) for k, v in a.ema.items())
    assert not torch.equal(ema["frames/dcnn/conv1/w"],
                           live["frames/dcnn/conv1/w"])


def test_dropout_streams_follow_the_seed_and_the_step():
    """With dropout on and lr 0 (the parameters never move), two steps on
    one feed draw different masks, since the step's seed folds in
    global_step, and a second engine with the same seed draws the same
    ones."""
    def run():
        ts, tmodel = flagship(compute_dtype="float32", base_lr=0.0)
        ts.train.dropout_keep_prob = 0.5
        eng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu", seed=1)
        feed = _feeds("x", seed=13)[0]
        return [eng.run_step(dict(feed))["loss"] for _ in range(2)]

    first = run()
    assert first[0] != first[1]
    assert run() == first
