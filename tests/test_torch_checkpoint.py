"""The port's checkpoints against the JAX package's on the CPU: training
checkpoints carried both ways (every parameter and EMA leaf equal after
the layout change), ``restore_checkpoint``'s name diff, ignorables,
shape checks and ``strict``, ``prepare_eval_state`` /
``select_eval_params`` in each of their cases, the EMA seeding of
``Train.load_state_dict(restored_names=...)``, the feeder's save side
(pruning, the fixed-name slot, the async writer's errors) and the
pretrained bvlc ``.npy`` loader with its ``.sha256`` check.  The
model is the tiny flagship (67x67 frames, fpc 2, a 1x32 LSTM, 5
classes), float32."""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import train as jtrain
from video_learning_tpu.data.feeder import Feeder as JFeeder
from video_learning_tpu.utils import FrameworkError as JFrameworkError
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import train as ttrain
from video_learning_tpu_torch.config import TrainOpts
from video_learning_tpu_torch.data.feeder import Feeder
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.flagship import flagship
from video_learning_tpu_torch.utils import FrameworkError

KW = dict(num_classes=5, fpc=2, lstm=(32, 1))


def _engines(ema_decay=0.9, optimizer="adam"):
    """A JAX and a port Train of the same flagship (fresh params each)."""
    s, jmodel = graft._flagship(compute_dtype="float32",
                                mesh_shape={"data": 1}, optimizer=optimizer,
                                **KW)
    ts, tmodel = flagship(compute_dtype="float32", optimizer=optimizer, **KW)
    for st in (s, ts):
        st.train.ema_decay = ema_decay
    jeng = jtrain.Train(s, s.feeder, jmodel, seed=0)
    teng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu", seed=1)
    return jeng, teng


def _port_engine():
    """A port Train of ``_engines``' configuration alone."""
    ts, tmodel = flagship(compute_dtype="float32", optimizer="adam", **KW)
    ts.train.ema_decay = 0.9
    return ttrain.Train(ts, ts.feeder, tmodel, device="cpu", seed=1)


def _perturbed(tree, seed):
    """``tree`` (JAX arrays) plus seeded noise, as numpy."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rs.randn(*np.shape(x)).astype(np.float32)
                   * 0.01).astype(np.float32), tree)


def _jax_flat(tree):
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def test_port_training_checkpoint_restores_into_jax(tmp_path):
    """Train.state_dict (params, EMA, optimizer leaves, step) saved by the
    port loads into the JAX Train: every params/, ema_params/ and
    opt_state_leaves/ name is restored, and every parameter and EMA leaf
    equals the port's after the layout change."""
    jeng, teng = _engines()
    with torch.no_grad():
        for i, (n, p) in enumerate(teng._flat.items()):
            p.add_(torch.full_like(p, 0.01 * (i + 1)))
            teng.ema[n].copy_(p * 0.5)
    teng.global_step = 7
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, teng.state_dict())
    loaded = []
    state = jckpt.restore_checkpoint(path, jeng.state_dict(),
                                     loaded_out=loaded)
    jeng.load_state_dict(state, restored_names=loaded)
    names = set(ckpt.flatten_tree(teng.state_dict()["params"]))
    leaves = len(teng.state_dict()["opt_state_leaves"])
    assert set(loaded) == ({"params/" + n for n in names} |
                           {"ema_params/" + n for n in names} |
                           {"opt_state_leaves/%d" % i for i in range(leaves)} |
                           {"global_step"})
    port = ckpt.to_jax_flat({"params": teng.params,
                             "ema_params": ckpt.unflatten_tree(teng.ema)})
    ref = _jax_flat({"params": jeng.params,
                     "ema_params": jeng.opt_state["ema"]})
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert np.array_equal(port[k], ref[k]), k
    assert jeng.global_step == 7
    assert ckpt.get_checkpoint_tensor_names(path) == \
        jckpt.get_checkpoint_tensor_names(path)


def test_jax_training_checkpoint_restores_into_the_port(tmp_path):
    """A JAX training checkpoint (params, EMA, opt_state_leaves, step)
    restores into the port's Train: every parameter and EMA leaf equal
    after the layout change, the step taken, the JAX slots reported."""
    jeng, teng = _engines()
    jeng.params = _perturbed(jeng.params, 1)
    jeng.opt_state = {"tx": jeng.opt_state["tx"],
                      "ema": _perturbed(jeng.opt_state["ema"], 2)}
    jeng.global_step = 11
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jeng.state_dict())
    loaded = []
    state = ckpt.restore_checkpoint(path, teng.state_dict(),
                                    loaded_out=loaded)
    teng.load_state_dict(state, restored_names=loaded)
    port = ckpt.to_jax_flat({"params": teng.params,
                             "ema_params": ckpt.unflatten_tree(teng.ema)})
    ref = _jax_flat({"params": jeng.params,
                     "ema_params": jeng.opt_state["ema"]})
    for k in ref:
        assert np.array_equal(port[k], ref[k]), k
    assert teng.global_step == 11
    # conv weights come back OIHW channels_last
    w = teng._flat["frames/dcnn/conv1/w"]
    assert w.shape == (96, 3, 11, 11)
    assert w.is_contiguous(memory_format=torch.channels_last)


def _randomized_slots(eng):
    """Random moments and per-tier step counts 5, 6, ... in ``eng``."""
    with torch.no_grad():
        for i, (tier, st) in enumerate(sorted(eng.opt_state.items())):
            st["count"].fill_(5 + i)
            for slot in ("mu", "nu"):
                for t in st[slot].values():
                    t.copy_(torch.rand_like(t))


def _assert_same_slots(a, b):
    for tier, st in a.opt_state.items():
        assert torch.equal(b.opt_state[tier]["count"], st["count"])
        for slot in ("mu", "nu"):
            for n, t in st[slot].items():
                assert torch.equal(b.opt_state[tier][slot][n], t), n


def test_port_checkpoint_round_trips_the_optimizer_slots(tmp_path):
    """The port's Adam slots (conv slots stored HWIO like the weights)
    and step counts, written as optax's leaves under
    opt_state_leaves/<i>, come back exactly into another port Train."""
    a, b = _port_engine(), _port_engine()
    _randomized_slots(a)
    path = str(tmp_path / "a.ckpt")
    ckpt.save_checkpoint(path, a.state_dict())
    loaded = []
    b.load_state_dict(ckpt.restore_checkpoint(path, b.state_dict(),
                                              strict=True,
                                              loaded_out=loaded),
                      restored_names=loaded)
    leaves = ["opt_state_leaves/%d" % i
              for i in range(len(a.state_dict()["opt_state_leaves"]))]
    assert set(leaves) <= set(loaded)
    assert not any(n.startswith("opt_state/") for n in loaded)
    flat = ckpt.load_flat(path)
    conv1_mu = a._opt_leaves.index(("regular", "mu", "frames/dcnn/conv1/w"))
    assert flat["opt_state_leaves/%d" % conv1_mu].shape == (11, 11, 3, 96)
    assert flat["opt_state_leaves/0"].dtype == np.int32
    _assert_same_slots(a, b)


def test_a_checkpoint_under_the_older_port_names_resumes(tmp_path):
    """A checkpoint written under the port's older optimizer names
    (opt_state/<tier>/count, opt_state/<tier>/{mu,nu}/<param>, the counts
    int64) restores strictly, its slots read as optax's leaves, and
    resumes with every slot and count."""
    a, b = _port_engine(), _port_engine()
    _randomized_slots(a)
    old = a.state_dict()
    del old["opt_state_leaves"]
    old["opt_state"] = {}
    for tier, st in a.opt_state.items():
        old["opt_state"][tier + "/count"] = st["count"].clone()
        for slot in ("mu", "nu"):
            for n, t in st[slot].items():
                old["opt_state"]["%s/%s/%s" % (tier, slot, n)] = t.clone()
    path = str(tmp_path / "old.ckpt")
    ckpt.save_checkpoint(path, old)
    assert "opt_state/regular/mu/frames/dcnn/conv1/w" in \
        ckpt.get_checkpoint_tensor_names(path)
    loaded = []
    b.load_state_dict(ckpt.restore_checkpoint(path, b.state_dict(),
                                              strict=True,
                                              loaded_out=loaded),
                      restored_names=loaded)
    assert len([n for n in loaded if n.startswith("opt_state_leaves/")]) \
        == len(b._opt_leaves)
    _assert_same_slots(a, b)


def test_ema_is_seeded_at_the_restored_params_as_in_jax(tmp_path):
    """A checkpoint without ema_params, restored into an EMA run: both
    packages start the EMA at the restored params (not at the template's
    fresh EMA); with ema_params in the file both take the file's."""
    jeng, teng = _engines()
    params = _perturbed(jeng.params, 3)
    path = str(tmp_path / "noema.ckpt")
    jckpt.save_checkpoint(path, {"params": params,
                                 "global_step": np.asarray(4)})
    loaded_j, loaded_t = [], []
    jeng.load_state_dict(jckpt.restore_checkpoint(
        path, jeng.state_dict(), loaded_out=loaded_j),
        restored_names=loaded_j)
    teng.load_state_dict(ckpt.restore_checkpoint(
        path, teng.state_dict(), loaded_out=loaded_t),
        restored_names=loaded_t)
    ref = _jax_flat(jeng.opt_state["ema"])
    port = ckpt.to_jax_flat(ckpt.unflatten_tree(teng.ema))
    want = _jax_flat(params)
    for k in want:
        assert np.array_equal(ref[k], want[k]), k
        assert np.array_equal(port[k], want[k]), k

    ema = _perturbed(params, 4)
    path = str(tmp_path / "ema.ckpt")
    jckpt.save_checkpoint(path, {"params": params, "ema_params": ema,
                                 "global_step": np.asarray(4)})
    loaded_t = []
    teng.load_state_dict(ckpt.restore_checkpoint(
        path, teng.state_dict(), loaded_out=loaded_t),
        restored_names=loaded_t)
    port = ckpt.to_jax_flat(ckpt.unflatten_tree(teng.ema))
    for k, v in _jax_flat(ema).items():
        assert np.array_equal(port[k], v), k


def _eval_case(tmp_path, case):
    """(JAX, port) ``select_eval_params`` results on one checkpoint."""
    s, jmodel = graft._flagship(compute_dtype="float32",
                                mesh_shape={"data": 1}, **KW)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = _perturbed(jparams, 5)
    ema = _perturbed(jparams, 6)
    saved = {"params": params, "global_step": np.asarray(3)}
    if case == "partial_ema":
        # shape drift: one EMA leaf no longer fits the model
        ema = jax.tree_util.tree_map(lambda x: x, ema)
        ema["clf"]["output_fc"]["b"] = np.zeros(7, np.float32)
    if case in ("ema", "partial_ema"):
        saved["ema_params"] = ema
    path = str(tmp_path / (case + ".ckpt"))
    jckpt.save_checkpoint(path, saved)
    use_ema = case != "no_use_ema"
    resumed = case != "not_resumed"
    out = []
    for mod, tree in ((jckpt, jparams),
                      (ckpt, ckpt.unflatten_tree(ckpt.from_jax_flat(
                          _jax_flat(jparams), "cpu")))):
        state, ignorables = mod.prepare_eval_state(tree, [], use_ema)
        loaded = []
        if resumed:
            state = mod.restore_checkpoint(path, state, ignorables,
                                           loaded_out=loaded)
        chosen, used = mod.select_eval_params(state, loaded, use_ema,
                                              resumed, "val: use_ema")
        flat = (ckpt.to_jax_flat(chosen) if mod is ckpt
                else _jax_flat(chosen))
        out.append((flat, used))
    return out, _jax_flat(params), _jax_flat(ema)


@pytest.mark.parametrize("case", ["no_use_ema", "not_resumed", "no_ema",
                                  "ema", "partial_ema"])
def test_select_eval_params_matches_jax(tmp_path, case):
    """The live params without use_ema, the fresh params without a
    restore, the live params from a checkpoint without EMA, the EMA tree
    from one with it, and a partial EMA tree completed from the restored
    live params: the same choice and the same leaves in both packages."""
    ((jflat, jused), (tflat, tused)), params, ema = _eval_case(tmp_path,
                                                               case)
    assert tused == jused == (case in ("ema", "partial_ema"))
    assert sorted(tflat) == sorted(jflat)
    for k in jflat:
        assert np.array_equal(tflat[k], jflat[k]), k
    if case == "no_ema":
        assert all(np.array_equal(jflat[k], params[k]) for k in params)
    if case == "partial_ema":
        b = "clf/output_fc/b"
        assert np.array_equal(tflat[b], params[b])
        assert np.array_equal(tflat["clf/output_fc/w"],
                              ema["clf/output_fc/w"])


def test_name_diff_ignorables_shapes_and_strict(tmp_path, caplog):
    """Names on one side only are warned about with their counts (raised
    with strict), ignorable substrings are skipped silently, a shape
    mismatch is warned about and the leaf kept (raised with strict): the
    same loaded names and messages as JAX."""
    path = str(tmp_path / "c.ckpt")
    jckpt.save_checkpoint(path, {"params": {
        "a": {"w": np.ones((2, 3), np.float32)},
        "b": np.ones(4, np.float32),
        "extra": np.ones(1, np.float32),
        "skip_me": np.ones(1, np.float32)}})

    def template(torch_side):
        make = (lambda *s: torch.zeros(s)) if torch_side else \
            (lambda *s: np.zeros(s, np.float32))
        return {"params": {"a": {"w": make(2, 3)}, "b": make(5),
                           "missing": make(1)}}

    caplog.set_level(logging.INFO, logger="vlt")
    results = []
    for mod, torch_side in ((jckpt, False), (ckpt, True)):
        caplog.clear()
        loaded = []
        state = mod.restore_checkpoint(path, template(torch_side),
                                       ["skip_me"], loaded_out=loaded)
        warnings = [r.getMessage() for r in caplog.records
                    if r.levelno == logging.WARNING]
        results.append((loaded, warnings))
        assert np.asarray(state["params"]["a"]["w"]).sum() == 6
        assert np.asarray(state["params"]["b"]).sum() == 0   # kept
    assert results[1] == results[0]
    loaded, warnings = results[1]
    assert loaded == ["params/a/w"]
    assert any("1 variables missing from checkpoint" in w for w in warnings)
    assert any("1 checkpoint variables missing in the model" in w
               for w in warnings)
    assert any("Shape mismatch for params/b" in w for w in warnings)
    with pytest.raises(FrameworkError, match="missing"):
        ckpt.restore_checkpoint(path, template(True), ["skip_me"],
                                strict=True)
    with pytest.raises(JFrameworkError, match="missing"):
        jckpt.restore_checkpoint(path, template(False), ["skip_me"],
                                 strict=True)
    # names and shapes all line up: strict passes except for the shape
    ok = {"params": {"a": {"w": torch.zeros(2, 3)}, "b": torch.zeros(5)}}
    with pytest.raises(FrameworkError, match="Shape mismatch"):
        ckpt.restore_checkpoint(path, ok, ["skip_me", "extra"], strict=True)


def _feeder(run_folder, num_saves=2, async_=False):
    train = TrainOpts()
    train.epoch_index = 1
    f = Feeder(defs.input_mode.video, [defs.phase.train], (train, None), 1,
               str(run_folder), False)
    f.num_saves = num_saves
    f.checkpoint_async = async_
    return f


def _state(v):
    return {"params": {"frames/dcnn/conv1/w": torch.full((4, 3, 2, 2), v),
                       "clf/b": torch.full((3,), v)},
            "global_step": int(v)}


def test_feeder_saves_prunes_and_keeps_best(tmp_path):
    """Each save writes the npz (conv weights HWIO) and then its JSON
    .snap; the rotation keeps the newest num_saves; best.ckpt stays
    outside it; a JAX feeder resumes the port's checkpoint."""
    f = _feeder(tmp_path)
    paths = [f.save(_state(i), "ep_1_btch_%d_gs_%d" % (i, i), i,
                    batch_index=i) for i in range(4)]
    best = f.save(_state(9), "best", 9, batch_index=0, fixed_name="best")
    left = sorted(os.listdir(tmp_path / "checkpoints"))
    assert left == sorted([os.path.basename(p) + s for p in paths[2:]
                           for s in ("", ".snap")] +
                          ["best.ckpt", "best.ckpt.snap"])
    with open(paths[3] + ".snap") as fh:
        assert json.load(fh) == [3, 1, 3]
    with open(best + ".snap") as fh:
        assert json.load(fh) == [0, 1, 9]
    flat = jckpt.load_flat(paths[3])
    assert flat["params/frames/dcnn/conv1/w"].shape == (2, 2, 3, 4)
    assert int(flat["global_step"]) == 3
    jf = JFeeder(defs.input_mode.video, [defs.phase.train],
                 (f.train, None), 1, str(tmp_path), True)
    assert jf._resolve_checkpoint("latest", require_snap=True) == paths[3]
    assert f._resolve_checkpoint("best") == best


def test_fixed_name_slot_drops_its_old_snap_first(tmp_path, monkeypatch):
    """Overwriting best.ckpt removes the old .snap before the new
    parameters are written: a write that fails leaves no .snap that
    would pair the old position with whatever the file holds."""
    f = _feeder(tmp_path)
    best = f.save(_state(1), "best", 1, batch_index=0, fixed_name="best")
    assert os.path.exists(best + ".snap")

    def broken(path, state):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_checkpoint", broken)
    with pytest.raises(OSError, match="disk full"):
        f.save(_state(2), "best", 2, batch_index=0, fixed_name="best")
    assert os.path.exists(best) and not os.path.exists(best + ".snap")


def test_async_save_error_surfaces_at_finish_saves(tmp_path, monkeypatch):
    """With checkpoint_async the write runs on a thread; its error is
    raised by finish_saves (and no .snap is written for it)."""
    f = _feeder(tmp_path, async_=True)
    good = f.save(_state(1), "ep_1_btch_1_gs_1", 1, batch_index=1)
    f.finish_saves()
    assert os.path.exists(good + ".snap")

    def broken(path, state):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_checkpoint", broken)
    bad = f.save(_state(2), "ep_1_btch_2_gs_2", 2, batch_index=2)
    with pytest.raises(OSError, match="disk full"):
        f.finish_saves()
    assert not os.path.exists(bad + ".snap")
    f.finish_saves()        # the error is raised once


def test_state_dict_is_a_snapshot():
    """``state_dict`` copies every tensor, so the steps after it (which
    update in place) leave an async write's state alone."""
    _, teng = _engines()
    state = teng.state_dict()
    before = {k: v.clone() for k, v in state["params"].items()}
    with torch.no_grad():
        for p in teng._flat.values():
            p.add_(1.0)
        for e in teng.ema.values():
            e.add_(1.0)
    for k, v in state["params"].items():
        assert torch.equal(v, before[k]), k


def test_watch_tensors_warns_about_a_pattern_that_matches_nothing(caplog):
    ts, tmodel = flagship(compute_dtype="float32", **KW)
    ts.watch_tensors = ["output_fc/w$", "no_such_param"]
    caplog.set_level(logging.WARNING, logger="vlt")
    eng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu")
    assert eng._watched == ["clf/output_fc/w"]
    assert "'no_such_param' matched no params" in caplog.text


def test_delete_checkpoint_and_orbax_directories(tmp_path):
    """delete_checkpoint removes a file or a directory and the .snap; the
    port refuses to read an orbax (directory) checkpoint."""
    d = tmp_path / "x.ckpt"
    d.mkdir()
    (tmp_path / "x.ckpt.snap").write_text("[0, 0, 0]")
    with pytest.raises(FrameworkError, match="orbax"):
        ckpt.load_flat(str(d))
    ckpt.delete_checkpoint(str(d))
    assert not os.listdir(tmp_path)


def test_bvlc_weights_load_as_in_jax(tmp_path):
    """``alexnet.init(weights_file=...)`` takes the convs and fc6 from a
    bvlc-schema ``.npy`` (fc7 drawn fresh where its pretrained shape does
    not fit, fc8 always fresh), equal to the JAX package's after the
    layout change; a ``.sha256`` sidecar must match the file."""
    import hashlib
    from video_learning_tpu.models import alexnet as jalexnet
    from video_learning_tpu_torch.models import alexnet
    rs = np.random.RandomState(0)
    fc6_in = jalexnet.conv_output_flat_dim((67, 67, 3))
    net = {name: [rs.randn(kh, kw, cin, cout).astype(np.float32),
                  rs.randn(cout).astype(np.float32)]
           for name, (kh, kw, cin, cout, _, _)
           in jalexnet._CONV_SPECS.items()}
    net["fc6"] = [rs.randn(fc6_in, 4096).astype(np.float32),
                  rs.randn(4096).astype(np.float32)]
    net["fc7"] = [rs.randn(5, 5).astype(np.float32),      # does not fit
                  rs.randn(5).astype(np.float32)]
    path = str(tmp_path / "w.npy")
    np.save(path, np.asarray(net, dtype=object), allow_pickle=True)
    ref = _jax_flat(jalexnet.init(jax.random.PRNGKey(0), 5,
                                  weights_file=path, fc6_in=fc6_in))
    out = ckpt.to_jax_flat(alexnet.init(torch.Generator().manual_seed(0), 5,
                                        weights_file=path, fc6_in=fc6_in))
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        if k.split("/")[0] in net and k.split("/")[0] != "fc7":
            assert np.array_equal(out[k], ref[k]), k
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with open(path + ".sha256", "w") as f:
        f.write(digest + "  w.npy\n")
    assert sorted(alexnet.load_bvlc_weights(path)) == sorted(net)
    with open(path + ".sha256", "w") as f:
        f.write("0" * 64 + "\n")
    with pytest.raises(FrameworkError, match="sha256"):
        alexnet.load_bvlc_weights(path)
    with pytest.raises(FrameworkError, match="does not exist"):
        alexnet.load_bvlc_weights(str(tmp_path / "none.npy"))
