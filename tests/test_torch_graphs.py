"""The port's compiled programs: ``Train.compile_scan_steps`` against the
JAX package's on the CPU, the properties a CUDA graph replay depends on
(state written in place, the clip as a select, the lr read from the
restored step), and, on the card, each graphed program against the eager
one it replaces.

The tiny flagship of ``__graft_entry__._flagship`` (67x67 frames, fpc 4,
16 classes, 2x256 LSTM), float32, dropout off where JAX is compared.
Tolerances of the JAX comparison are ``test_torch_train.py``'s for
``Train.run_step`` and for the same reason (its module docstring): lr
to 1e-7 relative, accuracy equal, loss to 1e-5 relative, the gradient
norm to 1e-2 relative (a relu input within rounding of zero may switch
on one side only), and every parameter within 2% of the largest
distance it moved plus 1e-6 of its scale.

The JAX side is imported inside the tests that use it, so that the card's
machine, which has no JAX, runs the ``cuda`` cases of this file:

    python -m pytest --noconftest tests/test_torch_graphs.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import graphs
from video_learning_tpu_torch import train as ttrain
from video_learning_tpu_torch.flagship import flagship

FPC, IMAGE, CLASSES = 4, 67, 16
SGD = dict(optimizer="sgd", lr_mult=2.0, clip_norm=5.0)


def _feeds(count, clips=2, seed=3):
    rng = np.random.RandomState(seed)
    return [{"frames_main_input": (rng.randn(clips * FPC, IMAGE, IMAGE, 3)
                                   * 60).astype(np.float32),
             "labels": np.eye(CLASSES, dtype=np.int32)[
                 rng.randint(0, CLASSES, clips)]}
            for _ in range(count)]


def _jax_engine(kw, lr_decay=None):
    """A JAX Train of the tiny flagship, dropout off; returns it and its
    parameters as a flat numpy dict."""
    import __graft_entry__ as graft
    from video_learning_tpu import checkpoint as jckpt
    from video_learning_tpu import train as jtrain
    s, jmodel = graft._flagship(compute_dtype="float32",
                                mesh_shape={"data": 1}, **kw)
    s.train.dropout_keep_prob = 1.0
    s.train.lr_decay = lr_decay
    jeng = jtrain.Train(s, s.feeder, jmodel, seed=0)
    jeng.place_params()
    return jeng, {k: np.asarray(v)
                  for k, v in jckpt.flatten_tree(jeng.params).items()}


def _port_engine(kw, start=None, lr_decay=None, device="cpu", seed=0,
                 graphs=None, **opts):
    ts, tmodel = flagship(compute_dtype="float32", **kw)
    ts.train.dropout_keep_prob = opts.pop("keep_prob", 1.0)
    ts.train.lr_decay = lr_decay
    for k, v in opts.items():
        setattr(ts.train, k, v)
    params = None if start is None else ckpt.unflatten_tree(
        ckpt.from_jax_flat(start, "cpu"))
    return ttrain.Train(ts, ts.feeder, tmodel, device=device, seed=seed,
                        params=params, graphs=graphs)


def _jax_flat(tree):
    from video_learning_tpu import checkpoint as jckpt
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


# ------------------------------------------- (a) compile_scan_steps vs JAX
def test_compile_scan_steps_matches_jax():
    """Three steps as one program on one feed, from shared parameters:
    the stacked metrics and the parameters after, against JAX's
    ``Train.compile_scan_steps(3)``."""
    import jax.numpy as jnp
    jeng, start = _jax_engine(SGD)
    teng = _port_engine(SGD, start)
    feed = _feeds(1)[0]
    many = jeng.compile_scan_steps(3)
    fd = jeng._shard_feed(jeng._pad_feed(dict(feed)))
    params, _, ref = many(jeng.params, jeng.opt_state, fd, jnp.asarray(0),
                          jeng.base_rng)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = teng.compile_scan_steps(3)(dict(feed))
    assert sorted(out) == sorted(ref)
    assert teng.global_step == 3
    for k in out:
        assert out[k].shape == (3,), k
    np.testing.assert_allclose(out["lr"], ref["lr"], rtol=1e-7)
    np.testing.assert_array_equal(out["accuracy"], ref["accuracy"])
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(out["grad_norm"], ref["grad_norm"],
                               rtol=1e-2)
    port, jref = ckpt.to_jax_flat(teng.params), _jax_flat(params)
    for k in sorted(jref):
        moved = float(np.abs(jref[k] - start[k]).max())
        assert moved > 0, k
        diff = float(np.abs(port[k] - jref[k]).max())
        assert diff <= 0.02 * moved + 1e-6 * float(np.abs(jref[k]).max()), \
            (k, diff, moved)


def test_compile_scan_steps_equals_as_many_run_steps_without_dropout():
    """With dropout off the N-step program is N ``run_step``s bit for bit
    on the CPU (the same ops in the same order)."""
    feed = _feeds(1)[0]
    a = _port_engine(dict(SGD, optimizer="adam", base_lr=1e-4),
                     ema_decay=0.5)
    b = _port_engine(dict(SGD, optimizer="adam", base_lr=1e-4),
                     ema_decay=0.5)
    stacked = a.compile_scan_steps(2)(dict(feed))
    rows = [b.run_step(dict(feed)) for _ in range(2)]
    for k in stacked:
        assert list(stacked[k]) == [np.float32(r[k]) for r in rows], k
    sa, sb = a.state_dict(), b.state_dict()
    for part in ("params", "opt_state", "ema_params"):
        for k, v in sa[part].items():
            assert torch.equal(v, sb[part][k]), (part, k)


# -------------------------------------------- (b) state written in place
def _state_tensors(eng):
    out = {"step": eng._step_t}
    out.update({"param/" + n: p for n, p in eng._flat.items()})
    out.update({"ema/" + n: e for n, e in eng.ema.items()})
    for tier, st in eng.opt_state.items():
        out[tier + "/count"] = st["count"]
        for slot in ("mu", "nu"):
            for n, t in st.get(slot, {}).items():
                out["%s/%s/%s" % (tier, slot, n)] = t
    return out


def test_state_keeps_its_storage_across_steps_and_a_restore():
    """Every parameter, moment, count, EMA tensor and the step counter
    keeps its storage across two ``run_step``s and a ``load_state_dict``
    (a replay reads and writes the memory it captured), while their
    values move."""
    kw = dict(SGD, optimizer="adam", base_lr=1e-3)
    eng = _port_engine(kw, ema_decay=0.9)
    other = _port_engine(kw, ema_decay=0.9, seed=5)
    tensors = _state_tensors(eng)
    ptrs = {k: t.data_ptr() for k, t in tensors.items()}
    before = {k: t.detach().clone() for k, t in tensors.items()}
    feeds = _feeds(2)
    for feed in feeds:
        eng.run_step(dict(feed))
    moved = [k for k, t in tensors.items() if not torch.equal(t, before[k])]
    assert {"step", "regular/count", "modified/count"} <= set(moved)
    assert any(k.startswith("regular/mu/") for k in moved)
    assert any(k.startswith("ema/") for k in moved)
    other.run_step(dict(feeds[0]))
    eng.load_state_dict(other.state_dict())
    after = _state_tensors(eng)
    assert {k: t.data_ptr() for k, t in after.items()} == ptrs
    assert all(after[k] is tensors[k] for k in tensors)
    assert eng.global_step == 1 and int(eng._step_t) == 1
    theirs = _state_tensors(other)
    for k, t in after.items():
        assert torch.equal(t, theirs[k]), k


# --------------------------------------------------- (c) clip as a select
@pytest.mark.parametrize("clip_norm", [1e-3, 1e3])
def test_global_norm_clip_is_a_select_matching_optax(clip_norm):
    """The global-norm clip below and above the gradients' norm: the
    updates equal optax's ``clip_by_global_norm`` chain (rtol 1e-6), and
    the step reads no value back to the host (the clip is
    ``torch.where``, not a branch on the norm)."""
    import optax
    import __graft_entry__ as graft
    from video_learning_tpu import train as jtrain
    s, _ = graft._flagship(optimizer="sgd", lr_mult=None,
                           clip_norm=clip_norm, mesh_shape={"data": 1})
    ts, _ = flagship(optimizer="sgd", lr_mult=None, clip_norm=clip_norm)
    for st in (s, ts):
        st.train.lr_decay = None
    rng = np.random.RandomState(1)
    grads = {"a": rng.randn(4, 3).astype(np.float32),
             "b": rng.randn(5).astype(np.float32)}
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in grads.values())))
    assert (norm < clip_norm) == (clip_norm > 1)
    lrs = np.asarray(jtrain.precompute_learning_rates(s, 8), np.float32)
    params = {k: np.zeros_like(v) for k, v in grads.items()}
    tx = jtrain.make_optimizer(s, lrs)
    ref, _ = tx.update(grads, tx.init(params), params)
    topt = ttrain.make_optimizer(ts, lrs)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    state = topt.init(tparams)

    def no_host_reads(*args, **kwargs):
        raise AssertionError("the clip read a tensor back to the host")

    saved = torch.Tensor.__bool__
    torch.Tensor.__bool__ = no_host_reads
    try:
        out = topt.update({k: torch.from_numpy(v) for k, v in
                           grads.items()}, state, tparams)
    finally:
        torch.Tensor.__bool__ = saved
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0)
    assert optax.global_norm(ref) == pytest.approx(
        min(norm, clip_norm) * float(lrs[0]), rel=1e-5)


# ------------------------------- (d) the restored step reads lr_array[k]
def test_restored_step_reads_the_lr_of_its_global_step():
    """A schedule that halves the lr every step: after ``load_state_dict``
    of a state at global_step 2 the next step's lr metric is
    ``lr_array[2]``, as JAX's ``run_step`` reports after the same
    restore, and its update is the one the original engine's third step
    makes (the optimizer counts were restored too)."""
    from video_learning_tpu.defs import defs as jdefs
    from video_learning_tpu_torch.defs import defs as tdefs
    kw = dict(SGD, clip_norm=None)
    jdecay = [jdefs.decay.staircase, jdefs.periodicity.interval, 1, 0.5]
    tdecay = [tdefs.decay.staircase, tdefs.periodicity.interval, 1, 0.5]
    jeng, start = _jax_engine(kw, jdecay)
    feeds = _feeds(3, seed=9)
    for feed in feeds[:2]:
        jeng.run_step(dict(feed))
    jeng2, _ = _jax_engine(kw, jdecay)
    jeng2.load_state_dict(jeng.state_dict())
    ref = jeng2.run_step(dict(feeds[2]))

    a = _port_engine(kw, start, tdecay)
    for feed in feeds[:2]:
        a.run_step(dict(feed))
    b = _port_engine(kw, start, tdecay)
    b.load_state_dict(a.state_dict())
    assert b.global_step == 2
    out_b = b.run_step(dict(feeds[2]))
    out_a = a.run_step(dict(feeds[2]))
    lr = a.lr_array
    assert len(set(lr[:3].tolist())) == 3
    assert out_b["lr"] == float(lr[2]) == out_a["lr"]
    assert out_b["lr"] == pytest.approx(ref["lr"], rel=1e-7)
    assert out_b == out_a
    for k, v in ckpt.flatten_tree(a.params).items():
        assert torch.equal(v, ckpt.flatten_tree(b.params)[k]), k


def test_graphs_need_a_cuda_device():
    """The CPU has no graphs: asking for them there raises, and the
    default there is the eager step."""
    from video_learning_tpu_torch.utils import FrameworkError
    ts, tmodel = flagship(compute_dtype="float32")
    with pytest.raises(FrameworkError):
        ttrain.Train(ts, ts.feeder, tmodel, device="cpu", graphs=True)
    assert not ttrain.Train(ts, ts.feeder, tmodel, device="cpu").graphs


def test_capture_error_names_the_failing_call():
    """A capture's error message names the innermost frame outside torch
    in the traceback of the first error of the chain (the one that broke
    the capture, not the one ending the broken capture raised)."""
    def inner():
        raise RuntimeError("first")

    try:
        try:
            inner()
        except RuntimeError:
            raise RuntimeError("second")
    except RuntimeError as exc:
        first = graphs._first_cause(exc)
    assert str(first) == "first"
    site = graphs._call_site(first)
    assert "in inner: raise RuntimeError(\"first\")" in site, site
    assert graphs.storage_key({"a": [torch.zeros(2), 3]}) != \
        graphs.storage_key({"a": [torch.zeros(2), 4]})


# ------------------------------------------------------- (e) on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode "
                    "(chip_smoke.py phase 11 runs the same checks on the "
                    "card)")
    # float32 without TF32, and cuDNN's deterministic algorithms: its
    # default backward algorithms add with atomics, so the eager step is
    # not reproducible by itself (chip_smoke.py phase 11)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = prev


def _card_engines(card, **opts):
    """A graphed engine, already captured (its warmup steps and one
    replay), restored to the start state of an eager engine."""
    kw = dict(SGD, optimizer="adam", base_lr=1e-4)
    eager = _port_engine(kw, device=card, keep_prob=0.5, graphs=False,
                         **opts)
    graphed = _port_engine(kw, device=card, keep_prob=0.5, **opts)
    assert graphed.graphs and not eager.graphs
    for feed in _feeds(ttrain.WARMUP_STEPS + 1, seed=21):
        graphed.run_step(dict(feed))
    assert len(graphed.graph_cache) == 1
    graphed.load_state_dict(eager.state_dict())
    return eager, graphed


def _assert_states_close(eager, graphed, start):
    se, sg = eager.state_dict(), graphed.state_dict()
    for part in ("params", "opt_state", "ema_params"):
        for k, v in se.get(part, {}).items():
            if not v.is_floating_point():
                assert torch.equal(v, sg[part][k]), (part, k)
                continue
            moved = float((v - start[part][k]).abs().max())
            tol = 1e-3 * moved + 1e-7 * float(v.abs().max())
            assert float((sg[part][k] - v).abs().max()) <= tol, (part, k)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{"ema_decay": 0.9},
                                  {"accum_steps": 2}],
                         ids=["ema", "accum_steps_2"])
def test_graphed_step_matches_the_eager_step(card, opts):
    """Dropout 0.5, three steps restored from one state after the
    capture: the replays draw the eager masks and agree per step and in
    every state tensor."""
    eager, graphed = _card_engines(card, **opts)
    start = eager.state_dict()
    for feed in _feeds(3, seed=22):
        me, mg = eager.run_step(dict(feed)), graphed.run_step(dict(feed))
        assert mg["accuracy"] == me["accuracy"]
        assert mg["loss"] == pytest.approx(me["loss"], rel=1e-5)
        assert mg["grad_norm"] == pytest.approx(me["grad_norm"], rel=1e-5)
    (program, _), = graphed.graph_cache.programs().values()
    assert program.replays == 4
    _assert_states_close(eager, graphed, start)


@pytest.mark.cuda
def test_graphed_scan_steps_match_the_eager_loop(card):
    """``compile_scan_steps(3)`` as one graph (its second call) against
    the eager loop with the same dropout stream."""
    eager, graphed = _card_engines(card)
    feed = _feeds(1, seed=23)[0]
    graphed.compile_scan_steps(3)(dict(feed))          # the eager warmup
    graphed.load_state_dict(eager.state_dict())
    start = eager.state_dict()
    me = eager.compile_scan_steps(3)(dict(feed))
    mg = graphed.compile_scan_steps(3)(dict(feed))
    assert len(graphed.graph_cache) == 2
    np.testing.assert_array_equal(mg["accuracy"], me["accuracy"])
    np.testing.assert_allclose(mg["loss"], me["loss"], rtol=1e-5)
    assert graphed.global_step == eager.global_step == 3
    _assert_states_close(eager, graphed, start)


@pytest.mark.cuda
@pytest.mark.parametrize("search", ["max", "beam"])
def test_graphed_decode_matches_the_eager_decode(card, search):
    from video_learning_tpu_torch.val import ForwardGraphs, serving_forward
    """Greedy and beam-4 tokens of 8 items: the first call (eager, the
    warmup) and a replay equal the eager decode."""
    settings, model = flagship(caption=True, fpc=1,
                               compute_dtype="float32")
    settings.captioning.caption_search = search
    settings.captioning.beam_width = 4
    params = model.init_params(seed=0, device=card)
    rng = np.random.RandomState(4)
    feed = {"frames_main_input": torch.from_numpy(
        (rng.randn(8, IMAGE, IMAGE, 3) * 60).astype(np.float32)).to(card)}
    fwd = ForwardGraphs()
    first = fwd(model, {}, params, dict(feed), decode=True)
    again = fwd(model, {}, params, dict(feed), decode=True)
    eager = serving_forward(model, {}, params, dict(feed), decode=True)
    assert len(fwd.cache) == 1
    assert torch.equal(first, eager) and torch.equal(again, eager)


@pytest.mark.cuda
def test_one_forward_cache_keeps_greedy_and_beam_apart(card):
    """The caption search options are read when a decode is captured, so
    they are part of the program's key: greedy, then beam through one
    ``ForwardGraphs``, each replay equal to its own eager decode."""
    from video_learning_tpu_torch.val import ForwardGraphs, serving_forward
    settings, model = flagship(caption=True, fpc=1,
                               compute_dtype="float32")
    params = model.init_params(seed=1, device=card)
    rng = np.random.RandomState(6)
    feed = {"frames_main_input": torch.from_numpy(
        (rng.randn(8, IMAGE, IMAGE, 3) * 60).astype(np.float32)).to(card)}
    fwd = ForwardGraphs()
    for search in ("max", "beam", "max"):
        settings.captioning.caption_search = search
        for _ in range(2):
            got = fwd(model, {}, params, dict(feed), decode=True)
        want = serving_forward(model, {}, params, dict(feed), decode=True)
        assert torch.equal(got, want), search
    assert len(fwd.cache) == 2


@pytest.mark.cuda
def test_graphed_buckets_match_the_eager_module(card):
    """``warmup()`` captures both buckets; 1 and 3 items (a short batch
    padded to bucket 4) replay to the eager module's logits within 1e-5 x
    max(1, max|logit|)."""
    from video_learning_tpu_torch.serving import ServingModule
    settings, model = flagship(compute_dtype="float32")
    params = model.init_params(seed=0, device=card)
    graphed = ServingModule(model, params, batch_items=[1, 4], device=card)
    eager = ServingModule(model, params, batch_items=[1, 4], device=card,
                          graphs=False)
    graphed.warmup()
    assert len(graphed.graphs.cache) == 2
    rng = np.random.RandomState(5)
    for items in (1, 3):
        x = (rng.randn(items * FPC, IMAGE, IMAGE, 3) * 60).astype(np.float32)
        got, want = graphed(x), eager(x)
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.cuda
def test_a_capture_that_reads_back_to_the_host_raises(card):
    x = torch.ones(16, device=card)

    def reads_back(t):
        return t * float(t.sum().item())

    program = graphs.Program("a read-back")
    with pytest.raises(graphs.GraphCaptureError, match="in reads_back"):
        program.capture(reads_back, x)
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 32.0        # the card still works


@pytest.mark.cuda
def test_a_capture_records_launches_and_a_replay_counts_none(card):
    """A kernel launched under a capture counts on the wrapper's
    ``captured``, not its ``launches``, and the program records it; a
    replay adds to neither (it runs no Python), and its output is the
    eager call's (the input is drawn on the CPU: a failed capture, as in
    the test above, can leave the card's default generator unusable)."""
    from video_learning_tpu_torch.ops import lrn as lrn_mod
    x = torch.randn(2, 5, 5, 16).to(card)
    want = lrn_mod.lrn(x)
    launches, captured = lrn_mod.lrn.launches, lrn_mod.lrn.captured
    program = graphs.Program("an lrn")
    out = program.capture(lrn_mod.lrn, x)
    assert (lrn_mod.lrn.launches, lrn_mod.lrn.captured) == \
        (launches, captured + 1)
    assert program.launch_counts() == {"lrn": 1}
    program.replay()
    program.replay()
    torch.cuda.synchronize()
    assert (lrn_mod.lrn.launches, lrn_mod.lrn.captured) == \
        (launches, captured + 1)
    assert torch.equal(out, want)
