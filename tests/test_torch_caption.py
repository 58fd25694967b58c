"""The port's captioning path against the JAX package on the CPU: greedy
and beam decoding, the caption model (training logits and decode), caption
training through ``Train.run_step``, caption framing, the caption serving
module and ``/predict``.  Parameters are the JAX package's (carried by
``checkpoint.from_jax_flat``) or drawn with numpy; inputs come from numpy
seeds; float32 throughout.

Tolerances.  Decoded tokens must be equal.  That is well posed only where
no step's choice lies within rounding of a tie, so each decode fixture
first asserts that its JAX top-2 logit margin exceeds 1e-4 at every step
(float32 logits of these sizes agree to ~1e-6 between XLA and torch).
Per-step logits agree within 1e-5 abs; train-mode caption logits within
1e-5 abs of scale-1 logits (AlexNet's float32 sums run in other orders).
"""

import http.client
import io
import json
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import train as jtrain
from video_learning_tpu.data import captions as jcaptions
from video_learning_tpu.defs import defs as jdefs
from video_learning_tpu.models import layers as jlayers
from video_learning_tpu.models import lstm as jlstm
from video_learning_tpu.models import pipeline as jpipeline
from video_learning_tpu.models.layers import fc_init as jfc_init
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import serving
from video_learning_tpu_torch import train as ttrain
from video_learning_tpu_torch.data import captions
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.flagship import (SERVING_MEAN, caption_feed,
                                               flagship)
from video_learning_tpu_torch.models import lstm
from video_learning_tpu_torch.models.pipeline import Model
from video_learning_tpu_torch.tools import serve as serve_mod
from video_learning_tpu_torch.utils import FrameworkError

MODES = ("state_bias", "input_bias", "input_concat")
V, E, H, B, T = 11, 6, 8, 3, 5
BOS, EOS = 0, 1


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def _port(tree):
    """JAX params -> the port's nested tree on the CPU."""
    return ckpt.unflatten_tree(ckpt.from_jax_flat(_flat(tree), "cpu"))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _decoder(mode, seed, vocab=V, visual_dim=None, eos_bias=0.0):
    """A 2-layer decoder: (JAX lstm params, out FC, embeddings (V, E),
    visual (B, Dv)) as numpy trees."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    rng = np.random.RandomState(seed)
    if visual_dim is None:
        visual_dim = {"state_bias": H, "input_bias": E - 2,
                      "input_concat": 7}[mode]
    lstm_in = E + visual_dim if mode == "input_concat" else E
    params = _flat(jlstm.init(keys[0], lstm_in, H, 2))
    params = {k: v * 8.0 for k, v in params.items()}  # decisive steps
    out_fc = _flat(jfc_init(keys[1], H, vocab))
    out_fc["w"] = out_fc["w"] * 20.0
    out_fc["b"] = out_fc["b"].copy()
    out_fc["b"][EOS] += eos_bias
    emb = rng.randn(vocab, E).astype(np.float32)
    visual = rng.randn(B, visual_dim).astype(np.float32)
    if mode == "state_bias":        # the initial state
        visual = np.tanh(visual)
    return params, out_fc, emb, visual


def _jax_tree(flat):
    return jax.tree_util.tree_map(jnp.asarray, ckpt.unflatten_tree(flat))


def _torch_tree(flat):
    return ckpt.unflatten_tree({k: _t(v) for k, v in flat.items()})


def _margins(logits):
    """Top-2 logit margin of every (item, step)."""
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ------------------------------------------------------------ greedy decode
@pytest.mark.parametrize("mode", MODES)
def test_greedy_decode_matches_jax(mode):
    params, out_fc, emb, visual = _decoder(mode, seed=1)
    jmode, tmode = getattr(jdefs.rnn_visual_mode, mode), \
        getattr(defs.rnn_visual_mode, mode)
    ref_ids, ref_logits = jlstm.greedy_decode(
        _jax_tree(params), _jax_tree(out_fc), jnp.asarray(visual),
        jnp.asarray(emb), BOS, T, H, jmode,
        return_type=jdefs.return_type.standard)
    assert _margins(ref_logits).min() > 1e-4
    args = (_torch_tree(params), _torch_tree(out_fc), _t(visual), _t(emb),
            BOS, T, H, tmode)
    ids, logits = lstm.greedy_decode(*args,
                                     return_type=defs.return_type.standard)
    assert ids.dtype == torch.int32 and ids.shape == (B, T)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert logits.shape == (B, T, V)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(lstm.greedy_decode(*args).numpy(),
                                  np.asarray(ref_ids))


def test_greedy_decode_rejects_an_unknown_return_type():
    params, out_fc, emb, visual = _decoder("input_concat", seed=1)
    with pytest.raises(FrameworkError, match="return type"):
        lstm.greedy_decode(_torch_tree(params), _torch_tree(out_fc),
                           _t(visual), _t(emb), BOS, T, H,
                           defs.rnn_visual_mode.input_concat,
                           return_type="logits")


# -------------------------------------------------------------- beam decode
def _beam_pair(mode, seed, k, length_norm, vocab=V, eos_bias=0.0):
    params, out_fc, emb, visual = _decoder(mode, seed, vocab,
                                           eos_bias=eos_bias)
    ref = jlstm.beam_decode(
        _jax_tree(params), _jax_tree(out_fc), jnp.asarray(visual),
        jnp.asarray(emb), BOS, EOS, T, H,
        getattr(jdefs.rnn_visual_mode, mode), beam_width=k,
        length_norm=length_norm)
    out = lstm.beam_decode(
        _torch_tree(params), _torch_tree(out_fc), _t(visual), _t(emb), BOS,
        EOS, T, H, getattr(defs.rnn_visual_mode, mode), beam_width=k,
        length_norm=length_norm)
    return out, np.asarray(ref)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,length_norm", [(1, 0.0), (3, 0.0), (3, 0.7)])
def test_beam_decode_matches_jax(mode, k, length_norm):
    out, ref = _beam_pair(mode, 2, k, length_norm)
    assert out.dtype == torch.int32 and out.shape == (B, T)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("eos_bias", [0.0, 40.0])
def test_beam_decode_ties_follow_jax(eos_bias):
    """Fewer words than beams (V 3 < K 4): the dead beams' scores of
    -1e9 + logp collide in float32, so the selection meets ties at every
    step; with a strong EOS bias every beam finishes and the frozen beams'
    continuations tie too.  The lower index wins, as in jax.lax.top_k."""
    out, ref = _beam_pair("state_bias", 3, 4, 0.0, vocab=3,
                          eos_bias=eos_bias)
    np.testing.assert_array_equal(out.numpy(), ref)
    if eos_bias:
        assert (ref == EOS).any(axis=1).all()


def test_top_k_orders_ties_as_jax():
    x = np.asarray([[1.0, 3.0, 3.0, -1e9 + 0.5, -1e9, 3.0, 0.0, -1e9],
                    [-1e9, -1e9, -1e9, -1e9, 2.0, 2.0, -1e9, 2.0]],
                   np.float32)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 5)
    v, i = lstm._top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


@pytest.mark.parametrize("mode", MODES)
def test_beam_width_one_equals_greedy(mode):
    """One beam picks the argmax at every step, as greedy does, up to its
    first EOS; after it the beam is frozen on EOS."""
    params, out_fc, emb, visual = _decoder(mode, 4, eos_bias=4.0)
    args = (_torch_tree(params), _torch_tree(out_fc), _t(visual), _t(emb),
            BOS)
    tmode = getattr(defs.rnn_visual_mode, mode)
    greedy = lstm.greedy_decode(*args, T, H, tmode).numpy()
    beam = lstm.beam_decode(*args, EOS, T, H, tmode, beam_width=1).numpy()
    for g, b in zip(greedy, beam):
        stop = list(g).index(EOS) + 1 if EOS in g else T
        np.testing.assert_array_equal(b[:stop], g[:stop])
        assert (b[stop:] == EOS).all()
    assert (greedy == EOS).any()


def test_decode_takes_parameters_that_require_gradients():
    """Decoding needs no gradient and runs under no_grad: live training
    parameters may be passed, and what comes out carries no graph."""
    params, out_fc, emb, visual = _decoder("input_concat", seed=1)
    tp, fc = _torch_tree(params), _torch_tree(out_fc)
    for leaf in list(ckpt.flatten_tree(tp).values()) + list(fc.values()):
        leaf.requires_grad_(True)
    mode = defs.rnn_visual_mode.input_concat
    ids, logits = lstm.greedy_decode(tp, fc, _t(visual), _t(emb), BOS, T, H,
                                     mode,
                                     return_type=defs.return_type.standard)
    beam = lstm.beam_decode(tp, fc, _t(visual), _t(emb), BOS, EOS, T, H,
                            mode)
    assert not (ids.requires_grad or logits.requires_grad or
                beam.requires_grad)


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_input_bias_visual_wider_than_the_embedding_is_an_error(decode):
    params, out_fc, emb, visual = _decoder("input_bias", 1,
                                              visual_dim=E + 1)
    args = (_torch_tree(params), _torch_tree(out_fc), _t(visual), _t(emb),
            BOS)
    mode = defs.rnn_visual_mode.input_bias
    with pytest.raises(FrameworkError, match="exceeds the embedding dim"):
        if decode == "greedy":
            lstm.greedy_decode(*args, T, H, mode)
        else:
            lstm.beam_decode(*args, EOS, T, H, mode)


# ------------------------------------------------------------ caption model
def _caption_pair(mode="state_bias", fpc=1, early=False):
    """(JAX model, JAX params, port model, port params) of the tiny caption
    flagship (67x67, emb 8, T 6, 16 classes, 2x256 LSTM), float32, dropout
    off, visual mode ``mode``; with ``early`` the frames pipeline averages
    its fpc frame vectors (the video-description form)."""
    pair = []
    for build, kw in ((graft._flagship, {"mesh_shape": {"data": 1}}),
                      (flagship, {})):
        s, _ = build(caption=True, fpc=fpc, compute_dtype="float32", **kw)
        s.train.dropout_keep_prob = 1.0
        d = jdefs if build is graft._flagship else defs
        s.pipelines["clf"].lstm_params = \
            s.pipelines["clf"].lstm_params[:3] + \
            [getattr(d.rnn_visual_mode, mode)]
        if early:
            s.pipelines["frames"].frame_fusion = [d.fusion_type.early,
                                                  d.fusion_method.avg]
        pair.append(s)
    js, ts = pair
    jmodel = jpipeline.Model(js)
    jp = _decisive(jmodel.init_params(jax.random.PRNGKey(0)))
    return js, jmodel, jp, ts, Model(ts), _port(jp)


def _decisive(params):
    """A randomly initialised captioner's next-word logits are nearly
    flat; larger output weights make each step's choice stand clear of
    rounding (the margins are asserted where used)."""
    clf = dict(params["clf"])
    clf["output_fc"] = dict(clf["output_fc"], w=clf["output_fc"]["w"] * 20.0)
    return dict(params, clf=clf)


def _jax_greedy_margin(model, params, frames):
    """The smallest top-2 logit margin over the steps of the JAX package's
    greedy decode of ``frames``, conditioned as its ``_apply_captioner``
    conditions it."""
    spec_frames, spec_clf = model.specs
    x = model._apply_pipeline(params["frames"], spec_frames, frames, {},
                              False, None, decode=False)
    clf = params["clf"]
    visual = jlayers.fc_apply(clf["state_fc"], x, model.compute_dtype) \
        if clf.get("state_fc") is not None else x
    dset = model.caption_dataset
    net = spec_clf["net"]
    _, logits = jlstm.greedy_decode(
        clf["lstm"], clf["output_fc"], visual,
        jnp.asarray(dset.embedding_matrix), dset.vocabulary.index("BOS"),
        dset.max_sequence_length, net.lstm_params[0],
        model._caption_mode(net), return_type=jdefs.return_type.standard)
    return float(_margins(logits).min())


def _greedy_margin(model, params, feed):
    """The port's counterpart: the same margin of a greedy decode from
    ``Model.decoder_inputs``, which ``Model.apply(decode=True)`` decodes
    from; also asserts that decode's tokens are these."""
    ids, logits = lstm.greedy_decode(
        **model.decoder_inputs(params, feed),
        return_type=defs.return_type.standard)
    np.testing.assert_array_equal(
        ids.numpy(), model.apply(params, feed, decode=True).numpy())
    return float(_margins(logits).min())


@pytest.mark.parametrize("mode,fpc,early", [
    ("state_bias", 1, False), ("input_bias", 1, False),
    ("input_concat", 1, False), ("state_bias", 4, True)])
def test_caption_model_matches_jax(mode, fpc, early):
    js, jmodel, jp, ts, tmodel, tp = _caption_pair(mode, fpc, early)
    assert sorted(_flat(jp)) == sorted(ckpt.to_jax_flat(
        tmodel.init_params(0, device="cpu")))
    feed = graft._caption_feed(js, jmodel, fpc=fpc)
    ref = np.asarray(jmodel.apply(jp, feed, train=True,
                                  dropout_rng=jax.random.PRNGKey(0)))
    out = tmodel.apply(tp, feed, train=True,
                       dropout_generator=torch.Generator().manual_seed(0))
    assert out.shape == (2 * 6, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    frames = {"frames_main_input": feed["frames_main_input"]}
    assert _jax_greedy_margin(jmodel, jp, frames) > 1e-4
    assert _greedy_margin(tmodel, tp, frames) > 1e-4
    ref_ids = np.asarray(jmodel.apply(jp, frames, decode=True))
    ids = tmodel.apply(tp, frames, decode=True)
    assert ids.dtype == torch.int32 and ids.shape == (2, 6)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    for s in (js, ts):
        s.captioning.caption_search = "beam"
        s.captioning.beam_width = 3
    np.testing.assert_array_equal(
        tmodel.apply(tp, frames, decode=True).numpy(),
        np.asarray(jmodel.apply(jp, frames, decode=True)))


def test_caption_params_move_by_name_between_the_packages():
    """clf/state_fc, clf/output_fc and the LSTM cells go through
    from_jax_flat and to_jax_flat by name, unchanged."""
    _, jmodel, jp, _, tmodel, tp = _caption_pair()
    flat = _flat(jp)
    for name in ("clf/state_fc/w", "clf/output_fc/w", "clf/lstm/cells/0/w",
                 "clf/lstm/cells/1/w"):
        assert name in flat
    back = ckpt.to_jax_flat(tp)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert ckpt.flatten_tree(tp)["clf/state_fc/w"].shape == (4096, 256)


def test_vocabulary_size_must_equal_num_classes():
    s, _ = flagship(caption=True, fpc=1)
    s.num_classes = 15
    with pytest.raises(FrameworkError, match="vocabulary size"):
        Model(s)


# ------------------------------------------------------------ caption data
def test_labels_to_words_and_feed_framing_match_jax():
    rs = np.random.RandomState(0)
    vocab = ["w%d" % i for i in range(7)] + ["UNK", "EOS", "BOS"]
    emb = rs.randn(10, 4).astype(np.float32)
    batch = [[1, 2, 3], [4], [0, 6, 5, 2]]
    for include in (True, False):
        ref = jcaptions.labels_to_words(batch, emb, vocab, 10, 6, include,
                                        True)
        out = captions.labels_to_words(batch, emb, vocab, 10, 6, include,
                                       True)
        assert sorted(out) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(ref[k]))
    with pytest.raises(FrameworkError, match="exceeds max sequence"):
        captions.labels_to_words([[1] * 6], emb, vocab, 10, 6, True, True)
    s, jmodel = graft._flagship(caption=True, fpc=1,
                                mesh_shape={"data": 1})
    ts, tmodel = flagship(caption=True, fpc=1)
    ref = graft._caption_feed(s, jmodel, rng_seed=4, fpc=1)
    out = caption_feed(ts, tmodel, rng_seed=4)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.mark.parametrize("row,cap", [([3, 4, 8, 2, 2], 10), ([3, 4, 5], 10),
                                     ([8, 1], 10), ([3, 4, 5, 6], 2), ([], 3)])
def test_trim_at_eos_matches_jax(row, cap):
    vocab = ["w%d" % i for i in range(7)] + ["UNK", "EOS", "BOS"]
    assert captions.trim_at_eos(row, vocab, cap) == \
        jcaptions.trim_at_eos(row, vocab, cap)


# ------------------------------------------------------- caption training
@pytest.mark.parametrize("accum", [1, 2])
def test_caption_run_step_matches_jax(accum):
    """Three float32 SGD steps with two tiers (lr_mult 2) and the global-
    norm clip on caption feeds with their label_mask: the loss within
    1e-5 relative, accuracy equal, and every parameter within 2% of the
    largest distance it moved (plus 1e-6 of its scale)."""
    kw = dict(caption=True, fpc=1, compute_dtype="float32", lr_mult=2.0,
              clip_norm=5.0, batch_size=4)
    js, jmodel = graft._flagship(mesh_shape={"data": 1}, **kw)
    ts, tmodel = flagship(**kw)
    for s in (js, ts):
        s.train.dropout_keep_prob = 1.0
        s.train.accum_steps = accum
    jeng = jtrain.Train(js, js.feeder, jmodel, seed=0)
    jeng.place_params()
    start = _flat(jeng.params)
    teng = ttrain.Train(ts, ts.feeder, tmodel, device="cpu",
                        params=ckpt.unflatten_tree(
                            ckpt.from_jax_flat(start, "cpu")))
    for step in range(3):
        feed = graft._caption_feed(js, jmodel, rng_seed=10 + step, fpc=1)
        ref = jeng.run_step(dict(feed))
        out = teng.run_step(dict(feed))
        assert out["loss"] == pytest.approx(ref["loss"], rel=1e-5), step
        assert out["accuracy"] == ref["accuracy"]
        assert out["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        assert out["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                 rel=1e-3), step
    port, jref = ckpt.to_jax_flat(teng.params), _flat(jeng.params)
    for k in sorted(jref):
        moved = float(np.abs(jref[k] - start[k]).max())
        assert moved > 0, k
        assert float(np.abs(port[k] - jref[k]).max()) <= \
            0.02 * moved + 1e-6 * float(np.abs(jref[k]).max()), k


# ------------------------------------------------------------ caption serving
RAW = (72, 80)


@pytest.fixture(scope="module")
def caption_module():
    settings, model = flagship(caption=True, fpc=1, raw_hw=RAW,
                               mean_scalars=SERVING_MEAN,
                               device_preprocess=True,
                               compute_dtype="float32")
    params = _decisive(model.init_params(seed=0, device="cpu"))
    return serving.ServingModule(model, params, batch_items=3,
                                 device="cpu"), model, params, settings


def _frames(settings, items, seed):
    frames = np.random.RandomState(seed).randint(0, 256, (items,) + RAW
                                                 + (3,), np.uint8)
    prm = settings.feeder.datasets[0].processor.draw_params(
        items, random.Random(seed))
    return frames, prm


def test_caption_module_decodes_as_the_model(caption_module, tmp_path):
    mod, model, params, settings = caption_module
    out = mod.meta["output"]
    assert out["kind"] == "token_ids" and out["caption_search"] == "max"
    assert out["vocabulary"] == model.caption_dataset.vocabulary
    assert out["max_caption_length"] == 5
    frames, prm = _frames(settings, 3, 1)
    ids = mod(frames, prm)
    assert ids.dtype == np.int32 and ids.shape == (3, 6)
    pre = mod._pre["frames_main_input"]
    feed = {"frames_main_input": pre(torch.from_numpy(frames),
                                     torch.from_numpy(prm))}
    assert _greedy_margin(model, params, feed) > 1e-4
    direct = model.apply(params, feed, decode=True)
    np.testing.assert_array_equal(ids, direct.numpy())
    # a short batch is padded and trimmed: its rows do not change
    np.testing.assert_array_equal(mod(frames[:2], prm[:2]), ids[:2])
    path = str(tmp_path / "cap.zip")
    mod.save(path)
    back = serving.load(path, device="cpu")
    assert back.meta == json.loads(json.dumps(mod.meta))
    np.testing.assert_array_equal(back(frames, prm), ids)
    np.testing.assert_array_equal(
        back.model.caption_dataset.embedding_matrix,
        model.caption_dataset.embedding_matrix)
    settings.captioning.caption_search = "beam"
    try:
        beam = serving.ServingModule(model, params, batch_items=3,
                                     device="cpu")
        assert beam.meta["output"]["caption_search"] == "beam"
        beam_ids = beam(frames, prm)
        beam.save(path)
    finally:
        settings.captioning.caption_search = "max"
    reloaded = serving.load(path, device="cpu")
    assert reloaded.model.settings.captioning.caption_search == "beam"
    np.testing.assert_array_equal(reloaded(frames, prm), beam_ids)


def test_captions_from_ids_follow_trim_at_eos(caption_module):
    mod, model, _, _ = caption_module
    vocab = model.caption_dataset.vocabulary
    eos = vocab.index("EOS")
    rows = np.asarray([[3, 4, eos, 5, 6, 7], [1, 2, 3, 4, 5, 6],
                       [eos, 1, 2, 3, 4, 5]], np.int32)
    want = [" ".join(vocab[i] for i in jcaptions.trim_at_eos(r, vocab, 5))
            or " " for r in rows]
    assert mod.captions_from_ids(rows) == want
    assert want == ["w003 w004", "w001 w002 w003 w004 w005", " "]


def test_predict_returns_captions(caption_module):
    mod, _, _, settings = caption_module
    started = threading.Event()
    thread = threading.Thread(target=serve_mod.serve, args=(mod,),
                              kwargs=dict(port=0, window_ms=5.0,
                                          started=started), daemon=True)
    thread.start()
    assert started.wait(timeout=120)
    try:
        frames, prm = _frames(settings, 2, 7)
        doc = {"inputs": {"frames_main_input": frames.tolist(),
                          "frames_main_input/proc_params": prm.tolist()},
               "topk": 2}
        conn = http.client.HTTPConnection(*started.addr, timeout=120)
        try:
            conn.request("POST", "/predict", body=json.dumps(doc).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            status, got = resp.status, json.loads(resp.read())
        finally:
            conn.close()
    finally:
        started.httpd.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert status == 200
    ids = mod(frames, prm)
    np.testing.assert_array_equal(np.asarray(got["outputs"]), ids)
    assert got["captions"] == mod.captions_from_ids(ids)
    assert "topk" not in got
