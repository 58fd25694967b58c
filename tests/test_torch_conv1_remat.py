"""conv1's other lowerings, remat and email_notify, held to the JAX
package on the CPU.

The space-to-depth conv1 forward (``alexnet.conv1_space_to_depth``)
against JAX's ``_conv1_space_to_depth`` and its autodiff at JAX's own
sizes (227 and 113) and against the port's direct forward; the im2col
weight gradient (``conv1_dw.conv1_dw_im2col``) against
``pallas_kernels.conv1_dw_xla`` with a chunk smaller than the batch;
the gradients of ``Model.apply`` and softmax cross entropy for the tiny
float32 flagship of ``__graft_entry__._flagship()`` (67x67, fpc 4,
shared parameters carried by ``checkpoint.from_jax_flat``) with remat,
s2d, im2col and a frozen conv1, each chosen in the port by the JAX
package's environment variable and in JAX by its module constant; two
``Train.run_step``s with remat, a frozen conv1, AdamW with weight decay
and ``accum_steps`` 2; the environment variables' parsing; and the
mail that ``email_notify`` sends, with ``smtplib.SMTP`` and
``getpass.getpass`` replaced by recorders.

Tolerances: the s2d forward within 1e-4 (``np.allclose`` with ``atol``,
as ``tests/test_models.py``'s s2d case holds JAX's s2d to its direct
conv), its gradients (of sum(out ** 2), hundreds in size) within 1e-4 of
their largest element; im2col within 1e-5 of the gradient's scale (float32
sums in another order); the whole model's gradients by ``np.allclose``
at ``atol`` 1e-5, the rule of ``tests/test_robustness.py``'s remat case;
remat on and off in the port bit for bit; the steps by
``test_torch_train.py``'s rule for adaptive optimizers.
"""

import getpass
import smtplib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from test_torch_config import _example_run, _load
from test_torch_opt_state import _jax_leaves, _port_leaves
from test_torch_train import _assert_params_close, _engines, _feeds
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu import utils as jutils
from video_learning_tpu.config import Settings as JSettings
from video_learning_tpu.models import alexnet as jalexnet
from video_learning_tpu.ops import pallas_kernels as pk
from video_learning_tpu.train import softmax_cross_entropy as jce
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import utils as tutils
from video_learning_tpu_torch.config import Settings
from video_learning_tpu_torch.flagship import flagship
from video_learning_tpu_torch.models import alexnet
from video_learning_tpu_torch.models.layers import (conv_apply, hwio_to_oihw,
                                                    oihw_to_hwio)
from video_learning_tpu_torch.ops import conv1_dw as c1
from video_learning_tpu_torch.train import softmax_cross_entropy
from video_learning_tpu_torch.utils import FrameworkError

CONV1_ENV = ("VLT_CONV1_S2D", "VLT_CONV1_DW_IMPL", "VLT_CONV1_FAST_DW",
             "VLT_CONV1_PALLAS_DW", "VLT_FREEZE_CONV1")


@pytest.fixture(autouse=True)
def _no_conv1_env(monkeypatch):
    for name in CONV1_ENV:
        monkeypatch.delenv(name, raising=False)


def _conv1_params(rng):
    return {"w": (rng.randn(11, 11, 3, 96) * 0.05).astype(np.float32),
            "b": (rng.randn(96) * 0.1).astype(np.float32)}


# ------------------------------------------------------- the s2d forward
@pytest.mark.parametrize("hw", [227, 113])
def test_s2d_forward_and_gradients_match_jax(hw):
    """The port's s2d forward against JAX's ``_conv1_space_to_depth``,
    and the gradients of sum(out ** 2) through ``Conv1Function`` (the
    weight gradient of its "shifted" choice) against JAX's autodiff of
    the s2d conv."""
    rng = np.random.RandomState(0)
    p = _conv1_params(rng)
    x = rng.randn(2, hw, hw, 3).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = np.asarray(jalexnet._conv1_space_to_depth(jp, jnp.asarray(x),
                                                    None))
    jg = jax.grad(lambda q: jnp.sum(jalexnet._conv1_space_to_depth(
        q, jnp.asarray(x), None) ** 2))(jp)

    w = hwio_to_oihw(torch.from_numpy(p["w"])).requires_grad_(True)
    b = torch.from_numpy(p["b"]).requires_grad_(True)
    out = alexnet.Conv1Function.apply(torch.from_numpy(x), w, b, "shifted",
                                      "s2d")
    assert tuple(out.shape) == ref.shape == (2, -(-hw // 4), -(-hw // 4),
                                             96)
    assert np.allclose(out.detach().numpy(), ref, atol=1e-4)
    gw, gb = torch.autograd.grad((out ** 2).sum(), (w, b))
    for got, want in ((oihw_to_hwio(gw), jg["w"]), (gb, jg["b"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("hw", [(227, 227), (113, 113), (67, 67), (70, 73)])
def test_s2d_forward_matches_the_direct_forward(hw):
    """Both lowerings compute one function: the s2d conv equals the
    direct 11x11 stride-4 SAME conv within float32 rounding, at odd and
    even sizes, non-square ones too."""
    rng = np.random.RandomState(1)
    p = _conv1_params(rng)
    w = hwio_to_oihw(torch.from_numpy(p["w"]))
    b = torch.from_numpy(p["b"])
    x = torch.from_numpy(rng.randn(2, *hw, 3).astype(np.float32))
    direct = conv_apply({"w": w, "b": b}, x, (4, 4), "SAME")
    s2d = alexnet.conv1_space_to_depth(x, w, b)
    assert s2d.shape == direct.shape
    torch.testing.assert_close(s2d, direct, rtol=0, atol=1e-4)


# ----------------------------------------------------------- im2col dW
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_im2col_weight_gradient_matches_conv1_dw_xla(dtype):
    """5 frames in chunks of 2: the last chunk is padded with a zero
    image, as in JAX; the result is the other formulations' too."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 67, 70, 3).astype(np.float32)
    g = rng.randn(5, 17, 18, 96).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = np.asarray(pk.conv1_dw_xla(jnp.asarray(x, jdt),
                                     jnp.asarray(g, jdt), chunk=2))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    out = c1.conv1_dw_im2col(tx, tg, chunk=2)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(c1.conv1_dw_shifted_reference(tx, tg).numpy(),
                               out.numpy(), rtol=0, atol=1e-5 * scale)


# ------------------------------------------------------ the whole model
CASES = {
    # the port's environment variable, and JAX's module constants
    "remat": ({}, {}),
    "s2d": ({"VLT_CONV1_S2D": "1"}, {"_CONV1_S2D": True}),
    "im2col": ({"VLT_CONV1_DW_IMPL": "im2col"},
               {"_CONV1_DW_IMPL": "im2col", "_CONV1_PALLAS_DW": True}),
    "freeze": ({"VLT_FREEZE_CONV1": "1"}, {}),
}


def _model_grads_jax(remat):
    settings, model = graft._flagship(compute_dtype="float32")
    settings.remat = remat
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    feed = {"frames_main_input": rng.randn(8, 67, 67, 3).astype(np.float32)}
    labels = np.eye(16, dtype=np.int32)[np.arange(2)]

    def loss(p):
        return jce(model.apply(p, feed), labels)

    grads = jax.jit(jax.grad(loss))(params)
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_tree(params).items()}
    return flat, feed, labels, {k: np.asarray(v) for k, v in
                                jckpt.flatten_tree(grads).items()}


def _model_grads_port(start, feed, labels, remat, calls):
    settings, model = flagship(compute_dtype="float32")
    settings.remat = remat
    leaves = {k: v.requires_grad_(True)
              for k, v in ckpt.from_jax_flat(start, "cpu").items()}
    logits = model.apply(ckpt.unflatten_tree(leaves), feed)
    loss = softmax_cross_entropy(logits, torch.from_numpy(labels), None)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    out = {k: torch.zeros_like(p) if g is None else g
           for (k, p), g in zip(leaves.items(), grads)}
    return ckpt.to_jax_flat(out), list(calls)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_gradients_match_jax(case, monkeypatch):
    """Each option, chosen by its environment variable in the port and by
    its module constant in JAX: the gradients agree.  Remat: the port's
    encoder runs under ``torch.utils.checkpoint`` and its gradients equal
    those without remat bit for bit.  Freeze: conv1 gets zero gradients
    and no weight gradient is computed."""
    port_env, jax_consts = CASES[case]
    for k, v in jax_consts.items():
        monkeypatch.setattr(jalexnet, k, v)
    if case == "freeze":
        monkeypatch.setenv("VLT_FREEZE_CONV1", "1")
    remat = case == "remat"
    start, feed, labels, ref = _model_grads_jax(remat)
    for k, v in port_env.items():
        monkeypatch.setenv(k, v)
    calls = []
    for name, fn in list(alexnet.CONV1_DW.items()):
        monkeypatch.setitem(alexnet.CONV1_DW, name,
                            lambda x, g, fn=fn, name=name:
                            calls.append(name) or fn(x, g))
    checkpointed = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: checkpointed.append(kw) or
                        real(*a, **kw))
    got, dw_calls = _model_grads_port(start, feed, labels, remat, calls)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.allclose(got[k], ref[k], atol=1e-5), \
            (k, np.abs(got[k] - ref[k]).max())
    want = {"im2col": ["im2col"], "freeze": []}.get(case, ["shifted"])
    assert dw_calls == want
    if case == "freeze":
        assert not np.abs(got["frames/dcnn/conv1/w"]).any()
        assert not np.abs(got["frames/dcnn/conv1/b"]).any()
    if remat:
        assert checkpointed == [{"use_reentrant": False,
                                 "preserve_rng_state": False}]
        plain, _ = _model_grads_port(start, feed, labels, False, [])
        for k in plain:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    else:
        assert not checkpointed


def test_remat_and_frozen_conv1_steps_match_jax(monkeypatch):
    """Two ``Train.run_step``s with remat, a frozen conv1, AdamW with
    weight decay and accum_steps 2 against JAX's ``Train``: the metrics
    and parameters by ``test_torch_train.py``'s rule.  conv1 still moves
    (AdamW's decoupled decay, on a zero gradient), equally in both, and
    the optimizer state has optax's leaves in optax's order."""
    monkeypatch.setenv("VLT_FREEZE_CONV1", "1")
    kw = dict(optimizer="adamw", lr_mult=2.0, clip_norm=5.0, base_lr=1e-5)
    jeng, teng, start = _engines(kw, {"weight_decay": 10.0,
                                      "accum_steps": 2})
    for eng in (jeng, teng):
        eng.settings.remat = True
        assert eng.model.settings.remat
    decay = 1.0
    for step, feed in enumerate(_feeds("remat_freeze")[:2]):
        ref = jeng.run_step(dict(feed))
        out = teng.run_step(dict(feed))
        decay *= 1.0 - ref["lr"] * 10.0
        assert out["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        assert out["accuracy"] == ref["accuracy"]
        assert out["loss"] == pytest.approx(ref["loss"], rel=1e-5), step
        assert out["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                 rel=1e-2), step
    port = ckpt.to_jax_flat(teng.params)
    jref = {k: np.asarray(v) for k, v in
            jckpt.flatten_tree(jeng.params).items()}
    # conv1's kernel only decays; its bias, which AdamW's mask exempts
    # from the decay, stays where it was
    w1, b1 = "frames/dcnn/conv1/w", "frames/dcnn/conv1/b"
    _assert_params_close({k: v for k, v in port.items() if k != b1},
                         {k: v for k, v in jref.items() if k != b1},
                         start, True)
    assert decay < 1.0
    for got in (jref, port):
        np.testing.assert_allclose(got[w1], start[w1] * decay, rtol=1e-6)
        np.testing.assert_array_equal(got[b1], start[b1])
    jl, tl = _jax_leaves(jeng), _port_leaves(teng)
    assert [(a.shape, a.dtype) for a in tl] == [(a.shape, a.dtype)
                                                 for a in jl]


# ------------------------------------------------ environment variables
@pytest.mark.parametrize("env,args,want", [
    ({}, {}, ("direct", "shifted", False)),
    ({"VLT_CONV1_S2D": "1"}, {}, ("s2d", "shifted", False)),
    ({"VLT_CONV1_S2D": "0"}, {}, ("direct", "shifted", False)),
    ({"VLT_CONV1_DW_IMPL": "im2col"}, {}, ("direct", "im2col", False)),
    ({"VLT_CONV1_DW_IMPL": "blocked"}, {}, ("direct", "blocked", False)),
    ({"VLT_CONV1_FAST_DW": "1"}, {}, ("direct", "im2col", False)),
    ({"VLT_CONV1_PALLAS_DW": "1"}, {}, ("direct", "im2col", False)),
    # FAST_DW, where set, decides; PALLAS_DW is read only without it
    ({"VLT_CONV1_FAST_DW": "0", "VLT_CONV1_PALLAS_DW": "1"}, {},
     ("direct", "shifted", False)),
    ({"VLT_CONV1_DW_IMPL": "shifted", "VLT_CONV1_FAST_DW": "1"}, {},
     ("direct", "shifted", False)),
    ({"VLT_FREEZE_CONV1": "1"}, {}, ("direct", "shifted", True)),
    # an argument is taken as it is
    ({"VLT_CONV1_S2D": "1", "VLT_FREEZE_CONV1": "1",
      "VLT_CONV1_DW_IMPL": "im2col"},
     {"conv1_fwd": "direct", "conv1_dw": "blocked", "freeze_conv1": False},
     ("direct", "blocked", False)),
])
def test_conv1_options_read_the_jax_environment(env, args, want,
                                                monkeypatch):
    """The JAX package's variables, read at the call
    (``alexnet.py:174-206, 269``), with its legacy aliases."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert alexnet.conv1_options(**args) == want


@pytest.mark.parametrize("env,args", [
    ({"VLT_CONV1_DW_IMPL": "im2colx"}, {}),
    ({}, {"conv1_dw": "xla"}),
    ({}, {"conv1_fwd": "space_to_depth"}),
])
def test_a_conv1_typo_raises(env, args, monkeypatch):
    """A typo must not run the default in its place (``alexnet.py:201``),
    at the call of ``Model.apply`` too."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(FrameworkError):
        alexnet.conv1_options(**args)
    settings, model = flagship(compute_dtype="float32")
    params = model.init_params(0, device="cpu")
    feed = {"frames_main_input": np.zeros((4, 67, 67, 3), np.float32)}
    with pytest.raises(FrameworkError):
        model.apply(params, feed, **args)


# ---------------------------------------------------------- email_notify
class _SMTP:
    """smtplib.SMTP's recorder; ``fail`` raises at login."""

    fail = False

    def __init__(self, calls, *args, **kwargs):
        self.calls = calls
        calls.append(("SMTP", args, kwargs))

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name == "login" and _SMTP.fail:
                raise smtplib.SMTPAuthenticationError(535, b"refused")
        return call


def _mail_of(cls, utils, error_cls, run, path, monkeypatch, caplog):
    calls = []
    monkeypatch.setattr(smtplib, "SMTP",
                        lambda *a, **kw: _SMTP(calls, *a, **kw))
    monkeypatch.setattr(getpass, "getpass",
                        lambda prompt="": calls.append(("getpass", prompt))
                        or "secret")
    settings = _load(cls, run, path)
    assert settings.email_notify == ("me@example.org", "secret",
                                     "you@example.org")
    utils.info("quiet")
    utils.info("done", email=True)
    utils.warning("careful", email=True)
    with pytest.raises(error_cls):
        utils.error("broken")
    _SMTP.fail = True
    caplog.clear()
    try:
        utils.info("refused", email=True)
    finally:
        _SMTP.fail = False
    assert "Email notification failed (ignored)." in caplog.text
    return calls


def test_email_notify_sends_what_jax_sends(tmp_path, monkeypatch, caplog):
    """Both packages ask for the password once, at the config's load, and
    send the same mails in the same calls: from ``error``, and from
    ``info`` and ``warning`` with ``email=True``; a failing server is
    logged and ignored."""
    monkeypatch.setattr(jutils.CustomLogger, "email_notify", None)
    monkeypatch.setattr(tutils, "_email_notify", None)
    caplog.set_level("INFO", logger="vlt")
    run = _example_run(tmp_path)
    run["logging"]["email_notify"] = ["me@example.org", "you@example.org"]
    path = str(tmp_path / "mail.json")
    ref = _mail_of(JSettings, jutils, jutils.FrameworkError, run, path,
                   monkeypatch, caplog)
    out = _mail_of(Settings, tutils, FrameworkError, run, path,
                   monkeypatch, caplog)
    assert out == ref
    assert [c[0] for c in out].count("getpass") == 1
    assert [c[0] for c in out].count("sendmail") == 3
    assert "email_notify is not ported" not in caplog.text
