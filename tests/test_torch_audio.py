"""The port's audionet and audio preprocessing against the JAX package's:
audionet's logits on shared parameters and its parameter groups, the
SAME max pool it uses, the spectrogram arrays and PNG frames of seeded
wavs (and of an mp3 through a stub decoder), the missing-decoder and
missing-PIL errors, and the folder post-processing with its collision
checks."""

import os
import shutil
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_run_task import _normwise
from video_learning_tpu.audio import postproc_folders as jpp
from video_learning_tpu.audio import spectrograms as jsp
from video_learning_tpu.models import audionet as jaudio
from video_learning_tpu.models import layers as jlayers
from video_learning_tpu.utils import FrameworkError as JError
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch.audio import postproc_folders as tpp
from video_learning_tpu_torch.audio import spectrograms as tsp
from video_learning_tpu_torch.models import audionet as taudio
from video_learning_tpu_torch.models import layers
from video_learning_tpu_torch.utils import FrameworkError as TError


# -------------------------------------------------------------- audionet
def test_audionet_logits_and_groups_as_jax():
    """Parameters of the shapes JAX's init gives (drawn with numpy at
    its scales), carried by ``from_jax_flat``: logits of a (4, 64, 48, 3)
    input within 1e-5 normwise in float32; the port's own init has JAX's
    names, shapes (the FC sized from the conv stack without running it,
    as JAX's ``eval_shape`` sizes it, at odd sizes too) and groups."""
    input_shape, classes = (64, 48, 3), 7
    shapes = jax.eval_shape(lambda k: jaudio.init(k, input_shape, classes),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    jparams = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * (0.1 if a.ndim > 1 else 0.05))
        .astype(np.float32), shapes)
    flat = ckpt.flatten_tree(jparams)
    tparams = ckpt.unflatten_tree(ckpt.from_jax_flat(flat, device="cpu"))
    x = np.random.RandomState(1).randn(4, *input_shape).astype(np.float32)
    ref = np.asarray(jaudio.apply(jparams, jnp.asarray(x)))
    out = taudio.apply(tparams, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (4, classes)
    assert _normwise(out, ref) < 1e-5
    assert taudio.param_groups(tparams, "aux/") == \
        jaudio.param_groups(jparams, "aux/")

    own = ckpt.to_jax_flat(taudio.init(torch.Generator().manual_seed(0),
                                       input_shape, classes))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in flat.items()}
    assert np.all(own["fc1/b"] == np.float32(0.1))
    assert np.all(own["conv1/b"] == 0)
    assert np.abs(own["conv2/w"]).max() <= 0.2
    for shape in ((33, 50, 3), (5, 1, 3), (227, 227, 3)):
        ref = jax.eval_shape(jaudio._conv_stack, jparams,
                             jax.ShapeDtypeStruct((1,) + shape, jnp.float32))
        assert taudio.conv_output_shape(shape) == ref.shape[1:]


@pytest.mark.parametrize("shape", [(2, 13, 12, 5), (1, 8, 9, 3),
                                   (3, 2, 3, 2)])
def test_same_max_pool_matches_jax(shape):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    ref = np.asarray(jlayers.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                      "SAME"))
    out = layers.max_pool(torch.from_numpy(x), (3, 3), (2, 2),
                          "SAME").numpy()
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(TError, match="SAME or VALID"):
        layers.max_pool(torch.from_numpy(x), (3, 3), (2, 2), "FULL")


# ---------------------------------------------------------- spectrograms
def _wav(path, rate, seconds, width=2, channels=1, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    sig = np.sin(2 * np.pi * 440 * t) * 0.4 + rs.randn(len(t)) * 0.05
    sig = np.repeat(sig[:, None], channels, 1)
    if width == 1:
        data = (sig * 120 + 128).astype(np.uint8)
    else:
        dtype = {2: np.int16, 4: np.int32}[width]
        data = (sig * np.iinfo(dtype).max * 0.5).astype(dtype)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())
    return str(path)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2),
                                            (4, 1)])
def test_spectrogram_arrays_as_jax(tmp_path, width, channels):
    """A seeded wav's samples, STFT magnitude and colormap agree with
    JAX's within 1e-6, and the written PNG frames are equal."""
    path = _wav(tmp_path / "tone.wav", 8000, 2.5, width, channels)
    (jsig, jrate), (tsig, trate) = jsp.read_wav(path), tsp.read_wav(path)
    assert trate == jrate == 8000
    np.testing.assert_allclose(tsig, jsig, rtol=0, atol=1e-6)
    jspec = jsp.stft_magnitude(jsig, jrate, 0.040, 0.020)
    tspec = tsp.stft_magnitude(tsig, trate, 0.040, 0.020)
    assert tspec.shape == jspec.shape
    np.testing.assert_allclose(tspec, jspec, rtol=0, atol=1e-6)
    norm = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(tsp.jet_colormap(norm),
                                  jsp.jet_colormap(norm))
    from PIL import Image
    outs = []
    for mod, who in ((jsp, "jax"), (tsp, "port")):
        target, count = mod.generate_spectrogram_frames(
            path, str(tmp_path / who), window_sec=1.0)
        assert count == 2
        outs.append([np.asarray(Image.open(os.path.join(target, f)))
                     for f in sorted(os.listdir(target))])
    assert len(outs[1]) == len(outs[0]) == 2
    for a, b in zip(*outs):
        assert a.dtype == np.uint8 and a.ndim == 3
        np.testing.assert_array_equal(b, a)


def test_spectrogram_decoders_and_pil_as_jax(tmp_path, monkeypatch):
    """An mp3 decodes through the ``ffmpeg`` found on PATH (a stub that
    writes a known wav) to the samples JAX reads; without a decoder, and
    without PIL for the PNGs, both packages raise the same error."""
    golden = _wav(tmp_path / "golden.wav", 8000, 1.0, seed=4)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "ffmpeg"
    # ffmpeg -y -v error -i <in> -acodec pcm_s16le <out>: copy the golden
    stub.write_text("#!/bin/sh\ncp %s \"$8\"\n" % golden)
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", "%s:%s" % (bindir, os.environ["PATH"]))
    mp3 = tmp_path / "tone.mp3"
    mp3.write_bytes(b"\xff\xfbnot-really-mp3")
    (jdata, jrate), (tdata, trate) = (jsp.read_audio(str(mp3)),
                                      tsp.read_audio(str(mp3)))
    assert trate == jrate == 8000
    np.testing.assert_allclose(tdata, jdata, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdata, tsp.read_wav(golden)[0], atol=0)

    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(JError) as jerr:
        jsp.read_audio(str(mp3))
    with pytest.raises(TError, match="ffmpeg") as terr:
        tsp.read_audio(str(mp3))
    assert str(terr.value) == str(jerr.value)

    monkeypatch.setitem(sys.modules, "PIL", None)
    for mod in (jsp, tsp):
        with pytest.raises(ImportError):
            mod.generate_spectrogram_frames(golden, str(tmp_path / "o"))


# ------------------------------------------------------- folder clean-up
def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, dirs, files in os.walk(root) for f in dirs + files)


def _make(base, spec):
    for rel, content in spec.items():
        p = base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if content is None:
            p.mkdir(exist_ok=True)
        else:
            p.write_bytes(content)


@pytest.mark.parametrize("spec,ok", [
    ({"fold_a/clip1.avi/f0.png": b"x", "fold_b/clip2.avi": None,
      "fold_b/clip3.AVI/g.png": b"y", "top.avi": b"z"}, True),
    ({"sub1/x.png": b"1", "sub2/x.png": b"2", "sub2/y.png": b"3"}, False),
    ({"sub/sub": b"z"}, False),
    ({"a/f1.png": b"1", "b/a": b"2"}, True)])
def test_postproc_folders_as_jax(tmp_path, spec, ok):
    """The same trees after flatten + strip, and on a collision the same
    error with nothing moved."""
    trees, errs = [], []
    for who, mod, err in (("jax", jpp, JError), ("port", tpp, TError)):
        base = tmp_path / who
        base.mkdir()
        _make(base, spec)
        before = _tree(base)
        if ok:
            mod.main([str(base)])
        else:
            with pytest.raises(err) as e:
                mod.flatten_one_level(str(base))
            errs.append(str(e.value).replace(str(base), "BASE"))
            assert _tree(base) == before
        trees.append(_tree(base))
        shutil.rmtree(base)
    assert trees[1] == trees[0]
    if not ok:
        assert errs[1] == errs[0]
