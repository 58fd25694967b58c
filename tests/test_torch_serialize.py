"""The port's offline packer (``video_learning_tpu_torch/data/serialize.py``
and ``data/samplers.py``) against the JAX package's: for one fixture and
one seed, both ``serialize.main`` on one JSON config write byte-identical
record, ``.idx``, ``.size``, ``.shuffled`` / ``.unshuffled``, clip-doc
and copied list files, in every clipframe mode, error strategy, shuffle
setting, input kind and process count.  The port's PIL-free netpbm read
equals the JAX ``read_image``, and with PIL hidden a .ppm set packs to
the same bytes while a .jpg names the missing module."""

import json
import os
import random
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from tests.conftest import make_image
from video_learning_tpu.data import imgproc as jimg
from video_learning_tpu.data import samplers as jsamp
from video_learning_tpu.data import serialize as jser
from video_learning_tpu.utils import FrameworkError as JError
from video_learning_tpu_torch.data import imgproc as timg
from video_learning_tpu_torch.data import samplers as tsamp
from video_learning_tpu_torch.data import serialize as tser
from video_learning_tpu_torch.tools.export_serving import write_ppm
from video_learning_tpu_torch.utils import FrameworkError as TError

RAW = (24, 32)
FRAMES = (9, 12, 7)          # frames of each video folder


def _write_pgm(path, gray):
    h, w = gray.shape
    with open(path, "wb") as f:
        f.write(b"P5\n# a comment line\n%d %d\n255\n" % (w, h))
        f.write(gray.tobytes())


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """JPEG video folders (one of 3 frames: short for fpc 4), .ppm video
    folders at the raw shape, JPEG images at another size, a feature
    vector file with ids, and their list files."""
    root = tmp_path_factory.mktemp("serialize")
    lists = {}

    def videos(name, ext, counts, size):
        lines = []
        for v, n in enumerate(counts):
            vdir = root / ("%s%d" % (name, v))
            vdir.mkdir()
            for i in range(n):
                arr = make_image(*size, seed=100 * v + i)
                if ext == "ppm":
                    write_ppm(str(vdir / ("f_%04d.ppm" % i)), arr)
                else:
                    Image.fromarray(arr).save(vdir / ("f_%04d.jpg" % i),
                                              quality=90)
            lines.append("%s %d" % (vdir, v % 2))
        lists[name] = root / ("%s.list" % name)
        lists[name].write_text("\n".join(lines) + "\n")

    videos("vid", "jpg", FRAMES, RAW)
    videos("short", "jpg", FRAMES + (3,), RAW)
    videos("ppmvid", "ppm", FRAMES, RAW)
    imgs = []
    for i in range(5):
        p = root / ("im%d.jpg" % i)
        Image.fromarray(make_image(30, 40, seed=7 + i)).save(p, quality=90)
        imgs.append("%s %d %d" % (p, i % 3, (i + 1) % 3))
    lists["img"] = root / "img.list"
    lists["img"].write_text("\n".join(imgs) + "\n")
    rs = np.random.RandomState(3)
    lists["vec"] = root / "vec.list"
    lists["vec"].write_text("".join(
        "%s %d\n" % (",".join("%.6g" % x for x in rs.randn(6)), i % 4)
        for i in range(7)))
    (root / "vec.list.ids").write_text("".join("item%d\n" % i
                                               for i in range(7)))
    return root, lists


def _config(folder, inputs, **over):
    """One JSON ``serialize:`` config for both packages, in ``folder``;
    the output folder is relative, so each package's run, started in a
    working folder of its own, writes there."""
    cfg = {"output_folder": "out", "path_prepend_folder": None,
           "input_files": [str(p) for p in inputs], "run_id": "both",
           "num_threads": 2, "num_items_per_thread": 3,
           "num_processes": 1, "raw_image_shape": "(%d, %d, 3)" % RAW,
           "clip_offset_or_num": 2, "num_frames_per_clip": 4,
           "clipframe_mode": "defs.clipframe_mode.rand_clips",
           "generation_error": "defs.generation_error.compromise",
           "do_shuffle": False, "do_serialize": True, "do_validate": True,
           "validate_pcnt": 100, "frame_format": "jpg",
           "logging_level": "logging.INFO", "seed": 5}
    cfg.update(over)
    path = folder / "serialize.json"
    path.write_text(json.dumps({"serialize": cfg}))
    return str(path)


def _run_both(tmp_path, monkeypatch, cfg):
    """Each package's ``serialize.main`` on ``cfg``, run from a working
    folder of its own (so the relative output folder and the log are its
    own).  Returns {package: (working folder, error or None)}."""
    out = {}
    for name, mod, exc in (("jax", jser, JError), ("port", tser, TError)):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        try:
            mod.main(["serialize", cfg])
            out[name] = (cwd, None)
        except exc as e:
            out[name] = (cwd, str(e))
    return out


def _files(folder):
    """{relative path: bytes} of what a run wrote, its log left out."""
    got = {}
    for dirpath, _, names in os.walk(folder):
        for n in names:
            if n.startswith("log_"):
                continue
            p = os.path.join(dirpath, n)
            key = os.path.relpath(p, folder)
            if n.startswith("generation_errors_files_"):
                key = "generation_errors_files"
            with open(p, "rb") as f:
                got[key] = f.read()
    return got


CASES = {
    "rand_clips": ("vid", {}),
    "rand_frames_shuffled": ("vid", {
        "clipframe_mode": "defs.clipframe_mode.rand_frames",
        "do_shuffle": True}),
    "iterative": ("vid", {"clipframe_mode": "defs.clipframe_mode.iterative",
                          "clip_offset_or_num": 1}),
    "rand_clips_shuffled": ("vid", {"do_shuffle": True,
                                    "clip_offset_or_num": 3}),
    "compromise_short": ("short", {}),
    "report_short": ("short", {
        "generation_error": "defs.generation_error.report"}),
    "abort_short": ("short", {
        "generation_error": "defs.generation_error.abort"}),
    "images_resized_shuffled": ("img", {"do_shuffle": True}),
    "images": ("img", {}),
    "vectors_shuffled": ("vec", {"do_shuffle": True}),
    "ppm_frames": ("ppmvid", {"frame_format": "ppm"}),
    "two_processes": ("vid", {"num_processes": 2, "do_shuffle": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_packages_write_the_same_bytes(fixture, tmp_path, monkeypatch,
                                            case):
    root, lists = fixture
    name, over = CASES[case]
    cfg = _config(tmp_path, [lists[name]], **over)
    runs = _run_both(tmp_path, monkeypatch, cfg)
    (jdir, jerr), (tdir, terr) = runs["jax"], runs["port"]
    assert terr == jerr
    if case == "abort_short":
        assert "cannot sustain" in terr
        return
    assert jerr is None
    jfiles, tfiles = _files(jdir), _files(tdir)
    assert sorted(tfiles) == sorted(jfiles)
    for key in jfiles:
        assert tfiles[key] == jfiles[key], key
    written = {os.path.basename(k) for k in jfiles}
    base = os.path.basename(str(lists[name]))
    if case == "report_short":
        assert set(jfiles["generation_errors_files"].decode().split()) == \
            {"short3"}
        assert base + ".tfrecord" not in written
        return
    for suffix in (".tfrecord", ".tfrecord.idx", ".tfrecord.size"):
        assert base + suffix in written, suffix
    if over.get("do_shuffle"):
        assert base + ".shuffled" in written
        if name != "vec":
            assert base + ".unshuffled" in written
    if name in ("vid", "short", "ppmvid"):
        assert any(k.endswith(".cfm") for k in written)


def test_samplers_draw_as_jax():
    """Every sampler, mode and shortfall strategy draws the same clips
    from the same ``random.Random`` state, and leaves it in the same
    state."""
    for n in (0, 3, 4, 9, 20):
        for mode, arg in (("rand_frames", 0), ("rand_clips", 3),
                          ("iterative", 1)):
            for strategy in ("compromise", "report", "abort"):
                out = []
                for mod, exc in ((jsamp, JError), (tsamp, TError)):
                    rng = random.Random(n)
                    log = mod.GenerationLog()
                    try:
                        clips = mod.sample_clips(
                            n, "defs.clipframe_mode." + mode, 4, arg, rng,
                            path="v", log=log,
                            strategy="defs.generation_error." + strategy)
                    except exc as e:
                        clips = str(e)
                    out.append((clips, [(p.message, p.path)
                                        for p in log.problems],
                                rng.random()))
                assert out[0] == out[1], (n, mode, strategy)


@pytest.mark.parametrize("raw", [None, RAW, (20, 28)])
def test_netpbm_reads_equal_jax_read_image(tmp_path, raw):
    """P6 and P5 (with a header comment) read without PIL to the array
    the JAX package's PIL read gives, resized where the raw shape
    differs."""
    rgb = make_image(*RAW, seed=3)
    ppm, pgm = str(tmp_path / "a.ppm"), str(tmp_path / "b.pgm")
    write_ppm(ppm, rgb)
    _write_pgm(pgm, rgb[:, :, 1])
    for path in (ppm, pgm):
        want = jimg.read_image(path, raw)
        got = timg.read_image(path, raw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timg.read_image(ppm), rgb[:, :, ::-1])


def test_ppm_set_packs_without_pil(fixture, tmp_path, monkeypatch):
    """With PIL hidden, the .ppm set packs to the JAX package's bytes (JAX
    run first, with PIL), and a .jpg set fails naming the file and the
    missing module."""
    root, lists = fixture
    cfg = _config(tmp_path, [lists["ppmvid"]], frame_format="ppm")
    for name, mod in (("jax", jser), ("port", tser)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "port":
            monkeypatch.setitem(sys.modules, "PIL", None)
            monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
        mod.main(["serialize", cfg])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    with pytest.raises(TError, match=r"f_0000\.jpg needs PIL"):
        timg.read_image(str(root / "vid0" / "f_0000.jpg"))
    with pytest.raises(TError, match="needs PIL"):
        timg.read_image(str(root / "ppmvid0" / "f_0000.ppm"), (20, 28))
    shutil.rmtree(tmp_path / "port")
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    with pytest.raises(TError, match=r"\.jpg needs PIL"):
        tser.main(["serialize", _config(tmp_path, [lists["vid"]])])
