"""The port's serving module and HTTP micro-batcher on the CPU: the
serving forward against the JAX package's (device preprocessing + model
at train=False), the artifact round trip, request coalescing with
correct row splitting, and the HTTP endpoints over loopback."""

import http.client
import io
import json
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as graft
from video_learning_tpu import checkpoint as jckpt
from video_learning_tpu.ops.preprocess import make_preprocessor
from video_learning_tpu_torch import checkpoint as ckpt
from video_learning_tpu_torch import serving
from video_learning_tpu_torch.flagship import (SERVING_MEAN, TRAIN_IMGPROC,
                                               flagship)
from video_learning_tpu_torch.tools import serve as serve_mod
from video_learning_tpu_torch.utils import FrameworkError

FPC, RAW, CLASSES, ITEMS = 2, (72, 80), 5, 2


def _build(compute_dtype="float32"):
    settings, model = flagship(num_classes=CLASSES, fpc=FPC, image=67,
                               raw_hw=RAW, mean_scalars=SERVING_MEAN,
                               imgproc=TRAIN_IMGPROC,
                               compute_dtype=compute_dtype)
    return settings, model


def _inputs(processor, items, seed):
    frames = np.random.RandomState(seed).randint(
        0, 256, (items * FPC,) + RAW + (3,), np.uint8)
    return frames, processor.draw_params(items * FPC, random.Random(seed))


@pytest.fixture(scope="module")
def module():
    settings, model = _build()
    params = model.init_params(seed=0, device="cpu")
    return serving.ServingModule(model, params, batch_items=ITEMS,
                                 device="cpu"), settings


def test_meta_uses_the_jax_keys(module):
    mod, _ = module
    assert [i["name"] for i in mod.meta["inputs"]] == \
        ["frames_main_input", "frames_main_input/proc_params"]
    assert mod.meta["inputs"][0] == {"name": "frames_main_input",
                                     "shape": [ITEMS * FPC, 72, 80, 3],
                                     "dtype": "uint8"}
    assert mod.meta["inputs"][1]["shape"] == [ITEMS * FPC, 3]
    assert mod.meta["batch_items"] == ITEMS
    assert mod.meta["num_classes"] == CLASSES
    assert mod.meta["output"]["kind"] == "logits"


def test_serving_forward_matches_jax():
    """The whole slice: uint8 frames + host-drawn params -> device
    preprocessing -> AlexNet fc7 -> LSTM -> logits, on shared parameters,
    against the JAX val forward (float32, rtol 1e-4 of the logit scale)."""
    _, jmodel = graft._flagship(num_classes=CLASSES, fpc=FPC,
                                raw_hw=RAW, mean_scalars=SERVING_MEAN,
                                device_preprocess=True,
                                compute_dtype="float32")
    jp = jmodel.init_params(jax.random.PRNGKey(3))
    dset = jmodel.settings.feeder.get_dataset_by_tag("main")[0]
    pre = make_preprocessor(dset.processor, out_dtype=jnp.float32)
    settings, tmodel = _build()
    frames, prm = _inputs(settings.feeder.datasets[0].processor, ITEMS, 1)
    jprm = dset.processor.draw_params(ITEMS * FPC, random.Random(1))
    np.testing.assert_array_equal(prm, jprm)
    ref = np.asarray(jmodel.apply(jp, {"frames_main_input": pre(
        jnp.asarray(frames), jnp.asarray(jprm))}))
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_tree(jp).items()}
    mod = serving.ServingModule(
        tmodel, ckpt.unflatten_tree(ckpt.from_jax_flat(flat, "cpu")),
        batch_items=ITEMS, device="cpu")
    out = mod(frames, prm)
    assert out.shape == (ITEMS, CLASSES)
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_short_batch_is_padded_and_trimmed(module):
    mod, settings = module
    frames, prm = _inputs(settings.feeder.datasets[0].processor, ITEMS, 2)
    full = mod(frames, prm)
    one = mod(frames[:FPC], prm[:FPC])
    assert one.shape == (1, CLASSES)
    np.testing.assert_array_equal(one[0], full[0])
    assert mod.last_bucket == ITEMS


def test_save_load_round_trip(module, tmp_path):
    mod, settings = module
    path = str(tmp_path / "m.zip")
    mod.save(path)
    again = serving.load(path, device="cpu")
    assert again.meta == mod.meta
    frames, prm = _inputs(settings.feeder.datasets[0].processor, ITEMS, 3)
    np.testing.assert_array_equal(again(frames, prm), mod(frames, prm))
    # the artifact's params.npz is a checkpoint with the JAX names
    flat = ckpt.to_jax_flat(mod.params)
    import zipfile
    with zipfile.ZipFile(path) as z:
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            assert sorted(npz.files) == sorted(flat)


def test_batcher_coalesces_and_splits_rows(module):
    mod, settings = module
    proc = settings.feeder.datasets[0].processor
    batcher = serve_mod.Batcher(mod, window_s=0.5)
    try:
        reqs = [_inputs(proc, 1, 10 + i) for i in range(2)]
        results = [None, None]
        barrier = threading.Barrier(2)

        def go(i):
            barrier.wait(timeout=30)
            results[i] = batcher.run(list(reqs[i]))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert batcher.stats.coalesced == 1
        assert sum(batcher.stats.device_calls.values()) == 1
        for (frames, prm), got in zip(reqs, results):
            np.testing.assert_array_equal(got, mod(frames, prm))
        with pytest.raises(ValueError):
            batcher.run([reqs[0][0][:1], reqs[0][1][:1]])   # partial clip
    finally:
        batcher.close()
    assert batcher._thread is None


@pytest.fixture(scope="module")
def server(module):
    mod, settings = module
    started = threading.Event()
    thread = threading.Thread(target=serve_mod.serve, args=(mod,),
                              kwargs=dict(port=0, window_ms=5.0,
                                          started=started), daemon=True)
    thread.start()
    assert started.wait(timeout=120)
    yield started.addr, settings.feeder.datasets[0].processor
    started.httpd.shutdown()
    thread.join(timeout=60)
    assert not thread.is_alive()


def _request(addr, method, path, body=None, ctype=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_endpoints(module, server):
    mod, _ = module
    addr, proc = server
    assert _request(addr, "GET", "/healthz") == (200, b"ok")
    status, body = _request(addr, "GET", "/meta")
    meta = json.loads(body)
    assert status == 200 and meta["inputs"] == mod.meta["inputs"]
    assert meta["server"]["capacity_items"] == ITEMS

    frames, prm = _inputs(proc, 1, 20)
    want = mod(frames, prm)
    doc = {"inputs": {"frames_main_input": frames.tolist(),
                      "frames_main_input/proc_params": prm.tolist()},
           "topk": 2}
    status, body = _request(addr, "POST", "/predict",
                            json.dumps(doc).encode(), "application/json")
    assert status == 200
    got = json.loads(body)
    np.testing.assert_allclose(np.asarray(got["outputs"]), want, rtol=1e-6)
    assert len(got["topk"][0]) == 2

    frames, prm = _inputs(proc, 2, 21)
    buf = io.BytesIO()
    np.savez(buf, frames_main_input=frames,
             **{"frames_main_input/proc_params": prm})
    status, body = _request(addr, "POST", "/predict?format=npz",
                            buf.getvalue(), "application/x-npz")
    assert status == 200
    with np.load(io.BytesIO(body)) as z:
        np.testing.assert_array_equal(z["outputs"], mod(frames, prm))

    bad = io.BytesIO()
    np.savez(bad, frames_main_input=frames[:, :10],
             **{"frames_main_input/proc_params": prm})
    status, body = _request(addr, "POST", "/predict", bad.getvalue(),
                            "application/x-npz")
    assert status == 400 and b"trailing shape" in body

    status, body = _request(addr, "GET", "/metrics")
    assert status == 200 and b'vlx_requests_total{status="400"} 1' in body


# ------------------------------------------------- int8 modules and buckets
@pytest.fixture(scope="module")
def int8_modules():
    """An int8 and an int8_static module of the tiny float32 flagship at
    buckets [1, 2], the static one calibrated on two items."""
    settings, model = _build()
    params = model.init_params(seed=0, device="cpu")
    calib = _inputs(settings.feeder.datasets[0].processor, ITEMS, 30)
    return {mode: serving.ServingModule(
        model, params, batch_items=[1, ITEMS], device="cpu", quantize=mode,
        calib_feed=calib if mode == "int8_static" else None)
        for mode in ("int8", "int8_static")}, settings, params


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_int8_round_trip_gives_the_same_bits(int8_modules, tmp_path, mode):
    mods, settings, params = int8_modules
    mod = mods[mode]
    assert mod.meta["quantize"] == mode
    assert mod.meta["buckets"] == [1, ITEMS]
    assert mod.meta["batch_items"] == ITEMS
    if mode == "int8_static":
        ranges = mod.meta["act_ranges"]
        assert sorted(ranges) == ["frames"]
        assert sorted(ranges["frames"]) == ["conv2", "conv3", "conv4",
                                            "conv5", "fc6", "fc7"]
        assert all(isinstance(v, float) and v > 0
                   for v in ranges["frames"].values())
    else:
        assert "act_ranges" not in mod.meta
    path = str(tmp_path / ("%s.zip" % mode))
    mod.save(path)
    again = serving.load(path, device="cpu")
    assert again.meta == mod.meta
    frames, prm = _inputs(settings.feeder.datasets[0].processor, ITEMS, 31)
    out = mod(frames, prm)
    np.testing.assert_array_equal(again(frames, prm), out)
    np.testing.assert_array_equal(again(frames[:FPC], prm[:FPC]),
                                  mod(frames[:FPC], prm[:FPC]))
    # the artifact keeps the float parameters, a checkpoint for either
    # package
    import zipfile
    with zipfile.ZipFile(path) as z:
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            flat = ckpt.to_jax_flat(params)
            assert sorted(npz.files) == sorted(flat)
            np.testing.assert_array_equal(npz["frames/dcnn/conv2/w"],
                                          flat["frames/dcnn/conv2/w"])
    # int8 differs from float, but not by much
    ref = serving.ServingModule(mod.model, params, batch_items=ITEMS,
                                device="cpu")(frames, prm)
    delta = np.abs(out - ref).max()
    assert 0 < delta < 0.5 * np.abs(ref).max()


def test_int8_static_needs_a_calibration_batch():
    _, model = _build()
    params = model.init_params(seed=0, device="cpu")
    with pytest.raises(FrameworkError,
                       match="int8_static requires a calibration batch"):
        serving.ServingModule(model, params, batch_items=ITEMS, device="cpu",
                              quantize="int8_static")
    with pytest.raises(FrameworkError, match="val quantize"):
        serving.ServingModule(model, params, batch_items=ITEMS, device="cpu",
                              quantize="int4")


def test_calls_route_to_the_smallest_bucket_that_fits(int8_modules):
    mods, settings, _ = int8_modules
    mod = mods["int8_static"]
    proc = settings.feeder.datasets[0].processor
    frames, prm = _inputs(proc, ITEMS, 32)
    assert [s["shape"][0] for s in mod.meta["inputs"]] == [ITEMS * FPC] * 2
    full = mod(frames, prm)
    assert mod.last_bucket == ITEMS and full.shape == (ITEMS, CLASSES)
    one = mod(frames[:FPC], prm[:FPC])
    assert mod.last_bucket == 1 and one.shape == (1, CLASSES)
    # static scales: the same row at another bucket, up to the rounding
    # of float products of another shape
    np.testing.assert_allclose(one[0], full[0], rtol=1e-5, atol=1e-6)
    mod(frames[:FPC + 1], prm[:FPC + 1])         # more than one clip
    assert mod.last_bucket == ITEMS
    out = mod.warmup()
    assert out.shape == (ITEMS, CLASSES) and mod.last_bucket == ITEMS


def test_dynamic_int8_logits_depend_on_batch_mates(int8_modules):
    """The activation scale of dynamic int8 is one amax over the whole
    padded batch, as in the JAX package: the same row beside two
    different batch-mates gives different logits.  Float and
    int8_static logits do not move."""
    mods, settings, params = int8_modules
    proc = settings.feeder.datasets[0].processor
    frames, prm = _inputs(proc, 1, 33)
    mates = [_inputs(proc, 1, 34), _inputs(proc, 1, 35)]
    # a brighter batch-mate raises the batch's amax
    mates[1] = (np.full_like(mates[1][0], 255), mates[1][1])
    float_mod = serving.ServingModule(mods["int8"].model, params,
                                      batch_items=ITEMS, device="cpu")
    rows = {}
    for name, mod in (("int8", mods["int8"]),
                      ("int8_static", mods["int8_static"]),
                      ("float", float_mod)):
        rows[name] = [mod(np.concatenate([frames, f]),
                          np.concatenate([prm, p]))[0] for f, p in mates]
    assert not np.array_equal(*rows["int8"])
    np.testing.assert_array_equal(*rows["int8_static"])
    np.testing.assert_array_equal(*rows["float"])


def test_selftest_reports_each_request_size(int8_modules, capsys):
    mods, _, _ = int8_modules
    rows = serve_mod.selftest(mods["int8_static"], item_counts=(1, 2),
                              duration_s=0.5, concurrency=2, window_ms=2.0)
    assert [r["items_per_request"] for r in rows] == [1, 2]
    for r in rows:
        assert r["requests"] > 0 and r["errors"] == 0
        assert r["rps"] > 0 and r["p99_ms"] >= r["p50_ms"] > 0
        assert r["items_per_sec"] == pytest.approx(
            r["rps"] * r["items_per_request"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows


def test_metrics_count_device_calls_by_bucket(int8_modules):
    mods, settings, _ = int8_modules
    proc = settings.feeder.datasets[0].processor
    batcher = serve_mod.Batcher(mods["int8"], window_s=0.0)
    try:
        batcher.run(list(_inputs(proc, 1, 36)))
        batcher.run(list(_inputs(proc, 2, 37)))
    finally:
        batcher.close()
    assert batcher.stats.device_calls == {1: 1, ITEMS: 1}
    text = batcher.stats.render().decode()
    assert 'vlx_device_calls_total{bucket="1"} 1' in text
