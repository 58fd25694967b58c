"""The operation and byte counts of ``counts.py`` against hand counts."""

import json
import os

import pytest

from lrcn_bench import counts

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


# CaffeNet's multiply-adds a 227x227 frame (conv1 unpadded: 55x55)
CAFFENET = {"conv1": 105_415_200, "conv2": 223_948_800,
            "conv3": 149_520_384, "conv4": 112_140_288,
            "conv5": 74_760_192, "fc6": 37_748_736, "fc7": 16_777_216}


@pytest.mark.parametrize("name", ["ucf101_lrcn", "coco_lrcn_cap"])
def test_alexnet_multiply_adds(name):
    cfg = config(name)
    assert counts.encoder_macs(cfg, conv1_padding="VALID") == CAFFENET
    assert sum(CAFFENET.values()) == 720_310_816
    # the port pads conv1 SAME: 57x57 maps, then 28x28 after pool1
    same = counts.encoder_macs(cfg)
    assert same["conv1"] == 57 * 57 * 96 * 11 * 11 * 3 == 113_221_152
    assert same["conv2"] == 28 * 28 * 256 * 5 * 5 * 48 == 240_844_800
    assert {k: same[k] for k in ("conv3", "conv4", "conv5", "fc6", "fc7")} \
        == {k: CAFFENET[k] for k in ("conv3", "conv4", "conv5", "fc6",
                                     "fc7")}
    assert sum(same.values()) == 745_012_768
    assert counts.feature_dim(cfg) == 4096


def test_kernel_bounds_at_2048_frames():
    cfg = config("ucf101_lrcn")
    assert counts.lrn_sites(cfg) == [(57, 57, 96), (28, 28, 256)]
    # x, g read and dx written, bf16: 3 * 2048 * 512,608 * 2 bytes
    assert counts.lrn_backward_bound_s(cfg, 2048) * 1e3 == \
        pytest.approx(1.880, abs=5e-4)
    # frames (227x227x3) and conv1's gradient (57x57x96) in bf16
    assert counts.conv1_dw_bound_s(cfg, 2048) * 1e3 == \
        pytest.approx(0.570, abs=5e-4)
    assert counts.lrn_forward_bound_s(cfg, 512) * 1e3 == \
        pytest.approx(0.313, abs=5e-4)


@pytest.mark.parametrize("rows, hidden, bound_us", [
    (128, 256, 0.627), (32, 256, 0.392), (256, 512, 2.507)])
def test_lstm_step_bound(rows, hidden, bound_us):
    assert counts.lstm_step_bound_s(rows, hidden) * 1e6 == \
        pytest.approx(bound_us, abs=1e-3)


def test_step_and_call_flops():
    ucf, coco = config("ucf101_lrcn"), config("coco_lrcn_cap")
    frame = 2 * 745_012_768
    lstm = 2 * ((4096 + 256) * 1024 + (256 + 256) * 1024)
    fwd = 2048 * (frame + lstm) + 2 * 128 * 256 * 101
    assert counts.forward_flops(ucf, 128) == fwd
    assert counts.train_step_flops(ucf, 128) == \
        3 * fwd - 2 * 2048 * 113_221_152
    assert counts.train_step_flops(ucf, 128) / 1e12 == \
        pytest.approx(8.75, abs=0.01)
    caption = 64 * frame + 2 * 64 * 4096 * 512 + 2 * 64 * 20 * (
        (300 + 512) * 2048 + 512 * 10000)
    assert counts.forward_flops(coco, 64) == caption
    assert counts.lstm_steps_of_call(ucf, {"items": 32}) == [(32, 256)] * 32
    assert counts.lstm_steps_of_call(coco, {"items": 64}) == [(64, 512)] * 20
