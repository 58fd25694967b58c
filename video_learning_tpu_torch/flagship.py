"""The flagship model: AlexNet fc7 -> 2-layer LSTM video classifier.

Counterpart of ``_flagship`` in the repository's ``__graft_entry__.py``:
the same two-pipeline DAG (``frames``: DCNN to fc7; ``clf``: NOP
representation, LSTM classifier with avg fusion) over a stub dataset
described by its geometry, with the same defaults (67x67 frames, fpc 4,
16 classes, 2x256 LSTM, bf16).  The full-width serving configuration is
``flagship(num_classes=101, fpc=16, image=227, raw_hw=(240, 320),
mean_scalars=SERVING_MEAN, imgproc=SERVING_IMGPROC)``.  The training
options are the JAX `_flagship`'s (SGD at lr 0.001, lr_mult 2, global-norm
clip 5, 8 batches per epoch); the full-width training step of the JAX
``bench.py`` is ``flagship(num_classes=101, fpc=16, image=227,
raw_hw=(240, 320), mean_scalars=SERVING_MEAN, device_preprocess=True,
batch_size=128, lr_mult=None, clip_norm=10.0, num_batches=1000)``.
"""

from video_learning_tpu_torch.config import (GeometryDataset,
                                             GeometryFeeder, Network,
                                             Settings, TrainOpts, ValOpts)
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.models.pipeline import Model

# BGR mean and the validation-time chain of the serving benchmark
SERVING_MEAN = (104.0, 117.0, 123.0)
SERVING_IMGPROC = (defs.imgproc.center_crop, defs.imgproc.sub_mean)
# the JAX `_flagship`'s device-preprocessing chain (training augmentation)
TRAIN_IMGPROC = (defs.imgproc.rand_crop, defs.imgproc.sub_mean,
                 defs.imgproc.rand_mirror)


def flagship(num_classes=16, fpc=4, image=67, lstm=(256, 2), raw_hw=None,
             mean_scalars=None, device_preprocess=False, batch_size=2,
             compute_dtype="bfloat16", imgproc=None, num_batches=8,
             base_lr=0.001, lr_mult=2.0, clip_norm=5.0, optimizer="sgd"):
    """(settings, Model) of the flagship DAG.  ``device_preprocess`` (or
    an explicit ``imgproc`` chain) makes the frames input raw uint8 frames
    of ``raw_hw`` that the device crops, mean-subtracts and mirrors.
    ``settings.train`` holds the training options (one epoch of
    ``num_batches`` batches of ``batch_size`` clips)."""
    if imgproc is None and device_preprocess:
        imgproc = TRAIN_IMGPROC
    dataset = GeometryDataset(
        defs.dataset_tag.main, (image, image, 3), fpc=fpc, cpv=1,
        imgproc=imgproc,
        raw_image_shape=tuple(raw_hw) + (3,) if raw_hw else None,
        mean_scalars=mean_scalars)

    frames = Network()
    frames.input = [defs.dataset_tag.main]
    frames.input_shape = [None]
    frames.representation = defs.representation.dcnn
    frames.frame_encoding_layer = "fc7"

    clf = Network()
    clf.input = ["frames"]
    clf.input_shape = [None]
    clf.representation = defs.representation.nop
    clf.classifier = defs.classifier.lstm
    clf.lstm_params = [lstm[0], lstm[1], defs.fusion_method.avg]

    s = Settings()
    s.num_classes = num_classes
    s.pipelines = {"frames": frames, "clf": clf}
    s.pipeline_names = ["frames", "clf"]
    s.feeder = GeometryFeeder([dataset], num_batches=num_batches)
    s.train = TrainOpts()
    s.train.batch_size = batch_size
    s.train.epochs = 1
    s.train.optimizer = getattr(defs.optim, optimizer)
    s.train.base_lr = base_lr
    s.train.lr_mult = lr_mult
    s.train.clip_norm = clip_norm
    s.phase = defs.phase.train
    s.compute_dtype = compute_dtype
    s.val = ValOpts()
    s.val.batch_size = batch_size
    return s, Model(s)
