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

``caption=True`` makes the last LSTM a captioner, as the JAX
``_flagship(caption=True)`` does; ``caption_flagship`` is the caption
workload of the JAX ``bench.py`` (``_caption_build``) at its production
sizes, and ``caption_feed`` a random caption-training feed laid out as
training batches are.
"""

import numpy as np

from video_learning_tpu_torch.config import (CaptionOpts, GeometryDataset,
                                             GeometryFeeder, Network,
                                             Settings, TrainOpts, ValOpts)
from video_learning_tpu_torch.data import captions
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
             base_lr=0.001, lr_mult=2.0, clip_norm=5.0, optimizer="sgd",
             caption=False, emb_dim=8, max_T=6):
    """(settings, Model) of the flagship DAG.  ``device_preprocess`` (or
    an explicit ``imgproc`` chain) makes the frames input raw uint8 frames
    of ``raw_hw`` that the device crops, mean-subtracts and mirrors.
    ``settings.train`` holds the training options (one epoch of
    ``num_batches`` batches of ``batch_size`` clips).  ``caption``: the
    dataset gets the vocabulary ``w000``... plus UNK, EOS and BOS
    (``num_classes`` tokens), ``RandomState(7)`` embeddings of ``emb_dim``
    and a word grid of ``max_T``, and ``settings.captioning`` the default
    (greedy) ``CaptionOpts``."""
    if imgproc is None and device_preprocess:
        imgproc = TRAIN_IMGPROC
    cap = {}
    if caption:
        cap = dict(
            vocabulary=(["w%03d" % i for i in range(num_classes - 3)]
                        + ["UNK", "EOS", "BOS"]),
            embedding_matrix=np.random.RandomState(7).randn(
                num_classes, emb_dim).astype(np.float32),
            max_sequence_length=max_T)
    dataset = GeometryDataset(
        defs.dataset_tag.main, (image, image, 3), fpc=fpc, cpv=1,
        imgproc=imgproc,
        raw_image_shape=tuple(raw_hw) + (3,) if raw_hw else None,
        mean_scalars=mean_scalars, **cap)

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
    if caption:
        s.captioning = CaptionOpts()
    return s, Model(s)


def caption_flagship(batch_size=64, compute_dtype="bfloat16"):
    """The caption workload of the JAX ``bench.py`` (``_caption_build``
    and its defaults): 240x320 uint8 frames cropped to 227 on the device,
    BGR mean, random mirror, AlexNet to fc7, ``state_fc`` 4096 -> 512,
    state_bias conditioning, a 1x512 LSTM, a vocabulary of 10,000, 300-d
    embeddings, T = 20, bf16, SGD at lr 0.001 with a global-norm clip of
    10, batches of 64 captions."""
    return flagship(num_classes=10000, fpc=1, image=227, lstm=(512, 1),
                    raw_hw=(240, 320), mean_scalars=SERVING_MEAN,
                    device_preprocess=True, batch_size=batch_size,
                    compute_dtype=compute_dtype, num_batches=1000,
                    base_lr=0.001, lr_mult=None, clip_norm=10.0,
                    caption=True, emb_dim=300, max_T=20)


def caption_feed(settings, model, rng_seed=0):
    """A random caption-training feed of ``settings.train.batch_size``
    captions: float32 frames of the dataset's frame shape, the (B*T, E)
    word grid, input lengths (1 + caption length), the (B, T) validity
    mask, one-hot labels scattered over the padded word grid and the
    flattened label_mask.  The same numpy draws as the JAX
    ``__graft_entry__._caption_feed`` (at the dataset's fpc and frame
    size), so one seed gives the same feed in both packages."""
    dset = model.caption_dataset
    B = settings.train.batch_size
    T = dset.max_sequence_length
    C = settings.num_classes
    rs = np.random.RandomState(rng_seed)
    lengths = rs.randint(1, T, size=B)            # caption token counts
    tokens = [list(rs.randint(0, C - 3, size=n)) for n in lengths]
    framed = captions.labels_to_words(tokens, dset.embedding_matrix,
                                      dset.vocabulary, C, T,
                                      include_labels=True, do_padding=True)
    feed = captions.feed_from_words(framed, framed["onehot_labels"])
    feed["frames_main_input"] = rs.randn(
        B * dset.num_frames_per_clip, *dset.image_shape).astype(np.float32)
    return feed
