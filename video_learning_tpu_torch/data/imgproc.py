"""Host-side image reading, crop geometry, mean image and augmentation.

Counterpart of ``video_learning_tpu/data/imgproc.py`` in host numpy:
``read_image``, ``compute_crop``, ``build_mean_image`` and the
``ImageProcessor`` chain.  ``draw_params`` draws the (crop_y, crop_x,
mirror) triples the device preprocessor (``ops/preprocess.py``)
consumes; ``process_batch`` runs the same chain on the host (a dataset
with ``device_preprocess: false``) from one such draw per batch.  The
draws use the same numpy stream as the JAX package, so one
``random.Random`` state gives both packages identical crops and mirrors.
PIL is imported only where an image is read or resized; binary netpbm
frames at the raw shape are read with numpy alone.
"""

import numpy as np

from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.utils import error


def _pil_image(what):
    """PIL's Image module, or a FrameworkError naming ``what`` needed it
    and the missing module."""
    try:
        from PIL import Image
    except ImportError:
        error("%s needs PIL (module 'PIL', the Pillow package), which is "
              "not installed; binary .ppm / .pgm frames at the raw shape "
              "are read without it" % what)
    return Image


def imresize(image, shape, what="an image"):
    """uint8 bilinear resize via PIL (the semantics of
    ``scipy.misc.imresize``).  ``shape`` is (H, W) or (H, W, C); ``what``
    names the image in the error where PIL is missing."""
    Image = _pil_image("Resizing %s" % what)
    h, w = int(shape[0]), int(shape[1])
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    mode = "RGB" if arr.ndim == 3 else "L"
    pil = Image.fromarray(arr, mode=mode)
    pil = pil.resize((w, h), resample=Image.BILINEAR)
    return np.asarray(pil)


def _read_netpbm(path):
    """A binary P6 (RGB) or P5 (gray) file with maxval 255 as a uint8
    (H, W, 3) or (H, W) array, else None."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"P6", b"P5"):
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            return None
        fields.append(int(data[start:pos]))
    width, height, maxval = fields
    channels = 3 if data[:2] == b"P6" else 1
    size = width * height * channels
    # exactly one whitespace byte separates maxval from the raster
    if maxval != 255 or len(data) < pos + 1 + size or \
            not data[pos:pos + 1].isspace():
        return None
    raster = np.frombuffer(data, np.uint8, size, pos + 1)
    return raster.reshape((height, width, channels)[:2 + (channels == 3)])


def read_image(imagepath, raw_image_shape=None):
    """Read an image from disk: grayscale -> 3 channels, non-RGB channels
    dropped, RGB -> BGR, optionally resized to the raw shape.

    A binary P6 / P5 file with maxval 255 is decoded with numpy, and a
    ``raw_image_shape`` equal to its own shape needs no resize (PIL's
    same-size resize is a copy), so such a file reads without PIL to the
    array PIL gives.  Every other file, and every real resize, goes
    through PIL."""
    image = None
    if str(imagepath).lower().endswith((".ppm", ".pgm", ".pnm")):
        image = _read_netpbm(imagepath)
    if image is None:
        Image = _pil_image("Reading %s" % imagepath)
        image = np.asarray(Image.open(imagepath))
    if image.ndim <= 2:
        image = np.repeat(image[:, :, np.newaxis], 3, 2)
    image = image[:, :, :3]
    image = image[:, :, ::-1]
    if raw_image_shape is not None:
        if tuple(raw_image_shape[:2]) == image.shape[:2]:
            return np.ascontiguousarray(image)
        image = imresize(image, raw_image_shape, what=imagepath)
    return image


def compute_crop(raw_image_shape, image_shape, mode):
    """Crop offset candidates: center_crop -> (h_off, w_off) scalars;
    rand_crop -> the full inclusive candidate lists."""
    if mode == defs.imgproc.center_crop:
        return tuple(int(np.floor((r - d) / 2))
                     for r, d in zip(raw_image_shape[:2], image_shape[:2]))
    if mode == defs.imgproc.rand_crop:
        if raw_image_shape[0] < image_shape[0] or \
                raw_image_shape[1] < image_shape[1]:
            error("Crop target %s exceeds raw shape %s"
                  % (tuple(image_shape[:2]), tuple(raw_image_shape[:2])))
        crop_h = list(range(0, raw_image_shape[0] - image_shape[0] + 1))
        crop_w = list(range(0, raw_image_shape[1] - image_shape[1] + 1))
        return crop_h, crop_w
    error("Unknown crop mode %s" % mode)


def build_mean_image(mean_scalars, image_shape):
    """Expand a 3-scalar per-channel mean into an HxWx3 float32 image in
    BGR channel order."""
    h, w = int(image_shape[0]), int(image_shape[1])
    planes = [np.full((h, w), float(m)) for m in mean_scalars]
    return np.transpose(np.stack(planes), [1, 2, 0]).astype(np.float32)


class ImageProcessor:
    """Per-dataset preprocessing chain: raw_resize -> {rand_crop |
    center_crop | resize} -> sub_mean -> rand_mirror."""

    def __init__(self, imgproc, raw_image_shape, desired_image_shape,
                 mean_scalars):
        self.imgproc = list(imgproc or [])
        self.raw_image_shape = raw_image_shape
        self.desired_image_shape = desired_image_shape
        self.mean_image = None
        if defs.imgproc.sub_mean in self.imgproc:
            if mean_scalars is None:
                error("sub_mean requires a mean image intensity triple")
            self.mean_image = build_mean_image(mean_scalars,
                                               desired_image_shape)
        self.crop_h = self.crop_w = None
        if defs.imgproc.rand_crop in self.imgproc and raw_image_shape:
            self.crop_h, self.crop_w = compute_crop(
                raw_image_shape, desired_image_shape, defs.imgproc.rand_crop)
        elif defs.imgproc.center_crop in self.imgproc and raw_image_shape:
            self.crop_h, self.crop_w = compute_crop(
                raw_image_shape, desired_image_shape,
                defs.imgproc.center_crop)

    def draw_params(self, n, rng):
        """Draw n (crop_y, crop_x, mirror) int32 triples from ``rng`` (a
        ``random.Random``): one 32-bit draw seeds a numpy stream for the
        whole batch, exactly as the JAX package does."""
        params = np.zeros((n, 3), dtype=np.int32)
        rand_crop = defs.imgproc.rand_crop in self.imgproc
        center_crop = defs.imgproc.center_crop in self.imgproc
        if (rand_crop or center_crop) and self.crop_h is None:
            error("draw_params needs precomputed crop offsets "
                  "(raw_image_shape unset?)")
        rand_mirror = defs.imgproc.rand_mirror in self.imgproc
        rs = (np.random.RandomState(rng.getrandbits(32))
              if (rand_crop or rand_mirror) else None)
        if rand_crop:
            params[:, 0] = rs.choice(np.asarray(self.crop_h), n)
            params[:, 1] = rs.choice(np.asarray(self.crop_w), n)
        elif center_crop:
            params[:, 0] = self.crop_h
            params[:, 1] = self.crop_w
        if rand_mirror:
            params[:, 2] = rs.randint(0, 2, n)
        return params

    def _crop(self, image, mode, rng):
        if self.crop_h is None:
            ch, cw = compute_crop(image.shape, self.desired_image_shape, mode)
        else:
            ch, cw = self.crop_h, self.crop_w
        if mode == defs.imgproc.rand_crop:
            ch, cw = rng.choice(ch), rng.choice(cw)
        ch, cw = int(ch), int(cw)
        return image[ch:ch + self.desired_image_shape[0],
                     cw:cw + self.desired_image_shape[1], :]

    def supports_params(self):
        """True when augmentation parameters can be drawn for a whole
        batch (the crop offsets do not depend on each image's shape)."""
        needs_crop = (defs.imgproc.rand_crop in self.imgproc or
                      defs.imgproc.center_crop in self.imgproc)
        return not needs_crop or self.crop_h is not None

    def _check_shape(self, image):
        if self.desired_image_shape is not None and \
                tuple(image.shape) != tuple(self.desired_image_shape):
            error("Encountered image shape %s but desired shape is %s"
                  % (image.shape, self.desired_image_shape))

    def process_batch(self, images, rng):
        """The host chain over a batch, consuming ``rng`` as the device
        path does (one ``draw_params`` per batch), so both paths give the
        same pixels from one rng."""
        if not self.supports_params():
            return [self.process(im, rng) for im in images]
        out = []
        for im, p in zip(images, self.draw_params(len(images), rng)):
            im = self.process_with_params(im, int(p[0]), int(p[1]),
                                          int(p[2]))
            self._check_shape(im)
            out.append(im)
        return out

    def process(self, image, rng):
        """One image through the chain."""
        if self.supports_params():
            p = self.draw_params(1, rng)[0]
            image = self.process_with_params(image, int(p[0]), int(p[1]),
                                             int(p[2]))
            self._check_shape(image)
            return image
        # per-image crop geometry (raw_image_shape unset: the offsets
        # depend on each image's own shape)
        if defs.imgproc.raw_resize in self.imgproc:
            image = imresize(image, self.raw_image_shape)
        if defs.imgproc.rand_crop in self.imgproc:
            image = self._crop(image, defs.imgproc.rand_crop, rng)
        elif defs.imgproc.center_crop in self.imgproc:
            image = self._crop(image, defs.imgproc.center_crop, rng)
        elif defs.imgproc.resize in self.imgproc:
            image = imresize(image, self.desired_image_shape)
        self._check_shape(image)
        if defs.imgproc.sub_mean in self.imgproc:
            image = image - self.mean_image
        if defs.imgproc.rand_mirror in self.imgproc:
            if not rng.randrange(2):
                image = image[:, ::-1, :]
        return image

    def process_with_params(self, image, crop_y, crop_x, mirror):
        """One frame through the chain with pre-drawn parameters: the
        host golden for the device preprocessor."""
        if defs.imgproc.raw_resize in self.imgproc:
            image = imresize(image, self.raw_image_shape)
        if defs.imgproc.rand_crop in self.imgproc or \
                defs.imgproc.center_crop in self.imgproc:
            image = image[crop_y:crop_y + self.desired_image_shape[0],
                          crop_x:crop_x + self.desired_image_shape[1], :]
        elif defs.imgproc.resize in self.imgproc:
            image = imresize(image, self.desired_image_shape)
        if defs.imgproc.sub_mean in self.imgproc:
            image = image - self.mean_image
        if defs.imgproc.rand_mirror in self.imgproc and mirror:
            image = image[:, ::-1, :]
        return image
