"""Device-side batched crop, mean-subtract and mirror.

Counterpart of ``video_learning_tpu/ops/preprocess.py:48-98``: uint8
frames go to the device as they are and are cropped, mean-subtracted and
mirrored there with the (crop_y, crop_x, mirror) triples the host drew
(``data/imgproc.ImageProcessor.draw_params``).  The JAX package leaves
this to XLA; here it is plain torch (one gather, one subtract, one
select) and has no hand kernel.  The output is pixel-identical to the
JAX one: the same float32 arithmetic, in the same order, then one
rounding to the output dtype.
"""

import torch

from video_learning_tpu_torch.defs import defs


def supports_device_path(imgproc, dataset=None):
    """The device path covers crop/mean/mirror chains.  Excluded: the
    PIL resize modes; raw-disk datasets that raw_resize (only the host
    path resizes their native-size frames before cropping); crop chains
    without precomputed offsets."""
    imgproc = imgproc or []
    if defs.imgproc.resize in imgproc:
        return False
    if dataset is not None:
        if defs.imgproc.raw_resize in imgproc and \
                getattr(dataset, "data_format", None) == \
                defs.data_format.raw:
            return False
        wants_crop = (defs.imgproc.rand_crop in imgproc or
                      defs.imgproc.center_crop in imgproc)
        proc = getattr(dataset, "processor", None)
        if wants_crop and (proc is None or proc.crop_h is None):
            return False
    return True


def batch_preprocess(images, params, mean_image, *, out_h, out_w, do_crop,
                     do_mean, do_mirror, out_dtype=torch.float32):
    """images: (N, Hr, Wr, C) uint8; params: (N, 3) int32 (crop_y, crop_x,
    mirror); mean_image: (out_h, out_w, C) float32, or None when unused.
    Returns (N, out_h, out_w, C) in ``out_dtype`` on the images' device."""
    x = images
    if do_crop:
        n, h, w, _ = x.shape
        params = params.to(device=x.device, dtype=torch.long)
        # clamp like lax.dynamic_slice: a window never leaves the frame
        y0 = params[:, 0].clamp(0, h - out_h)
        x0 = params[:, 1].clamp(0, w - out_w)
        rows = y0[:, None] + torch.arange(out_h, device=x.device)
        cols = x0[:, None] + torch.arange(out_w, device=x.device)
        idx = torch.arange(n, device=x.device)
        x = x[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
    x = x.to(torch.float32)
    if do_mean:
        x = x - mean_image
    if do_mirror:
        flip = params[:, 2].to(x.device) > 0
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return x.to(out_dtype)


def make_preprocessor(processor, out_dtype=torch.float32, device="cpu"):
    """Bind an ImageProcessor's chain into a device-side callable
    ``run(images_u8, params) -> processed batch``."""
    imgproc = processor.imgproc
    do_crop = (defs.imgproc.rand_crop in imgproc or
               defs.imgproc.center_crop in imgproc)
    do_mean = defs.imgproc.sub_mean in imgproc
    do_mirror = defs.imgproc.rand_mirror in imgproc
    out_h, out_w = processor.desired_image_shape[:2]
    mean = (torch.as_tensor(processor.mean_image, device=device)
            if do_mean else None)

    def run(images, params):
        return batch_preprocess(
            images, params, mean, out_h=out_h, out_w=out_w, do_crop=do_crop,
            do_mean=do_mean, do_mirror=do_mirror, out_dtype=out_dtype)

    return run
